"""The differentiable collectives of the sharded model, on process groups.

The port's counterpart of the reference's ``shard_map`` shim
(``models/compat.py``) and of the collectives GSPMD inserts: the model runs
one SPMD program per rank and calls these where the reference's
``shard_map`` bodies call ``psum``/``all_gather``/``all_to_all``, and where
GSPMD puts them for it (Megatron TP, FSDP gathers).

* :func:`copy_to` — identity forward, all-reduce backward (a replicated
  activation entering a sharded computation);
* :func:`reduce_from` — all-reduce forward, identity backward (partial sums
  leaving one; its result is replicated, so its gradient already is the
  whole gradient).  ``funcol.all_reduce`` is *not* this: its backward
  all-reduces again and multiplies a replicated gradient by the group size;
* :func:`all_gather` — along any dimension, reduce-scatter backward (FSDP,
  the MoE's token gather);
* :func:`all_to_all` — split one dimension, concatenate another; its
  backward is the inverse exchange;
* :func:`all_reduce_max` — no gradient (the CE's stability shift, as the
  reference's ``stop_gradient`` before ``pmax``);
* :func:`lse_combine` / :func:`lse_merge` — attention partials over slices
  of a sequence, combined exactly by their log-sum-exp.

Every helper is a no-op on ``group=None``, the group of one rank, so a
``(1, 1)`` mesh runs the same code path with no collective.  Each counts
its calls and bytes by kind in :data:`COUNTS`, under the reference's kind
names; the bytes of a call are the larger of its input's and its output's
(the reference's ``hlo_analysis`` convention), backward calls included.
"""

from __future__ import annotations

import warnings
from typing import Dict

import torch
import torch.distributed as dist

__all__ = ["COUNTS", "KINDS", "all_gather", "all_reduce_", "all_reduce_max",
           "all_to_all", "copy_to", "counts", "lse_combine", "lse_merge",
           "reduce_from", "reset_counts"]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
#: ``{kind: {"count", "bytes"}}`` since the last :func:`reset_counts`
COUNTS: Dict[str, Dict[str, int]] = {}


def reset_counts() -> None:
    for k in KINDS:
        COUNTS[k] = {"count": 0, "bytes": 0}


reset_counts()


def counts() -> Dict[str, object]:
    """A copy of :data:`COUNTS` with ``total_bytes`` and ``total_count``."""
    out: Dict[str, object] = {k: dict(v) for k, v in COUNTS.items()}
    out["total_bytes"] = sum(v["bytes"] for v in COUNTS.values())
    out["total_count"] = sum(v["count"] for v in COUNTS.values())
    return out


def _count(kind: str, *tensors: torch.Tensor) -> None:
    COUNTS[kind]["count"] += 1
    COUNTS[kind]["bytes"] += max(t.numel() * t.element_size()
                                 for t in tensors)


def _gloo_cuda(x: torch.Tensor, group) -> bool:
    """A CUDA tensor on a gloo group: the collective runs on a host copy,
    synchronously (gloo's own CUDA path is not used: two ranks on one card
    share no NCCL, and host staging keeps every tensor's lifetime plain)."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _staged(x: torch.Tensor, group, run):
    """``run(x)`` on the host when ``x`` is a CUDA tensor on a gloo group,
    the result copied back; else ``run(x)``."""
    if not _gloo_cuda(x, group):
        return run(x)
    return run(x.cpu()).to(x.device)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM,
                async_op: bool = False):
    """In-place all-reduce of ``x`` over ``group`` (counted); returns the
    work handle with ``async_op`` (None where it ran at once), else
    None."""
    if group is None:
        return None
    _count("all-reduce", x)
    if _gloo_cuda(x, group):
        h = x.cpu()
        dist.all_reduce(h, op=op, group=group)
        x.copy_(h)
        return None
    return dist.all_reduce(x, op=op, group=group, async_op=async_op)


def _gather0(src: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = src.new_empty((n * src.shape[0],) + src.shape[1:])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src, group=group)
    return out


def _scatter0(src: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, src, group=group)
    return out


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    src = x.movedim(dim, 0).contiguous()
    out = _staged(src, group, lambda t: _gather0(t, group)).movedim(0, dim)
    _count("all-gather", x, out)
    return out


def _scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    src = x.movedim(dim, 0).contiguous()
    out = _staged(src, group, lambda t: _scatter0(t, group)).movedim(0, dim)
    _count("reduce-scatter", x, out)
    return out


def _exchange(x: torch.Tensor, split: int, concat: int, group) -> torch.Tensor:
    """Cut ``split`` into ``n`` pieces, send piece j to rank j, and lay the
    pieces received along ``concat`` in rank order."""
    n = dist.get_world_size(group)
    parts = x.movedim(split, 0)
    src = parts.reshape((n, parts.shape[0] // n) + parts.shape[1:])

    def run(t):
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    out = _staged(src, group, run)
    # out[j] is rank j's piece for this rank: (n, s/n, ...) with the split
    # axis first; put the pieces side by side along `concat`
    out = out.movedim(1, split + 1)          # (n, ... original layout ...)
    out = torch.cat(list(out.unbind(0)), dim=concat)
    _count("all-to-all", x, out)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_(g, ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        all_reduce_(y, group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, concat, group):
        ctx.split, ctx.concat, ctx.group = split, concat, group
        return _exchange(x, split, concat, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.concat, ctx.split, ctx.group), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient is all-reduced over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward; the gradient passes unchanged."""
    return x if group is None else _ReduceFrom.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in rank order; the
    gradient is reduce-scattered back."""
    return x if group is None else _AllGather.apply(x, dim, group)


def all_to_all(x: torch.Tensor, split: int, concat: int, group) -> torch.Tensor:
    """The reference's tiled ``lax.all_to_all(x, split_axis=split,
    concat_axis=concat)``."""
    return x if group is None else _AllToAll.apply(x, split, concat, group)


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over ``group``, outside autograd."""
    if group is None:
        return x.detach()
    y = x.detach().contiguous().clone()
    all_reduce_(y, group, op=dist.ReduceOp.MAX)
    return y


def _weights(lse: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``exp(lse - m)``, 0 where ``lse`` is -inf (an empty slice), never
    NaN (``m`` is finite wherever some slice has a key)."""
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.where(torch.isfinite(lse), torch.exp(lse - m),
                       torch.zeros_like(lse))


def lse_merge(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """Combine attention partials stacked on a leading axis: ``outs`` ``(n,
    B, H, d)`` each normalised over its own keys, ``lses`` ``(n, B, H)``
    float32 their log-sum-exps.  Returns ``sum_i out_i w_i / sum_i w_i``,
    ``w_i = exp(lse_i - max lse)``, in ``outs``'s dtype (zeros where no
    slice had a key)."""
    m = lses.amax(dim=0)
    w = _weights(lses, m)
    num = (outs.float() * w[..., None]).sum(dim=0)
    den = w.sum(dim=0)
    return (num / den.clamp_min(1e-30)[..., None]).to(outs.dtype)


@torch.no_grad()
def lse_combine(out: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """:func:`lse_merge` of every rank's ``(out (B, H, d), lse (B, H))``
    over ``group``: one max and one sum all-reduce."""
    if group is None:
        return out
    m = all_reduce_max(lse, group)
    w = _weights(lse.float(), m)
    B, H, d = out.shape
    buf = torch.cat([(out.float() * w[..., None]).reshape(-1),
                     w.reshape(-1)])
    all_reduce_(buf, group)
    num = buf[:B * H * d].view(B, H, d)
    den = buf[B * H * d:].view(B, H)
    return (num / den.clamp_min(1e-30)[..., None]).to(out.dtype)
