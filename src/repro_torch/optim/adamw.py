"""AdamW with global-norm clipping and a warmup + cosine schedule.

The port of the reference's ``repro/optim/adamw.py`` over an :class:`LM`'s
named parameters.  The optimizer state mirrors them: ``{"m": {name:
tensor}, "v": {name: tensor}, "step": tensor}``, ``m`` and ``v`` float32
on the parameters' device, ``step`` an int32 scalar there.  Gradients are
a ``{name: tensor}`` dict in the same names.

The arithmetic is the reference's, operation by operation: the clipped
gradients are rounded back to their own type; ``m`` and ``v`` take the
float32 gradient; the bias corrections divide them; the update is ``p32 -
lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p32)``, rounded once to
the parameter's type; weight decay applies to every leaf, norms included.
Unlike the reference, which returns new trees, the update works in place
and in chunks of :data:`CHUNK` elements, so no temporary is larger than a
chunk: written leaf by leaf, a 778.6 M-element embedding would make
several 3.1 GB float32 temporaries.

On the card those chunks are the kernel's plain version: a leaf the
hand-written ``kernels/csrc/adamw.cu`` takes is updated there in two
passes that keep every temporary in registers (the gradient read once
for the norm, then p, g, m and v read once and p, m and v written once),
with the same float32 operations in the same order, so p, m and v come
out bit for bit as the chunks make them from the same clip scale.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from ..kernels import adamw as adamw_kernel
from ..obs import spans

__all__ = ["AdamWConfig", "CHUNK", "adamw_init", "adamw_update",
           "adamw_update_ref", "clip_by_global_norm", "lr_schedule"]

#: elements per chunk of the in-place update (a 128 MB float32 temporary)
CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), as a float32 tensor on its
    device: linear warmup to ``cfg.lr``, then a cosine down to
    ``min_lr_frac * lr`` at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(1.0,
                                           cfg.total_steps - cfg.warmup_steps)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: nn.Module) -> Dict[str, object]:
    """Zero float32 ``m`` and ``v`` for every named parameter, on its
    device, and ``step`` 0."""
    named = list(params.named_parameters())
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,   # noqa: E731
                                  device=p.device)
    return {"m": {n: zeros(p) for n, p in named},
            "v": {n: zeros(p) for n, p in named},
            "step": torch.zeros((), dtype=torch.int32,
                                device=named[0][1].device)}


def _chunks(*tensors: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Views of :data:`CHUNK` consecutive elements of each tensor, side by
    side; the tensors whole, in one piece, when any of them is not
    contiguous (it has no flat view)."""
    if not all(t.is_contiguous() for t in tensors):
        yield tensors
        return
    flat = [t.view(-1) for t in tensors]
    for i in range(0, flat[0].numel(), CHUNK):
        yield tuple(f[i:i + CHUNK] for f in flat)


def _squares(grads, shares):
    """The float32 sum of the ``(name, gradient)`` pairs' squared sums,
    each weighted by ``shares[name]`` (1 by default), chunk by chunk;
    None for no pair."""
    sq = None
    for name, g in grads:
        w = shares.get(name, 1.0) if shares else 1.0
        for (c,) in _chunks(g):
            part = c.float().square().sum()
            if w != 1.0:
                part = part * w
            sq = part if sq is None else sq + part
    return sq


def _clip_scale(sq: torch.Tensor, max_norm: float, group):
    """``(norm, scale)`` of the summed squares ``sq`` (added over
    ``group`` first, in place): ``scale = min(1, max_norm / max(norm,
    1e-12))``, both float32 device scalars."""
    if group is not None:
        from ..sharding import collectives
        collectives.all_reduce_(sq, group)
    gn = torch.sqrt(sq)
    return gn, torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        shares: Optional[Dict[str, float]] = None,
                        group=None):
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-12))``,
    ``norm`` the float32 global norm, each rounded back to its own type,
    **in place**; returns ``(grads, norm)`` with the norm before
    clipping.

    Sharded gradients (each rank holding its shards): ``shares[name]`` is
    the part of a leaf's squared sum this rank counts (1 over the ranks
    holding the same shard), and the weighted sum is added over ``group``
    (every rank of the mesh)."""
    with torch.no_grad():
        gn, scale = _clip_scale(_squares(grads.items(), shares), max_norm,
                                group)
        for g in grads.values():
            _clip_(g, scale)
    return grads, gn


def _clip_(g: torch.Tensor, scale: torch.Tensor) -> None:
    """``g *= scale`` in place, rounded once to ``g``'s type.  A gradient
    narrower than float32 is multiplied in float32, chunk by chunk: the
    reference's ``(g.astype(f32) * scale).astype(g.dtype)``.  (Torch's
    ``mul_`` of a bfloat16 CUDA tensor by a float32 device scalar rounds
    the scalar to bfloat16 first.)"""
    if g.element_size() >= 4:
        g.mul_(scale)
        return
    for (c,) in _chunks(g):
        c.copy_(c.float() * scale)


def _plain_leaf(cfg: AdamWConfig, p, g, m, v, lr, bc1, bc2) -> None:
    """One leaf's update from its clipped gradient in torch ops, chunk by
    chunk: the kernel's plain version."""
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    for pc, gc, mc, vc in _chunks(p, g, m, v):
        g32 = gc.float()
        mc.mul_(b1).add_((1 - b1) * g32)
        vc.mul_(b2).add_((1 - b2) * g32 * g32)
        del g32
        p32 = pc.float()
        delta = (mc / bc1) / (torch.sqrt(vc / bc2) + eps)
        delta += wd * p32
        pc.copy_(p32 - lr * delta)


def _update(cfg, params, grads, state, shares, group, fused_ok):
    """:func:`adamw_update`, the leaves for which ``fused_ok(p, g, m, v)``
    holds through the kernel and the rest through :func:`_plain_leaf`."""
    named = list(params.named_parameters())
    ms, vs = state["m"], state["v"]
    fused = [n for n, p in named if fused_ok(p, grads[n], ms[n], vs[n])]
    kernel_leaves = set(fused)
    plain = [(n, g) for n, g in grads.items() if n not in kernel_leaves]
    with torch.no_grad():
        sq = _squares(plain, shares)
        if fused:
            part = adamw_kernel.sum_squares(
                [grads[n] for n in fused],
                [shares.get(n, 1.0) if shares else 1.0 for n in fused])
            sq = part if sq is None else part + sq
        gnorm, scale = _clip_scale(sq, cfg.clip_norm, group)
        for _, g in plain:
            _clip_(g, scale)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    stepf = step.float()
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf
    counts = {"fused": 0, "plain": 0}
    with torch.no_grad():
        for name, p in named:
            g, m, v = grads[name], ms[name], vs[name]
            if name in kernel_leaves:
                adamw_kernel.update(p, g, m, v, scale, lr, bc1, bc2, cfg.b1,
                                    cfg.b2, cfg.eps, cfg.weight_decay)
                counts["fused"] += p.numel()
            else:
                _plain_leaf(cfg, p, g, m, v, lr, bc1, bc2)
                counts["plain"] += p.numel()
    sp = spans.current()
    if sp is not None:
        for kind, n in counts.items():
            sp.count(f"repro.optim.{kind}_params", n)
    state = {"m": ms, "v": vs, "step": step}
    return params, state, {"lr": lr, "grad_norm": gnorm}


def adamw_update(cfg: AdamWConfig, params: nn.Module,
                 grads: Dict[str, torch.Tensor], state: Dict[str, object],
                 shares: Optional[Dict[str, float]] = None, group=None):
    """One AdamW step: clips ``grads`` (``shares`` and ``group`` as
    :func:`clip_by_global_norm` takes them, for sharded leaves), then
    updates every parameter of ``params`` and the state's ``m`` and ``v``
    **in place**.  Returns ``(params, state, {"lr", "grad_norm"})`` with
    ``state["step"]`` advanced, the reference's return.

    The path is chosen leaf by leaf from what the leaf is.  A leaf the
    kernel takes (:func:`repro_torch.kernels.adamw.takes`: on CUDA,
    contiguous, a bfloat16 or float32 parameter and gradient, float32
    ``m`` and ``v``) goes through ``csrc/adamw.cu``, a norm pass and one
    fused clip-and-update pass; its gradient is read and **left
    unclipped**, as the train step throws it away.  Every other leaf
    (on the CPU, float64, float16, or with a tensor that is not
    contiguous) goes through the chunked torch ops, its gradient clipped
    in place; a leaf that is not contiguous is updated whole, in one
    piece.  Inside
    an open span call (:func:`repro_torch.obs.spans.current`) it counts
    each path's elements, ``repro.optim.fused_params`` and
    ``repro.optim.plain_params``."""
    return _update(cfg, params, grads, state, shares, group,
                   adamw_kernel.takes)


def adamw_update_ref(cfg: AdamWConfig, params: nn.Module,
                     grads: Dict[str, torch.Tensor], state: Dict[str, object],
                     shares: Optional[Dict[str, float]] = None, group=None):
    """:func:`adamw_update` with every leaf through the chunked torch ops,
    each gradient clipped in place: the kernel's plain version, which the
    card's tests and ``chip_smoke.py`` hold the kernel against."""
    return _update(cfg, params, grads, state, shares, group,
                   lambda *leaf: False)
