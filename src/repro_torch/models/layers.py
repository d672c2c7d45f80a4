"""Transformer and MoE layer primitives, as ``nn.Module``\\ s.

The port of the reference's ``repro/models/layers.py``: ``rmsnorm``,
``rope``, the attention block (prefill, decode and cross-attention
branches), the SwiGLU MLP, the top-k MoE FFN (its single-device path) and
parameter creation.  Modules keep the reference's parameter names (``wq``,
``wk``, ``wv``, ``wo``, ``gamma_q``, ``gamma_k``, ``wg``, ``wu``, ``wd``,
``router``, ``shared``), so ``blocks.3.attn.wq`` is the reference's
``blocks/attn/wq[3]``.  Activations are ``(batch, seq, d_model)``.

Attention runs through the port's hand-written kernels where the reference
says "the Pallas flash kernel is the TPU fast path": prefill through
:func:`~repro_torch.kernels.flash_attention.flash_attention` (the
reference's ``_chunked_attn``), decode through
:func:`~repro_torch.kernels.decode_attention.decode_attention` (the
reference's ``decode_attention``).  Cross-attention takes the same two:
its prefill is flash attention of the prompt over the memory rows
(``causal=False``, the two lengths differ), and a decode step's single
query over all ``M`` memory rows is decode attention at ``length = M``,
which is the reference's ``_chunked_attn(causal=False)`` at one query.  On
CPU tensors both take their plain versions.  The large products (``x @
wq``, the MLP, the experts' products) stay ``torch.matmul``/``torch.bmm``,
as the reference leaves them to XLA.

Parameters are made with ``requires_grad=False``, which serving keeps;
training turns them on with ``model.requires_grad_(True)``.  Every path
of a training step (the cache-less and memory branches of
:class:`Attention`, the MLP, the MoE's capacity slots) is then
differentiable: flash attention through its autograd Function.  Decode
attention has no backward and refuses inputs that require grad.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention
from ..obs import spans
from ..sharding import collectives as C

__all__ = ["Attention", "Block", "LOGICAL_AXES", "MLP", "MoE", "attn_axes",
           "attn_spec", "materialize_", "mlp_axes", "mlp_spec",
           "moe_axes", "moe_capacity", "moe_loop_ref", "moe_route",
           "moe_route_sigmoid", "moe_spec", "rmsnorm", "rope", "rope_tables",
           "sharded"]

#: the logical axis vocabulary (mapped to mesh axes by
#: :mod:`repro_torch.sharding.rules`)
LOGICAL_AXES = ("batch", "seq", "embed", "heads", "kv_heads", "ff", "vocab",
                "experts", "ssm_inner", "state", None)


def sharded(ctx) -> bool:
    """Whether ``ctx`` (a :class:`~repro_torch.sharding.ShardCtx` or None)
    holds a mesh: the per-rank path, even on a mesh of one rank."""
    return ctx is not None and ctx.mesh is not None


# ---------------------------------------------------------------------------
# parameter creation
# ---------------------------------------------------------------------------
def _is_scale(name: str) -> bool:
    """A 1-D leaf that scales a normalised activation: starts at one."""
    return (name.startswith(("norm", "gamma", "ln")) or name.endswith("norm")
            or name == "scale")


@torch.no_grad()
def materialize_(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of ``module`` in place, in registration order.

    The reference's rule (``layers.materialize``): a leaf of rank >= 2 is a
    truncated normal on [-2, 2] drawn in float32 times ``1/sqrt(fan_in)``,
    ``fan_in`` being the second-to-last dimension (the product of all but
    the last beyond rank 2), then cast to the parameter's type; 1-D scales
    are ones and other 1-D leaves zeros.  Each leaf is drawn on its own
    device, so a full-width model never passes through the host.

    Two differences (ROADMAP Queue C).  The reference matches scales by
    the prefixes ``norm``/``gamma`` only, so its ``final_norm`` starts at
    zero, which zeroes every logit of a fresh model; here scales start at
    one.  And the reference draws each block leaf stacked over the layers:
    its block norm scales, (layers, d), as matrices at fan-in ``layers``,
    and its block matrices at ``layers`` times the fan-in used here."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if p.dim() >= 2:
            shape = p.shape
            fan_in = shape[-2] if p.dim() == 2 else math.prod(shape[:-1])
            x = torch.empty(shape, dtype=torch.float32, device=p.device)
            nn.init.trunc_normal_(x, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                  generator=generator)
            p.copy_(x.mul_(1.0 / math.sqrt(fan_in)))
            del x
        elif _is_scale(leaf):
            p.fill_(1.0)
        else:
            p.zero_()


def _param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised leaf that serving leaves frozen; training turns it
    on with ``model.requires_grad_(True)``."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Root-mean-square norm over the last axis, computed in float32 and
    returned in x's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def rope_tables(positions: torch.Tensor, theta: float,
                hd: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(cos, sin)`` of shape ``(..., S, 1, hd // 2)`` for integer
    ``positions`` ``(..., S)``; one pair serves every layer of a step that
    shares ``theta``."""
    half = hd // 2
    dev = positions.device
    # filled on the device: no copy from the host, which would wait for it
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32,
                                     device=dev))
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=dev)
                      * (log_theta / half))
    ang = positions[..., :, None].float() * freqs
    return torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def rope(x: torch.Tensor,
         tables: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Rotary embedding of x ``(..., S, H, hd)`` by the ``(cos, sin)`` of
    :func:`rope_tables`: the two halves of the head dimension are rotated as
    pairs and concatenated (not interleaved)."""
    half = x.shape[-1] // 2
    cos, sin = tables
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def attn_spec(cfg) -> Dict[str, tuple]:
    """Parameter shapes of one attention block, by name."""
    hd, d = cfg.head_dim, cfg.d_model
    s = {
        "wq": (d, cfg.n_heads * hd),
        "wk": (d, cfg.n_kv_heads * hd),
        "wv": (d, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, d),
    }
    if cfg.qk_norm:
        s["gamma_q"] = (hd,)
        s["gamma_k"] = (hd,)
    if cfg.attn_gate:
        s["wgate"] = (d, cfg.n_heads * hd)
    return s


def attn_axes(cfg) -> Dict[str, tuple]:
    """The logical axes of :func:`attn_spec`'s leaves (the reference's)."""
    s = {"wq": ("embed", "heads"), "wk": ("embed", "kv_heads"),
         "wv": ("embed", "kv_heads"), "wo": ("heads", "embed")}
    if cfg.qk_norm:
        s["gamma_q"] = (None,)
        s["gamma_k"] = (None,)
    if cfg.attn_gate:
        s["wgate"] = ("embed", "heads")
    return s


def _local_heads(ctx, cfg):
    """``(group, tp, rank, hl)``: the model axis's group, size and this
    rank's index, and the query heads each rank holds: ``H / tp``, or
    ``ceil(H / tp)`` when ``tp`` does not divide ``H`` (the last ranks'
    surplus heads are zero padding)."""
    tp = ctx.model_size
    return (ctx.group(ctx.model_axis), tp, ctx.index(ctx.model_axis),
            -(-cfg.n_heads // tp))


def _realign(w: torch.Tensor, dim: int, ctx, cfg) -> torch.Tensor:
    """``w``'s head columns (``dim`` 1 of ``wq``) or rows (``dim`` 0 of
    ``wo``) regrouped into whole heads when the model axis does not divide
    the heads: the even flat shards are gathered (their gradient
    reduce-scattered back) and this rank keeps heads ``[r hl, (r + 1)
    hl)``, zero-padded past ``H``.  When it divides, ``w`` itself."""
    g, tp, r, hl = _local_heads(ctx, cfg)
    if cfg.n_heads % tp == 0:
        return w
    hd = cfg.head_dim
    full = C.all_gather(w, dim, g)
    lo, hi = min(r * hl, cfg.n_heads) * hd, min((r + 1) * hl, cfg.n_heads) * hd
    part = full.narrow(dim, lo, hi - lo)
    pad = [0, 0] * (part.dim() - 1 - dim) + [0, hl * hd - (hi - lo)]
    return nn.functional.pad(part, pad)


def _kv_heads_for(ctx, cfg, hl: int):
    """How this rank's ``hl`` query heads read the K/V heads its
    projections computed: None when they group in place (``h`` reads
    ``h // (hl / KV_local)``), else the long tensor of the KV head each
    query head reads (the K/V are then expanded to one head per query
    head)."""
    if ctx.shard_kv:
        return None
    rep = cfg.n_heads // cfg.n_kv_heads
    r = ctx.index(ctx.model_axis)
    kv = [min(r * hl + j, cfg.n_heads - 1) // rep for j in range(hl)]
    uniq = sorted(set(kv))
    if hl % len(uniq) == 0 and kv == [u for u in uniq
                                      for _ in range(hl // len(uniq))]:
        return slice(uniq[0], uniq[-1] + 1)
    return torch.tensor(kv)


def _select_kv(t: torch.Tensor, which, dim: int) -> torch.Tensor:
    if which is None:
        return t
    if isinstance(which, slice):
        return t.narrow(dim, which.start, which.stop - which.start)
    return t.index_select(dim, which.to(t.device))


def cache_seq_axes(cfg, ctx) -> tuple:
    """The mesh axes the decode cache's sequence shards over
    (``lm.cache_pspecs``): "model" when the KV heads do not divide it, and
    the batch axes too under ``seq_shard_cache``."""
    kv_div = bool(cfg.n_kv_heads) and cfg.n_kv_heads % ctx.model_size == 0
    axes = tuple(ctx.batch_axes) if ctx.seq_shard_cache else ()
    return axes + (() if kv_div else (ctx.model_axis,))


def _local_window(start: int, S_l: int, length: int, window: int):
    """``(length, window)`` for the decode kernel over the cache slice
    ``[start, start + S_l)`` when the valid keys are ``[lo, length)``
    with ``lo = length - window`` under a window."""
    lo = max(0, length - window) if window > 0 else 0
    hi = min(max(length - start, 0), S_l)
    lo_l = max(lo - start, 0)
    if lo_l >= hi:
        return 0, 0
    return hi, (hi - lo_l if lo_l > 0 else 0)


class Attention(nn.Module):
    """Self- or cross-attention with an optional KV cache (the reference's
    ``layers.attention``)."""

    def __init__(self, cfg, *, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.cfg = cfg
        for name, shape in attn_spec(cfg).items():
            setattr(self, name, _param(shape, dtype, device))

    def forward(self, x: torch.Tensor, *, window: int = 0, rope_cs=None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: Optional[int] = None,
                memory: Optional[torch.Tensor] = None, causal: bool = True,
                ctx=None):
        """* prefill (``cache is None``): returns ``(out, {"k", "v"})`` with
          the full rotated K/V ``(B, S, KV, hd)`` for the cache; ``causal=
          False`` is the encoder's full self-attention;
        * decode (``cache={"k", "v"}`` views ``(B, S_max, KV, hd)`` of one
          layer, ``cache_index`` the host-side fill): writes this step's K/V
          at ``cache_index`` *in place* and returns ``(out, cache)``;
        * cross-attention (``memory`` ``(B, M, D)``): K/V are projected from
          ``memory`` at every call, with no rope, no mask and no cache;
          returns ``(out, None)``.

        ``rope_cs`` is the step's ``(cos, sin)`` from :func:`rope_tables`,
        or None for a layer without rope.  With ``cfg.attn_gate`` the heads'
        output is multiplied by ``sigmoid(x @ wgate)`` before ``wo``.  With a
        mesh in ``ctx``, :meth:`_sharded` runs this rank's heads."""
        if sharded(ctx):
            return self._sharded(x, window=window, rope_cs=rope_cs,
                                 cache=cache, cache_index=cache_index,
                                 memory=memory, causal=causal, ctx=ctx)
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.head_dim
        src = x if memory is None else memory
        M = src.shape[1]
        q = (x @ self.wq).view(B, S, cfg.n_heads, hd)
        k = (src @ self.wk).view(B, M, cfg.n_kv_heads, hd)
        v = (src @ self.wv).view(B, M, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, self.gamma_q, cfg.norm_eps)
            k = rmsnorm(k, self.gamma_k, cfg.norm_eps)

        if memory is not None:
            if S == 1:
                # one query over every memory row: the decode kernel's
                # layout, (B, M, KV, hd), with all M rows valid
                out = decode_attention(q[:, 0], k, v, M)
            else:
                out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2),
                                      causal=False).transpose(1, 2)
            return out.reshape(B, S, cfg.n_heads * hd) @ self.wo, None

        if rope_cs is not None:
            q = rope(q, rope_cs)
            k = rope(k, rope_cs)

        if cache is None:
            # the kernel reads (B, heads, S, hd) views of the projections
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window)
            out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * hd)
            return self._gated(out, x) @ self.wo, {"k": k, "v": v}

        if S != 1:
            raise NotImplementedError(
                "a decode step takes one token per sequence")
        ck, cv = cache["k"], cache["v"]
        ck[:, cache_index] = k[:, 0]
        cv[:, cache_index] = v[:, 0]
        out = decode_attention(q[:, 0], ck, cv, cache_index + 1,
                               window=window)
        out = self._gated(out.reshape(B, 1, cfg.n_heads * hd), x)
        return out @ self.wo, cache

    def _gated(self, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The heads' output ``(B, S, H hd)`` times ``sigmoid(x @ wgate)``
        with ``cfg.attn_gate``, else as it is."""
        if not self.cfg.attn_gate:
            return out
        return out * torch.sigmoid(x @ self.wgate)

    def _sharded(self, x, *, window, rope_cs, cache, cache_index, memory,
                 causal, ctx):
        """This rank's share of :meth:`forward` (Megatron TP): q, k and v
        are column-parallel over its query heads (and its KV heads, or all
        of them where ``ctx.shard_kv`` is False), ``o`` is row-parallel and
        its partial sums are added over the model axis.  The cache (decode)
        is this rank's slice, :func:`cache_seq_axes` telling whether its
        sequence is cut: then the kernel returns each row's log-sum-exp
        and the slices' partials combine over those axes (the query heads
        gathered first when the slices cut across the model axis).
        Returns ``(out, {"k", "v"})`` with this rank's computed K/V heads
        (prefill), ``(out, cache)`` or ``(out, None)``."""
        cfg = self.cfg
        if cfg.attn_gate:
            raise NotImplementedError("the attention gate runs on one device")
        g, tp, r, hl = _local_heads(ctx, cfg)
        B, S, _ = x.shape
        hd = cfg.head_dim
        xin = C.copy_to(x, g)
        src = xin if memory is None else C.copy_to(memory, g)
        M = src.shape[1]
        wk, wv = self.wk, self.wv
        if not ctx.shard_kv:
            # replicated K/V weights feed this rank's heads only: their
            # gradient is summed over the model axis
            wk, wv = C.copy_to(wk, g), C.copy_to(wv, g)
        wq = _realign(self.wq, 1, ctx, cfg)
        wo = _realign(self.wo, 0, ctx, cfg)
        q = (xin @ wq).view(B, S, hl, hd)
        k = (src @ wk).view(B, M, -1, hd)
        v = (src @ wv).view(B, M, -1, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, C.copy_to(self.gamma_q, g), cfg.norm_eps)
            k = rmsnorm(k, C.copy_to(self.gamma_k, g), cfg.norm_eps)
        which = _kv_heads_for(ctx, cfg, hl)

        def attend(q, k, v, *, causal, window):
            k, v = _select_kv(k, which, 2), _select_kv(v, which, 2)
            if S == 1 and not causal:
                return decode_attention(q[:, 0], k, v, k.shape[1])[:, None]
            return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal,
                                   window=window).transpose(1, 2)

        def finish(out):
            out = out.reshape(B, S, hl * hd) @ wo
            return C.reduce_from(out, g)

        if memory is not None:
            return finish(attend(q, k, v, causal=False, window=0)), None
        if rope_cs is not None:
            q = rope(q, rope_cs)
            k = rope(k, rope_cs)
        if cache is None:
            return finish(attend(q, k, v, causal=causal, window=window)), \
                {"k": k, "v": v}
        if S != 1:
            raise NotImplementedError(
                "a decode step takes one token per sequence")
        return finish(self._decode_slice(q[:, 0], k[:, 0], v[:, 0], cache,
                                         cache_index, window, ctx, hl)
                      [:, None]), cache

    def _decode_slice(self, q, k, v, cache, idx, window, ctx, hl):
        """One decode step over this rank's slice of the cache: writes
        this token's K/V where the slice holds position ``idx``, attends,
        and combines the slices; returns this rank's heads ``(B, hl,
        hd)``."""
        cfg = self.cfg
        ck, cv = cache["k"], cache["v"]
        S_l, kv_c = ck.shape[1], ck.shape[2]
        seq = cache_seq_axes(cfg, ctx)
        start = ctx.index(seq) * S_l
        if k.shape[1] != kv_c:
            # replicated K/V weights (shard_kv off) over a head-sharded cache
            k = k.narrow(1, ctx.index(ctx.model_axis) * kv_c, kv_c)
            v = v.narrow(1, ctx.index(ctx.model_axis) * kv_c, kv_c)
        if start <= idx < start + S_l:
            ck[:, idx - start] = k
            cv[:, idx - start] = v
        length, win = _local_window(start, S_l, idx + 1, window)
        if not seq:
            return decode_attention(q, ck, cv, length, window=win)
        gather_q = ctx.model_axis in seq
        if gather_q:
            # all heads over this slice of the sequence (all KV heads)
            qa = C.all_gather(q, 1, ctx.group(ctx.model_axis))
            q = qa[:, :cfg.n_heads]
        out, lse = decode_attention(q, ck, cv, length, window=win,
                                    return_lse=True)
        out = C.lse_combine(out, lse, ctx.group(seq))
        if gather_q:
            r = ctx.index(ctx.model_axis)
            out = nn.functional.pad(out, (0, 0, 0, hl * ctx.model_size
                                          - cfg.n_heads))
            out = out[:, r * hl:(r + 1) * hl]
        return out


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
def mlp_spec(cfg, d_ff: Optional[int] = None) -> Dict[str, tuple]:
    f, d = d_ff or cfg.d_ff, cfg.d_model
    return {"wg": (d, f), "wu": (d, f), "wd": (f, d)}


def mlp_axes(cfg=None) -> Dict[str, tuple]:
    """The logical axes of :func:`mlp_spec`'s leaves."""
    return {"wg": ("embed", "ff"), "wu": ("embed", "ff"), "wd": ("ff", "embed")}


class MLP(nn.Module):
    def __init__(self, cfg, *, dtype: torch.dtype, device: torch.device,
                 d_ff: Optional[int] = None):
        super().__init__()
        for name, shape in mlp_spec(cfg, d_ff).items():
            setattr(self, name, _param(shape, dtype, device))

    def forward(self, x: torch.Tensor, ctx=None) -> torch.Tensor:
        """With a mesh in ``ctx``: ``wg``/``wu`` column-parallel over
        ``ff``, ``wd`` row-parallel, the partial sums added over the model
        axis."""
        if not sharded(ctx):
            return (nn.functional.silu(x @ self.wg) * (x @ self.wu)) @ self.wd
        g = ctx.group(ctx.model_axis)
        x = C.copy_to(x, g)
        out = (nn.functional.silu(x @ self.wg) * (x @ self.wu)) @ self.wd
        return C.reduce_from(out, g)


# ---------------------------------------------------------------------------
# MoE (top-k routing, per-expert static capacity or dropless; single-device
# path)
# ---------------------------------------------------------------------------
def _shared_width(cfg) -> int:
    return cfg.d_shared or cfg.d_ff or cfg.d_expert


def moe_spec(cfg) -> Dict[str, tuple]:
    """Parameter shapes of one MoE FFN: the router, every expert's SwiGLU
    stacked on a leading expert axis, with sigmoid routing the experts'
    selection bias (float32) and, with ``cfg.shared_expert``, one shared
    MLP of width ``d_shared or d_ff or d_expert``."""
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_expert
    s = {"router": (d, e), "wg": (e, d, fe), "wu": (e, d, fe),
         "wd": (e, fe, d)}
    if cfg.router_score == "sigmoid":
        s["expert_bias"] = (e,)
    if cfg.shared_expert:
        s["shared"] = mlp_spec(cfg, _shared_width(cfg))
    return s


def moe_axes(cfg) -> Dict[str, tuple]:
    """The logical axes of :func:`moe_spec`'s leaves."""
    s = {"router": ("embed", None), "wg": ("experts", "embed", None),
         "wu": ("experts", "embed", None), "wd": ("experts", None, "embed")}
    if cfg.router_score == "sigmoid":
        s["expert_bias"] = (None,)
    if cfg.shared_expert:
        s["shared"] = mlp_axes(cfg)
    return s


def moe_capacity(tokens: int, cfg) -> int:
    """Tokens each expert keeps of ``tokens``: the reference's
    ``_moe_capacity``, ``max(1, int(T * top_k * capacity_factor / E))``, and
    never more than ``tokens``; all of them when ``capacity_factor`` is 0
    (dropless)."""
    if cfg.capacity_factor <= 0:
        return tokens
    cap = max(1, int(tokens * cfg.top_k * cfg.capacity_factor
                     / cfg.n_experts))
    return min(cap, tokens)


def moe_route(x_flat: torch.Tensor, router: torch.Tensor, top_k: int):
    """The router: ``x @ router`` in the model's dtype, cast to float32,
    softmax over the experts, the ``top_k`` largest (among equal
    probabilities the lower expert id first, as ``lax.top_k`` keeps them),
    renormalised with a ``1e-9`` floor.  Returns float32 weights and int64
    expert ids, both ``(T, top_k)``, in descending weight."""
    probs = torch.softmax((x_flat @ router).float(), dim=-1)
    wts, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    wts, ids = wts[:, :top_k], ids[:, :top_k]
    return wts / wts.sum(-1, keepdim=True).clamp_min(1e-9), ids


def moe_route_sigmoid(x_flat: torch.Tensor, router: torch.Tensor,
                      bias: torch.Tensor, top_k: int, scale: float):
    """The sigmoid router (AfMoE, DeepSeek-V3 style): ``s = sigmoid(x @
    router)`` in float32; the ``top_k`` experts of ``s + bias`` (the bias
    decides the selection only); weights ``scale * s / sum(s)`` over the
    selected, from the unbiased scores.  Returns float32 weights and int64 expert ids, both
    ``(T, top_k)``, in descending ``s + bias``."""
    s = torch.sigmoid(x_flat.float() @ router.float())
    ids = torch.topk(s + bias, top_k, dim=-1).indices
    wts = s.gather(1, ids)
    return wts * (scale / wts.sum(-1, keepdim=True)), ids


def _swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            wd: torch.Tensor) -> torch.Tensor:
    """Batched expert SwiGLU ``(silu(x wg) * (x wu)) wd`` over a leading
    expert axis, cast to float32 (the reference's ``ye``)."""
    h = nn.functional.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)
    return torch.bmm(h, wd).float()


def _grouped_swiglu(x: torch.Tensor, ends: torch.Tensor, wg: torch.Tensor,
                    wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU over its contiguous rows of ``x`` ``(P, D)``
    (expert ``e`` owns rows ``[ends[e - 1], ends[e])``), as grouped products
    whose group offsets stay on the device, in ``x``'s dtype: the
    arithmetic of :func:`_swiglu` on each expert's rows, before its cast."""
    offs = ends.to(torch.int32)
    h = (nn.functional.silu(torch._grouped_mm(x, wg, offs=offs))
         * torch._grouped_mm(x, wu, offs=offs))
    return torch._grouped_mm(h, wd, offs=offs)


def _begin(sp, name: str) -> int:
    """Open an MoE span under the open call's spans (unmirrored: the
    profiler names the kernels already); 0 when spans are off."""
    return sp.begin(name, mirror=False) if sp is not None else 0


def _end(sp, sid: int) -> None:
    if sp is not None:
        sp.end(sid)


def moe_loop_ref(x_flat: torch.Tensor, wts: torch.Tensor, ids: torch.Tensor,
                 wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                 capacity: int) -> torch.Tensor:
    """The reference's ``_moe_compute`` over every expert, literally: for
    each expert in turn, its ``capacity`` slots are the first assigned
    tokens in token order, padded with the first unassigned ones (which
    add nothing); each kept token's output times its routing weight is
    added into a float32 ``(T, D)`` sum, expert by expert in ascending id.
    Every expert's weights are read.  The plain version of :class:`MoE`'s
    combine, for the tests and the card check; no model path calls it."""
    T, D = x_flat.shape
    capacity = min(capacity, T)
    y = torch.zeros((T, D), dtype=torch.float32, device=x_flat.device)
    for e in range(wg.shape[0]):
        weight = torch.where(ids == e, wts, torch.zeros_like(wts)).sum(dim=1)
        assigned = weight > 0
        # lax.top_k of the 0/1 score: assigned tokens first, lowest index
        # first among equals
        slots = torch.argsort((~assigned).to(torch.int8), stable=True)
        slots = slots[:capacity]
        valid = assigned[slots]
        xe = x_flat[slots]
        h = nn.functional.silu(xe @ wg[e]) * (xe @ wu[e])
        ye = (h @ wd[e]).float() * (weight[slots] * valid)[:, None]
        y.index_add_(0, slots, torch.where(valid[:, None], ye,
                                           torch.zeros_like(ye)))
    return y


class MoE(nn.Module):
    """Top-k MoE FFN (the reference's ``layers.moe`` without a sharding
    context): ``router`` (and, with sigmoid routing, ``expert_bias``), the
    experts' ``wg``/``wu`` ``(E, D, Fe)`` and ``wd`` ``(E, Fe, D)`` and,
    with ``cfg.shared_expert``, a ``shared`` :class:`MLP` added last.

    With a capacity (``cfg.capacity_factor > 0``) it computes the
    reference's function: each expert keeps the first ``moe_capacity(T)``
    tokens routed to it, in token order, and drops the rest; each kept
    token's expert output, cast to float32 and scaled by its routing
    weight, is summed into a float32 ``y`` in ascending expert id, then
    cast to the model's dtype.  Dropless (``capacity_factor`` 0) every
    routed pair is computed and summed the same way.  Unlike the
    reference's loop over every expert (:func:`moe_loop_ref`), it runs
    batched products over the experts the tokens use, and reads no value
    back to the host:

    * when ``T * top_k >= E`` (a prompt) with a capacity, every expert's
      capacity slots are filled from a cumulative count over token order
      and the three products run as ``torch.bmm`` over the ``(E, C, D)``
      slots, as the reference computes them;
    * when ``T * top_k >= E`` dropless, the pairs are sorted by expert and
      the products run as grouped products over each expert's contiguous
      rows, the group offsets kept on the device;
    * when fewer (a decode step), the products run per routed
      ``(token, expert)`` pair on that expert's weights, gathered, so only
      the ``T * top_k`` routed experts are read, not all ``E``.

    Each token then adds its up to ``top_k`` contributions one by one, in
    ascending expert id: no atomics, the same bits on every run.

    Under traced spans the call opens the device spans
    ``repro.moe.route``, ``.dispatch``, ``.experts``, ``.combine`` and
    ``.shared`` and counts ``repro.moe.assignments`` (pairs computed),
    ``.max_load`` (the largest expert's pairs) and ``.dropped`` (pairs
    routed and not computed); untraced it counts nothing."""

    def __init__(self, cfg, *, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.cfg = cfg
        for name, shape in moe_spec(cfg).items():
            if name == "expert_bias":
                # a float32 buffer of the checkpoint, added to the float32
                # scores to decide the selection only
                self.expert_bias = _param(shape, torch.float32, device)
            elif name != "shared":
                setattr(self, name, _param(shape, dtype, device))
        if cfg.shared_expert:
            self.shared = MLP(cfg, dtype=dtype, device=device,
                              d_ff=_shared_width(cfg))

    def route(self, x_flat: torch.Tensor):
        """``(wts, ids)`` of the configuration's router."""
        cfg = self.cfg
        if cfg.router_score == "sigmoid":
            return moe_route_sigmoid(x_flat, self.router, self.expert_bias,
                                     cfg.top_k, cfg.route_scale)
        return moe_route(x_flat, self.router, cfg.top_k)

    def forward(self, x: torch.Tensor, ctx=None) -> torch.Tensor:
        cfg = self.cfg
        B, S, D = x.shape
        T, E = B * S, cfg.n_experts
        x_flat = x.reshape(T, D)
        sp = spans.current()
        sid = _begin(sp, "repro.moe.route")
        wts, ids = self.route(x_flat)
        _end(sp, sid)
        if not sharded(ctx):
            y = self.combine(x_flat, wts, ids, moe_capacity(T, cfg), sp)
        elif cfg.capacity_factor <= 0:
            raise NotImplementedError("a dropless MoE runs on one device")
        elif ctx.moe_gather_tokens:
            y = self._gather_tokens(x_flat, wts, ids, ctx)
        else:
            y = self._expert_parallel(x_flat, wts, ids, ctx)
        y = y.to(x.dtype).view(B, S, D)
        if cfg.shared_expert:
            sid = _begin(sp, "repro.moe.shared")
            y = y + self.shared(x, ctx)
            _end(sp, sid)
        return y

    def _expert_parallel(self, x_flat, wts, ids, ctx):
        """EP over the model axis (the reference's psum branch): this
        rank's experts ``[r E_l, (r + 1) E_l)`` take their capacity of its
        own tokens (``moe_capacity`` of the local count: per shard), and
        the float32 partial sums are added over the model axis (in
        bfloat16 with ``ctx.moe_wire_bf16``)."""
        g = ctx.group(ctx.model_axis)
        n_local = self.wg.shape[0]
        e0 = ctx.index(ctx.model_axis) * n_local
        x_flat, wts = C.copy_to(x_flat, g), C.copy_to(wts, g)
        mine = (ids >= e0) & (ids < e0 + n_local)
        wts = torch.where(mine, wts, torch.zeros_like(wts))
        ids = torch.where(mine, ids - e0, torch.zeros_like(ids))
        y = self.combine(x_flat, wts, ids,
                         moe_capacity(x_flat.shape[0], self.cfg))
        if ctx.moe_wire_bf16:
            return C.reduce_from(y.to(torch.bfloat16), g).float()
        return C.reduce_from(y, g)

    def _gather_tokens(self, x_flat, wts, ids, ctx):
        """The reference's ``moe_gather_tokens`` branch: the expert weights
        stay sharded (experts on the model axis, d_model on the batch
        axes) and are never gathered; the tokens are gathered over the
        batch axes instead, each expert's first two products contract
        over this rank's d_model columns and are summed over the batch
        axes, the third writes this rank's output columns, an all-to-all
        over the batch axes brings every rank its own rows back, and the
        experts' outputs are added over the model axis."""
        cfg = self.cfg
        g, bg = ctx.group(ctx.model_axis), ctx.group(ctx.batch_axes)
        n_local = self.wg.shape[0]
        e0 = ctx.index(ctx.model_axis) * n_local
        wg, wu, wd = self.wg, self.wu, self.wd
        D = x_flat.shape[1]
        dloc = D // ctx.dp_size
        didx = ctx.index(ctx.batch_axes)
        if wg.shape[1] == D:
            # FSDP off: the weights are whole over the batch axes; each
            # rank takes its d_model columns
            wg = wg.narrow(1, didx * dloc, dloc)
            wu = wu.narrow(1, didx * dloc, dloc)
            wd = wd.narrow(2, didx * dloc, dloc)
        x_flat, wts = C.copy_to(x_flat, g), C.copy_to(wts, g)
        xg = C.all_gather(x_flat, 0, bg)
        wtg = C.all_gather(wts, 0, bg)
        with torch.no_grad():
            idg = C.all_gather(ids, 0, bg)
        Tg = xg.shape[0]
        cap = moe_capacity(Tg, cfg)
        y = xg.new_zeros((Tg, dloc), dtype=torch.float32)
        xpart = xg.narrow(1, didx * dloc, dloc)
        for le in range(n_local):
            weight = torch.where(idg == e0 + le, wtg,
                                 torch.zeros_like(wtg)).sum(dim=1)
            assigned = weight > 0
            slots = torch.argsort((~assigned).to(torch.int8), stable=True)
            slots = slots[:cap]
            valid = assigned[slots]
            xe = xpart[slots]
            part = lambda w: C.copy_to(C.reduce_from(   # noqa: E731
                (xe @ w).float(), bg), bg)
            h = nn.functional.silu(part(wg[le])) * part(wu[le])
            ye = (h.to(xg.dtype) @ wd[le]).float()
            ye = ye * (weight[slots] * valid)[:, None]
            y = y.index_add(0, slots, torch.where(valid[:, None], ye,
                                                  torch.zeros_like(ye)))
        wire = y.to(torch.bfloat16) if ctx.moe_wire_bf16 else y
        yl = C.all_to_all(wire, 0, 1, bg)
        return C.reduce_from(yl, g).float()

    def combine(self, x_flat: torch.Tensor, wts: torch.Tensor,
                ids: torch.Tensor, capacity: int, sp=None) -> torch.Tensor:
        """The float32 ``(T, D)`` sum of :func:`moe_loop_ref` for routing
        ``(wts, ids)``: per routed pair when ``T * top_k < E`` (a decode
        step), else (a prompt) over every expert's capacity slots, or
        dropless over every expert's grouped rows.  ``sp``: the open
        call's spans, or None."""
        T, k = ids.shape
        if T * k < self.wg.shape[0]:
            return self._combine_pairs(x_flat, wts, ids, capacity, sp)
        if self.cfg.capacity_factor <= 0:
            return self._combine_grouped(x_flat, wts, ids, sp)
        return self._combine_slots(x_flat, wts, ids, capacity, sp)

    def _combine_slots(self, x_flat: torch.Tensor, wts: torch.Tensor,
                       ids: torch.Tensor, capacity: int,
                       sp=None) -> torch.Tensor:
        """:meth:`combine` over the ``(E, C, D)`` capacity slots, every
        expert's products as one ``torch.bmm``."""
        T, D = x_flat.shape
        k, E = ids.shape[1], self.wg.shape[0]
        sid = _begin(sp, "repro.moe.dispatch")
        wts, ids, rank, kept = _rank_pairs(wts, ids, E, capacity)
        # slot e * C + rank of the expert's buffer; dropped pairs write the
        # spare row E * C, which no product reads
        slot = torch.where(kept, ids * capacity + rank,
                           torch.full_like(ids, E * capacity))
        buf = x_flat.new_zeros((E * capacity + 1, D))
        buf[slot.reshape(-1)] = x_flat.repeat_interleave(k, dim=0)
        _end(sp, sid)
        sid = _begin(sp, "repro.moe.experts")
        ye = _swiglu(buf[:-1].view(E, capacity, D), self.wg, self.wu,
                     self.wd).view(E * capacity, D)
        _end(sp, sid)
        sid = _begin(sp, "repro.moe.combine")
        y = _sum_kept(ye[slot.clamp_max(E * capacity - 1)], wts, kept)
        _end(sp, sid)
        self._tally(sp, wts, rank, kept)
        return y

    def _combine_pairs(self, x_flat: torch.Tensor, wts: torch.Tensor,
                       ids: torch.Tensor, capacity: int,
                       sp=None) -> torch.Tensor:
        """:meth:`combine` per routed ``(token, expert)`` pair on that
        expert's gathered weights: only the ``T * top_k`` routed experts
        are read, not all ``E``."""
        T, D = x_flat.shape
        k, E = ids.shape[1], self.wg.shape[0]
        sid = _begin(sp, "repro.moe.dispatch")
        wts, ids, rank, kept = _rank_pairs(wts, ids, E, capacity)
        flat = ids.reshape(-1)
        xe = x_flat.repeat_interleave(k, dim=0)[:, None]          # (T k, 1, D)
        _end(sp, sid)
        sid = _begin(sp, "repro.moe.experts")
        ye = _swiglu(xe, self.wg.index_select(0, flat),
                     self.wu.index_select(0, flat),
                     self.wd.index_select(0, flat)).view(T, k, D)
        _end(sp, sid)
        sid = _begin(sp, "repro.moe.combine")
        y = _sum_kept(ye, wts, kept)
        _end(sp, sid)
        self._tally(sp, wts, rank, kept)
        return y

    def _combine_grouped(self, x_flat: torch.Tensor, wts: torch.Tensor,
                         ids: torch.Tensor, sp=None) -> torch.Tensor:
        """:meth:`combine` dropless: the ``T * top_k`` pairs sorted by
        expert (token order within an expert), their rows gathered, each
        expert's products over its contiguous rows (:func:`_grouped_swiglu`,
        the group ends found on the device), the outputs put back as
        ``(top_k, T, D)`` and summed as :func:`_sum_kept` sums them (each
        output cast to float32 and times its weight, added one by one in
        ascending expert id), a pass over the sum a pair."""
        T, D = x_flat.shape
        k, E = ids.shape[1], self.wg.shape[0]
        sid = _begin(sp, "repro.moe.dispatch")
        # each token's pairs in ascending expert id: the order of the sum
        ids, order = torch.sort(ids, dim=-1)
        wts = wts.gather(1, order)
        by_expert, pairs = torch.sort(ids.reshape(-1), stable=True)
        ends = torch.searchsorted(by_expert, torch.arange(
            1, E + 1, device=ids.device, dtype=by_expert.dtype))
        xs = x_flat.index_select(0, pairs // k)
        _end(sp, sid)
        sid = _begin(sp, "repro.moe.experts")
        ye = _grouped_swiglu(xs, ends, self.wg, self.wu, self.wd)
        _end(sp, sid)
        sid = _begin(sp, "repro.moe.combine")
        back = torch.empty_like(pairs).scatter_(
            0, pairs, torch.arange(T * k, device=pairs.device))
        ye = ye.index_select(0, back.view(T, k).t().reshape(-1)).view(k, T, D)
        y = torch.zeros((T, D), dtype=torch.float32, device=ye.device)
        for j in range(k):
            y.addcmul_(ye[j], wts[:, j, None])
        _end(sp, sid)
        if sp is not None:
            self._count(sp, T * k, ends[-1], torch.diff(
                ends, prepend=ends.new_zeros(1)).max())
        return y

    def _tally(self, sp, wts: torch.Tensor, rank: torch.Tensor,
               kept: torch.Tensor) -> None:
        """:meth:`_count` of a capacity schedule's pairs (ranked by
        :func:`_rank_pairs`), under spans only."""
        if sp is None:
            return
        assigned = wts > 0
        self._count(sp, assigned.sum(), kept.sum(), torch.where(
            assigned, rank + 1, torch.zeros_like(rank)).max())

    @staticmethod
    def _count(sp, routed, computed: torch.Tensor,
               max_load: torch.Tensor) -> None:
        """The call's deferred counters (read when the spans are):
        ``repro.moe.assignments``, ``.max_load`` and ``.dropped``."""
        sp.count_later("repro.moe.assignments", computed)
        sp.count_later("repro.moe.max_load", max_load)
        sp.count_later("repro.moe.dropped", routed - computed)


def _rank_pairs(wts: torch.Tensor, ids: torch.Tensor, n_experts: int,
                capacity: int):
    """Each token's routed pairs in ascending expert id (the order of the
    sum), with each pair's rank among its expert's assigned tokens in token
    order (an exclusive cumulative count) and whether it is kept (assigned
    and ranked below ``capacity``).  Returns (wts, ids, rank, kept), each
    ``(T, top_k)``."""
    ids, order = torch.sort(ids, dim=-1)
    wts = wts.gather(1, order)
    assigned = wts > 0
    hits = torch.zeros((ids.shape[0], n_experts), dtype=torch.int32,
                       device=ids.device)
    # an add, not a write: EP's pairs of other ranks' experts share a
    # column with a local pair and must add nothing to it
    hits.scatter_add_(1, ids, assigned.to(torch.int32))
    rank = (torch.cumsum(hits, dim=0) - hits).gather(1, ids)
    return wts, ids, rank, assigned & (rank < capacity)


def _sum_kept(ye: torch.Tensor, wts: torch.Tensor,
              kept: torch.Tensor) -> torch.Tensor:
    """The float32 ``(T, D)`` sum over each token's kept ``(T, top_k, D)``
    expert outputs times their weights, one by one in the pairs' order: no
    atomics, the same bits on every run."""
    contrib = torch.where(kept[..., None], ye * wts[..., None],
                          torch.zeros((), device=ye.device))
    T, k, D = contrib.shape
    y = torch.zeros((T, D), dtype=torch.float32, device=ye.device)
    for j in range(k):
        y = y + contrib[:, j]
    return y


class Block(nn.Module):
    """One decoder layer (the reference's block of the ``dense``, ``moe``,
    ``encdec`` and ``vlm`` families, and the encoder's layer):
    ``x + attn(ln1(x))``; then, where ``memory`` is given,
    ``x + xattn(lnx(x), memory)`` (``vlm``: times ``tanh(xgate)``); then
    ``x + ffn(ln2(x))`` with ``ffn`` the ``mlp`` or, for ``moe``, the
    :class:`MoE`.  ``cross`` registers ``lnx`` and ``xattn`` (and, when
    ``gated``, ``xgate``).  With ``cfg.sandwich_norm`` each sublayer's
    output is normed before its residual add: ``x + ln1_post(attn(...))``
    and ``x + ln2_post(ffn(...))``."""

    def __init__(self, cfg, *, dtype: torch.dtype, device: torch.device,
                 moe: bool = False, cross: bool = False, gated: bool = False):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        if cfg.sandwich_norm:
            self.ln1_post = _param((cfg.d_model,), dtype, device)
            self.ln2_post = _param((cfg.d_model,), dtype, device)
        if moe:
            self.moe = MoE(cfg, dtype=dtype, device=device)
        else:
            self.mlp = MLP(cfg, dtype=dtype, device=device)
        if cross:
            self.lnx = _param((cfg.d_model,), dtype, device)
            self.xattn = Attention(cfg, dtype=dtype, device=device)
            if gated:
                self.xgate = _param((1,), dtype, device)

    def forward(self, x: torch.Tensor, *, window: int, rope_cs,
                cache=None, cache_index: Optional[int] = None,
                causal: bool = True, memory: Optional[torch.Tensor] = None,
                ctx=None):
        eps = self.cfg.norm_eps
        out, kv = self.attn(rmsnorm(x, self.ln1, eps), window=window,
                            rope_cs=rope_cs, cache=cache,
                            cache_index=cache_index, causal=causal, ctx=ctx)
        if self.cfg.sandwich_norm:
            out = rmsnorm(out, self.ln1_post, eps)
        x = x + out
        if memory is not None:
            out, _ = self.xattn(rmsnorm(x, self.lnx, eps), memory=memory,
                                ctx=ctx)
            if hasattr(self, "xgate"):
                out = torch.tanh(self.xgate) * out
            x = x + out
        h = rmsnorm(x, self.ln2, eps)
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        out = ffn(h) if ctx is None else ffn(h, ctx)
        if self.cfg.sandwich_norm:
            out = rmsnorm(out, self.ln2_post, eps)
        return x + out, kv
