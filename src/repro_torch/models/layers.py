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

__all__ = ["Attention", "Block", "MLP", "MoE", "attn_spec", "materialize_",
           "mlp_spec", "moe_capacity", "moe_loop_ref", "moe_route",
           "moe_spec", "rmsnorm", "rope", "rope_tables"]


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
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32, device=dev))
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
    return s


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
                memory: Optional[torch.Tensor] = None, causal: bool = True):
        """* prefill (``cache is None``): returns ``(out, {"k", "v"})`` with
          the full rotated K/V ``(B, S, KV, hd)`` for the cache; ``causal=
          False`` is the encoder's full self-attention;
        * decode (``cache={"k", "v"}`` views ``(B, S_max, KV, hd)`` of one
          layer, ``cache_index`` the host-side fill): writes this step's K/V
          at ``cache_index`` *in place* and returns ``(out, cache)``;
        * cross-attention (``memory`` ``(B, M, D)``): K/V are projected from
          ``memory`` at every call, with no rope, no mask and no cache;
          returns ``(out, None)``.

        ``rope_cs`` is the step's ``(cos, sin)`` from :func:`rope_tables`."""
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

        q = rope(q, rope_cs)
        k = rope(k, rope_cs)

        if cache is None:
            # the kernel reads (B, heads, S, hd) views of the projections
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window)
            out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * hd)
            return out @ self.wo, {"k": k, "v": v}

        if S != 1:
            raise NotImplementedError(
                "a decode step takes one token per sequence")
        ck, cv = cache["k"], cache["v"]
        ck[:, cache_index] = k[:, 0]
        cv[:, cache_index] = v[:, 0]
        out = decode_attention(q[:, 0], ck, cv, cache_index + 1,
                               window=window)
        return out.reshape(B, 1, cfg.n_heads * hd) @ self.wo, cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
def mlp_spec(cfg, d_ff: Optional[int] = None) -> Dict[str, tuple]:
    f, d = d_ff or cfg.d_ff, cfg.d_model
    return {"wg": (d, f), "wu": (d, f), "wd": (f, d)}


class MLP(nn.Module):
    def __init__(self, cfg, *, dtype: torch.dtype, device: torch.device,
                 d_ff: Optional[int] = None):
        super().__init__()
        for name, shape in mlp_spec(cfg, d_ff).items():
            setattr(self, name, _param(shape, dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (nn.functional.silu(x @ self.wg) * (x @ self.wu)) @ self.wd


# ---------------------------------------------------------------------------
# MoE (top-k routing, per-expert static capacity; single-device path)
# ---------------------------------------------------------------------------
def moe_spec(cfg) -> Dict[str, tuple]:
    """Parameter shapes of one MoE FFN: the router, every expert's SwiGLU
    stacked on a leading expert axis and, with ``cfg.shared_expert``, one
    shared MLP of width ``d_ff or d_expert``."""
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_expert
    s = {"router": (d, e), "wg": (e, d, fe), "wu": (e, d, fe),
         "wd": (e, fe, d)}
    if cfg.shared_expert:
        s["shared"] = mlp_spec(cfg, cfg.d_ff or cfg.d_expert)
    return s


def moe_capacity(tokens: int, cfg) -> int:
    """Tokens each expert keeps of ``tokens``: the reference's
    ``_moe_capacity``, ``max(1, int(T * top_k * capacity_factor / E))``, and
    never more than ``tokens``."""
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


def _swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            wd: torch.Tensor) -> torch.Tensor:
    """Batched expert SwiGLU ``(silu(x wg) * (x wu)) wd`` over a leading
    expert axis, cast to float32 (the reference's ``ye``)."""
    h = nn.functional.silu(torch.bmm(x, wg)) * torch.bmm(x, wu)
    return torch.bmm(h, wd).float()


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
    context): ``router``, the experts' ``wg``/``wu`` ``(E, D, Fe)`` and
    ``wd`` ``(E, Fe, D)`` and, with ``cfg.shared_expert``, a ``shared``
    :class:`MLP` added last.

    It computes the reference's function: each expert keeps the first
    ``moe_capacity(T)`` tokens routed to it, in token order, and drops the
    rest; each kept token's expert output, cast to float32 and scaled by
    its routing weight, is summed into a float32 ``y`` in ascending expert
    id, then cast to the model's dtype.  Unlike the reference's loop over
    every expert (:func:`moe_loop_ref`), it runs batched products over the
    experts the tokens use, with shapes fixed by ``T`` alone (no value is
    read back to the host):

    * when ``T * top_k >= E`` (a prompt), every expert's capacity slots are
      filled from a cumulative count over token order and the three
      products run as ``torch.bmm`` over the ``(E, C, D)`` slots, as the
      reference computes them;
    * when fewer (a decode step), the products run per routed
      ``(token, expert)`` pair on that expert's weights, gathered, so only
      the ``T * top_k`` routed experts are read, not all ``E``.

    Each token then adds its up to ``top_k`` contributions one by one, in
    ascending expert id: no atomics, the same bits on every run."""

    def __init__(self, cfg, *, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.cfg = cfg
        for name, shape in moe_spec(cfg).items():
            if name != "shared":
                setattr(self, name, _param(shape, dtype, device))
        if cfg.shared_expert:
            self.shared = MLP(cfg, dtype=dtype, device=device,
                              d_ff=cfg.d_ff or cfg.d_expert)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, D = x.shape
        T, E = B * S, cfg.n_experts
        x_flat = x.reshape(T, D)
        wts, ids = moe_route(x_flat, self.router, cfg.top_k)
        y = self.combine(x_flat, wts, ids, moe_capacity(T, cfg))
        y = y.to(x.dtype).view(B, S, D)
        if cfg.shared_expert:
            y = y + self.shared(x)
        return y

    def combine(self, x_flat: torch.Tensor, wts: torch.Tensor,
                ids: torch.Tensor, capacity: int) -> torch.Tensor:
        """The float32 ``(T, D)`` sum of :func:`moe_loop_ref` for routing
        ``(wts, ids)``: per routed pair when ``T * top_k < E`` (a decode
        step), else over every expert's capacity slots (a prompt)."""
        T, k = ids.shape
        if T * k < self.wg.shape[0]:
            return self._combine_pairs(x_flat, wts, ids, capacity)
        return self._combine_slots(x_flat, wts, ids, capacity)

    def _combine_slots(self, x_flat: torch.Tensor, wts: torch.Tensor,
                       ids: torch.Tensor, capacity: int) -> torch.Tensor:
        """:meth:`combine` over the ``(E, C, D)`` capacity slots, every
        expert's products as one ``torch.bmm``."""
        T, D = x_flat.shape
        k, E = ids.shape[1], self.wg.shape[0]
        wts, ids, rank, kept = _rank_pairs(wts, ids, E, capacity)
        # slot e * C + rank of the expert's buffer; dropped pairs write the
        # spare row E * C, which no product reads
        slot = torch.where(kept, ids * capacity + rank,
                           torch.full_like(ids, E * capacity))
        buf = x_flat.new_zeros((E * capacity + 1, D))
        buf[slot.reshape(-1)] = x_flat.repeat_interleave(k, dim=0)
        ye = _swiglu(buf[:-1].view(E, capacity, D), self.wg, self.wu,
                     self.wd).view(E * capacity, D)
        return _sum_kept(ye[slot.clamp_max(E * capacity - 1)], wts, kept)

    def _combine_pairs(self, x_flat: torch.Tensor, wts: torch.Tensor,
                       ids: torch.Tensor, capacity: int) -> torch.Tensor:
        """:meth:`combine` per routed ``(token, expert)`` pair on that
        expert's gathered weights: only the ``T * top_k`` routed experts
        are read, not all ``E``."""
        T, D = x_flat.shape
        k, E = ids.shape[1], self.wg.shape[0]
        wts, ids, _, kept = _rank_pairs(wts, ids, E, capacity)
        flat = ids.reshape(-1)
        xe = x_flat.repeat_interleave(k, dim=0)[:, None]          # (T k, 1, D)
        ye = _swiglu(xe, self.wg.index_select(0, flat),
                     self.wu.index_select(0, flat),
                     self.wd.index_select(0, flat)).view(T, k, D)
        return _sum_kept(ye, wts, kept)


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
    hits.scatter_(1, ids, assigned.to(torch.int32))
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
    ``gated``, ``xgate``)."""

    def __init__(self, cfg, *, dtype: torch.dtype, device: torch.device,
                 moe: bool = False, cross: bool = False, gated: bool = False):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
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
                causal: bool = True, memory: Optional[torch.Tensor] = None):
        eps = self.cfg.norm_eps
        out, kv = self.attn(rmsnorm(x, self.ln1, eps), window=window,
                            rope_cs=rope_cs, cache=cache,
                            cache_index=cache_index, causal=causal)
        x = x + out
        if memory is not None:
            out, _ = self.xattn(rmsnorm(x, self.lnx, eps), memory=memory)
            if hasattr(self, "xgate"):
                out = torch.tanh(self.xgate) * out
            x = x + out
        h = rmsnorm(x, self.ln2, eps)
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        return x + ffn(h), kv
