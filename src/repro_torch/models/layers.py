"""Transformer layer primitives of the dense family, as ``nn.Module``\\ s.

The port of the reference's ``repro/models/layers.py`` (dense part):
``rmsnorm``, ``rope``, the attention block (prefill and decode branches),
the SwiGLU MLP and parameter creation.  Modules keep the reference's
parameter names (``wq``, ``wk``, ``wv``, ``wo``, ``gamma_q``, ``gamma_k``,
``wg``, ``wu``, ``wd``), so ``blocks.3.attn.wq`` is the reference's
``blocks/attn/wq[3]``.  Activations are ``(batch, seq, d_model)``.

Attention runs through the port's hand-written kernels where the reference
says "the Pallas flash kernel is the TPU fast path": prefill through
:func:`~repro_torch.kernels.flash_attention.flash_attention` (the
reference's ``_chunked_attn``), decode through
:func:`~repro_torch.kernels.decode_attention.decode_attention` (the
reference's ``decode_attention``).  On CPU tensors both take their plain
versions.  The large products (``x @ wq``, the MLP) stay ``torch.matmul``,
as the reference leaves them to XLA.

Cross-attention (``memory=``) and MoE (``layers.moe``) are not ported yet
(ROADMAP Queue A items 9b and 9a).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention

__all__ = ["Attention", "Block", "MLP", "attn_spec", "materialize_",
           "mlp_spec", "rmsnorm", "rope", "rope_tables"]


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

    One difference: the reference matches scales by the prefixes
    ``norm``/``gamma`` only, so its ``ln1``, ``ln2`` and ``final_norm``
    start at zero, which zeroes every block's input and every logit of a
    fresh model.  Here they start at one (ROADMAP Queue C)."""
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
    """Self-attention with an optional KV cache (the reference's
    ``layers.attention``, dense path)."""

    def __init__(self, cfg, *, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.cfg = cfg
        for name, shape in attn_spec(cfg).items():
            setattr(self, name, _param(shape, dtype, device))

    def forward(self, x: torch.Tensor, *, window: int = 0, rope_cs=None,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: Optional[int] = None,
                memory: Optional[torch.Tensor] = None):
        """* prefill (``cache is None``): returns ``(out, {"k", "v"})`` with
          the full rotated K/V ``(B, S, KV, hd)`` for the cache;
        * decode (``cache={"k", "v"}`` views ``(B, S_max, KV, hd)`` of one
          layer, ``cache_index`` the host-side fill): writes this step's K/V
          at ``cache_index`` *in place* and returns ``(out, cache)``.

        ``rope_cs`` is the step's ``(cos, sin)`` from :func:`rope_tables`."""
        if memory is not None:
            raise NotImplementedError(
                "cross-attention is not ported to repro_torch yet; see "
                "ROADMAP Queue A item 9b (enc-dec and VLM)")
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.head_dim
        q = (x @ self.wq).view(B, S, cfg.n_heads, hd)
        k = (x @ self.wk).view(B, S, cfg.n_kv_heads, hd)
        v = (x @ self.wv).view(B, S, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, self.gamma_q, cfg.norm_eps)
            k = rmsnorm(k, self.gamma_k, cfg.norm_eps)
        q = rope(q, rope_cs)
        k = rope(k, rope_cs)

        if cache is None:
            # the kernel reads (B, heads, S, hd) views of the projections
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True,
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
def mlp_spec(cfg) -> Dict[str, tuple]:
    f, d = cfg.d_ff, cfg.d_model
    return {"wg": (d, f), "wu": (d, f), "wd": (f, d)}


class MLP(nn.Module):
    def __init__(self, cfg, *, dtype: torch.dtype, device: torch.device):
        super().__init__()
        for name, shape in mlp_spec(cfg).items():
            setattr(self, name, _param(shape, dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (nn.functional.silu(x @ self.wg) * (x @ self.wu)) @ self.wd


class Block(nn.Module):
    """One dense decoder layer: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, cfg, *, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        self.mlp = MLP(cfg, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, *, window: int, rope_cs,
                cache=None, cache_index: Optional[int] = None):
        h = rmsnorm(x, self.ln1, self.cfg.norm_eps)
        out, kv = self.attn(h, window=window, rope_cs=rope_cs, cache=cache,
                            cache_index=cache_index)
        x = x + out
        h = rmsnorm(x, self.ln2, self.cfg.norm_eps)
        return x + self.mlp(h), kv
