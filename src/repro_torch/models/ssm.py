"""Mamba2 (SSD, state-space duality) block: chunked for prefill, recurrent
for decode.

The port of the reference's ``repro/models/ssm.py``.  The layout is the
reference's: x ``(B, T, D)`` goes through separate in-projections

* z  ``(B, T, di)``  the gate branch (``di = expand * D``);
* xs ``(B, T, di)``  causal conv, then the SSD input (``H = di / P`` heads);
* B, C ``(B, T, N)`` the state's input and output projections (one group);
* dt ``(B, T, H)``   the per-head step size,

and :class:`SSM` keeps the reference's parameter names (``wz wx wb wc wdt
dt_bias a_log d_skip conv_x conv_b conv_c norm wo``), so ``blocks.3.ssm.wx``
is the reference's ``blocks/ssm/wx[3]``.

Prefill, scoring and training run the scan through the port's
hand-written SSD chunk-scan kernel
(:func:`~repro_torch.kernels.ssd_scan.ssd_scan`), where the reference's
``ssd_chunked`` computes it in ``jnp`` and names the Pallas kernel as the
TPU fast path; on CPU tensors the kernel's wrapper takes its plain version.
Gradients flow through the scan's autograd Function (a torch-op backward,
as ``jax.grad`` differentiates the reference's jnp scan) and through the
padding, cumulative sum and casts of :func:`ssd_scan_inputs`, the causal
conv and the gating, all plain torch ops.  Decode is the reference's
single-step recurrence in plain torch: no kernel computes it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..kernels.ssd_scan import ssd_scan
from ..sharding import collectives as C
from .layers import _param, rmsnorm, sharded

__all__ = ["SSM", "SSM_AXES", "ssd_chunked", "ssd_scan_inputs", "ssm_spec",
           "ssm_state_spec"]

#: the logical axes of :func:`ssm_spec`'s leaves (the reference's): the
#: inner width and its heads shard on the model axis; B and C are shared
SSM_AXES = {
    "wz": ("embed", "ssm_inner"),
    "wx": ("embed", "ssm_inner"),
    "wb": ("embed", "state"),
    "wc": ("embed", "state"),
    "wdt": ("embed", "ssm_inner"),
    "dt_bias": ("ssm_inner",),
    "a_log": ("ssm_inner",),
    "d_skip": ("ssm_inner",),
    "conv_x": (None, "ssm_inner"),
    "conv_b": (None, "state"),
    "conv_c": (None, "state"),
    "norm": ("ssm_inner",),
    "wo": ("ssm_inner", "embed"),
}


def ssm_spec(cfg) -> Dict[str, tuple]:
    """Parameter shapes of one SSM block, by name."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.conv_width
    return {
        "wz": (d, di),
        "wx": (d, di),
        "wb": (d, n),
        "wc": (d, n),
        "wdt": (d, h),
        "dt_bias": (h,),
        "a_log": (h,),
        "d_skip": (h,),
        "conv_x": (w, di),
        "conv_b": (w, n),
        "conv_c": (w, n),
        "norm": (di,),
        "wo": (di, d),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of x ``(B, T, C)`` by w ``(W, C)``.  Returns
    ``(y, new_state)``, the new state being the last ``W - 1`` inputs (a
    new tensor, for decode to continue from); ``state`` is the previous
    one, zeros when ``None``."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                 # (B, T + W - 1, C)
    T = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(W):
        y = y + xp[:, i:i + T] * w[i]
    new_state = xp[:, -(W - 1):] if W > 1 else state
    return y, new_state


def ssd_scan_inputs(xs: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int):
    """The SSD kernel's inputs for xs ``(B, T, H, P)``, step sizes dt
    ``(B, T, H)``, decay rates a ``(H,)`` (negative) and Bm/Cm ``(B, T,
    N)``: ``(xdt (B, nc, L, H, P), cs (B, nc, L, H), Bm, Cm (B, nc, L,
    N))``, float32 and contiguous.

    As the reference's ``ssd_chunked``: chunks of ``L = min(chunk, T)``
    steps, T zero-padded up to a multiple of L (a padded step has ``dt =
    0``, so it neither decays nor feeds the state: the final state is
    exact), per-step log-decay ``la = dt * a``, its cumulative sum ``cs``
    within each chunk and ``xdt = xs * dt``."""
    Bsz, T, H, P = xs.shape
    N = Bm.shape[-1]
    L = min(chunk, T)
    nc = -(-T // L)
    pad = nc * L - T
    f = torch.float32
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    dt = dt.reshape(Bsz, nc, L, H).to(f)
    cs = torch.cumsum(dt * a, dim=2)
    xdt = xs.reshape(Bsz, nc, L, H, P).to(f) * dt[..., None]
    return (xdt.contiguous(), cs.contiguous(),
            Bm.reshape(Bsz, nc, L, N).to(f).contiguous(),
            Cm.reshape(Bsz, nc, L, N).to(f).contiguous())


def ssd_chunked(xs: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int):
    """The SSD scan of xs ``(B, T, H, P)`` with step sizes dt ``(B, T, H)``,
    decay rates a ``(H,)`` (negative) and Bm/Cm ``(B, T, N)``; returns
    ``(y (B, T, H, P), final_state (B, H, N, P))``, both float32.

    The inputs are laid out by :func:`ssd_scan_inputs` and the chunk scan
    is :func:`~repro_torch.kernels.ssd_scan.ssd_scan`, called in float32
    (as the reference computes it) so that y is not rounded before the
    caller adds its skip term; the padding is trimmed off y."""
    Bsz, T, H, P = xs.shape
    y, final = ssd_scan(*ssd_scan_inputs(xs, dt, a, Bm, Cm, chunk=chunk))
    return y.reshape(Bsz, -1, H, P)[:, :T], final


class SSM(nn.Module):
    """One Mamba2 block (the reference's ``ssm_block``)."""

    def __init__(self, cfg, *, dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.cfg = cfg
        for name, shape in ssm_spec(cfg).items():
            setattr(self, name, _param(shape, dtype, device))

    def forward(self, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None, ctx=None):
        """* prefill (``state is None``): returns ``(out, new_state)``, the
          state after the last position;
        * decode (``state={"ssm", "conv_x", "conv_b", "conv_c"}`` of one
          layer, x ``(B, 1, D)``): one step of the recurrence; returns
          ``(out, new_state)`` in new tensors (the caller decides where
          they go).

        ``new_state["ssm"]`` is float32 ``(B, H, N, P)``; the conv states
        are in x's dtype.

        With a mesh in ``ctx`` the block runs this rank's heads: ``wz``,
        ``wx``, ``wdt`` and the per-head leaves are its shards of the inner
        width, ``wo`` is row-parallel (its partial sums added over the
        model axis), B and C are computed whole on every rank, and the
        gated norm over the sharded inner width adds its sum of squares
        over the model axis; the state is this rank's heads'."""
        cfg = self.cfg
        B, T, _ = x.shape
        P = cfg.ssm_head_dim
        H = self.wdt.shape[1]
        f = torch.float32
        g = ctx.group(ctx.model_axis) if sharded(ctx) else None
        xin = C.copy_to(x, g)
        z = xin @ self.wz
        xs = xin @ self.wx
        bm = x @ self.wb
        cm = x @ self.wc
        dt = F.softplus((xin @ self.wdt).to(f) + self.dt_bias.to(f))
        a = -torch.exp(self.a_log.to(f))

        st = state or {}
        xs, ns_x = _causal_conv(xs, self.conv_x, st.get("conv_x"))
        bm, ns_b = _causal_conv(bm, self.conv_b, st.get("conv_b"))
        cm, ns_c = _causal_conv(cm, self.conv_c, st.get("conv_c"))
        xs, bm, cm = F.silu(xs), F.silu(bm), F.silu(cm)
        # shared B and C feed this rank's heads only
        bm, cm = C.copy_to(bm, g), C.copy_to(cm, g)
        xs_h = xs.reshape(B, T, H, P)

        if state is None:
            y, s = ssd_chunked(xs_h, dt, a, bm, cm, chunk=cfg.ssm_chunk)
        else:
            if T != 1:
                raise NotImplementedError(
                    "a decode step takes one token per sequence")
            s = state["ssm"].to(f)                             # (B, H, N, P)
            dt1 = dt[:, 0]                                     # (B, H)
            dec = torch.exp(dt1 * a)
            upd = torch.einsum("bn,bh,bhp->bhnp", bm[:, 0].to(f), dt1,
                               xs_h[:, 0].to(f))
            s = s * dec[:, :, None, None] + upd
            y = torch.einsum("bn,bhnp->bhp", cm[:, 0].to(f), s)[:, None]
        new_state = {"ssm": s, "conv_x": ns_x, "conv_b": ns_b,
                     "conv_c": ns_c}

        y = y + xs_h.to(f) * self.d_skip.to(f)[:, None]
        y = y.reshape(B, T, H * P)
        if not sharded(ctx):
            y = rmsnorm(y.to(x.dtype), self.norm, cfg.norm_eps) * F.silu(z)
            return y @ self.wo, new_state
        y = y.to(x.dtype).float()
        ssq = (y * y).sum(dim=-1, keepdim=True)
        ssq = C.copy_to(C.reduce_from(ssq, g), g)
        y = y * torch.rsqrt(ssq / cfg.d_inner + cfg.norm_eps)
        y = (y * self.norm.float()).to(x.dtype) * F.silu(z)
        return C.reduce_from(y @ self.wo, g), new_state


def ssm_state_spec(cfg, batch: int,
                   dtype: torch.dtype) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """``{name: (shape, dtype)}`` of one layer's decode state: the SSD
    state in float32 and the conv states (the last ``W - 1`` inputs) in the
    model's dtype."""
    H, P, N, W = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.conv_width
    di = cfg.d_inner
    return {
        "ssm": ((batch, H, N, P), torch.float32),
        "conv_x": ((batch, W - 1, di), dtype),
        "conv_b": ((batch, W - 1, N), dtype),
        "conv_c": ((batch, W - 1, N), dtype),
    }
