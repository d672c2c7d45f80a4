"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

The CPU tests run them, ``chip_smoke.py`` holds each kernel against them on
the card, and a kernel's wrapper takes them for tensors that lie on the CPU.
On a CUDA tensor the main path never reaches them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["decode_attention_ref", "flash_attention_ref", "ssd_chunk_ref",
           "ssd_scan_ref", "tile_matmul_ref"]


def tile_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                    c: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
                    beta: float = 1.0, trans_b: bool = False) -> torch.Tensor:
    """``beta * c + alpha * a @ op(b)`` with ``op(b) = b.T`` if ``trans_b``.

    float64 accumulates in float64; every other type in float32, with the
    result cast back to ``a.dtype`` (as the reference package's
    ``tile_matmul_ref`` does).  ``c=None`` drops the C term."""
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    bb = b.mT if trans_b else b
    out = alpha * (a.to(acc) @ bb.to(acc))
    if c is not None:
        out = out + beta * c.to(acc)
    return out.to(a.dtype)


def _masked_softmax_pv(s: torch.Tensor, mask: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """``softmax(s) @ v`` over the unmasked keys, in ``s``'s type.  A row with
    no unmasked key gives zeros (the Pallas kernels' finite ``NEG_INF`` and
    ``max(l, 1e-30)`` divide), not the NaN of a softmax over ``-inf``."""
    s = s.masked_fill(~mask, -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)                       # masked: exp(-inf) = 0
    l = p.sum(dim=-1, keepdim=True)
    return (p @ v.to(s.dtype)) / l.clamp_min(1e-30)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Prefill attention: q ``(B, H, Sq, d)``; k/v ``(B, KV, Sk, d)`` with
    query head ``h`` reading KV head ``h // (H // KV)``; returns
    ``(B, H, Sq, d)`` in q's dtype.  Scores, softmax and the ``p @ v``
    product are float32 (float64 for float64 inputs, which the gradient
    tests differentiate), at scale ``1/sqrt(d)``; ``causal`` keeps keys at
    or before the query, ``window > 0`` keeps keys less than ``window``
    positions behind it.  Query ``i`` and key ``j`` sit at positions ``i``
    and ``j``; the lengths may differ without ``causal`` (the encoder's
    and cross-attention's full attention)."""
    B, H, S, d = q.shape
    Sk = k.shape[2]
    if causal and Sk != S:
        raise ValueError(f"causal attention needs equal lengths, got Sq={S}, "
                         f"Sk={Sk}")
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) / math.sqrt(d)
    qpos = torch.arange(S, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones(S, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    return _masked_softmax_pv(s, mask, v).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: int, *, window: int = 0,
                         return_lse: bool = False):
    """One query token per ``(b, h)`` against a KV cache: q ``(B, H, d)``;
    k/v ``(B, S, KV, d)`` with query head ``h`` reading KV head
    ``h // (H // KV)``; positions ``< length`` are valid and, with
    ``window > 0``, only those ``> length - 1 - window``.  Returns
    ``(B, H, d)`` in v's dtype; ``length = 0`` gives zeros.  With
    ``return_lse``, also each row's float32 log-sum-exp of its scaled
    scores over the valid keys, ``(B, H)``, -inf where there is none."""
    B, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qh = q.float().reshape(B, KV, rep, d)
    s = torch.einsum("bgrd,bsgd->bgrs", qh, k.float()) / math.sqrt(d)
    pos = torch.arange(S, device=q.device)
    mask = pos < length
    if window > 0:
        mask &= pos > length - 1 - window
    out = _masked_softmax_pv(s, mask, v.permute(0, 2, 1, 3))
    out = out.reshape(B, H, d).to(v.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s.masked_fill(~mask, -math.inf), dim=-1)
    return out, lse.reshape(B, H)


def ssd_chunk_ref(xdt: torch.Tensor, cs: torch.Tensor, Bm: torch.Tensor,
                  Cm: torch.Tensor, s_in: torch.Tensor):
    """One Mamba2 SSD chunk (the SSD kernel's unit of work), in float32
    (float64 for float64 inputs, which the gradient tests differentiate).

    xdt ``(L, H, P)`` = x * dt; cs ``(L, H)`` the cumulative log-decay;
    Bm/Cm ``(L, N)``; s_in ``(H, N, P)`` the incoming state.  Returns
    ``(y (L, H, P), s_out (H, N, P))``: y is the intra-chunk term
    ``sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) xdt_j`` plus the inter-chunk
    term ``exp(cs_i) C_i . s_in``; ``s_out = s_in exp(cs_L) + sum_j B_j
    exp(cs_L - cs_j) xdt_j``.  The decay is masked with ``where`` after the
    ``exp``, as the reference does: ``exp(cs_i - cs_j)`` for ``j > i`` may be
    ``inf``, and ``where`` never multiplies it."""
    L = xdt.shape[0]
    f = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    x, c, b, cs = xdt.to(f), Cm.to(f), Bm.to(f), cs.to(f)
    cb = c @ b.T                                                  # (L, L)
    diff = cs[:, None, :] - cs[None, :, :]                        # (L, L, H)
    mask = torch.ones(L, L, dtype=torch.bool, device=xdt.device).tril()
    decay = torch.where(mask[:, :, None], torch.exp(diff),
                        torch.zeros((), dtype=f, device=xdt.device))
    y_intra = torch.einsum("ij,ijh,jhp->ihp", cb, decay, x)
    y_inter = (torch.einsum("in,hnp->ihp", c, s_in.to(f))
               * torch.exp(cs)[:, :, None])
    w_end = torch.exp(cs[-1][None, :] - cs)                       # (L, H)
    s_out = (s_in.to(f) * torch.exp(cs[-1])[:, None, None]
             + torch.einsum("jn,jh,jhp->hnp", b, w_end, x))
    return y_intra + y_inter, s_out


def ssd_scan_ref(xdt: torch.Tensor, cs: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor):
    """The SSD chunk scan over the kernel's chunked layout: xdt ``(B, nc,
    L, H, P)``, cs ``(B, nc, L, H)`` float32, Bm/Cm ``(B, nc, L, N)``.
    Chunks run in order, each batch row carrying its float32 state from a
    zero start (the reference package's ``ssd_scan_ref`` loop).  Returns
    ``(y (B, nc, L, H, P)`` in xdt's dtype, ``final_state (B, H, N, P)``
    float32).  float64 inputs run in float64 throughout: autograd through
    that is the gradient tests' float64 formulation (there ``exp(cs_i -
    cs_j)`` above the diagonal stays finite, so the ``where`` is safe)."""
    B, nc, L, H, P = xdt.shape
    N = Bm.shape[-1]
    f = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    s = torch.zeros((B, H, N, P), dtype=f, device=xdt.device)
    ys = []
    for c in range(nc):
        ych, sch = [], []
        for b in range(B):
            y, s_b = ssd_chunk_ref(xdt[b, c], cs[b, c], Bm[b, c], Cm[b, c],
                                   s[b])
            ych.append(y)
            sch.append(s_b)
        ys.append(torch.stack(ych))
        s = torch.stack(sch)
    return torch.stack(ys, dim=1).to(xdt.dtype), s
