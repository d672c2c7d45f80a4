"""Wrapper of the hand-written Hopper SSD chunk-scan kernel
(``csrc/ssd_scan.cu``), the Mamba2 scan of every SSM layer's prefill,
scoring and training forward.

``ssd_scan(xdt, cs, Bm, Cm)`` takes the chunked layout of the reference's
``ssd_scan``: xdt ``(B, nc, L, H, P)`` = x * dt, cs ``(B, nc, L, H)`` the
float32 cumulative log-decay within each chunk, Bm/Cm ``(B, nc, L, N)`` in
xdt's dtype (float32 or bfloat16).  It returns ``(y, final_state)``: y
``(B, nc, L, H, P)`` in xdt's dtype and the state after the last chunk
``(B, H, N, P)`` in float32, the scan starting from a zero state.
Dispatch follows the tensors' device: on CUDA tensors it launches the
kernel on the current stream (and raises if the kernel cannot be built or
launched); on CPU tensors it runs the plain version,
:func:`~repro_torch.kernels.ref.ssd_scan_ref`.  There is no mode switch and
no fallback between the two.

The kernel takes ``P`` of 32 or 64 and any ``L`` and ``N`` whose chunk fits
a block's 227 KB of shared memory (:func:`smem_bytes`): ``L = 128`` with
``N`` up to 128 at ``P = 64``.  Anything else raises with the reason.  One
call is three device launches (the chunks' state increments and ``C·Bᵀ``,
the state recurrence, the outputs) into two float32 scratch tensors that
the wrapper allocates (:func:`scratch_shapes`), with the heads of a chunk
cut into head groups per chunk (:func:`chunk_groups`); ``launches``
counts the call once.

Gradients: every call goes through :class:`SSDScanFn`, whose forward is
the launch (or the plain version) and whose backward is
:func:`ssd_scan_bwd`, written in torch ops; autograd records it only when
grad mode is on and an input requires grad, so serving's calls carry no
history.  The reference has no backward kernel either: its training
differentiates ``repro/models/ssm.py::ssd_chunked`` with ``jax.grad``.

Replaces the Pallas kernel ``repro/kernels/ssd_scan.py::ssd_scan``.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from . import cuda_lib
from .ref import ssd_scan_ref

__all__ = ["MAX_SMEM_BYTES", "PS", "SSDScanFn", "TARGET_BLOCKS", "chunk_groups",
           "launches", "scratch_shapes", "smem_bytes", "ssd_scan",
           "ssd_scan_bwd"]

#: launches of the CUDA kernel (CPU calls do not count)
launches = cuda_lib.LaunchCounter("ssd_scan")

#: the dynamic shared memory one H100 block may opt into
MAX_SMEM_BYTES = 232448
#: head dims the kernel is instantiated for (one or two columns per lane)
PS = (32, 64)
_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2}
_fn = None
#: blocks a batch row's passes aim at: one for each of the H100's 132 SMs
TARGET_BLOCKS = 132


def _pad16(x: int) -> int:
    return -(-x // 16) * 16


def _rows(Lp: int, P: int):
    """The output block's rows: ``(RS, R)``, a thread per 4 columns of a
    row group, its R rows RS apart (R the least of 2, 4, 8 with ``R * RS
    >= Lp``, else 0)."""
    rs = 512 // (P // 4)
    return rs, next((r for r in (2, 4, 8) if Lp <= r * rs), 0)


def smem_bytes(L: int, N: int, P: int) -> int:
    """Shared memory of the kernel's larger block in bytes, with L and N
    rounded up to 16 (``Lp``, ``Np``; ``csrc/ssd_scan.cu``'s ``state_smem``
    and ``output_smem``), all float32: the state-increment block holds B
    (Lp, Np), two heads' xdt (Lp, P) and an Lp-vector; the ``C·Bᵀ`` block C
    or B (Lp, Np + 1), Cᵀ and Bᵀ (Np, Lp + 4); the output block a head's
    Wᵀ (Lp, LR) and its chunk's Cᵀ (Np, LR), [xdt; state] (Lp + Np, P) and
    three vectors, with LR = R * RS output rows (:func:`_rows`)."""
    Lp, Np = _pad16(L), _pad16(N)
    rs, r = _rows(Lp, P)
    if r == 0:
        return 1 << 40
    state = max(Lp * Np + 2 * Lp * P + Lp, Lp * (Np + 1) + 2 * Np * (Lp + 4))
    output = (Lp + Np) * (r * rs + P) + 2 * r * rs + Lp
    return 4 * max(state, output)


def chunk_groups(nc: int, H: int) -> int:
    """Head groups per chunk: the state-increment and output passes take a
    chunk's heads in this many contiguous ranges ``[g H // groups, (g + 1)
    H // groups)``, a block each, which loads the chunk's head-independent
    operands once.  At most :data:`TARGET_BLOCKS` blocks for a batch row's
    ``nc`` chunks (each with as few heads as that allows); a function of
    ``nc`` and ``H`` only (never of the batch size; a head's result does not
    depend on its group either): zamba2-7b's 512-token prefill (nc = 4, H =
    112) takes 28 groups of 4 heads, 112 blocks."""
    if nc <= 0 or H <= 0:
        raise ValueError(f"empty scan: nc={nc}, H={H}")
    per = -(-nc * H // TARGET_BLOCKS)          # heads a block, at least
    return -(-H // per)


def scratch_shapes(B: int, nc: int, L: int, H: int, N: int, P: int):
    """The kernel's two float32 scratch tensors: each chunk's ``(C·Bᵀ)ᵀ``
    and ``Cᵀ`` stacked, their columns in the output block's row order,
    ``(B, nc, Lp + Np, LR)`` (L, N rounded up to 16; LR from :func:`_rows`);
    and each chunk's state increment, overwritten by the state entering
    the chunk, ``(B, nc, H, N, P)``."""
    Lp, Np = _pad16(L), _pad16(N)
    rs, r = _rows(Lp, P)
    return (B, nc, Lp + Np, r * rs), (B, nc, H, N, P)


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_lib.load("ssd_scan").ssd_scan_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(xdt, cs, Bm, Cm):
    if xdt.dim() != 5 or cs.dim() != 4 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError(f"ssd_scan takes xdt (B, nc, L, H, P), cs (B, nc, "
                         f"L, H) and Bm/Cm (B, nc, L, N), got "
                         f"{tuple(xdt.shape)}, {tuple(cs.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    B, nc, L, H, P = xdt.shape
    N = Bm.shape[-1]
    if tuple(cs.shape) != (B, nc, L, H):
        raise ValueError(f"cs must be (B, nc, L, H) = {(B, nc, L, H)}, got "
                         f"{tuple(cs.shape)}")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if tuple(t.shape) != (B, nc, L, N):
            raise ValueError(f"{name} must be (B, nc, L, N) = "
                             f"{(B, nc, L, N)}, got {tuple(t.shape)}")
    if min(B, nc, L, H, P, N) <= 0:
        raise ValueError(f"empty scan: {(B, nc, L, H, P, N)}")
    if xdt.dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16 xdt, got "
                        f"{xdt.dtype}")
    if cs.dtype != torch.float32:
        raise TypeError(f"cs must be float32, got {cs.dtype}")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != xdt.dtype:
            raise TypeError(f"{name} is {t.dtype} but xdt is {xdt.dtype}")
    for name, t in (("cs", cs), ("Bm", Bm), ("Cm", Cm)):
        if t.device != xdt.device:
            raise ValueError(f"{name} is on {t.device} but xdt is on "
                             f"{xdt.device}")
    return B, nc, L, H, P, N


def ssd_scan(xdt: torch.Tensor, cs: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor):
    """The SSD chunk scan: returns ``(y (B, nc, L, H, P), final_state (B,
    H, N, P))``, through :class:`SSDScanFn`, which carries a gradient back
    to xdt, cs, Bm and Cm where one is to flow."""
    return SSDScanFn.apply(xdt, cs, Bm, Cm)


class SSDScanFn(torch.autograd.Function):
    """The SSD scan with a gradient: the forward is the kernel's launch
    (the plain version on CPU tensors), which it counts like any launch;
    the backward is :func:`ssd_scan_bwd` from the saved inputs.  Under
    ``torch.utils.checkpoint`` the forward runs again in the backward
    pass, and that launch counts too.  A gradient of None for y or for the
    final state (training never reads the final state) is taken as
    zeros."""

    @staticmethod
    def forward(ctx, xdt, cs, Bm, Cm):
        ctx.set_materialize_grads(False)
        y, final = _forward(xdt, cs, Bm, Cm)
        ctx.save_for_backward(xdt, cs, Bm, Cm)
        return y, final

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dfinal):
        xdt, cs, Bm, Cm = ctx.saved_tensors
        return ssd_scan_bwd(xdt, cs, Bm, Cm, dy, dfinal)


def _forward(xdt, cs, Bm, Cm):
    """The kernel's launch on CUDA tensors, the plain version on CPU
    ones."""
    B, nc, L, H, P, N = _check(xdt, cs, Bm, Cm)
    if xdt.device.type == "cpu":
        return ssd_scan_ref(xdt, cs, Bm, Cm)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, got "
                         f"{xdt.device}")
    if xdt.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {xdt.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    if P not in PS:
        raise ValueError(f"ssd_scan's kernel takes a head dim P in {PS}, "
                         f"got {P}")
    if smem_bytes(L, N, P) > MAX_SMEM_BYTES:
        raise ValueError(f"a chunk of L={L}, N={N}, P={P} needs "
                         f"{smem_bytes(L, N, P)} bytes of shared memory, more "
                         f"than the {MAX_SMEM_BYTES} a block can have; use a "
                         f"shorter chunk")
    for name, t in (("xdt", xdt), ("cs", cs), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    fn = _launcher()
    y = torch.empty_like(xdt)
    final = torch.empty((B, H, N, P), dtype=torch.float32, device=xdt.device)
    cb, st = (torch.empty(shape, dtype=torch.float32, device=xdt.device)
              for shape in scratch_shapes(B, nc, L, H, N, P))
    err = fn(_DTYPE_CODES[xdt.dtype], xdt.data_ptr(), cs.data_ptr(),
             Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), final.data_ptr(),
             cb.data_ptr(), st.data_ptr(), B, nc, L, H, N, P,
             chunk_groups(nc, H), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error "
                           f"{err} (B={B}, nc={nc}, L={L}, H={H}, N={N}, "
                           f"P={P}, {xdt.dtype})")
    launches.add()
    return y, final


def ssd_scan_bwd(xdt: torch.Tensor, cs: torch.Tensor, Bm: torch.Tensor,
                 Cm: torch.Tensor, dy, dfinal):
    """The gradient of :func:`ssd_scan` in torch ops: returns ``(dxdt, dcs,
    dBm, dCm)`` in the inputs' types for the gradients ``dy`` ``(B, nc, L,
    H, P)`` of y and ``dfinal`` ``(B, H, N, P)`` of the final state (any
    strides; None for zeros).

    The counterpart of what ``jax.grad`` computes through the reference's
    ``ssd_chunked``, which no Pallas kernel differentiates.  Per chunk c,
    head h, with S_c the state entering the chunk (S_0 = 0), the forward is

    * y_i = sum_{j <= i} (C_i . B_j) e^{cs_i - cs_j} x_j   (intra-chunk)
      + e^{cs_i} C_i . S_c                                  (inter-chunk);
    * S_{c+1} = e^{cs_L} S_c + sum_j e^{cs_L - cs_j} B_j (x) x_j  (carry),

    x = xdt, cs_L the chunk's last entry.  The entering states are
    recomputed here in torch ops from the inputs (one product for the
    chunks' increments, then ``nc`` steps of the carry), so the backward
    takes the same inputs on either device: the kernel's scratch holds
    them too, but the plain version has no scratch, and the recurrence
    costs one state-sized product, small beside the ``L x L`` terms.  The
    state gradients run the carry backwards from ``dfinal``: D_nc =
    dfinal, D_c = e^{cs_L} D_{c+1} + sum_i e^{cs_i} C_i (x) dy_i.  All
    other terms are vectorised over batch rows and chunks, a few ``(B, nc,
    L, L, H)`` tensors at a time.  B and C are shared by all heads (one
    group), so their gradients sum over H.

    The decay ``e^{cs_i - cs_j}`` is masked *before* its exp
    (``masked_fill(-inf)``): above the diagonal ``cs_i - cs_j`` passes 88
    once a chunk's decay does, and an ``exp`` that overflows to inf would
    turn the zero cotangent of a ``where`` into NaN, as it does in the
    reference (``repro/models/ssm.py:92``).  ``e^{cs_i}`` may underflow to
    zero far into a chunk, which no term divides by.  Arithmetic is
    float32 (float64 for float64 inputs)."""
    B, nc, L, H, P = xdt.shape
    N = Bm.shape[-1]
    acc = torch.float64 if xdt.dtype == torch.float64 else torch.float32
    dev = xdt.device
    x, b, c, cum = xdt.to(acc), Bm.to(acc), Cm.to(acc), cs.to(acc)
    dy = (torch.zeros((B, nc, L, H, P), dtype=acc, device=dev) if dy is None
          else dy.to(acc))

    # the states entering each chunk, S (B, nc, H, N, P)
    a_last = cum[:, :, -1]                                       # (B, nc, H)
    w_end = torch.exp(a_last[:, :, None] - cum)                  # (B, nc, L, H)
    xw = x * w_end[..., None]
    inc = torch.einsum("bcjn,bcjhp->bchnp", b, xw)
    carry = torch.exp(a_last)[..., None, None]                 # (B, nc, H, 1, 1)
    S = torch.empty_like(inc)
    s = torch.zeros((B, H, N, P), dtype=acc, device=dev)
    for ch in range(nc):
        S[:, ch] = s
        s = s * carry[:, ch] + inc[:, ch]
    del inc

    # the inter-chunk term's gradients, and the carry backwards: D[:, c] =
    # D_{c+1}, the gradient of the state leaving chunk c
    ea = torch.exp(cum)                                          # (B, nc, L, H)
    dye = dy * ea[..., None]
    dc = torch.einsum("bcihp,bchnp->bcin", dye, S)
    dcs = ea * (torch.einsum("bcin,bchnp->bcihp", c, S) * dy).sum(-1)
    q = torch.einsum("bcin,bcihp->bchnp", c, dye)
    del dye
    D = torch.empty_like(S)
    d = (torch.zeros((B, H, N, P), dtype=acc, device=dev) if dfinal is None
         else dfinal.to(acc))
    for ch in reversed(range(nc)):
        D[:, ch] = d
        d = d * carry[:, ch] + q[:, ch]
    del q

    # the state term: S_{c+1} = e^{cs_L} S_c + sum_j w_j B_j (x) x_j
    bd = torch.einsum("bcjn,bchnp->bcjhp", b, D)               # B_j . D
    dx = bd * w_end[..., None]
    t = (bd * xw).sum(-1)                                      # (B, nc, L, H)
    del bd
    dcs = dcs - t
    dcs[:, :, -1] += t.sum(2) + carry[..., 0, 0] * (S * D).sum((-2, -1))
    db = torch.einsum("bcjhp,bchnp->bcjn", xw, D)
    del xw, D, S, t

    # the intra-chunk term: M_ij = (C_i . B_j) e^{cs_i - cs_j}, j <= i
    keep = torch.ones((L, L), dtype=torch.bool, device=dev).tril()
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (.., i, j, H)
    decay = decay.masked_fill_(~keep[:, :, None], -math.inf).exp_()
    cb = torch.einsum("bcin,bcjn->bcij", c, b)
    m = decay * cb[..., None]
    dx = dx + torch.einsum("bcijh,bcihp->bcjhp", m, dy)
    dm = torch.einsum("bcihp,bcjhp->bcijh", dy, x)             # dy_i . x_j
    dcb = (dm * decay).sum(-1)
    del decay
    dm.mul_(m)                                                 # d(cs_i - cs_j)
    del m
    dcs = dcs + dm.sum(3) - dm.sum(2)
    del dm
    dc = dc + torch.einsum("bcij,bcjn->bcin", dcb, b)
    db = db + torch.einsum("bcij,bcin->bcjn", dcb, c)
    return dx.to(xdt.dtype), dcs.to(cs.dtype), db.to(Bm.dtype), dc.to(Cm.dtype)
