"""Wrapper of the hand-written Hopper SSD chunk-scan kernel
(``csrc/ssd_scan.cu``), the Mamba2 scan of every SSM layer's prefill.

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
``N`` up to 128 at ``P = 64``.  Anything else raises with the reason.

Replaces the Pallas kernel ``repro/kernels/ssd_scan.py::ssd_scan``.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .ref import ssd_scan_ref

__all__ = ["MAX_SMEM_BYTES", "PS", "launches", "smem_bytes", "ssd_scan"]

#: launches of the CUDA kernel (CPU calls do not count)
launches = cuda_lib.LaunchCounter("ssd_scan")

#: the dynamic shared memory one H100 block may opt into
MAX_SMEM_BYTES = 232448
#: head dims the kernel is instantiated for (one or two columns per lane)
PS = (32, 64)
_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2}
_fn = None


def smem_bytes(L: int, N: int, P: int) -> int:
    """Shared memory of one block: the (N, P) state, the head's (L, P)
    xdt, padded (L, N + 1) B and C, a 32-row weight tile and two L-vectors,
    all float32 (``csrc/ssd_scan.cu``'s ``smem_bytes``)."""
    return 4 * (N * P + L * P + 2 * L * (N + 1) + 32 * L + 2 * L)


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_lib.load("ssd_scan").ssd_scan_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
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
    H, N, P))``."""
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
    err = fn(_DTYPE_CODES[xdt.dtype], xdt.data_ptr(), cs.data_ptr(),
             Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), final.data_ptr(),
             B, nc, L, H, N, P, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error "
                           f"{err} (B={B}, nc={nc}, L={L}, H={H}, N={N}, "
                           f"P={P}, {xdt.dtype})")
    launches.add()
    return y, final
