"""Wrapper of the hand-written Hopper tile GEMM (``csrc/tile_matmul.cu``).

``tile_matmul(a, b, c, alpha=, beta=, trans_b=, out=)`` computes
``out = beta * c + alpha * a @ op(b)``.  Dispatch follows the tensors'
device: on CUDA tensors it launches the kernel on the current stream (and
raises if the kernel cannot be built or launched); on CPU tensors it runs
the plain version, :func:`~repro_torch.kernels.ref.tile_matmul_ref`.  There
is no mode switch and no fallback between the two.

float64 runs on the DMMA tensor cores with K cut into
:func:`gemm_splits` ranges, one thread-block cluster per output block;
float32 and bfloat16 run the kernel's float32 FMA path.

Replaces the Pallas kernel ``repro/kernels/tile_matmul.py::tile_matmul``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda_lib
from .ref import tile_matmul_ref

__all__ = ["BLOCK", "K_SLICE", "MAX_SPLITS", "TARGET_BLOCKS", "gemm_splits",
           "launches", "tile_matmul"]

#: launches of the CUDA kernel (CPU calls do not count)
launches = cuda_lib.LaunchCounter("tile_matmul")

_DTYPE_CODES = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
_fn = None

#: the float64 kernel's output block (rows = columns) and K slice depth
BLOCK = 32
K_SLICE = 16
#: the largest cluster of K splits (the portable cluster size)
MAX_SPLITS = 8
#: blocks a float64 launch aims at: about one for each of the H100's 132
#: SMs, a little more so that no SM waits on a second wave of whole tiles
TARGET_BLOCKS = 160


def gemm_splits(M: int, N: int, K: int) -> Tuple[int, int]:
    """How the float64 kernel cuts K: returns ``(splits, per)``, split
    ``z`` taking the 16-deep K slices ``[z * per, (z + 1) * per)`` clipped
    to ``ceil(K / 16)``.  ``splits`` fills about :data:`TARGET_BLOCKS`
    blocks with ``ceil(M / 32) * ceil(N / 32)`` output blocks, at most
    :data:`MAX_SPLITS` and at most one per slice, and no split is empty.
    A function of the three integers only, so that one shape sums in one
    order on every launch: 192^3 gives ``(4, 3)``, 144 blocks."""
    if min(M, N, K) <= 0:
        raise ValueError(f"empty product: M={M}, N={N}, K={K}")
    tiles = -(-M // BLOCK) * -(-N // BLOCK)
    slices = -(-K // K_SLICE)
    want = max(1, min(MAX_SPLITS, slices, TARGET_BLOCKS // tiles))
    per = -(-slices // want)
    return -(-slices // per), per


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_lib.load("tile_matmul").tile_matmul_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 8
                       + [ctypes.c_double, ctypes.c_double]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(a, b, c, out, trans_b):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"tile_matmul takes 2-D a and b, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[0] if trans_b else b.shape[1]
    kb = b.shape[1] if trans_b else b.shape[0]
    if kb != K:
        raise ValueError(f"inner dimensions differ: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} (trans_b={trans_b})")
    if min(M, N, K) <= 0:
        raise ValueError(f"empty product: M={M}, N={N}, K={K}")
    if a.dtype not in _DTYPE_CODES:
        raise TypeError(f"tile_matmul takes float64, float32 or bfloat16, got "
                        f"{a.dtype}")
    for name, t in (("b", b), ("c", c), ("out", out)):
        if t is None:
            continue
        if t.dtype != a.dtype:
            raise TypeError(f"{name} is {t.dtype} but a is {a.dtype}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device} but a is on {a.device}")
        if name != "b" and tuple(t.shape) != (M, N):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(M, N)}")
    for name, t in (("a", a), ("b", b), ("c", c), ("out", out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (row-major)")
    if out is not None and out.data_ptr() in (a.data_ptr(), b.data_ptr()):
        raise ValueError("out may be c, but must not be a or b")
    return M, N, K


def tile_matmul(a: torch.Tensor, b: torch.Tensor,
                c: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
                beta: float = 1.0, trans_b: bool = False,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = beta * c + alpha * a @ op(b)``; returns ``out`` (allocated
    when not given; ``out=c`` updates C in place)."""
    M, N, K = _check(a, b, c, out, trans_b)
    cuda_lib.refuse_grad("tile_matmul", a, b, c)
    if a.device.type == "cpu":
        res = tile_matmul_ref(a, b, c, alpha=alpha, beta=beta, trans_b=trans_b)
        return res if out is None else out.copy_(res)
    if a.device.type != "cuda":
        raise ValueError(f"tile_matmul runs on CUDA or CPU tensors, got "
                         f"{a.device}")
    if a.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {a.device} but the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    fn = _launcher()
    splits, per = gemm_splits(M, N, K)
    if out is None:
        out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    err = fn(_DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(),
             None if c is None else c.data_ptr(), out.data_ptr(),
             M, N, K, K, b.shape[1], N, N, int(trans_b), float(alpha),
             float(beta), splits, per, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tile_matmul kernel launch failed with CUDA "
                           f"error {err} (M={M}, N={N}, K={K}, {a.dtype})")
    launches.add()
    return out
