"""Wrapper of the hand-written AdamW passes (``csrc/adamw.cu``).

:func:`sum_squares` is the clip's norm pass: the weighted sum of squares
of a list of gradients, a float32 scalar on their device (one launch a
leaf and one that adds the leaves' partials in a fixed order).
:func:`update` is the fused clip and update of one leaf: it reads p, g,
m and v once and writes p, m and v in place, with the scale, the
learning rate and the bias corrections read on the device, so the
optimizer never synchronises with the host.  The clipped gradient is not
written back.

:func:`takes` says which leaves the kernel updates: a CUDA leaf with a
contiguous bfloat16 or float32 parameter, a contiguous float32 or
bfloat16 gradient of its shape, and contiguous float32 ``m`` and ``v``.
``optim/adamw.py`` sends every other leaf (a leaf that is not
contiguous is updated whole there), and every leaf of
``adamw_update_ref``, through its chunked torch ops, the kernel's plain
version, whose p, m and v the kernel matches bit for bit given the same
scale.  A failed build raises :class:`~repro_torch.kernels.cuda_lib.
BuildError`; nothing falls back.

Replaces no Pallas kernel: the reference's update is jnp ops
(``repro/optim/adamw.py``).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import cuda_lib

__all__ = ["NORM_MAX_BLOCKS", "launches", "norm_blocks", "sum_squares",
           "takes", "update"]

#: launches of the CUDA kernels (norm passes, their sums and updates)
launches = cuda_lib.LaunchCounter("adamw")

_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2}
#: a norm block's threads and the elements a thread takes at once
THREADS, VEC = 256, 8
#: the most blocks (float32 partial sums) of one leaf's norm pass
NORM_MAX_BLOCKS = 1024
_fns = None


def takes(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
          v: torch.Tensor) -> bool:
    """Whether :func:`update` takes this leaf (see the module's note)."""
    return (p.device.type == "cuda" and p.dtype in _DTYPE_CODES
            and g.dtype in _DTYPE_CODES and m.dtype == torch.float32
            and v.dtype == torch.float32
            and g.device == p.device and m.device == p.device
            and v.device == p.device
            and g.shape == p.shape and m.shape == p.shape
            and v.shape == p.shape and p.numel() > 0
            and p.is_contiguous() and g.is_contiguous()
            and m.is_contiguous() and v.is_contiguous())


def norm_blocks(n: int) -> int:
    """A leaf's norm blocks: one a ``THREADS * VEC`` elements, at most
    :data:`NORM_MAX_BLOCKS`; a function of ``n`` alone, so a leaf sums in
    one order on every run."""
    return max(1, min(NORM_MAX_BLOCKS, -(-n // (THREADS * VEC))))


def _launchers():
    global _fns
    if _fns is None:
        lib = cuda_lib.load("adamw")
        sumsq = lib.adamw_sumsq_launch
        sumsq.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p]
        finish = lib.adamw_sumsq_finish_launch
        finish.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_void_p]
        upd = lib.adamw_update_launch
        upd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                        + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
                        + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        for fn in (sumsq, finish, upd):
            fn.restype = ctypes.c_int
        _fns = sumsq, finish, upd
    return _fns


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"adamw {what} launch failed with CUDA error "
                           f"{err}")


def sum_squares(grads: Sequence[torch.Tensor],
                weights: Sequence[float]) -> torch.Tensor:
    """``sum(w * (g.float() ** 2).sum())`` over the leaves, a float32
    scalar on their device (each leaf's blocks weighted before they are
    added).  The leaves are CUDA gradients :func:`takes` accepts, all on
    one device."""
    dev = grads[0].device
    for g in grads:
        if not (g.device == dev and g.device.type == "cuda"
                and g.dtype in _DTYPE_CODES and g.is_contiguous()
                and g.numel() > 0):
            raise ValueError(f"the norm pass takes non-empty contiguous "
                             f"float32 or bfloat16 CUDA gradients on one "
                             f"device, got {g.dtype} {tuple(g.shape)} on "
                             f"{g.device}")
    sumsq, finish, _ = _launchers()
    blocks = [norm_blocks(g.numel()) for g in grads]
    partial = torch.empty(sum(blocks), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        at = partial.data_ptr()
        for g, w, b in zip(grads, weights, blocks):
            _raise(sumsq(_DTYPE_CODES[g.dtype], g.data_ptr(), g.numel(),
                         float(w), at, b, stream), "norm")
            at += 4 * b
        _raise(finish(partial.data_ptr(), partial.numel(), out.data_ptr(),
                      stream), "norm sum")
    launches.add(len(grads) + 1)
    return out


def update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
           v: torch.Tensor, scale: torch.Tensor, lr: torch.Tensor,
           bc1: torch.Tensor, bc2: torch.Tensor, b1: float, b2: float,
           eps: float, wd: float) -> None:
    """One leaf's clip and AdamW update, in place: ``scale``, ``lr``,
    ``bc1`` and ``bc2`` are float32 device scalars; ``b1``, ``b2``,
    ``eps`` and ``wd`` become float32 as torch's ops take Python floats
    (``1 - b1`` and ``1 - b2`` formed in double first)."""
    if not takes(p, g, m, v):
        raise ValueError("the update takes what takes() accepts: a "
                         "contiguous bfloat16 or float32 CUDA parameter, a "
                         "gradient of its shape, float32 m and v")
    for t in (scale, lr, bc1, bc2):
        if t.dtype != torch.float32 or t.numel() != 1 or t.device != p.device:
            raise ValueError("scale, lr, bc1 and bc2 are float32 scalars on "
                             "the parameter's device")
    _, _, upd = _launchers()
    dev = p.device
    with torch.cuda.device(dev):
        err = upd(_DTYPE_CODES[p.dtype], _DTYPE_CODES[g.dtype], p.data_ptr(),
                  g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(),
                  scale.data_ptr(), lr.data_ptr(), bc1.data_ptr(),
                  bc2.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, wd,
                  torch.cuda.current_stream(dev).cuda_stream)
    _raise(err, "update")
    launches.add()
