"""Wrapper of the hand-written Hopper flash-decoding kernel
(``csrc/decode_attention.cu``).

``decode_attention(q, k, v, length, window=)`` attends one query token per
``(b, h)`` — q ``(B, H, d)`` — over the first ``length`` positions of a KV
cache — k/v ``(B, S, KV, d)`` — with grouped-query heads read in place
(query head ``h`` reads KV head ``h // (H // KV)``) and an optional sliding
window; it returns ``(B, H, d)`` in v's dtype, zeros when ``length`` is 0.
Dispatch follows the tensors' device: on CUDA tensors it launches the
kernel on the current stream (and raises if the kernel cannot be built or
launched); on CPU tensors it runs the plain version,
:func:`~repro_torch.kernels.ref.decode_attention_ref`.  There is no mode
switch and no fallback between the two.

``length`` is a host integer, a launch argument: the caller never reads a
device value to pass it, so a decode step does not synchronise.

Replaces the Pallas kernel ``repro/kernels/decode_attention.py::
decode_attention`` and the body of ``repro/models/layers.py::
decode_attention``.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from . import cuda_lib
from .ref import decode_attention_ref

__all__ = ["MAX_HEAD_DIM", "decode_attention", "launches"]

#: launches of the CUDA kernel (CPU calls do not count)
launches = cuda_lib.LaunchCounter("decode_attention")

#: the kernel keeps d / 32 columns per lane in registers, up to 8
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_lib.load("decode_attention").decode_attention_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 7 + [ctypes.c_int64] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, length, window):
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"decode_attention takes q (B, H, d) and k/v "
                         f"(B, S, KV, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, d = q.shape
    S, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, S, KV, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v must be (B, S, KV, d) = ({B}, S, KV, {d}) "
                         f"alike, got {tuple(k.shape)} and {tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside 1..{MAX_HEAD_DIM}")
    if not isinstance(length, numbers.Integral):
        raise TypeError(f"length must be a host integer, got "
                        f"{type(length).__name__}")
    if not 0 <= length <= S:
        raise ValueError(f"length {length} is outside 0..{S} (the cache)")
    if not isinstance(window, numbers.Integral):
        raise TypeError(f"window must be an integer, got {window!r}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype} but q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device} but q is on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous")
    return B, H, KV, S, d


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int, *, window: int = 0) -> torch.Tensor:
    """Attention of q ``(B, H, d)`` over ``k/v[:, :length]`` ``(B, S, KV,
    d)``; with ``window > 0`` only the last ``window`` positions."""
    B, H, KV, S, d = _check(q, k, v, length, window)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, int(length), window=int(window))
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {q.device} but the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    fn = _launcher()
    out = torch.empty((B, H, d), dtype=v.dtype, device=q.device)
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), B, H, KV, S, d, int(length), int(window),
             q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2), out.stride(0),
             out.stride(1), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed with CUDA "
                           f"error {err} (B={B}, H={H}, KV={KV}, S={S}, "
                           f"d={d}, {q.dtype})")
    launches.add()
    return out
