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

With ``return_lse=True`` it returns ``(out, lse)``, ``lse`` float32 ``(B,
H)``: each row's log-sum-exp of its scaled scores over the valid keys
(``m + log l`` of the merged splits), -inf where no key is valid, so that
partials over slices of a sequence-sharded cache combine exactly
(:func:`~repro_torch.sharding.collectives.lse_combine`).  ``out`` has the
same bits either way.

``length`` is a host integer, a launch argument: the caller never reads a
device value to pass it, so a decode step does not synchronise.

The kernel cuts ``[lo, length)`` into the ranges of :func:`decode_splits`,
one block each, merged in a fixed order; the cut depends on ``length``,
``window`` and the KV heads alone, never on the batch, so a lane's result
has the same bits whoever else runs beside it.  Each K and V row is one
bulk copy into shared memory, so the cache's base address and its (batch,
position, head) strides must be multiples of 16 bytes, and so must a row
(``d`` times the element size); the wrapper raises, with the reason, where
they are not.

Replaces the Pallas kernel ``repro/kernels/decode_attention.py::
decode_attention`` and the body of ``repro/models/layers.py::
decode_attention``.
"""

from __future__ import annotations

import ctypes
import numbers
from typing import Tuple

import torch

from . import cuda_lib
from .ref import decode_attention_ref

__all__ = ["MAX_HEAD_DIM", "MAX_SPLITS", "decode_attention", "decode_splits",
           "launches"]

#: launches of the CUDA kernel (CPU calls do not count)
launches = cuda_lib.LaunchCounter("decode_attention")

#: the widest head the kernel's shared memory is sized for
MAX_HEAD_DIM = 256
#: the most query heads per KV head a block holds
MAX_GROUP = 16
#: the most blocks one (batch, KV head) is split over: a thread-block
#: cluster, whose blocks merge through each other's shared memory, of the
#: largest size Hopper allows (16, above the portable 8 on request)
MAX_SPLITS = 16
#: the blocks one batch row aims at: about two on each of the H100's 132 SMs
TARGET_BLOCKS = 256
_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2}
_fn = None


def decode_splits(length: int, window: int, kv_heads: int,
                  head_dim: int) -> Tuple[int, int, int]:
    """How the kernel cuts the valid keys ``[lo, length)``: returns ``(lo,
    splits, per)``, split ``s`` taking ``[lo + s * per, lo + (s + 1) *
    per)`` clipped to ``length``.  ``splits`` fills about
    :data:`TARGET_BLOCKS` blocks per batch row with ``kv_heads`` groups, at
    most :data:`MAX_SPLITS`; ranges past ``length`` are empty (fewer keys
    than splits).  A function of these four integers only: never of the
    batch size or of any device value.  ``head_dim`` does not change the
    cut today; it is part of the contract so that a later cut may."""
    lo = max(0, length - window) if window > 0 else 0
    splits = max(1, min(MAX_SPLITS, -(-TARGET_BLOCKS // kv_heads)))
    per = -(-(length - lo) // splits)
    return lo, splits, per


def _check_copies(k, v):
    """Each K and V row is one bulk copy, reading the cache in place."""
    row = k.shape[-1] * k.element_size()
    if row % 16:
        raise ValueError(f"a K/V row of {row} bytes is not a multiple of 16 "
                         f"bytes; the kernel moves each row with one bulk "
                         f"copy")
    for name, t in (("k", k), ("v", v)):
        cuda_lib.require_aligned(name, t, {0: "batch", 1: "position",
                                           2: "head"},
                                 "the kernel's bulk copy")


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_lib.load("decode_attention").decode_attention_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 9 + [ctypes.c_int64] * 10
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
    if H // KV > MAX_GROUP:
        raise ValueError(f"{H // KV} query heads per KV head; the kernel "
                         f"holds at most {MAX_GROUP}")
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
                     length: int, *, window: int = 0,
                     return_lse: bool = False):
    """Attention of q ``(B, H, d)`` over ``k/v[:, :length]`` ``(B, S, KV,
    d)``; with ``window > 0`` only the last ``window`` positions; with
    ``return_lse`` also each row's float32 log-sum-exp ``(B, H)``."""
    B, H, KV, S, d = _check(q, k, v, length, window)
    cuda_lib.refuse_grad("decode_attention", q, k, v)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, int(length), window=int(window),
                                    return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {q.device} but the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    _check_copies(k, v)
    lo, splits, per = decode_splits(int(length), int(window), KV, d)
    fn = _launcher()
    out = torch.empty((B, H, d), dtype=v.dtype, device=q.device)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), lse.data_ptr() if return_lse else None,
             B, H, KV, S, d, int(length), lo, splits, per,
             q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2), out.stride(0),
             out.stride(1), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed with CUDA "
                           f"error {err} (B={B}, H={H}, KV={KV}, S={S}, "
                           f"d={d}, {q.dtype})")
    launches.add()
    return (out, lse) if return_lse else out
