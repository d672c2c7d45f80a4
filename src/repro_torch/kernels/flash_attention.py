"""Wrapper of the hand-written Hopper flash-attention kernel
(``csrc/flash_attention.cu``), the attention of prefill, of the encoder and
of cross-attention's prefill.

``flash_attention(q, k, v, causal=, window=)`` takes q ``(B, H, Sq, d)``
and k/v ``(B, KV, Sk, d)`` — query head ``h`` reads KV head
``h // (H // KV)`` in place — and returns ``(B, H, Sq, d)`` in q's dtype,
at scale ``1/sqrt(d)``, for any lengths.  Dispatch follows the tensors' device: on
CUDA tensors it launches the kernel on the current stream (and raises if
the kernel cannot be built or launched); on CPU tensors it runs the plain
version, :func:`~repro_torch.kernels.ref.flash_attention_ref`.  There is no
mode switch and no fallback between the two.

bfloat16 runs on the tensor cores, its tiles fed by TMA straight from the
tensors as they are: their base addresses and (batch, head, position)
strides must be multiples of 16 bytes, and the wrapper raises, with the
reason, where they are not (it never copies).  float32 runs a plain
kernel of FMAs from shared memory.  Only what the model paths call is
taken: the queries start at position 0, and the two lengths differ only
without the causal mask (cross-attention: ``Sq`` prompt positions over
``Sk`` memory rows).  ``layers._chunked_attn``'s ``q_offset`` and a causal
``Sq != Sk`` (a prefill that continues a cache) raise
``NotImplementedError`` (ROADMAP Queue B item 3).

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention`` and the body of ``repro/models/layers.py::_chunked_attn``
as ``attention`` calls it for prefill, for the encoder (``causal=False``)
and for cross-attention (``memory=``).
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from . import cuda_lib
from .ref import flash_attention_ref

__all__ = ["MAX_HEAD_DIM", "flash_attention", "launches"]

#: launches of the CUDA kernel (CPU calls do not count)
launches = cuda_lib.LaunchCounter("flash_attention")

#: float32 Q, K and V tiles of 64 rows must fit the 227 KB of shared memory,
#: and a bfloat16 head is at most four 64-column panels
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2}
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_lib.load("flash_attention").flash_attention_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 8 + [ctypes.c_int64] * 12
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, causal, window, q_offset):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes q (B, H, Sq, d) and k/v "
                         f"(B, KV, Sk, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if q_offset != 0 or (causal and Sk != S):
        raise NotImplementedError(
            f"flash_attention takes queries from position 0, and unequal "
            f"query and key lengths only with causal=False, got "
            f"q_offset={q_offset}, Sq={S}, Sk={Sk}, causal={causal}; see "
            f"ROADMAP Queue B item 3")
    if tuple(k.shape) != (B, KV, Sk, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v must be (B, KV, Sk, d) = ({B}, KV, Sk, {d}) "
                         f"alike, got {tuple(k.shape)} and {tuple(v.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if S < 1 or Sk < 1:
        raise ValueError("flash_attention needs at least one query and one "
                         "key position")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside 1..{MAX_HEAD_DIM}")
    if not isinstance(window, numbers.Integral):
        raise TypeError(f"window must be an integer, got {window!r}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype} but q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device} but q is on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous")
    return B, H, KV, S, Sk, d


def _check_tma(q, k, v):
    """The bfloat16 kernel's TMA loads read q, k and v in place."""
    if q.shape[-1] % 8:
        raise ValueError(f"head dim {q.shape[-1]} is not a multiple of 8: the "
                         f"bfloat16 kernel's TMA rows are whole 16-byte units")
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_lib.require_aligned(name, t, {0: "batch", 1: "head",
                                           2: "position"},
                                 "the bfloat16 kernel's TMA load")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention of q ``(B, H, Sq, d)`` over k/v ``(B, KV, Sk, d)``
    (``Sq == Sk`` when ``causal``); returns a new contiguous ``(B, H, Sq,
    d)`` tensor."""
    B, H, KV, S, Sk, d = _check(q, k, v, causal, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=int(window))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors are on {q.device} but the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    if q.dtype == torch.bfloat16:
        _check_tma(q, k, v)
    fn = _launcher()
    out = torch.empty((B, H, S, d), dtype=q.dtype, device=q.device)
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), B, H, KV, S, Sk, d, int(bool(causal)),
             int(window),
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise RuntimeError(f"flash_attention: the driver refused a TMA tensor "
                           f"map (CUresult {-err}; B={B}, H={H}, KV={KV}, "
                           f"Sq={S}, Sk={Sk}, d={d})")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err} (B={B}, H={H}, KV={KV}, Sq={S}, "
                           f"Sk={Sk}, d={d}, {q.dtype})")
    launches.add()
    return out
