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

Gradients: every call goes through :class:`FlashAttentionFn`, whose
forward is the launch (or plain version); autograd records it only when
grad mode is on and q, k or v requires grad, so serving's calls carry no
history.  Its backward is a second hand-written kernel where
:func:`backward_takes` says so, from what the input is: bfloat16 CUDA
tensors with a head dim of at most :data:`BWD_MAX_HEAD_DIM`
(``csrc/flash_attention.cu``'s backward: dQ, dK and dV on the tensor
cores from the forward's row log-sum-exp, which the forward then also
stores); every other input (float32, gemma3's head of 256, CPU tensors)
takes :func:`flash_attention_bwd`, written in torch ops.  The kernel
reads the output gradient in place, as the forward reads q, k and v: its
head dimension must be contiguous and its other strides multiples of 16
bytes, and it raises, with the reason, where they are not (it never
copies).  So ``flash_attention(q, k, v).sum().backward()`` on bfloat16
CUDA tensors raises (autograd passes an expanded gradient, of stride 0);
pass the gradient as a tensor, ``out.backward(torch.ones_like(out))``.
The reference has no backward kernel: its training differentiates
``layers._chunked_attn`` with ``jax.grad``.  Inside a traced top-level
call (a train step or an engine step under a profiler,
:mod:`repro_torch.obs.spans`) each forward, remat's included, is a
``repro.flash.fwd`` span and each backward a ``repro.flash.bwd`` one,
with its device interval, and each backward counts one call of its path,
``repro.flash.bwd_kernel`` or ``repro.flash.bwd_plain``; the spans stay
out of the profiler's trace, which names the kernels and the backward's
autograd node already.

Replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention`` and the body of ``repro/models/layers.py::_chunked_attn``
as ``attention`` calls it for prefill, for training's forward, for the
encoder (``causal=False``) and for cross-attention (``memory=``).
"""

from __future__ import annotations

import ctypes
import math
import numbers

import torch
from torch.autograd.function import once_differentiable

from ..obs import spans
from . import cuda_lib
from .ref import flash_attention_ref

__all__ = ["BWD_BLOCK", "BWD_MAX_HEAD_DIM", "FlashAttentionFn",
           "MAX_HEAD_DIM", "backward_takes", "bwd_launches",
           "flash_attention", "flash_attention_bwd", "launches"]

#: launches of the CUDA kernel (CPU calls do not count)
launches = cuda_lib.LaunchCounter("flash_attention")
#: calls of the backward kernel (its four launches count as one)
bwd_launches = cuda_lib.LaunchCounter("flash_attention_bwd")

#: float32 Q, K and V tiles of 64 rows must fit the 227 KB of shared memory,
#: and a bfloat16 head is at most four 64-column panels
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 1, torch.bfloat16: 2}
#: query rows per block of the backward: its float32 scores, probabilities
#: and their gradients take O(BWD_BLOCK * Sk) per head
BWD_BLOCK = 512
#: the backward kernel keeps dK and dV of a 64-key tile in float32
#: registers: heads of at most two 64-column panels
BWD_MAX_HEAD_DIM = 128
#: the forward's row log-sum-exp is stored for rows padded to a multiple of
#: this (the backward kernel's tiles of queries)
LSE_ROWS = 64
_fn = None
_bwd_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = cuda_lib.load("flash_attention").flash_attention_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 8 + [ctypes.c_int64] * 12
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_launcher():
    global _bwd_fn
    if _bwd_fn is None:
        fn = cuda_lib.load("flash_attention").flash_attention_bwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def backward_takes(dtype: torch.dtype, head_dim: int, device_type: str) -> bool:
    """Does a call's backward run the kernel?  bfloat16 CUDA tensors with a
    head dim of at most :data:`BWD_MAX_HEAD_DIM` (the bfloat16 forward
    already takes only multiples of 8); float32, larger heads and CPU
    tensors take :func:`flash_attention_bwd`."""
    return (device_type == "cuda" and dtype == torch.bfloat16
            and head_dim <= BWD_MAX_HEAD_DIM)


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
    d)`` tensor, through :class:`FlashAttentionFn`, which carries a
    gradient back to q, k or v where one is to flow.  On bfloat16 CUDA
    tensors with heads of at most :data:`BWD_MAX_HEAD_DIM` the gradient
    that reaches the output must have a contiguous head dimension and
    16-byte aligned strides (the backward kernel reads it in place and
    raises otherwise; ``.sum().backward()`` hands it an expanded one)."""
    return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)


def _forward(q, k, v, causal, window, q_offset, lse: bool = False):
    """The kernel's launch on CUDA tensors, the plain version on CPU ones;
    returns ``(out, lse)``, where ``lse`` (asked for only where
    :func:`backward_takes`) is each row's log2-sum-exp, float32 ``(B, H,
    ld)`` with ``ld`` Sq rounded up to :data:`LSE_ROWS`, else None."""
    B, H, KV, S, Sk, d = _check(q, k, v, causal, window, q_offset)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   window=int(window)), None
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
    ld = -(-S // LSE_ROWS) * LSE_ROWS
    lse_t = (torch.empty((B, H, ld), dtype=torch.float32, device=q.device)
             if lse else None)
    err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), B, H, KV, S, Sk, d, int(bool(causal)),
             int(window),
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             *out.stride()[:3], lse_t.data_ptr() if lse else None, ld,
             torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise RuntimeError(f"flash_attention: the driver refused a TMA tensor "
                           f"map (CUresult {-err}; B={B}, H={H}, KV={KV}, "
                           f"Sq={S}, Sk={Sk}, d={d})")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err} (B={B}, H={H}, KV={KV}, Sq={S}, "
                           f"Sk={Sk}, d={d}, {q.dtype})")
    launches.add()
    return out, lse_t


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: the forward is the kernel's launch
    (the plain version on CPU tensors), which it counts like any launch;
    the backward is the backward kernel where :func:`backward_takes` (from
    the saved q, k, v, output and the forward's row log-sum-exp, which the
    forward stores when an input requires grad), else
    :func:`flash_attention_bwd`.  Under ``torch.utils.checkpoint`` the
    forward runs again in the backward pass, and that launch counts too."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        sp = spans.current()
        sid = sp.begin("repro.flash.fwd", mirror=False) if sp else 0
        kernel = (any(ctx.needs_input_grad[:3])
                  and backward_takes(q.dtype, q.shape[-1], q.device.type))
        out, lse = _forward(q, k, v, causal, window, q_offset, lse=kernel)
        if sp is not None:
            sp.end(sid)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = bool(causal), int(window)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        sp = spans.current()
        sid = sp.begin("repro.flash.bwd", mirror=False) if sp else 0
        kw = dict(causal=ctx.causal, window=ctx.window)
        if lse is not None:
            dq, dk, dv = _backward(q, k, v, out, dout, lse, **kw)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, **kw)
        if sp is not None:
            sp.count("repro.flash.bwd_kernel", int(lse is not None))
            sp.count("repro.flash.bwd_plain", int(lse is None))
            sp.end(sid)
        return dq, dk, dv, None, None, None


def _backward(q, k, v, out, dout, lse, *, causal, window):
    """The backward kernel's launch: ``(dq, dk, dv)``, new contiguous
    bfloat16 tensors, from the forward's inputs, ``out`` and ``lse`` and
    the output gradient ``dout``, which it reads in place (bfloat16, the
    head dimension contiguous, 16-byte aligned: it raises otherwise)."""
    B, H, S, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if tuple(dout.shape) != (B, H, S, d):
        raise ValueError(f"dout must be (B, H, Sq, d) = {(B, H, S, d)}, got "
                         f"{tuple(dout.shape)}")
    if dout.dtype != torch.bfloat16 or dout.device != q.device:
        raise TypeError(f"the backward kernel takes a bfloat16 dout on "
                        f"{q.device}, got {dout.dtype} on {dout.device}")
    if dout.stride(-1) != 1:
        raise ValueError("dout's head dimension must be contiguous: the "
                         "backward kernel reads it in place")
    cuda_lib.require_aligned("dout", dout, {0: "batch", 1: "head",
                                            2: "position"},
                             "the backward kernel's TMA load")
    ld = lse.shape[-1]
    dq = torch.empty((B, H, S, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, KV, Sk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, KV, Sk, d), dtype=v.dtype, device=q.device)
    # float32 scratch: each query head's dK and dV, summed over its KV
    # group, then D = rowsum(dO * O) of each query row
    part = torch.empty(2 * B * H * Sk * d + B * H * ld, dtype=torch.float32,
                       device=q.device)
    strides = (ctypes.c_int64 * 24)(*[st for t in (q, k, v, out, dout, dq,
                                                   dk, dv)
                                      for st in t.stride()[:3]])
    err = _bwd_launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(),
        part.data_ptr() + 4 * (2 * B * H * Sk * d), part.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, KV, S, Sk, d,
        int(causal), int(window), ld, strides,
        torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise RuntimeError(f"flash_attention backward: the driver refused a "
                           f"TMA tensor map (CUresult {-err}; B={B}, H={H}, "
                           f"KV={KV}, Sq={S}, Sk={Sk}, d={d})")
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed "
                           f"with CUDA error {err} (B={B}, H={H}, KV={KV}, "
                           f"Sq={S}, Sk={Sk}, d={d})")
    bwd_launches.add()
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, window: int = 0):
    """The gradient of :func:`flash_attention` in torch ops, the backward
    kernel's plain version (what :class:`FlashAttentionFn` runs where
    :func:`backward_takes` does not): returns ``(dq, dk, dv)`` in the types
    of q, k and v for the output gradient ``dout`` ``(B, H, Sq, d)`` (any
    strides) at the forward's ``out``.

    The counterpart of what ``jax.grad`` computes through the reference's
    ``_chunked_attn``, which no Pallas kernel differentiates.  Query rows go
    in blocks of at most :data:`BWD_BLOCK`; each block recomputes its
    scores over the keys its rows can see (with ``causal`` none past the
    block's last row, with ``window`` none ``window`` or more behind its
    first) and a float32 softmax P (float64 for float64 inputs), then forms
    dV += Pᵀ·dO, dP = dO·Vᵀ, dS = P ⊙ (dP − rowsum(dO ⊙ O)), dQ = dS·K·s
    and dK += dSᵀ·Q·s at scale ``s = 1/sqrt(d)``.  The query heads of a KV
    group share their KV head, so dK and dV sum over the group.  Memory
    is O(BWD_BLOCK · Sk) per head.

    ``out`` enters only through rowsum(dO ⊙ O): the bfloat16 kernel rounds
    p to bfloat16 before P·V (``chip_smoke.FLASH_P_ROUND``) and its output
    once more, so its O, and through it dS, differs from the float32
    forward's by that rounding, while P here is float32."""
    B, H, S, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    rep = H // KV
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    kf, vf = k.to(acc), v.to(acc)
    dq = torch.empty((B, H, S, d), dtype=acc, device=dev)
    dk = torch.zeros((B, KV, Sk, d), dtype=acc, device=dev)
    dv = torch.zeros((B, KV, Sk, d), dtype=acc, device=dev)
    for q0 in range(0, S, BWD_BLOCK):
        q1 = min(S, q0 + BWD_BLOCK)
        lo = max(0, q0 - window + 1) if window > 0 else 0
        hi = min(Sk, q1) if causal else Sk
        n = q1 - q0

        def rows(t):                      # (B, KV, rep, n, d) in acc
            return t[:, :, q0:q1].to(acc).reshape(B, KV, rep, n, d)

        qb, ob, dob = rows(q), rows(out), rows(dout)
        kb, vb = kf[:, :, lo:hi], vf[:, :, lo:hi]
        s = torch.einsum("bgrqd,bgkd->bgrqk", qb, kb) * scale
        qpos = torch.arange(q0, q1, device=dev)[:, None]
        kpos = torch.arange(lo, hi, device=dev)[None, :]
        mask = torch.ones((n, hi - lo), dtype=torch.bool, device=dev)
        if causal:
            mask &= qpos >= kpos
        if window > 0:
            mask &= qpos - kpos < window
        s = s.masked_fill(~mask, -math.inf)
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m)
        p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        del s
        dv[:, :, lo:hi] += torch.einsum("bgrqk,bgrqd->bgkd", p, dob)
        dp = torch.einsum("bgrqd,bgkd->bgrqk", dob, vb)
        ds = p * (dp - (dob * ob).sum(dim=-1, keepdim=True))
        del p, dp
        dq[:, :, q0:q1] = (torch.einsum("bgrqk,bgkd->bgrqd", ds, kb)
                           * scale).reshape(B, H, n, d)
        dk[:, :, lo:hi] += torch.einsum("bgrqk,bgrqd->bgkd", ds, qb) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
