"""The flash backward kernel's dispatch and arithmetic, on the CPU.

The kernel (``csrc/flash_attention.cu``, ``flash_bwd_*``) runs only on the
card, where ``tests/test_torch_flash_bwd_cuda.py`` and ``chip_smoke.py``
hold it to autograd through the plain version.  Here:

* the dispatch rule, :func:`~repro_torch.kernels.flash_attention.
  backward_takes`, as a function of dtype, head dim and device, and the
  plain path's counters inside a traced call on the CPU;
* a float64 emulation of the kernel's arithmetic on tiny shapes: the row
  log-sum-exp (log2 units) from the forward's online recurrence over
  64-key tiles, stored as float32; the D pre-pass ``rowsum(dO * O)`` in
  float32; P and dS split into a bfloat16 high part and the bfloat16 of
  the remainder before each product; the kernel's blocks (64 keys and one
  query head a dK/dV block over the 64-query tiles from the causal start
  to a window past its last key, its float32 partials summed over the KV
  group in head order; 64 queries a dQ block over the forward's key range)
  with its tile skipping and its padding; dK, dV and dQ rounded to
  bfloat16 once.  It must match
  :func:`flash_attention_bwd` (float64, on the same bfloat16 output O)
  within the limit chip_smoke.py derives for the bfloat16 gradients, and
  two planted faults must fail that limit.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention import (BWD_MAX_HEAD_DIM,
                                                 LSE_ROWS, backward_takes,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.obs import span_trace, spans

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# the limits of the bfloat16 gradients
from chip_smoke import flash_grad_share  # noqa: E402

TILE = 64                  # rows of a tile and of a block (kBQ, kBK)


@pytest.mark.parametrize("dtype,d,device,takes", [
    (torch.bfloat16, 128, "cuda", True),
    (torch.bfloat16, 112, "cuda", True),
    (torch.bfloat16, 64, "cuda", True),
    (torch.bfloat16, 40, "cuda", True),
    (torch.bfloat16, 256, "cuda", False),
    (torch.bfloat16, 136, "cuda", False),
    (torch.float32, 128, "cuda", False),
    (torch.float16, 128, "cuda", False),
    (torch.bfloat16, 128, "cpu", False),
    (torch.float64, 64, "cpu", False),
])
def test_backward_dispatch_is_a_function_of_dtype_head_dim_and_device(
        dtype, d, device, takes):
    assert backward_takes(dtype, d, device) is takes
    assert (d <= BWD_MAX_HEAD_DIM) or not takes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_backward_is_the_plain_version_and_counts_so(dtype):
    """On CPU tensors the backward is ``flash_attention_bwd`` (the same
    bits), counts one plain call and no kernel call inside a traced call,
    and launches nothing."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 4, 70, 16))).to(dtype)
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 70, 16))).to(dtype)
            for _ in range(2))
    dout = torch.from_numpy(rng.standard_normal((1, 4, 70, 16))).to(dtype)
    before = launch_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    call = spans.open_call("test.flash_bwd", traced=True)
    try:
        out = flash_attention(*leaves, causal=True, window=9)
        got = torch.autograd.grad(out, leaves, dout)
    finally:
        call.close()
    counters = span_trace().counters
    assert counters["repro.flash.bwd_plain"] == 1
    assert counters["repro.flash.bwd_kernel"] == 0
    want = flash_attention_bwd(q, k, v, out.detach(), dout, causal=True,
                               window=9)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated in float64
def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float64)


def _split(x):
    """x = hi + lo, both bfloat16 (the kernel's split_bf16)."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _f32(x):
    return x.to(torch.float32).to(torch.float64)


def _visible(qpos, kpos, Sq, Sk, causal, window):
    ok = (qpos < Sq) & (kpos < Sk)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (qpos - kpos < window)
    return ok


def _tile_masked(q0, k0, Sq, Sk, causal, window):
    return (q0 >= Sq or k0 >= Sk or (causal and k0 > q0 + TILE - 1)
            or (window > 0 and q0 - (k0 + TILE - 1) >= window))


def _pad(t, rows):
    """Rows past the tensor read as zeros (TMA's fill past a map's end)."""
    return torch.nn.functional.pad(t, (0, 0, 0, rows - t.shape[2]))


def _forward_lse(q, k, c, causal, window, ld):
    """Each row's log2-sum-exp by the forward kernel's online recurrence
    over 64-key tiles, stored as float32, rows past Sq 0."""
    B, H, Sq, _ = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(H // KV, dim=1)
    qpos = torch.arange(Sq)[:, None]
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float64)
    l = torch.zeros((B, H, Sq), dtype=torch.float64)
    for k0 in range(0, Sk, TILE):
        kpos = torch.arange(k0, min(Sk, k0 + TILE))[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", q, kr[:, :, k0:k0 + TILE]) * c
        s = s.masked_fill(~_visible(qpos, kpos, Sq, Sk, causal, window),
                          -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        fin = torch.isfinite(m_new)
        base = torch.where(fin, m_new, torch.zeros(()))
        corr = torch.where(fin, torch.exp2(m - base), torch.ones(()))
        l = l * corr + torch.exp2(s - base[..., None]).sum(-1)
        m = m_new
    lse = torch.zeros((B, H, ld), dtype=torch.float64)
    lse[:, :, :Sq] = _f32(m + torch.log2(l))
    return lse


def emulate_bwd(q, k, v, out, dout, *, causal, window, fault=None):
    """The backward kernel's arithmetic in float64 on bfloat16 values:
    returns (dq, dk, dv) rounded to bfloat16, as float64.  ``fault``
    plants a bug: ``"diagonal"`` drops the diagonal key from dS,
    ``"lse_row"`` reads each row's log-sum-exp from the next row."""
    B, H, Sq, d = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    rep = H // KV
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    c = float(np.float32(scale) * np.float32(1.4426950408889634))
    ld = -(-Sq // LSE_ROWS) * LSE_ROWS
    lse = _forward_lse(q, k, c, causal, window, ld)
    if fault == "lse_row":
        lse[:, :, :-1] = lse[:, :, 1:].clone()
    dsum = torch.zeros((B, H, ld), dtype=torch.float64)
    dsum[:, :, :Sq] = _f32((dout * out).sum(-1))
    skp = -(-Sk // TILE) * TILE
    qp, dop = _pad(q, ld), _pad(dout, ld)
    kp, vp = _pad(k, skp), _pad(v, skp)
    ar = torch.arange(TILE)

    def probs(s, qpos, kpos, lse_q, d_q, dp):
        ok = _visible(qpos, kpos, Sq, Sk, causal, window)
        p = torch.where(ok, torch.exp2(s * c - lse_q), torch.zeros(()))
        ds_ok = ok & (kpos != qpos) if fault == "diagonal" else ok
        return p, torch.where(ds_ok, p * (dp - d_q), torch.zeros(()))

    # dK and dV: a block per (64 keys, query head), its float32 partials
    # summed over the KV group in head order
    part_k = torch.zeros((B, H, skp, d), dtype=torch.float64)
    part_v = torch.zeros_like(part_k)
    for b in range(B):
        for h in range(H):
            g = h // rep
            for k0 in range(0, Sk, TILE):
                q_begin = k0 if causal else 0
                q_end = min(Sq, k0 + TILE - 1 + window) if window > 0 else Sq
                kt, vt = kp[b, g, k0:k0 + TILE], vp[b, g, k0:k0 + TILE]
                for q0 in range(q_begin, q_end, TILE):
                    if _tile_masked(q0, k0, Sq, Sk, causal, window):
                        continue
                    qt, dot = qp[b, h, q0:q0 + TILE], dop[b, h, q0:q0 + TILE]
                    qpos, kpos = (q0 + ar)[None, :], (k0 + ar)[:, None]
                    p, ds = probs(kt @ qt.T, qpos, kpos,
                                  lse[b, h, q0:q0 + TILE][None, :],
                                  dsum[b, h, q0:q0 + TILE][None, :],
                                  vt @ dot.T)
                    for part in _split(p):
                        part_v[b, h, k0:k0 + TILE] += part @ dot
                    for part in _split(ds):
                        part_k[b, h, k0:k0 + TILE] += part @ qt
    part_k = _f32(part_k * scale)
    part_v = _f32(part_v)
    dk = torch.zeros((B, KV, skp, d), dtype=torch.float64)
    dv = torch.zeros_like(dk)
    for j in range(rep):
        dk = _f32(dk + part_k[:, j::rep])
        dv = _f32(dv + part_v[:, j::rep])
    # dQ: a block per (64 queries, head) over the forward's key range
    dq = torch.zeros((B, H, ld, d), dtype=torch.float64)
    for b in range(B):
        for h in range(H):
            g = h // rep
            for q0 in range(0, Sq, TILE):
                kv_end = min(Sk, q0 + TILE) if causal else Sk
                kv_begin = max(0, q0 - window + 1) if window > 0 else 0
                kv_begin -= kv_begin % TILE
                qt, dot = qp[b, h, q0:q0 + TILE], dop[b, h, q0:q0 + TILE]
                for kt0 in range(kv_begin, kv_end, TILE):
                    if _tile_masked(q0, kt0, Sq, Sk, causal, window):
                        continue
                    kt, vt = kp[b, g, kt0:kt0 + TILE], vp[b, g, kt0:kt0 + TILE]
                    qpos, kpos = (q0 + ar)[:, None], (kt0 + ar)[None, :]
                    _, ds = probs(qt @ kt.T, qpos, kpos,
                                  lse[b, h, q0:q0 + TILE][:, None],
                                  dsum[b, h, q0:q0 + TILE][:, None],
                                  dot @ vt.T)
                    for part in _split(ds):
                        dq[b, h, q0:q0 + TILE] += part @ kt
    return (_bf16(_f32(dq[:, :, :Sq] * scale)), _bf16(dk[:, :, :Sk]),
            _bf16(dv[:, :, :Sk]))


def _case(seed, B, H, KV, Sq, Sk, d):
    """bfloat16 inputs as float64, and the bfloat16 output O of the
    forward (the float32 plain version's, rounded once)."""
    rng = np.random.default_rng(seed)
    q, dout = (_bf16(torch.from_numpy(rng.standard_normal((B, H, Sq, d))))
               for _ in range(2))
    k, v = (_bf16(torch.from_numpy(rng.standard_normal((B, KV, Sk, d))))
            for _ in range(2))
    return q, k, v, dout


def _shares(got, want):
    """Each gradient's largest error over chip_smoke's bfloat16 limit
    (without the D-shift: the emulation reads the plain version's O)."""
    return [flash_grad_share(g, w, None, torch.bfloat16)[1]
            for g, w in zip(got, want)]


#: (B, H, KV, Sq, Sk, d, causal, window): a ragged causal length, a window
#: that ends inside a later tile, non-causal cross shapes both ways
#: (ragged tiles past Sq and past Sk), a window of 5 on a short row, d = 40
#: (not a multiple of 16)
EMU_CASES = [(1, 4, 2, 200, 200, 32, True, 0),
             (1, 4, 2, 300, 300, 16, True, 48),
             (2, 4, 2, 70, 150, 16, False, 0),
             (1, 2, 1, 150, 40, 16, False, 0),
             (1, 2, 1, 37, 37, 40, True, 5)]


@pytest.mark.parametrize("B,H,KV,Sq,Sk,d,causal,window", EMU_CASES)
def test_kernel_emulation_matches_the_plain_backward_within_the_limit(
        B, H, KV, Sq, Sk, d, causal, window):
    q, k, v, dout = _case(20, B, H, KV, Sq, Sk, d)
    kw = dict(causal=causal, window=window)
    out = _bf16(flash_attention_ref(q.float(), k.float(), v.float(),
                                    **kw).double())
    want = flash_attention_bwd(q, k, v, out, dout, **kw)
    got = emulate_bwd(q, k, v, out, dout, **kw)
    shares = _shares(got, want)
    assert max(shares) <= 1.0, shares
    for g in got:
        assert torch.isfinite(g).all()
    # the rounding is real: the emulation is not the plain version's bits
    assert any((g != w).any() for g, w in zip(got, want))


@pytest.mark.parametrize("fault", ["diagonal", "lse_row"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48)])
def test_kernel_emulation_with_a_planted_fault_fails_the_limit(fault, causal,
                                                               window):
    q, k, v, dout = _case(21, 1, 4, 2, 200, 200, 32)
    kw = dict(causal=causal, window=window)
    out = _bf16(flash_attention_ref(q.float(), k.float(), v.float(),
                                    **kw).double())
    want = flash_attention_bwd(q, k, v, out, dout, **kw)
    got = emulate_bwd(q, k, v, out, dout, fault=fault, **kw)
    assert max(_shares(got, want)) > 10
