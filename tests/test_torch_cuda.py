"""The port's CUDA kernels and its main paths on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; each is marked ``cuda``
and skips where ``torch.cuda.is_available()`` is false.  The file imports
no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.kernels import cuda_lib, launch_counts
from repro_torch.kernels import tile_matmul as tm
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import (decode_attention_ref, flash_attention_ref,
                                     tile_matmul_ref)
from repro_torch.linalg import (build_cholesky_graph, cholesky_extract,
                                random_spd, to_tiles)

pytestmark = pytest.mark.cuda

# tests/test_kernels.py's TOL table; float64 error relative to the largest
# |entry| of the result
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
F64_RTOL = 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,M,N,K,trans_b", [
    ("float64", 192, 192, 192, True),
    ("float64", 200, 136, 72, True),
    ("float64", 33, 65, 17, False),
    ("float32", 256, 256, 256, False),
    ("float32", 512, 128, 256, False),
    ("bfloat16", 256, 256, 256, False),
    ("bfloat16", 512, 128, 256, False),
])
def test_cuda_kernel_matches_plain_version(cuda, dtype, M, N, K, trans_b):
    rng = np.random.default_rng(7)
    dt = getattr(torch, dtype)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(cuda, dt)

    a = rand(M, K)
    b = rand(N, K) if trans_b else rand(K, N)
    c = rand(M, N)
    expect = tile_matmul_ref(a, b, c, alpha=-1.0, beta=1.0, trans_b=trans_b)
    before = launch_counts()["tile_matmul"]
    got = c.clone()
    tm.tile_matmul(a, b, got, alpha=-1.0, beta=1.0, trans_b=trans_b, out=got)
    torch.cuda.synchronize()
    assert launch_counts()["tile_matmul"] == before + 1
    if dtype == "float64":
        err = (got - expect).abs().max() / expect.abs().max()
        assert err.item() <= F64_RTOL
    else:
        torch.testing.assert_close(got.float(), expect.float(), **TOL[dtype])


def test_cuda_tensor_with_unbuildable_kernel_raises(cuda, monkeypatch, tmp_path):
    """No fallback: when the kernel cannot be built, a CUDA call raises."""
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib, "NVCC_FLAGS",
                        cuda_lib.NVCC_FLAGS + ("--no-such-nvcc-flag",))
    monkeypatch.setattr(cuda_lib, "_libs", {})
    monkeypatch.setattr(tm, "_fn", None)
    a = torch.ones(8, 8, dtype=torch.float64, device=cuda)
    before = launch_counts()["tile_matmul"]
    with pytest.raises(cuda_lib.BuildError):
        tm.tile_matmul(a, a.clone())
    assert launch_counts()["tile_matmul"] == before


@pytest.mark.parametrize("nb,b", [(6, 32), (3, 192), (4, 50)])
def test_cholesky_on_card_launches_the_kernel_for_every_update(cuda, nb, b):
    a = random_spd(nb * b, seed=0)
    assert a.device.type == "cuda"                    # the default device
    store = to_tiles(a, b)
    before = launch_counts()["tile_matmul"]
    with repro_torch.Session(4, policy="hybrid") as s:
        s.run(build_cholesky_graph(nb, b, store=store))
    torch.cuda.synchronize()
    assert launch_counts()["tile_matmul"] - before == math.comb(nb + 1, 3)
    L = cholesky_extract(store)
    ref = torch.linalg.cholesky(a)
    assert ((L - ref).abs().max() / ref.abs().max()).item() <= 1e-10


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape)).to(device, dtype)


# the attention kernels keep p in float32 for p . V, as the plain versions
# and the Pallas kernels do (the reference's layers.decode_attention rounds
# p to the cache's type first, so bfloat16 is held against the plain
# versions, not against it): float32 meets tests/test_kernels.py's kernel
# tolerance.  bfloat16 outputs round once from float32 sums that differ only
# in order, so the two land at most one unit in the last place apart:
# 2**-7 |x| < 1e-2 |x|, with atol for the float32 sums' ~1e-6 near zero
# (chip_smoke.py's ATTN_TOL)
ATTN_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
            "bfloat16": dict(rtol=1e-2, atol=1e-4)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,S,d,length,window", [
    (1, 40, 8, 545, 128, 545, 0),       # the batch serving path's cache
    (1, 40, 8, 4096, 128, 4000, 0),
    (1, 40, 8, 1033, 128, 700, 64),     # sliding window
    (2, 4, 2, 200, 32, 137, 0),         # the reduced configs' head dim
    (1, 16, 8, 300, 256, 300, 100),     # gemma3's head dim
    (1, 40, 8, 545, 128, 0, 0),         # empty cache: zeros
])
def test_decode_attention_kernel_matches_plain_version(
        cuda, dtype, B, H, KV, S, d, length, window):
    rng = np.random.default_rng(11)
    dt = getattr(torch, dtype)
    q = _randn(rng, (B, H, d), dt, cuda)
    k = _randn(rng, (B, S, KV, d), dt, cuda)
    v = _randn(rng, (B, S, KV, d), dt, cuda)
    expect = decode_attention_ref(q, k, v, length, window=window)
    before = launch_counts()["decode_attention"]
    got = decode_attention(q, k, v, length, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["decode_attention"] == before + 1
    assert got.shape == (B, H, d) and got.dtype == dt
    torch.testing.assert_close(got.float(), expect.float(), **ATTN_TOL[dtype])
    if length == 0:
        assert not got.any()
    again = decode_attention(q, k, v, length, window=window)
    assert torch.equal(got, again)              # no atomics: same bits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,S,d,causal,window", [
    (1, 40, 8, 512, 128, True, 0),      # the batch serving path's prompt
    (1, 40, 8, 500, 128, True, 0),      # ragged edge
    (1, 40, 8, 512, 128, True, 64),     # sliding window
    (2, 4, 2, 200, 32, True, 0),
    (1, 4, 4, 130, 64, False, 0),
    (1, 16, 8, 257, 256, True, 100),
])
def test_flash_attention_kernel_matches_plain_version(
        cuda, dtype, B, H, KV, S, d, causal, window):
    rng = np.random.default_rng(12)
    dt = getattr(torch, dtype)
    q = _randn(rng, (B, H, S, d), dt, cuda)
    k = _randn(rng, (B, KV, S, d), dt, cuda)
    v = _randn(rng, (B, KV, S, d), dt, cuda)
    expect = flash_attention_ref(q, k, v, causal=causal, window=window)
    before = launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    assert got.shape == (B, H, S, d) and got.dtype == dt
    torch.testing.assert_close(got.float(), expect.float(), **ATTN_TOL[dtype])
    # strided views of (B, S, heads, d) projections, as prefill passes them
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)
    vt = v.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(flash_attention(qt, kt, vt, causal=causal,
                                       window=window), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_model_serves_on_card_graph_equals_plain_loop(cuda, dtype):
    """qwen3-14b's reduced config cut to 2 layers, made on the card: the
    decode-step graphs on ``Session(2)`` give the plain loop's tokens bit
    for bit, and each attention kernel launches once per layer per prefill
    or lane-step, never on the other path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import (build_decode_graph, decode_step,
                                    greedy_sample, init_params,
                                    make_decode_state, prefill)

    cfg = get_config("qwen3-14b").reduced(n_layers=2, dtype=dtype)
    model = init_params(cfg, seed=0)
    assert model.device.type == "cuda"                # the default device
    lanes, prompt, steps = 3, 70, 6
    max_len = prompt + steps + 1
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (lanes, prompt), dtype=np.int32)

    reset_launch_counts()
    state = make_decode_state(model, cfg, {"tokens": prompts}, n_shards=lanes,
                              max_len=max_len)
    assert launch_counts() == {"tile_matmul": 0, "flash_attention": 2 * lanes,
                               "decode_attention": 0}
    reset_launch_counts()
    with repro_torch.Session(2) as s:
        for _ in range(steps - 1):
            s.run(build_decode_graph(
                state, lambda p, c, t: decode_step(p, cfg, c, t)))
    torch.cuda.synchronize()
    assert launch_counts() == {"tile_matmul": 0, "flash_attention": 0,
                               "decode_attention": 2 * lanes * (steps - 1)}
    assert all(torch.isfinite(sh.logits).all() for sh in state.shards)

    loop = []
    for b in range(lanes):
        cache, logits = prefill(model, cfg, {"tokens": prompts[b:b + 1]},
                                max_len=max_len)
        tok = greedy_sample(logits)
        toks = [tok]
        for _ in range(steps - 1):
            cache, logits = decode_step(model, cfg, cache, tok)
            tok = greedy_sample(logits)
            toks.append(tok)
        loop.append(torch.cat(toks, 1))
    assert state.tokens().shape == (lanes, steps)
    assert torch.equal(state.tokens(), torch.cat(loop, 0))
