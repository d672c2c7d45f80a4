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
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import (decode_attention_ref, flash_attention_ref,
                                     ssd_scan_ref, tile_matmul_ref)
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
    # the DMMA kernel's edges: both layouts at the Cholesky tile, shallow
    # and ragged K (one or several 16-deep slices, 1-8 splits), tiles below
    # one 32 x 32 block
    ("float64", 192, 192, 192, False),
    ("float64", 192, 192, 1, True),
    ("float64", 192, 192, 3, False),
    ("float64", 192, 192, 17, True),
    ("float64", 192, 192, 72, False),
    ("float64", 20, 192, 72, True),
    ("float64", 192, 9, 17, False),
    ("float64", 5, 7, 3, True),
    ("float64", 64, 64, 4096, True),
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
    again = c.clone()
    tm.tile_matmul(a, b, again, alpha=-1.0, beta=1.0, trans_b=trans_b,
                   out=again)
    assert torch.equal(got, again)      # K splits merged in a fixed order


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


@pytest.mark.parametrize("M,N,K,with_c", [
    (192, 192, 7680, False),   # QR's W = V^T A at its tallest
    (192, 192, 3840, False),
    (7680, 192, 192, True),    # QR's A - V Y
])
def test_qr_tall_gemm_shapes_match_plain_version(cuda, M, N, K, with_c):
    rng = np.random.default_rng(11)
    a = _randn(rng, (M, K), torch.float64, cuda)
    b = _randn(rng, (K, N), torch.float64, cuda)
    c = _randn(rng, (M, N), torch.float64, cuda) if with_c else None
    kw = dict(alpha=-1.0, beta=1.0) if with_c else {}
    expect = tile_matmul_ref(a, b, c, **kw)
    runs = []
    for _ in range(2):
        if with_c:
            got = c.clone()
            tm.tile_matmul(a, b, got, out=got, **kw)
        else:
            got = tm.tile_matmul(a, b)
        runs.append(got)
    torch.cuda.synchronize()
    err = ((runs[0] - expect).abs().max() / expect.abs().max()).item()
    assert err <= F64_RTOL
    assert torch.equal(runs[0], runs[1])


def _panel_matrix(kernel, n, device):
    from repro_torch.linalg import random_diagdom
    if kernel == "lu":
        return random_diagdom(n, seed=0, device=device)
    return torch.from_numpy(
        np.random.default_rng(0).standard_normal((n, n))).to(device)


@pytest.mark.parametrize("kernel", ["lu", "qr"])
def test_lu_qr_on_card_match_the_cpu_run(cuda, kernel):
    """nb = 6: the card's factors (tile GEMM kernel) against the same run
    on the CPU (its plain version), and the exact launch count."""
    from repro_torch.linalg import KERNELS, qr_reconstruct
    from repro_torch.linalg.qr import COL_UPDATE_LAUNCHES

    nb, b = 6, 32
    outs = {}
    for device in ("cpu", "cuda"):
        a = _panel_matrix(kernel, nb * b, device)
        store = to_tiles(a, b, device=device)
        before = launch_counts()["tile_matmul"]
        with repro_torch.Session(4, policy="hybrid") as s:
            report = s.run(KERNELS[kernel](nb, b, store=store,
                                           panel_threads=3))
        if device == "cuda":
            torch.cuda.synchronize()
        launched = launch_counts()["tile_matmul"] - before
        assert report.stats["gang_regions"] == nb
        packed = store.assemble()
        if kernel == "qr":
            packed = torch.cat([packed, qr_reconstruct(store)])
        outs[device] = (packed.cpu(), launched)
    want = (sum(m * m for m in range(1, nb)) if kernel == "lu"
            else COL_UPDATE_LAUNCHES * math.comb(nb, 2))
    assert outs["cpu"][1] == 0 and outs["cuda"][1] == want
    ref = outs["cpu"][0]
    assert ((outs["cuda"][0] - ref).abs().max() / ref.abs().max()).item() <= 1e-10


def test_replay_on_card_is_bit_identical(cuda):
    """A recorded LU run with gang panels and a pool's Cholesky serves on
    the card: replays give the dynamic run's bits."""
    from repro_torch.linalg import build_lu_graph, lu_extract
    from repro_torch.replay import replay_graph

    nb, b = 6, 32
    a = _panel_matrix("lu", nb * b, "cuda")
    st = to_tiles(a, b)
    with repro_torch.Session(4, record=True) as s:
        rec = s.run(build_lu_graph(nb, b, store=st, panel_threads=3)).recording
    st2 = to_tiles(a, b)
    replay_graph(build_lu_graph(nb, b, store=st2, panel_threads=3), rec)
    torch.cuda.synchronize()
    assert torch.equal(lu_extract(st)[1], lu_extract(st2)[1])
    assert torch.equal(lu_extract(st)[0], lu_extract(st2)[0])

    spd = random_spd(nb * b, seed=0)
    outs, modes = [], []
    with repro_torch.Session(4, scheduler="pool") as s:
        for _ in range(3):
            store = to_tiles(spd, b)
            modes.append(s.run(build_cholesky_graph(nb, b, store=store))
                         .stats["pool_mode"])
            outs.append(cholesky_extract(store))
    torch.cuda.synchronize()
    assert modes == ["warmup", "record", "replay"]
    assert all(torch.equal(o, outs[0]) for o in outs)


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape)).to(device, dtype)


# the decode kernel keeps p in float32 for p . V, as the plain versions and
# the Pallas kernels do (the reference's layers.decode_attention rounds p to
# the cache's type first, so bfloat16 is held against the plain versions,
# not against it): float32 meets tests/test_kernels.py's kernel tolerance.
# bfloat16 outputs round once from float32 sums that differ only in order,
# so the two land at most one unit in the last place apart: 2**-7 |x| <
# 1e-2 |x|, with atol for the float32 sums' ~1e-6 near zero (chip_smoke.py's
# ATTN_TOL).  The float32 prefill kernel is held to the same.
ATTN_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
            "bfloat16": dict(rtol=1e-2, atol=1e-4)}
# the bfloat16 prefill kernel rounds p to bfloat16 for p . V on the tensor
# cores (as the reference's layers._chunked_attn does): with each p_j off by
# at most u = 2**-8 relative, the output moves by at most u * sum_j p_j |v_j|
# / l, u times the attention of |v|, on top of ATTN_TOL's one ulp
# (chip_smoke.py's FLASH_P_ROUND; planted faults fail it, see
# kernel_faults.py)
FLASH_P_ROUND = 2.0 ** -8


def _assert_flash_close(got, q, k, v, *, causal, window):
    """The prefill kernel against its plain version: ATTN_TOL, plus the
    allowance for rounding p in bfloat16."""
    expect = flash_attention_ref(q, k, v, causal=causal,
                                 window=window).float()
    t = ATTN_TOL[str(q.dtype).split(".")[-1]]
    limit = t["atol"] + t["rtol"] * expect.abs()
    if q.dtype == torch.bfloat16:
        limit = limit + FLASH_P_ROUND * flash_attention_ref(
            q.float(), k.float(), v.float().abs(), causal=causal,
            window=window)
    diff = (got.float() - expect).abs()
    assert (diff <= limit).all(), (diff / limit).max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,S,d,length,window", [
    (1, 40, 8, 545, 128, 545, 0),       # the batch serving path's cache
    (1, 40, 8, 4096, 128, 4000, 0),
    (1, 40, 8, 1033, 128, 700, 64),     # sliding window
    (2, 4, 2, 200, 32, 137, 0),         # the reduced configs' head dim
    (1, 16, 8, 300, 256, 300, 100),     # gemma3's head dim
    (1, 40, 8, 545, 128, 0, 0),         # empty cache: zeros
    (1, 32, 32, 545, 112, 545, 0),      # zamba2's shared block: MHA, d = 112
    (1, 40, 8, 545, 128, 3, 0),         # fewer keys than splits
    (3, 8, 1, 100, 64, 5, 0),           # fewer keys than splits, B = 3
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
    (1, 32, 32, 512, 112, True, 0),     # zamba2's shared block: MHA, d = 112
])
def test_flash_attention_kernel_matches_plain_version(
        cuda, dtype, B, H, KV, S, d, causal, window):
    rng = np.random.default_rng(12)
    dt = getattr(torch, dtype)
    q = _randn(rng, (B, H, S, d), dt, cuda)
    k = _randn(rng, (B, KV, S, d), dt, cuda)
    v = _randn(rng, (B, KV, S, d), dt, cuda)
    before = launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    assert got.shape == (B, H, S, d) and got.dtype == dt
    _assert_flash_close(got, q, k, v, causal=causal, window=window)
    # no atomics: the same bits again
    assert torch.equal(flash_attention(q, k, v, causal=causal,
                                       window=window), got)
    # strided views of (B, S, heads, d) projections, as prefill passes them
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)
    vt = v.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(flash_attention(qt, kt, vt, causal=causal,
                                       window=window), got)


def _needles(rng, B, H, KV, S, d, offset, dtype, device):
    """Inputs where, in every row i >= offset, key i - offset carries
    nearly all the weight (chip_smoke.py's needle_arrays): the query heads
    of a KV group share a row u_i and key j is 2 u_{j + offset}."""
    u = rng.standard_normal((B, KV, S + offset, d))
    q = np.repeat(u[:, :, :S], H // KV, axis=1)
    v = rng.standard_normal((B, KV, S, d))
    return [torch.from_numpy(x).to(device, dtype)
            for x in (q, 2.0 * u[:, :, offset:], v)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,offset", [
    (512, 0, 0),        # the needle on the causal diagonal
    (512, 64, 63),      # on the window's oldest key
    (500, 0, 0),        # on the diagonal, the ragged last key among them
])
def test_flash_attention_holds_needles_on_masked_edge_keys(cuda, dtype, S,
                                                           window, offset):
    """A key on a mask's edge that carries a row's weight: dropping it
    moves the output by about |v|, far above the bfloat16 limit."""
    q, k, v = _needles(np.random.default_rng(21), 1, 40, 8, S, 128, offset,
                       getattr(torch, dtype), cuda)
    got = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    _assert_flash_close(got, q, k, v, causal=True, window=window)
    # the needle dominates: its row's output is its own value row
    rows = torch.arange(offset, S, device=cuda)
    near = (got[0, 0, rows].float() - v[0, 0, rows - offset].float()).abs()
    assert near.max().item() < 0.25


def test_flash_attention_head_dim_112_reads_no_column_past_d(cuda):
    """zamba2's d = 112 runs as 128: the tensor map's d extent is 112, so TMA
    fills columns 112..127 with zeros; NaN stored there in a wider buffer
    must not reach the output."""
    rng = np.random.default_rng(22)
    wide = [_randn(rng, (1, 32, 512, 128), torch.bfloat16, cuda)
            for _ in range(3)]
    for w in wide:
        w[..., 112:] = float("nan")
    q, k, v = (w[..., :112] for w in wide)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal=True))
    _assert_flash_close(got, q, k, v, causal=True, window=0)


def test_attention_wrappers_refuse_misaligned_strides(cuda):
    """TMA and bulk copies read the tensors in place: a stride or a base
    that is not a multiple of 16 bytes is refused with the reason, never
    copied."""
    rng = np.random.default_rng(23)
    q = _randn(rng, (1, 4, 64, 64 + 4), torch.bfloat16, cuda)[..., :64]
    kv = _randn(rng, (1, 2, 64, 64), torch.bfloat16, cuda)
    before = launch_counts()
    with pytest.raises(ValueError, match="position stride of 68 elements"):
        flash_attention(q, kv, kv)
    off = _randn(rng, (1, 2, 64, 64 + 1), torch.bfloat16, cuda)[..., 1:]
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(q.contiguous(), off, off)
    cache = _randn(rng, (1, 100, 2, 64 + 4), torch.bfloat16, cuda)[..., :64]
    qd = _randn(rng, (1, 4, 64), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head stride of 68 elements"):
        decode_attention(qd, cache, cache, 10)
    assert launch_counts() == before


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
                               "decode_attention": 0, "ssd_scan": 0}
    reset_launch_counts()
    with repro_torch.Session(2) as s:
        for _ in range(steps - 1):
            s.run(build_decode_graph(
                state, lambda p, c, t: decode_step(p, cfg, c, t)))
    torch.cuda.synchronize()
    assert launch_counts() == {"tile_matmul": 0, "flash_attention": 0,
                               "decode_attention": 2 * lanes * (steps - 1),
                               "ssd_scan": 0}
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


# the SSD scan: float32 sums in another order than the plain version's;
# bfloat16 y rounds once from such sums (one unit in the last place at
# most, as ATTN_TOL); chip_smoke.py's SSD_TOL
SSD_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
           "bfloat16": dict(rtol=1e-2, atol=1e-4)}


def _ssd_inputs(B, T, H, N, P, chunk, dtype, device, seed):
    """The kernel's inputs made as an SSM layer makes them: silu'd x, B
    and C, step sizes softplus(N(0, 0.8)) ~ 0.75 and a = -1, so cs falls to
    about -95 across a 128-step chunk; laid out and padded by the model's
    own ``ssd_scan_inputs``."""
    from repro_torch.models.ssm import ssd_scan_inputs

    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(device)

    silu = torch.nn.functional.silu
    xs = silu(t(rng.standard_normal((B, T, H, P))))
    dt = torch.nn.functional.softplus(t(0.8 * rng.standard_normal((B, T, H))))
    Bm = silu(t(rng.standard_normal((B, T, N))))
    Cm = silu(t(rng.standard_normal((B, T, N))))
    a = -torch.ones(H, device=device)
    xdt, cs, Bm, Cm = ssd_scan_inputs(xs, dt, a, Bm, Cm, chunk=chunk)
    return xdt.to(dtype), cs, Bm.to(dtype), Cm.to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,N,P,chunk", [
    (1, 512, 112, 64, 64, 128),         # zamba2-7b's prefill
    (1, 512, 80, 128, 64, 128),         # mamba2-2.7b's
    (1, 300, 112, 64, 64, 128),         # ragged: the last chunk padded
    (2, 512, 112, 64, 64, 128),
    (1, 100, 112, 64, 64, 128),         # one short chunk, L = T = 100
    (2, 80, 8, 16, 32, 32),             # the reduced configs
    (1, 4096, 112, 64, 64, 128),        # 32 chunks in the state recurrence
])
def test_ssd_scan_kernel_matches_plain_version(cuda, dtype, B, T, H, N, P,
                                               chunk):
    dt = getattr(torch, dtype)
    xdt, cs, Bm, Cm = _ssd_inputs(B, T, H, N, P, chunk, dt, cuda, seed=13)
    if chunk == 128:              # the decay that overflows above the diagonal
        assert cs.min().item() < -50
    ey, es = ssd_scan_ref(xdt, cs, Bm, Cm)
    before = launch_counts()["ssd_scan"]
    y, s = ss.ssd_scan(xdt, cs, Bm, Cm)
    torch.cuda.synchronize()
    assert launch_counts()["ssd_scan"] == before + 1
    assert y.shape == xdt.shape and y.dtype == dt
    assert s.shape == (B, H, N, P) and s.dtype == torch.float32
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y.float(), ey.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(s, es, **SSD_TOL["float32"])
    y2, s2 = ss.ssd_scan(xdt, cs, Bm, Cm)
    assert torch.equal(y, y2) and torch.equal(s, s2)   # no atomics: same bits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_batch_rows_equal_their_scans_alone(cuda, dtype):
    """Batch invariance: row b of a B = 2 scan is the B = 1 scan of that
    row bit for bit (the engine serves a request in a batch with the bits
    it gets alone)."""
    dt = getattr(torch, dtype)
    xdt, cs, Bm, Cm = _ssd_inputs(2, 512, 112, 64, 64, 128, dt, cuda,
                                  seed=21)
    y, s = ss.ssd_scan(xdt, cs, Bm, Cm)
    for b in range(2):
        yb, sb = ss.ssd_scan(*(t[b:b + 1].contiguous()
                               for t in (xdt, cs, Bm, Cm)))
        assert torch.equal(yb, y[b:b + 1]) and torch.equal(sb, s[b:b + 1])


def test_ssd_scan_refuses_what_the_kernel_does_not_take(cuda):
    xdt, cs, Bm, Cm = _ssd_inputs(1, 64, 2, 16, 32, 64, torch.float32, cuda,
                                  seed=0)
    with pytest.raises(ValueError, match="head dim P"):
        ss.ssd_scan(xdt[..., :16].contiguous(), cs, Bm, Cm)
    big = _ssd_inputs(1, 256, 2, 128, 64, 256, torch.float32, cuda, seed=0)
    with pytest.raises(ValueError, match="shared memory"):
        ss.ssd_scan(*big)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssd_scan(xdt.transpose(3, 4).contiguous().transpose(3, 4), cs,
                    Bm, Cm)


def test_ssd_scan_with_unbuildable_kernel_raises(cuda, monkeypatch, tmp_path):
    """No fallback: when the kernel cannot be built, a CUDA call raises."""
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib, "NVCC_FLAGS",
                        cuda_lib.NVCC_FLAGS + ("--no-such-nvcc-flag",))
    monkeypatch.setattr(cuda_lib, "_libs", {})
    monkeypatch.setattr(ss, "_fn", None)
    xdt, cs, Bm, Cm = _ssd_inputs(1, 64, 2, 16, 32, 64, torch.float32, cuda,
                                  seed=0)
    before = launch_counts()["ssd_scan"]
    with pytest.raises(cuda_lib.BuildError):
        ss.ssd_scan(xdt, cs, Bm, Cm)
    assert launch_counts()["ssd_scan"] == before


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_reduced_ssm_model_serves_on_card_graph_equals_plain_loop(cuda, arch):
    """The reduced mamba2-2.7b and zamba2-7b made on the card: the
    decode-step graphs on ``Session(2)`` give the plain loop's tokens bit
    for bit; every SSM layer's prefill launches the scan kernel once, and
    zamba2's shared block each attention kernel once per use."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import (build_decode_graph, decode_step,
                                    greedy_sample, init_params,
                                    make_decode_state, prefill)
    from repro_torch.models.lm import layer_flags

    cfg = get_config(arch).reduced(dtype="bfloat16")
    uses = sum(layer_flags(cfg).get("use_attn", []))
    model = init_params(cfg, seed=0)
    assert model.device.type == "cuda"                # the default device
    lanes, prompt, steps = 3, 70, 6
    max_len = prompt + steps + 1
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (lanes, prompt), dtype=np.int32)

    reset_launch_counts()
    state = make_decode_state(model, cfg, {"tokens": prompts}, n_shards=lanes,
                              max_len=max_len)
    assert launch_counts() == {"tile_matmul": 0,
                               "flash_attention": uses * lanes,
                               "decode_attention": 0,
                               "ssd_scan": cfg.n_layers * lanes}
    reset_launch_counts()
    with repro_torch.Session(2) as s:
        for _ in range(steps - 1):
            s.run(build_decode_graph(
                state, lambda p, c, t: decode_step(p, cfg, c, t)))
    torch.cuda.synchronize()
    assert launch_counts() == {"tile_matmul": 0, "flash_attention": 0,
                               "decode_attention": uses * lanes * (steps - 1),
                               "ssd_scan": 0}
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
    assert torch.equal(state.tokens(), torch.cat(loop, 0))


# ---------------------------------------------------------------------------
# compiled plans: fused segments captured as CUDA graphs
# ---------------------------------------------------------------------------
def _factors(kernel, store):
    """Everything a factorization leaves behind, flat (QR: with every
    panel's reflectors)."""
    parts = [store.assemble().flatten()]
    if kernel == "qr":
        parts += [x.flatten() for k in range(store.nb)
                  for x in store.vt_store[k]]
    return torch.cat(parts)


def _build(kernel, nb, b, store):
    from repro_torch.linalg import KERNELS
    kw = {} if kernel == "cholesky" else dict(panel_threads=3)
    return KERNELS[kernel](nb, b, store=store, **kw)


def _matrix(kernel, n, device, seed=0):
    if kernel == "cholesky":
        return random_spd(n, seed=seed, device=device)
    return _panel_matrix(kernel, n, device) if seed == 0 else \
        _panel_matrix(kernel, n, device) + seed * torch.eye(n, device=device,
                                                            dtype=torch.float64)


def _expected_launches(kernel, nb):
    from repro_torch.linalg.qr import COL_UPDATE_LAUNCHES
    if kernel == "cholesky":
        return math.comb(nb + 1, 3)
    if kernel == "lu":
        return sum(m * m for m in range(1, nb))
    return COL_UPDATE_LAUNCHES * math.comb(nb, 2)


@pytest.mark.parametrize("kernel", ["cholesky", "lu", "qr"])
def test_compiled_on_card_equals_dynamic_with_exact_launches(cuda, kernel):
    """nb = 6: record, then capture-and-replay, then replay only; every
    compiled run's factors equal the dynamic run's bit for bit, every
    captured graph's launches are counted at each replay, and the factors
    agree with the CPU run."""
    from repro_torch.replay import GraphCache

    nb, b = 6, 32
    a = _matrix(kernel, nb * b, cuda)
    want = _expected_launches(kernel, nb)
    with repro_torch.Session(4) as s:
        store = to_tiles(a, b)
        s.run(_build(kernel, nb, b, store))
    dynamic = _factors(kernel, store)
    cpu_store = to_tiles(a.cpu(), b, device="cpu")
    with repro_torch.Session(4) as s:
        s.run(_build(kernel, nb, b, cpu_store))
    cpu = _factors(kernel, cpu_store)
    modes = []
    with repro_torch.Session(4, scheduler="compiled",
                             cache=GraphCache()) as s:
        for run in range(4):
            store = to_tiles(a, b)
            torch.cuda.synchronize()
            before = launch_counts()["tile_matmul"]
            report = s.run(_build(kernel, nb, b, store))
            torch.cuda.synchronize()
            modes.append(report.plan.mode)
            assert launch_counts()["tile_matmul"] - before == want
            assert "compiled_fallback" not in report.stats
            assert torch.equal(_factors(kernel, store), dynamic)
            if run:
                ex = s._compiled[report.recording.digest]
                assert report.stats["captured_graphs"] == \
                    ex.plan.meta.jit_segments > 0
                assert report.stats["graphs_captured_this_run"] == \
                    (ex.plan.meta.jit_segments if run == 1 else 0)
    assert modes == ["record", "compiled", "compiled", "compiled"]
    rel = ((dynamic.cpu() - cpu).abs().max() / cpu.abs().max()).item()
    assert rel <= 1e-10


@pytest.mark.parametrize("kernel", ["cholesky", "qr"])
def test_compiled_run_leaves_no_factor_aliasing_the_graphs(cuda, kernel):
    """A later compiled run on another matrix replays the same graphs; the
    earlier run's factors stay as they were."""
    from repro_torch.replay import GraphCache

    nb, b = 6, 32
    first, second = _matrix(kernel, nb * b, cuda), \
        _matrix(kernel, nb * b, cuda, seed=3)
    with repro_torch.Session(4, scheduler="compiled",
                             cache=GraphCache()) as s:
        s.run(_build(kernel, nb, b, to_tiles(first, b)))       # records
        s.run(_build(kernel, nb, b, to_tiles(first, b)))       # captures
        kept = to_tiles(first, b)
        s.run(_build(kernel, nb, b, kept))
        torch.cuda.synchronize()
        snapshot = _factors(kernel, kept).clone()
        other = to_tiles(second, b)
        report = s.run(_build(kernel, nb, b, other))
        torch.cuda.synchronize()
    assert report.plan.mode == "compiled"
    assert torch.equal(_factors(kernel, kept), snapshot)
    assert not torch.equal(_factors(kernel, other), snapshot)


def test_compiled_qr_stages_the_panel_reflectors(cuda):
    """QR's column updates read ``("vt", k)``, a tuple every panel uploads
    afresh: its captured segments stage it into buffers of their own."""
    from repro_torch.replay import GraphCache

    nb, b = 6, 32
    a = _matrix("qr", nb * b, cuda)
    with repro_torch.Session(4, scheduler="compiled",
                             cache=GraphCache()) as s:
        s.run(_build("qr", nb, b, to_tiles(a, b)))
        report = s.run(_build("qr", nb, b, to_tiles(a, b)))
        ex = s._compiled[report.recording.digest]
    graphs = [e[1].graph for e in ex.plan.program
              if e[0] == "fused" and e[1].graph is not None]
    staged = [k for g in graphs for k in g.staged_keys]
    assert staged and all(k[0] == "vt" for k in staged)
    direct = [k for g in graphs for k, _ in g.direct]
    assert direct and all(k[0] != "vt" for k in direct)


def test_capture_runs_while_another_thread_uses_the_card(cuda):
    """Captures use ``capture_error_mode="thread_local"``: another thread
    allocating and launching on the card meanwhile neither breaks a capture
    nor changes the factor."""
    import threading

    from repro_torch.replay import GraphCache

    nb, b = 6, 32
    a = _matrix("cholesky", nb * b, cuda)
    with repro_torch.Session(4) as s:
        store = to_tiles(a, b)
        s.run(_build("cholesky", nb, b, store))
    dynamic = _factors("cholesky", store)
    stop = threading.Event()
    errors = []

    def busy():
        keep, x = [], torch.ones(1 << 16, device=cuda)
        try:
            while not stop.is_set():
                x = x * 1.0000001
                keep.append(torch.empty((len(keep) + 1) << 20,
                                        dtype=torch.uint8, device=cuda))
        except Exception as e:      # noqa: BLE001 - asserted below
            errors.append(e)

    with repro_torch.Session(4, scheduler="compiled",
                             cache=GraphCache()) as s:
        s.run(_build("cholesky", nb, b, to_tiles(a, b)))
        th = threading.Thread(target=busy)
        th.start()
        try:
            store = to_tiles(a, b)
            report = s.run(_build("cholesky", nb, b, store))
        finally:
            stop.set()
            th.join()
    torch.cuda.synchronize()
    assert not errors
    assert report.stats["graphs_captured_this_run"] > 0
    assert torch.equal(_factors("cholesky", store), dynamic)
