"""The port's tile GEMM against the reference package.

On the CPU the wrapper runs its plain version (``tile_matmul_ref``); it is
held against the reference oracle (``repro.kernels.ref.tile_matmul_ref``),
against the Pallas kernel in interpret mode, and, in float64, against the
reference factorization's ``tiles.tile_gemm_sub``.  The CUDA kernel itself
is checked on the card by ``tests/test_torch_cuda.py``.
Inputs come from ``numpy.random.default_rng(seed)`` and reach both
packages as numpy arrays.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.linalg import tiles as jax_tiles
from repro_torch.kernels import cuda_lib, launch_counts
from repro_torch.kernels import ops, tile_matmul as tm
from repro_torch.kernels.ref import tile_matmul_ref
from repro_torch.linalg import tiles

# tests/test_kernels.py's TOL table, keyed by name
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# tests/test_kernels.py's tile-matmul shapes: M, K, N and the Pallas blocks
SHAPES = [(256, 256, 256, 128, 128, 128), (512, 256, 128, 256, 128, 256)]
# float64 trailing update: error relative to the largest |entry| of the
# result (a dot product of length K rounds at ~K * 1e-16 of its terms)
F64_RTOL = 1e-12


def _pair(x: np.ndarray, dtype: str):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    return t, j


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,bm,bn,bk", SHAPES)
def test_tile_matmul_ref_matches_reference_oracle(M, K, N, bm, bn, bk, dtype):
    rng = np.random.default_rng(2)
    a, ja = _pair(rng.standard_normal((M, K), np.float32), dtype)
    b, jb = _pair(rng.standard_normal((K, N), np.float32), dtype)
    out = ops.tile_matmul(a, b)
    assert out.dtype == a.dtype and out.shape == (M, N)
    np.testing.assert_allclose(_np32(out), _np32(jax_ref.tile_matmul_ref(ja, jb)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,bm,bn,bk", SHAPES)
def test_tile_matmul_ref_matches_pallas_interpret(M, K, N, bm, bn, bk, dtype):
    rng = np.random.default_rng(3)
    a, ja = _pair(rng.standard_normal((M, K), np.float32), dtype)
    b, jb = _pair(rng.standard_normal((K, N), np.float32), dtype)
    pallas = jax_ops.tile_matmul(ja, jb, mode="interpret", bm=bm, bn=bn, bk=bk)
    np.testing.assert_allclose(_np32(tile_matmul_ref(a, b)), _np32(pallas),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_matmul_plus_c_matches_reference_oracle(dtype):
    rng = np.random.default_rng(4)
    a, ja = _pair(rng.standard_normal((96, 64), np.float32), dtype)
    b, jb = _pair(rng.standard_normal((64, 80), np.float32), dtype)
    c, jc = _pair(rng.standard_normal((96, 80), np.float32), dtype)
    np.testing.assert_allclose(_np32(ops.tile_matmul(a, b, c)),
                               _np32(jax_ref.tile_matmul_ref(ja, jb, jc)),
                               **TOL[dtype])


@pytest.mark.parametrize("fn", ["tile_gemm_sub", "tile_gemm_nn_sub"])
@pytest.mark.parametrize("M,N,K", [(48, 48, 48), (50, 34, 18)],
                         ids=["b48", "ragged"])
def test_tile_gemm_float64_matches_reference(M, N, K, fn):
    """C - A B^T (Cholesky) and C - A B (LU) against the reference's tile
    kernels of the same name, in float64."""
    rng = np.random.default_rng(5)
    b_shape = (N, K) if fn == "tile_gemm_sub" else (K, N)
    c, a, b = (rng.standard_normal(s) for s in ((M, N), (M, K), b_shape))
    with jax.enable_x64(True):
        expect = np.asarray(getattr(jax_tiles, fn)(
            jnp.asarray(c, jnp.float64), jnp.asarray(a, jnp.float64),
            jnp.asarray(b, jnp.float64)))
    assert expect.dtype == np.float64
    tc = torch.from_numpy(c.copy())
    got = getattr(tiles, fn)(tc, torch.from_numpy(a), torch.from_numpy(b))
    assert got is tc and got.dtype == torch.float64       # written in place
    np.testing.assert_allclose(got.numpy(), expect, rtol=F64_RTOL,
                               atol=F64_RTOL * np.abs(expect).max())


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(6)
    a, b, c = (torch.from_numpy(rng.standard_normal(s)) for s in
               ((24, 16), (20, 16), (24, 20)))
    before = launch_counts()["tile_matmul"]
    expect = tile_matmul_ref(a, b, c, alpha=-0.5, beta=2.0, trans_b=True)
    out = torch.empty(24, 20, dtype=torch.float64)
    got = tm.tile_matmul(a, b, c, alpha=-0.5, beta=2.0, trans_b=True, out=out)
    assert got is out
    torch.testing.assert_close(got, 2.0 * c - 0.5 * a @ b.T, rtol=1e-13, atol=1e-13)
    assert torch.equal(got, expect)
    assert launch_counts()["tile_matmul"] == before


@pytest.mark.parametrize("case", ["dtype_mismatch", "inner_dim", "c_shape",
                                  "non_contiguous", "int_dtype", "out_is_a"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    a = torch.ones(8, 4, dtype=torch.float64)
    b = torch.ones(4, 6, dtype=torch.float64)
    kw = {}
    if case == "dtype_mismatch":
        b = b.float()
    elif case == "inner_dim":
        b = torch.ones(5, 6, dtype=torch.float64)
    elif case == "c_shape":
        kw = dict(c=torch.ones(8, 5, dtype=torch.float64))
    elif case == "non_contiguous":
        b = torch.ones(6, 4, dtype=torch.float64).T
    elif case == "int_dtype":
        a, b = a.long(), b.long()
    elif case == "out_is_a":
        a = torch.ones(6, 6, dtype=torch.float64)
        b = torch.ones(6, 6, dtype=torch.float64)
        kw = dict(out=a)
    with pytest.raises((ValueError, TypeError)):
        tm.tile_matmul(a, b, **kw)


def test_launch_counter_loses_no_update_across_threads():
    """Worker threads launch concurrently; the count must stay exact."""
    counter = cuda_lib.LaunchCounter("stress")
    n_threads, per_thread = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [counter.add() for _ in range(per_thread)])
            for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert counter.count == n_threads * per_thread
    counter.reset()
    assert counter.count == 0


def test_library_path_changes_when_a_shared_header_changes(tmp_path,
                                                           monkeypatch):
    """A kernel is rebuilt when its source, any csrc/*.cuh header or the
    flags change: each is folded into the library's name."""
    monkeypatch.setattr(cuda_lib, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = cuda_lib.library_path("k")
    assert cuda_lib.library_path("k") == first           # stable
    (tmp_path / "h.cuh").write_text("// two\n")
    edited = cuda_lib.library_path("k")
    assert edited != first
    (tmp_path / "g.cuh").write_text("// new\n")
    added = cuda_lib.library_path("k")
    assert added not in (first, edited)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// more\n')
    source = cuda_lib.library_path("k")
    assert source not in (first, edited, added)
    monkeypatch.setattr(cuda_lib, "NVCC_FLAGS",
                        cuda_lib.NVCC_FLAGS + ("-DX",))
    assert cuda_lib.library_path("k") not in (first, edited, added, source)


# the float64 kernel's K plan: gemm_splits(M, N, K)
@pytest.mark.parametrize("M,N,K", [(192, 192, 192), (200, 136, 72),
                                   (33, 65, 17), (192, 192, 1), (192, 192, 3),
                                   (20, 9, 72), (1, 1, 1), (32, 32, 4096),
                                   (7680, 192, 192), (256, 256, 256)])
def test_gemm_splits_cover_every_k_slice_once(M, N, K):
    splits, per = tm.gemm_splits(M, N, K)
    slices = -(-K // tm.K_SLICE)
    assert 1 <= splits <= min(tm.MAX_SPLITS, slices) and per >= 1
    covered = [s for z in range(splits)
               for s in range(z * per, min((z + 1) * per, slices))]
    assert covered == list(range(slices))            # each slice once, in order
    assert (splits - 1) * per < slices               # no split is empty
    tiles = -(-M // tm.BLOCK) * -(-N // tm.BLOCK)
    assert splits == 1 or tiles * splits <= tm.TARGET_BLOCKS
    assert tm.gemm_splits(M, N, K) == (splits, per)  # a function of the shape


def test_gemm_splits_fill_the_card_at_the_cholesky_tile():
    """192^3: 36 output blocks, 12 slices, 4 splits of 3 -> 144 blocks."""
    assert tm.gemm_splits(192, 192, 192) == (4, 3)
    assert tm.gemm_splits(200, 136, 72) == (3, 2)


@pytest.mark.parametrize("M,N,K", [(0, 4, 4), (4, 0, 4), (4, 4, 0)])
def test_gemm_splits_refuse_an_empty_product(M, N, K):
    with pytest.raises(ValueError, match="empty product"):
        tm.gemm_splits(M, N, K)


def test_tile_matmul_refuses_inputs_that_require_grad():
    """No backward: with grad on, an input that requires grad raises before
    the device dispatch (the same on either device); under ``no_grad``, or
    with inputs that do not require grad, the call runs."""
    a = torch.ones(4, 3, requires_grad=True)
    b = torch.ones(3, 5)
    c = torch.ones(4, 5)
    for args in ((a, b, None), (a.detach(), b.requires_grad_(), None),
                 (a.detach(), b.detach(), c.requires_grad_())):
        with pytest.raises(RuntimeError, match="no backward"):
            tm.tile_matmul(*args)
        with torch.no_grad():
            assert tm.tile_matmul(*args).shape == (4, 5)
    assert tm.tile_matmul(a.detach(), b.detach()).shape == (4, 5)
