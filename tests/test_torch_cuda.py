"""The port's CUDA kernel and its main path on the card.

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
from repro_torch.kernels.ref import tile_matmul_ref
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
