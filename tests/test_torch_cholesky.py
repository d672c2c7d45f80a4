"""The port's tiled Cholesky through its work-stealing runtime, held against
the reference package's factorization of the same tiles.

The reference factors ``random_spd(192, seed=0)`` through ``repro.Session``
in float64.  Its task bodies run on worker threads, and JAX's scoped
``jax.enable_x64`` context is local to the thread that enters it, so the
reference run switches x64 on process-wide and restores the previous
setting afterwards.  The port factors copies of the very same tiles
(``from_numpy_tiles``) on the CPU, where the tile GEMM runs its plain
version.
"""

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.linalg import build_cholesky_graph as jax_build_cholesky
from repro.linalg import cholesky_extract as jax_cholesky_extract
from repro.linalg import random_spd as jax_random_spd
from repro.linalg import to_tiles as jax_to_tiles
from repro_torch.kernels import launch_counts
from repro_torch.linalg import (build_cholesky_graph, cholesky_extract,
                                from_numpy_tiles, random_spd, to_tiles)

N = 192
TILES = [48, 32]                       # nb = 4 and nb = 6
POLICIES = ["history", "random", "hybrid"]


@pytest.fixture(scope="module")
def reference():
    """{b: (A, the tiles before factoring, the reference package's L)}."""
    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        out = {}
        for b in TILES:
            a = jax_random_spd(N, seed=0)
            store = jax_to_tiles(a, b)
            tiles = {k: np.asarray(v) for k, v in store.tiles.items()}
            with repro.Session(4, policy="hybrid") as s:
                s.run(jax_build_cholesky(N // b, b, store=store))
            L = np.asarray(jax_cholesky_extract(store))
            assert L.dtype == np.float64
            out[b] = (np.array(a), tiles, L)
        return out
    finally:
        jax.config.update("jax_enable_x64", prev)


def _factor(tiles, b, *, workers=4, policy="hybrid"):
    store = from_numpy_tiles(tiles, N // b, b, device="cpu")
    graph = build_cholesky_graph(N // b, b, store=store)
    with repro_torch.Session(workers, policy=policy) as s:
        report = s.run(graph)
    assert len(report.results) == len(graph)
    return cholesky_extract(store)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("b", TILES)
def test_cholesky_matches_reference_package(reference, b, policy):
    a, tiles, L_ref = reference[b]
    before = launch_counts()["tile_matmul"]
    L = _factor(tiles, b, policy=policy)
    assert launch_counts()["tile_matmul"] == before    # CPU: plain version
    assert L.dtype == torch.float64 and L.shape == (N, N)
    np.testing.assert_allclose(L.numpy(), L_ref, rtol=1e-10, atol=1e-10)
    A = torch.from_numpy(a)
    resid = torch.linalg.matrix_norm(A - L @ L.T) / torch.linalg.matrix_norm(A)
    assert resid.item() <= 1e-12


@pytest.mark.parametrize("b", TILES)
def test_cholesky_schedule_independent(reference, b):
    _, tiles, _ = reference[b]
    base = _factor(tiles, b, workers=1, policy="history")
    for workers in (1, 2, 4):
        for policy in POLICIES:
            L = _factor(tiles, b, workers=workers, policy=policy)
            assert (L - base).abs().max().item() <= 1e-12, (workers, policy)


def test_random_spd_and_to_tiles_match_reference_package():
    with jax.enable_x64(True):
        ref = np.asarray(jax_random_spd(64, seed=3))
    a = random_spd(64, seed=3, device="cpu")
    assert a.dtype == torch.float64 and a.device.type == "cpu"
    np.testing.assert_allclose(a.numpy(), ref, rtol=1e-12, atol=1e-12)
    store = to_tiles(a, 16, device="cpu")
    assert store.nb == 4 and store[(1, 2)].is_contiguous()
    assert torch.equal(store[(1, 2)], a[16:32, 32:48])
    store[(1, 2)].zero_()                  # tiles own their storage
    assert a[16:32, 32:48].abs().sum() > 0


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        random_spd(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_tiles(np.eye(8), 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_numpy_tiles({(0, 0): np.eye(4)}, 1, 4)
