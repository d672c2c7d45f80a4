"""The port's tiled LU and QR (gang-scheduled panels on the host, column
updates on the tile GEMM's plain version here on the CPU), its panels, its
static schedules and its multi-rank cost-model graphs, held against the
reference package on the same numpy inputs.

The reference factors through ``repro.Session`` in float64.  JAX's scoped
``jax.enable_x64`` does not reach the session's worker threads, so the
reference runs switch x64 on process-wide and restore the previous setting
afterwards (as ``tests/test_torch_cholesky.py`` does).
"""

import math
import threading

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import ListScheduler as JaxListScheduler
from repro.core import Simulator as JaxSimulator
from repro.linalg import ShapeOnlyStore as JaxShapeOnlyStore
from repro.linalg import build_lu_graph as jax_build_lu
from repro.linalg import build_qr_graph as jax_build_qr
from repro.linalg import lu_extract as jax_lu_extract
from repro.linalg import paper_graph as jax_paper_graph
from repro.linalg import qr_extract_r as jax_qr_extract_r
from repro.linalg import qr_reconstruct as jax_qr_reconstruct
from repro.linalg import random_diagdom as jax_random_diagdom
from repro.linalg import to_tiles as jax_to_tiles
from repro.linalg import dist as jax_dist
from repro.linalg import panels as jax_panels
from repro.replay import graph_key as jax_graph_key
from repro_torch.core import ListScheduler, Simulator
from repro_torch.linalg import (GRAPH_KEYS, KERNELS, CostModel,
                                ShapeOnlyStore, build_lu_graph,
                                build_qr_graph, from_numpy_tiles, lu_extract,
                                lu_graph_key, paper_graph, qr_extract_r,
                                qr_graph_key, qr_reconstruct, random_diagdom)
from repro_torch.linalg import dist, panels
from repro_torch.replay import graph_key

N, B, PANEL_THREADS = 128, 32, 3
NB = N // B
POLICIES = ["history", "hybrid"]


@pytest.fixture(scope="module")
def reference():
    """{"lu" | "qr": (A, the tiles before factoring, the reference's
    factors)}: LU of ``random_diagdom(128, seed=3)``, QR of a standard
    normal matrix from numpy seed 4, each through ``repro.Session(4)``."""
    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        out = {}
        a = jax_random_diagdom(N, seed=3)
        store = jax_to_tiles(a, B)
        tiles = {k: np.asarray(v) for k, v in store.tiles.items()}
        with repro.Session(4, policy="hybrid") as s:
            s.run(jax_build_lu(NB, B, store=store,
                               panel_threads=PANEL_THREADS))
        l, u = (np.asarray(x) for x in jax_lu_extract(store))
        assert u.dtype == np.float64
        out["lu"] = (np.array(a), tiles, (l, u))

        a = np.random.default_rng(4).standard_normal((N, N))
        store = jax_to_tiles(jax.numpy.asarray(a), B)
        tiles = {k: np.asarray(v) for k, v in store.tiles.items()}
        with repro.Session(4, policy="hybrid") as s:
            s.run(jax_build_qr(NB, B, store=store,
                               panel_threads=PANEL_THREADS))
        r = np.asarray(jax_qr_extract_r(store))
        recon = np.asarray(jax_qr_reconstruct(store))
        assert r.dtype == np.float64
        out["qr"] = (a, tiles, (r, recon))
        return out
    finally:
        jax.config.update("jax_enable_x64", prev)


def _factor(kernel, tiles, *, workers=4, policy="hybrid",
            panel_threads=PANEL_THREADS):
    """Factor copies of ``tiles`` on the CPU through ``repro_torch.Session``;
    returns the store."""
    store = from_numpy_tiles(tiles, NB, B, device="cpu")
    graph = KERNELS[kernel](NB, B, store=store, panel_threads=panel_threads)
    with repro_torch.Session(workers, policy=policy) as s:
        report = s.run(graph)
    assert len(report.results) == len(graph)
    return store


def _rel(a, b):
    return (torch.linalg.matrix_norm(a - b) / torch.linalg.matrix_norm(a)).item()


# ---------------------------------------------------------------------------
# the panels: the reference's numpy regions, copied — the same bits
# ---------------------------------------------------------------------------
class _SerialRegion:
    def barrier(self):
        pass


class _ThreadRegion:
    def __init__(self, n):
        self._barrier = threading.Barrier(n)

    def barrier(self):
        self._barrier.wait(timeout=60)


def _run_region(body, n_threads):
    if n_threads == 1:
        body(0, _SerialRegion())
        return
    region = _ThreadRegion(n_threads)
    threads = [threading.Thread(target=body, args=(t, region))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


def _lu_panel_input():
    rng = np.random.default_rng(0)
    p = rng.standard_normal((160, 32))
    p[:32] += np.diag(np.abs(p).sum(axis=0) + 1.0)
    return p


@pytest.mark.parametrize("n_threads", [1, 3])
def test_lu_panel_region_is_the_reference_panel(n_threads):
    ours, theirs = _lu_panel_input(), _lu_panel_input()
    _run_region(panels.lu_panel_region(ours, 32, n_threads), n_threads)
    _run_region(jax_panels.lu_panel_region(theirs, 32, n_threads), n_threads)
    np.testing.assert_array_equal(ours, theirs)
    # without reductions, the thread count does not change a bit
    serial = _lu_panel_input()
    _run_region(panels.lu_panel_region(serial, 32, 1), 1)
    np.testing.assert_array_equal(ours, serial)
    ref = _lu_panel_input()
    l = np.vstack([np.tril(ours[:32], -1) + np.eye(32), ours[32:]])
    np.testing.assert_allclose(l @ np.triu(ours[:32]), ref, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("n_threads", [1, 3])
def test_qr_panel_region_and_t_factor_are_the_reference_panel(n_threads):
    rng = np.random.default_rng(1)
    ours = rng.standard_normal((160, 32))
    theirs, ref = ours.copy(), ours.copy()
    body, taus = panels.qr_panel_region(ours, 32, n_threads)
    _run_region(body, n_threads)
    jbody, jtaus = jax_panels.qr_panel_region(theirs, 32, n_threads)
    _run_region(jbody, n_threads)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(taus, jtaus)
    T = panels.qr_form_t(ours, taus)
    np.testing.assert_array_equal(T, jax_panels.qr_form_t(theirs, jtaus))
    V = np.tril(ours, -1)[:, :32] + np.eye(160, 32)
    r = np.vstack([np.triu(ours[:32]), np.zeros((128, 32))])
    np.testing.assert_allclose(r - V @ (T @ (V.T @ r)), ref, rtol=1e-12,
                               atol=1e-12)


def test_row_ranges_are_the_reference_ranges():
    for m, b, n_threads in [(160, 32, 3), (100, 32, 4), (32, 32, 2)]:
        for tid in range(n_threads):
            assert (panels._row_ranges(m, b, n_threads, tid)
                    == jax_panels._row_ranges(m, b, n_threads, tid))


# ---------------------------------------------------------------------------
# the factorizations through the port's runtime, against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
def test_lu_matches_reference_package(reference, policy):
    a, tiles, (l_ref, u_ref) = reference["lu"]
    l, u = lu_extract(_factor("lu", tiles, policy=policy))
    assert u.dtype == torch.float64 and u.shape == (N, N)
    np.testing.assert_allclose(l.numpy(), l_ref, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(u.numpy(), u_ref, rtol=1e-10, atol=1e-10)
    assert _rel(torch.from_numpy(a), l @ u) <= 1e-12


@pytest.mark.parametrize("policy", POLICIES)
def test_qr_matches_reference_package(reference, policy):
    a, tiles, (r_ref, recon_ref) = reference["qr"]
    store = _factor("qr", tiles, policy=policy)
    r, recon = qr_extract_r(store), qr_reconstruct(store)
    np.testing.assert_allclose(r.numpy(), r_ref, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(recon.numpy(), recon_ref, rtol=1e-10,
                               atol=1e-10)
    assert _rel(torch.from_numpy(a), recon) <= 1e-12
    # the panels wrote zeros below the diagonal
    assert torch.equal(r, torch.triu(store.assemble()))


def test_random_diagdom_is_the_reference_matrix(reference):
    a = random_diagdom(N, seed=3, device="cpu")
    assert a.dtype == torch.float64
    np.testing.assert_allclose(a.numpy(), reference["lu"][0], rtol=1e-15,
                               atol=0)


@pytest.mark.parametrize("kernel", ["lu", "qr"])
def test_factors_bit_identical_across_policies(reference, kernel):
    _, tiles, _ = reference[kernel]
    stores = [_factor(kernel, tiles, policy=p)
              for p in ("history", "random", "hybrid")]
    outs = [s.assemble() for s in stores]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


@pytest.mark.parametrize("kernel", ["lu", "qr"])
def test_factors_schedule_independent_over_workers(reference, kernel):
    """One panel thread fits every worker count; the factors must not
    depend on the count (gang panels of 2 threads on 2 and 4 workers too)."""
    _, tiles, _ = reference[kernel]
    for panel_threads, counts in ((1, (1, 2, 4)), (2, (2, 4))):
        outs = [_factor(kernel, tiles, workers=w, policy="history",
                        panel_threads=panel_threads).assemble()
                for w in counts]
        for o in outs[1:]:
            assert torch.equal(o, outs[0])


@pytest.mark.parametrize("kernel", ["lu", "qr"])
def test_every_panel_forks_one_gang_region(reference, kernel):
    store = from_numpy_tiles(reference[kernel][1], NB, B, device="cpu")
    with repro_torch.Session(4) as s:
        report = s.run(KERNELS[kernel](NB, B, store=store,
                                       panel_threads=PANEL_THREADS))
    assert report.stats["gang_regions"] == NB
    with repro_torch.Session(4) as s:       # Cholesky's panels fork none
        report = s.run(paper_graph("cholesky", NB, B))
    assert report.stats["gang_regions"] == 0


@pytest.mark.parametrize("kernel,want", [
    # LU: step k updates nb-k-1 columns, each with nb-k-1 tile GEMMs
    ("lu", sum(m * m for m in range(1, NB))),
    # QR: 3 GEMMs (V^T A, T^T W, A - V Y) per column update, C(nb, 2) updates
    ("qr", 3 * math.comb(NB, 2))])
def test_tile_gemm_calls_per_factorization(reference, monkeypatch, kernel,
                                           want):
    """The launch counts chip_smoke.py holds the card to, here as calls."""
    from repro_torch.linalg import lu, qr

    calls = []
    if kernel == "lu":
        real = lu.tile_gemm_nn_sub
        monkeypatch.setattr(lu, "tile_gemm_nn_sub",
                            lambda *a: calls.append(1) or real(*a))
    else:
        real = qr.tile_matmul
        monkeypatch.setattr(qr, "tile_matmul",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    _factor(kernel, reference[kernel][1])
    assert len(calls) == want


# ---------------------------------------------------------------------------
# structure: digests, static schedules, cost-model graphs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nb,b,panel_threads", [(4, 32, 3), (6, 48, 2),
                                                (40, 192, 4)])
@pytest.mark.parametrize("kernel", ["lu", "qr"])
def test_graph_key_matches_reference_package(kernel, nb, b, panel_threads):
    ours = {"lu": build_lu_graph, "qr": build_qr_graph}[kernel]
    theirs = {"lu": jax_build_lu, "qr": jax_build_qr}[kernel]
    cost = graph_key(ours(nb, b, panel_threads=panel_threads))
    assert cost.digest == jax_graph_key(
        theirs(nb, b, panel_threads=panel_threads)).digest
    assert cost == GRAPH_KEYS[kernel](nb, b, panel_threads=panel_threads)
    numeric = graph_key(ours(nb, b, store=ShapeOnlyStore(nb, b),
                             panel_threads=panel_threads))
    assert numeric.digest == jax_graph_key(theirs(
        nb, b, store=JaxShapeOnlyStore(nb, b),
        panel_threads=panel_threads)).digest
    assert numeric.digest != cost.digest     # the panel forks at run time
    assert lu_graph_key is GRAPH_KEYS["lu"] and qr_graph_key is GRAPH_KEYS["qr"]


@pytest.mark.parametrize("kernel", ["cholesky", "lu", "qr"])
def test_paper_graph_matches_reference_package(kernel):
    assert (graph_key(paper_graph(kernel, 8)).digest
            == jax_graph_key(jax_paper_graph(kernel, 8)).digest)


@pytest.mark.parametrize("ranks", [2, 4])
def test_dist_graph_keys_match_reference_package(ranks):
    pairs = [(dist.build_dist_cholesky_graph(8, 96, ranks=ranks),
              jax_dist.build_dist_cholesky_graph(8, 96, ranks=ranks))]
    for kernel in ("lu", "qr"):
        pairs.append((
            dist.build_dist_panel_graph(kernel, 8, 96, ranks=ranks,
                                        panel_threads=3),
            jax_dist.build_dist_panel_graph(kernel, 8, 96, ranks=ranks,
                                            panel_threads=3)))
    for ours, theirs in pairs:
        assert graph_key(ours).digest == jax_graph_key(theirs).digest


@pytest.mark.parametrize("policy", ["history", "random", "hybrid"])
@pytest.mark.parametrize("kernel", ["cholesky", "lu", "qr"])
def test_list_schedule_matches_reference_package(kernel, policy):
    ours = ListScheduler(4, policy=policy, seed=0).schedule(
        paper_graph(kernel, 6, 64))
    theirs = JaxListScheduler(4, policy=policy, seed=0).schedule(
        jax_paper_graph(kernel, 6, 64))
    assert ours.makespan == theirs.makespan
    assert ([(i.tid, i.slot, i.t0, i.t1) for i in ours.items]
            == [(i.tid, i.slot, i.t0, i.t1) for i in theirs.items])
    assert ours.waves() == theirs.waves()
    assert ours.collective_order() == theirs.collective_order()
    assert ([(g.spawn_tid, g.gang_id, g.workers) for g in ours.gangs]
            == [(g.spawn_tid, g.gang_id, g.workers) for g in theirs.gangs])


@pytest.mark.parametrize("policy", ["history", "hybrid"])
@pytest.mark.parametrize("kernel", ["lu", "qr"])
def test_dist_simulation_matches_reference_package(kernel, policy):
    ours = Simulator(8, ranks=2, policy=policy, mode="gang", seed=0).run(
        dist.build_dist_panel_graph(kernel, 8, 96, ranks=2, panel_threads=3))
    theirs = JaxSimulator(8, ranks=2, policy=policy, mode="gang", seed=0).run(
        jax_dist.build_dist_panel_graph(kernel, 8, 96, ranks=2,
                                        panel_threads=3))
    assert ours.makespan == theirs.makespan
    assert ([(e.worker, e.t0, e.t1, e.kind, e.label) for e in ours.events]
            == [(e.worker, e.t0, e.t1, e.kind, e.label) for e in theirs.events])


def test_lu_graph_cost_mode_structure():
    g = build_lu_graph(6, 64, store=None)
    kinds = g.subgraph_kinds()
    assert kinds["panel"] == 6 and kinds["comm"] == 6
    assert kinds["lookahead"] == 5          # one per step but the last
    assert all(t.parallel is not None for t in g if t.kind == "panel")
    length, _ = g.critical_path()
    assert length > 0


# ---------------------------------------------------------------------------
# the five properties of tests/test_dist_graphs.py, on the port
# ---------------------------------------------------------------------------
def test_dist_cholesky_graph_structure():
    g = dist.build_dist_cholesky_graph(8, 96, ranks=2)
    g.validate()
    assert all(t.meta.get("rank") is not None for t in g)
    assert len([t for t in g if t.name.startswith("bcast[")]) == 8
    assert len([t for t in g if t.name.startswith("recv[")]) == 8


def test_rank_pools_do_not_cross_steal():
    g = dist.build_dist_cholesky_graph(10, 96, ranks=2)
    tr = Simulator(8, ranks=2, policy="hybrid", seed=0).run(g)
    by_name = {t.name: t for t in g}
    for e in tr.events:
        t = by_name.get(e.label)
        if t is not None:
            assert e.worker // 4 == t.meta["rank"], e.label


@pytest.mark.parametrize("kernel", ["lu", "qr"])
def test_dist_panel_graphs_complete_with_gangs(kernel):
    g = dist.build_dist_panel_graph(kernel, 8, 96, ranks=2, panel_threads=3)
    tr = Simulator(8, ranks=2, policy="hybrid", mode="gang", seed=0).run(g)
    assert tr.makespan > 0
    assert any(e.kind == "panel" for e in tr.events)


def test_cholesky_policy_ordering_at_scale():
    cm = CostModel(comm_bw=3e9, comm_latency=20e-6)
    g = dist.build_dist_cholesky_graph(64, 192, ranks=4, cost=cm)
    times = {pol: Simulator(40, ranks=4, policy=pol, seed=0).run(g).makespan
             for pol in ("history", "random", "hybrid")}
    assert times["hybrid"] < times["history"] * 0.95
    assert times["hybrid"] < times["random"]
    assert times["random"] < times["history"]


def test_lu_insensitive_to_policy():
    g = dist.build_dist_panel_graph("lu", 32, 192, ranks=4)
    times = {pol: Simulator(32, ranks=4, policy=pol, seed=0).run(g).makespan
             for pol in ("history", "hybrid")}
    assert abs(times["history"] - times["hybrid"]) / times["history"] < 0.05
