"""The port's record and replay: recordings from instrumented dynamic runs
and from static schedules, the replay executor (bit-identical to dynamic,
gang issue order reproduced, fallback on stale or scrambled recordings),
the on-disk graph cache shared with the reference package, worker-count
remapping, the serving pool, and the sessions and ``serve_lm`` modes built
on them.  Everything runs on the CPU; nothing here asserts on timing."""

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.linalg import build_cholesky_graph as jax_build_cholesky
from repro.linalg import build_lu_graph as jax_build_lu
from repro.linalg import lu_extract as jax_lu_extract
from repro.linalg import lu_static_recording as jax_lu_static_recording
from repro.linalg import qr_static_recording as jax_qr_static_recording
from repro.linalg import random_diagdom as jax_random_diagdom
from repro.linalg import to_tiles as jax_to_tiles
from repro.replay import GraphCache as JaxGraphCache
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro_torch.core import ListScheduler, Runtime, TaskGraph, run_graph
from repro_torch.exec.registry import REGISTRY
from repro_torch.linalg import (CostModel, build_cholesky_graph,
                                build_lu_graph, build_qr_graph,
                                cholesky_extract, from_numpy_tiles,
                                lu_extract, lu_static_recording,
                                qr_reconstruct, qr_static_recording,
                                random_diagdom, random_spd, to_tiles)
from repro_torch.replay import (GraphCache, Recording, RecordingError,
                                ReplayExecutor, ReplayPool, cache_key,
                                graph_key, remap_recording, replay_graph)
from repro_torch.serving import ContinuousBatchingEngine, PoissonWorkload

NB, B = 6, 16
LU_NB, PANEL_THREADS = 5, 3


def _cholesky_store(seed=1):
    return to_tiles(random_spd(NB * B, seed=seed, device="cpu"), B,
                    device="cpu")


def _lu_store(seed=2):
    return to_tiles(random_diagdom(LU_NB * B, seed=seed, device="cpu"), B,
                    device="cpu")


def _lu_graph(store, panel_threads=PANEL_THREADS):
    return build_lu_graph(LU_NB, B, store=store, panel_threads=panel_threads)


def _record_cholesky(workers=4):
    st = _cholesky_store()
    with Runtime(workers) as rt:
        rt.run(build_cholesky_graph(NB, B, store=st), record=True)
    return cholesky_extract(st), rt.last_recording


def _record_lu(workers=4):
    st = _lu_store()
    with repro_torch.Session(workers, record=True) as s:
        report = s.run(_lu_graph(st))
    assert report.plan.mode == "record"
    return lu_extract(st), report.recording


@pytest.fixture
def x64():
    """JAX x64 on process-wide for the reference package's float64
    factorizations (its scoped form does not reach worker threads)."""
    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


# ---------------------------------------------------------------------------
# replay == dynamic, bit for bit
# ---------------------------------------------------------------------------
def test_replay_cholesky_bit_identical():
    l_dyn, rec = _record_cholesky()
    st = _cholesky_store()
    replay_graph(build_cholesky_graph(NB, B, store=st), rec)
    assert torch.equal(cholesky_extract(st), l_dyn)


def test_replay_lu_bit_identical_with_gang_panels():
    (l1, u1), rec = _record_lu()
    assert len(rec.gang_issue_order) == LU_NB, "every LU panel forks a gang"
    for p in rec.gang_placements.values():
        assert len(set(p.workers)) == len(p.workers)   # distinct workers
    st = _lu_store()
    replay_graph(_lu_graph(st), rec)
    l2, u2 = lu_extract(st)
    assert torch.equal(l1, l2) and torch.equal(u1, u2)


def test_replay_reproduces_the_gang_issue_order():
    _, rec = _record_lu()
    recorded = [rec.gang_placements[t].gang_id for t in rec.gang_issue_order]
    assert recorded == sorted(recorded), "recorded ids are monotonic"
    with ReplayExecutor(rec) as ex:
        ex.run(_lu_graph(_lu_store()))
        assert list(ex.issued_gang_ids) == recorded


def test_replay_task_results_match_dynamic():
    def mk():
        g = TaskGraph("arith")
        xs = [g.add(lambda ctx, i=i: i * i, name=f"x{i}") for i in range(8)]
        s = g.add(lambda ctx: sum(ctx.dep_results()), deps=xs, name="sum")
        g.add(lambda ctx: ctx[s] * 2, deps=[s], name="double")
        return g

    with repro_torch.Session(3, record=True) as s:
        report = s.run(mk())
    assert replay_graph(mk(), report.recording) == report.results


# ---------------------------------------------------------------------------
# stale and broken recordings
# ---------------------------------------------------------------------------
def test_stale_digest_rejected_then_fallback_completes():
    l_dyn, rec = _record_cholesky()
    slow = CostModel(flop_rate=CostModel().flop_rate / 7.0)
    st = _cholesky_store()
    g = build_cholesky_graph(NB, B, store=st, cost=slow)
    with pytest.raises(RecordingError):
        replay_graph(g, rec)                              # digest mismatch
    replay_graph(g, rec, check_digest=False)              # fallback path
    assert torch.equal(cholesky_extract(st), l_dyn)


@pytest.mark.parametrize("kernel", ["cholesky", "lu"])
def test_scrambled_recording_completes_via_fallback(kernel):
    """Reversed run lists break the start order everywhere; the dynamic
    fallback must still finish the graph, gang panels included."""
    if kernel == "cholesky":
        want, rec = _record_cholesky()
        st = _cholesky_store()
        graph, extract = build_cholesky_graph(NB, B, store=st), cholesky_extract
    else:
        (_, want), rec = _record_lu()
        st = _lu_store()
        graph, extract = _lu_graph(st), (lambda s: lu_extract(s)[1])
    bad = Recording.from_dict(rec.to_dict())
    bad.worker_orders = [list(reversed(o)) for o in bad.worker_orders]
    with ReplayExecutor(bad, stall_timeout=1e-4) as ex:
        ex.run(graph, timeout=60.0)
        assert ex.stats["fallback_steals"] > 0
    assert torch.equal(extract(st), want)


def test_recording_refuses_double_fork_per_task():
    g = TaskGraph("twofork")

    def forks_twice(ctx):
        ctx.parallel(2, lambda tid, region: tid)
        ctx.parallel(2, lambda tid, region: tid)

    g.add(forks_twice, name="p", kind="panel")
    with pytest.raises(ValueError, match="more than one parallel region"):
        run_graph(g, 3, record=True)


def test_recording_must_cover_graph():
    _, rec = _record_cholesky()
    bad = Recording.from_dict(rec.to_dict())
    w = max(range(len(bad.worker_orders)),
            key=lambda i: len(bad.worker_orders[i]))
    bad.worker_orders[w] = bad.worker_orders[w][:-2]
    with pytest.raises(RecordingError):
        replay_graph(build_cholesky_graph(NB, B), bad, check_digest=False)


# ---------------------------------------------------------------------------
# static recordings
# ---------------------------------------------------------------------------
def test_static_schedule_seeds_replay():
    l_dyn, _ = _record_cholesky()
    gcost = build_cholesky_graph(NB, B)
    sched = ListScheduler(4, policy="hybrid").schedule(gcost)
    rec = Recording.from_static_schedule(sched, gcost)
    assert rec.source == "static"
    assert rec.collective_order == sched.collective_order()
    rec.validate_against(gcost)
    st = _cholesky_store()
    replay_graph(build_cholesky_graph(NB, B, store=st), rec)
    assert torch.equal(cholesky_extract(st), l_dyn)


def test_lu_static_recording_replays_placed_and_bit_identical():
    (l1, u1), _ = _record_lu()
    rec = lu_static_recording(LU_NB, B, n_workers=4,
                              panel_threads=PANEL_THREADS)
    assert len(rec.gang_placements) == LU_NB      # every panel is placed
    for p in rec.gang_placements.values():
        assert len(set(p.workers)) == len(p.workers)
    st = _lu_store()
    with ReplayExecutor(rec) as ex:
        ex.run(_lu_graph(st))              # the numeric build's digest
        assert list(ex.issued_gang_ids) == [
            rec.gang_placements[t].gang_id for t in rec.gang_issue_order]
    l2, u2 = lu_extract(st)
    assert torch.equal(l1, l2) and torch.equal(u1, u2)


def test_qr_static_recording_replays_bit_identical():
    a = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (LU_NB * B, LU_NB * B)))
    outs = []
    for rec in (None, qr_static_recording(LU_NB, B, n_workers=4,
                                          panel_threads=PANEL_THREADS)):
        st = to_tiles(a, B, device="cpu")
        g = build_qr_graph(LU_NB, B, store=st, panel_threads=PANEL_THREADS)
        if rec is None:
            run_graph(g, 4)
        else:
            replay_graph(g, rec)
        outs.append((st.assemble(), qr_reconstruct(st)))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("kernel", ["lu", "qr"])
def test_static_recording_json_is_the_reference_recording(kernel):
    ours, theirs = {"lu": (lu_static_recording, jax_lu_static_recording),
                    "qr": (qr_static_recording, jax_qr_static_recording)}[kernel]
    assert (ours(6, 32, n_workers=4, panel_threads=3).to_json()
            == theirs(6, 32, n_workers=4, panel_threads=3).to_json())


# ---------------------------------------------------------------------------
# the cache, on disk and shared with the reference package
# ---------------------------------------------------------------------------
def test_graph_cache_on_disk_roundtrip(tmp_path):
    l_dyn, rec = _record_cholesky()
    GraphCache(tmp_path).store(rec)
    fresh = GraphCache(tmp_path)                       # another process's view
    hit = fresh.lookup(build_cholesky_graph(NB, B), rec.n_workers, rec.policy)
    assert hit is not None and hit.to_dict() == rec.to_dict()
    st = _cholesky_store()
    replay_graph(build_cholesky_graph(NB, B, store=st), hit)
    assert torch.equal(cholesky_extract(st), l_dyn)


def test_cache_key_distinguishes_worker_count_and_policy():
    k = graph_key(build_cholesky_graph(NB, B))
    assert cache_key(k, 2, "hybrid") != cache_key(k, 4, "hybrid")
    assert cache_key(k, 4, "hybrid") != cache_key(k, 4, "history")


@pytest.mark.parametrize("kernel", ["cholesky", "lu"])
def test_one_worker_recording_json_is_byte_identical_to_reference(x64,
                                                                  kernel):
    if kernel == "cholesky":
        a = random_spd(NB * B, seed=1, device="cpu")
        ours_g = build_cholesky_graph(NB, B, store=to_tiles(a, B, device="cpu"))
        theirs_g = jax_build_cholesky(NB, B, store=jax_to_tiles(
            jax.numpy.asarray(a.numpy()), B))
    else:
        a = random_diagdom(LU_NB * B, seed=2, device="cpu")
        ours_g = build_lu_graph(LU_NB, B, store=to_tiles(a, B, device="cpu"),
                                panel_threads=1)
        theirs_g = jax_build_lu(LU_NB, B, store=jax_to_tiles(
            jax.numpy.asarray(a.numpy()), B), panel_threads=1)
    with repro_torch.Session(1, record=True, seed=0) as s:
        ours = s.run(ours_g).recording
    with repro.Session(1, record=True, seed=0) as s:
        theirs = s.run(theirs_g).recording
    assert ours.to_json() == theirs.to_json()


def test_reference_recording_replays_in_the_port(x64, tmp_path):
    """The reference package records LU into an on-disk cache; the port's
    replay session finds it there and replays it, bit-identical to its own
    dynamic factors."""
    a = jax_random_diagdom(LU_NB * B, seed=2)
    store = jax_to_tiles(a, B)
    tiles = {k: np.asarray(v) for k, v in store.tiles.items()}
    with repro.Session(4, cache=JaxGraphCache(tmp_path)) as s:
        report = s.run(jax_build_lu(LU_NB, B, store=store,
                                    panel_threads=PANEL_THREADS))
    assert report.plan.mode == "record"
    u_ref = np.asarray(jax_lu_extract(store)[1])

    dyn = from_numpy_tiles(tiles, LU_NB, B, device="cpu")
    run_graph(_lu_graph(dyn), 4)
    st = from_numpy_tiles(tiles, LU_NB, B, device="cpu")
    with repro_torch.Session(4, scheduler="replay",
                             cache=GraphCache(tmp_path)) as s:
        report = s.run(_lu_graph(st))
    assert report.plan.mode == "replay"
    assert report.recording.to_dict() == GraphCache(tmp_path).lookup(
        graph_key(_lu_graph(st)), 4, "hybrid").to_dict()
    assert torch.equal(st.assemble(), dyn.assemble())
    np.testing.assert_allclose(lu_extract(st)[1].numpy(), u_ref, rtol=1e-10,
                               atol=1e-10)


# ---------------------------------------------------------------------------
# sessions: record, cache, replay, remap (the modes the port now runs)
# ---------------------------------------------------------------------------
def test_session_record_returns_the_recording():
    with repro_torch.Session(2, record=True) as s:
        report = s.run(build_cholesky_graph(NB, B, store=_cholesky_store()))
    rec = report.recording
    assert report.plan.mode == "record" and rec.n_workers == 2
    assert rec.digest == graph_key(build_cholesky_graph(NB, B)).digest
    assert Recording.from_json(rec.to_json()).to_dict() == rec.to_dict()


def test_dynamic_session_cache_records_then_replays():
    cache = GraphCache()
    outs, modes = [], []
    with repro_torch.Session(4, cache=cache) as s:
        for _ in range(3):
            st = _cholesky_store()
            modes.append(s.run(build_cholesky_graph(NB, B, store=st)).plan.mode)
            outs.append(cholesky_extract(st))
    assert modes == ["record", "replay", "replay"] and len(cache) == 1
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_replay_session_records_then_replays_lu():
    outs, modes = [], []
    with repro_torch.Session(4, scheduler="replay") as s:
        for _ in range(3):
            st = _lu_store()
            report = s.run(_lu_graph(st))
            modes.append(report.plan.mode)
            outs.append(st.assemble())
    assert modes == ["record", "replay", "replay"]
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert REGISTRY.refcounts().get(4, 0) == 0


def test_replay_session_remaps_another_worker_count():
    l_dyn, rec = _record_cholesky(workers=4)
    cache = GraphCache()
    cache.store(rec)
    st = _cholesky_store()
    with repro_torch.Session(2, scheduler="replay", cache=cache) as s:
        plan = s.plan(build_cholesky_graph(NB, B, store=st))
        assert plan.mode == "replay" and plan.remapped_from == 4
        s.run(plan=plan)
    assert torch.equal(cholesky_extract(st), l_dyn)
    assert remap_recording(rec, 3).n_workers == 3


def test_run_graph_shim_records_replays_and_caches():
    st = _cholesky_store()
    run_graph(build_cholesky_graph(NB, B, store=st), 3, record=True)
    with pytest.warns(DeprecationWarning):
        rec = run_graph.last_recording
    assert rec.n_workers == 3
    st2 = _cholesky_store()
    run_graph(build_cholesky_graph(NB, B, store=st2), 3, replay=rec)
    assert torch.equal(cholesky_extract(st), cholesky_extract(st2))
    cache = GraphCache()
    for _ in range(2):
        run_graph(build_cholesky_graph(NB, B, store=_cholesky_store()), 2,
                  cache=cache)
    assert len(cache) == 1


# ---------------------------------------------------------------------------
# the serving pool
# ---------------------------------------------------------------------------
def test_pool_session_warms_up_records_then_replays():
    outs, modes = [], []
    with repro_torch.Session(4, scheduler="pool") as s:
        for _ in range(4):
            st = _cholesky_store()
            report = s.run(build_cholesky_graph(NB, B, store=st))
            modes.append(report.stats["pool_mode"])
            outs.append(cholesky_extract(st))
        (stats,) = s.pool.describe().values()
    assert modes == ["warmup", "record", "replay", "replay"]
    assert stats["replays"] == 2 and stats["records"] == 1
    assert all(torch.equal(o, outs[0]) for o in outs)


def test_pool_adopts_a_cached_recording_at_another_worker_count(tmp_path):
    _, rec = _record_lu(workers=4)
    GraphCache(tmp_path).store(rec)
    with ReplayPool(GraphCache(tmp_path)) as pool:
        out = pool.serve(_lu_graph(_lu_store()), 3)
    assert out.mode == "remap" and out.recording.n_workers == 3


def test_pool_compiled_promotion_and_traces_are_not_ported():
    """The pool's warm -> compiled promotion and its traced serves run in
    the port: ``compile_after`` validates as the reference's does, a
    session's pool promotes after its clean replays, and a traced replay
    leaves its trace."""
    with pytest.raises(ValueError, match="compile_after"):
        ReplayPool(compile_after=0)
    modes = []
    with repro_torch.Session(2, scheduler="pool", trace=True,
                             pool_kwargs={"compile_after": 1,
                                          "warmup_runs": 0}) as s:
        for _ in range(4):
            report = s.run(build_cholesky_graph(NB, B, store=_cholesky_store()))
            modes.append(report.stats["pool_mode"])
    assert modes == ["record", "replay", "compiled", "compiled"]
    assert report.stats["compiles"] == 1
    with ReplayExecutor(_record_cholesky()[1], trace=True) as ex:
        ex.run(build_cholesky_graph(NB, B, store=_cholesky_store()))
    assert ex.last_trace is not None and ex.last_trace.events


def _toy_prefill(prompt):
    h = (int(np.asarray(prompt).sum()) * 31 + 7) % 10_007
    return {"h": h}, _toy_logits(h)


def _toy_decode(cache, tok):
    h = (cache["h"] * 31 + int(tok) + 7) % 10_007
    return {"h": h}, _toy_logits(h)


def _toy_logits(h):
    row = [0.0] * 13
    row[h % 13] = 1.0
    return row


def _toy_sample(logits):
    return int(np.argmax(np.asarray(logits)))


def test_pool_engine_matches_dynamic_and_the_reference_pool_engine():
    """The engine over a toy model on the virtual clock: pool serving gives
    the dynamic session's streams with warm replays, and the reference
    engine on its own pool composes the same steps and numbers."""
    w = PoissonWorkload(200.0, 10, seed=3, prompt_len=4,
                        max_new_tokens=(2, 6), vocab_size=50)
    kw = dict(sample_fn=_toy_sample, max_batch=3, step_time=0.01)
    pool_kwargs = {"warmup_runs": 0}
    with repro_torch.Session(2) as s:
        dynamic = ContinuousBatchingEngine(s, _toy_decode, _toy_prefill,
                                           **kw).run(w.requests())
    with repro_torch.Session(2, scheduler="pool",
                             pool_kwargs=pool_kwargs) as s:
        ours = ContinuousBatchingEngine(s, _toy_decode, _toy_prefill,
                                        **kw).run(w.requests())
    with repro.Session(2, scheduler="pool", pool_kwargs=pool_kwargs) as s:
        ref = JaxEngine(s, _toy_decode, _toy_prefill,
                        **kw).run(w.requests())
    assert ours.tokens_by_rid() == dynamic.tokens_by_rid()
    assert ours.warm_hit_rate > 0.0 and dynamic.warm_hit_rate == 0.0
    assert ours.shape_counts == ref.shape_counts
    assert ours.tokens_by_rid() == ref.tokens_by_rid()
    assert ours.summary() == ref.summary()


@pytest.mark.parametrize("arrivals", ["batch", "poisson"])
def test_serve_lm_pool_gives_the_dynamic_tokens(tmp_path, arrivals):
    from repro_torch.serving import serve_lm

    argv = ["--reduced", "--device", "cpu", "--layers", "2", "--tokens", "6",
            "--prompt-len", "16", "--arrivals", arrivals, "--requests", "4",
            "--max-new", "2:5"]
    dynamic = serve_lm.main(argv + ["--scheduler", "dynamic"])
    pooled = serve_lm.main(argv + ["--scheduler", "pool",
                                   "--cache-dir", str(tmp_path)])
    if arrivals == "batch":
        assert torch.equal(pooled, dynamic)
    else:
        assert pooled.tokens_by_rid() == dynamic.tokens_by_rid()
        assert pooled.warm_hit_rate > 0.0
    assert any(tmp_path.glob("*.json")), "recordings persisted on disk"
