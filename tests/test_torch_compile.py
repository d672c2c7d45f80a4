"""The port's compiled plans (``repro_torch.compile``) on the CPU, held
against the reference package's (``repro.compile``).

Mirrors ``tests/test_compile.py`` test for test: the segmentation
invariants of ``compile_recording``, bit-identity of the compiled path
against dynamic and replay scheduling for the factorizations and a decode
loop, the pool's warm -> compiled promotion ladder, and the cache's plan
meta.  Across packages: a reference recording lowers to the same
``CompiledPlanMeta`` JSON in both, and the compiled factors agree with the
reference's.  On the CPU a fused segment runs its composed callable; the
CUDA-graph capture is covered by ``tests/test_torch_cuda.py``.
"""

import json

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.compile import FuseSpec as JaxFuseSpec
from repro.compile import compile_recording as jax_compile_recording
from repro.linalg import build_cholesky_graph as jax_build_cholesky
from repro.linalg import build_lu_graph as jax_build_lu
from repro.linalg import build_qr_graph as jax_build_qr
from repro.linalg import cholesky_extract as jax_cholesky_extract
from repro.linalg import lu_extract as jax_lu_extract
from repro.linalg import qr_extract_r as jax_qr_extract_r
from repro.linalg import to_tiles as jax_to_tiles
from repro.replay import GraphCache as JaxGraphCache
from repro.replay import Recording as JaxRecording
from repro_torch.compile import (
    CompiledExecutor,
    CompiledPlanMeta,
    CompiledRunError,
    CompileError,
    FuseSpec,
    compile_recording,
)
from repro_torch.compile.fuse import fused_cache_info
from repro_torch.core import Runtime
from repro_torch.kernels import cuda_lib
from repro_torch.linalg import (
    build_cholesky_graph,
    build_lu_graph,
    build_qr_graph,
    cholesky_extract,
    from_numpy_tiles,
    lu_extract,
    qr_extract_r,
    random_diagdom,
    random_spd,
    to_tiles,
)
from repro_torch.replay import GraphCache, Recording, ReplayPool

NB, B = 4, 8
BUILDERS = {"cholesky": (build_cholesky_graph, jax_build_cholesky),
            "lu": (build_lu_graph, jax_build_lu),
            "qr": (build_qr_graph, jax_build_qr)}


def _tiles(a):
    return to_tiles(a, B, device="cpu")


def _record_cholesky(workers=2, seed=3):
    a = random_spd(NB * B, seed=seed, device="cpu")
    st = _tiles(a)
    g = build_cholesky_graph(NB, B, store=st)
    with Runtime(workers) as rt:
        rt.run(g, record=True)
    return a, cholesky_extract(st), g, rt.last_recording


def _build(name, store, panel_threads=2):
    kw = {} if name == "cholesky" else dict(panel_threads=panel_threads)
    return BUILDERS[name][0](NB, B, store=store, **kw)


def _matrix(name, seed=7):
    if name == "lu":
        return random_diagdom(NB * B, seed=seed, device="cpu")
    return random_spd(NB * B, seed=seed, device="cpu")


def _extract(name, st):
    if name == "cholesky":
        return (cholesky_extract(st),)
    if name == "lu":
        return lu_extract(st)
    return (qr_extract_r(st),)


@pytest.fixture
def x64():
    """JAX x64 on process-wide for the reference package's float64
    factorizations (its scoped form does not reach worker threads)."""
    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


# ---------------------------------------------------------------------------
# compile_recording: segmentation invariants
# ---------------------------------------------------------------------------
def test_plan_covers_every_task_exactly_once():
    _, _, g, rec = _record_cholesky()
    plan = compile_recording(g, rec)
    seen = []
    for entry in plan.program:
        if entry[0] == "fused":
            seen.extend(entry[1].tids)
        elif entry[0] == "task":
            seen.append(entry[1])
    assert sorted(seen) == sorted(t.tid for t in g.tasks)
    assert len(seen) == len(set(seen))
    m = plan.meta
    assert m.n_tasks == len(g.tasks)
    assert m.n_fused_tasks + m.n_opaque == m.n_tasks
    assert m.n_segments == len(plan.program)
    assert m.digest == rec.digest


def test_segment_boundaries_record_their_reasons():
    _, _, g, rec = _record_cholesky(workers=2)
    plan = compile_recording(g, rec)
    assert plan.meta.n_fused >= 1
    assert plan.meta.jit_segments >= 1
    assert sum(plan.meta.boundaries.values()) >= plan.meta.n_fused
    known = {"worker_switch", "opaque", "gang", "resume", "end"}
    assert set(plan.meta.boundaries) <= known
    _, _, g1, rec1 = _record_cholesky(workers=1)
    plan1 = compile_recording(g1, rec1)
    assert "worker_switch" not in plan1.meta.boundaries
    assert plan1.meta.n_segments <= plan.meta.n_segments
    r2 = Recording.from_dict(rec1.to_dict())
    serial = list(rec1.worker_orders[0])
    r2.worker_orders = [serial[0::2], serial[1::2]]
    r2.n_workers = 2
    plan2 = compile_recording(g1, r2)
    assert plan2.meta.boundaries.get("worker_switch", 0) >= 1
    assert plan2.meta.n_segments >= plan1.meta.n_segments


def test_stale_recording_rejected_with_compile_error():
    _, _, g, rec = _record_cholesky(workers=2)
    bad = Recording.from_dict(rec.to_dict())
    bad.worker_orders = [list(reversed(o)) for o in bad.worker_orders]
    with pytest.raises(CompileError, match="stale"):
        compile_recording(g, bad)


def test_plan_meta_round_trips_and_ignores_unknown_keys():
    _, _, g, rec = _record_cholesky()
    meta = compile_recording(g, rec).meta
    d = meta.to_dict()
    assert json.loads(json.dumps(d)) == d
    assert CompiledPlanMeta.from_dict(d) == meta
    d["future_field"] = "ignored"
    assert CompiledPlanMeta.from_dict(d) == meta


def test_executor_rejects_digest_mismatch_and_reports_stats():
    a, l_ref, g, rec = _record_cholesky()
    ex = CompiledExecutor(g, compile_recording(g, rec))
    st2 = _tiles(a)
    g2 = build_cholesky_graph(NB, B, store=st2)
    ex.run(g2)
    assert torch.equal(cholesky_extract(st2), l_ref)
    stats = ex.stats
    assert 0.0 <= stats["dispatch_overhead_fraction"] < 1.0
    assert stats["segments"] == ex.plan.meta.n_segments
    # the CPU runs every segment's composed callable: nothing is captured
    assert "captured_graphs" not in stats
    assert all(e[1].graph is None for e in ex.plan.program
               if e[0] == "fused")
    other = build_cholesky_graph(NB + 1, B)
    with pytest.raises(CompiledRunError, match="digest"):
        ex.run(other)


# ---------------------------------------------------------------------------
# bit-identity: compiled vs dynamic vs replay, and against the reference
# ---------------------------------------------------------------------------
def _factor_with(scheduler, cache, name, mat, runs=3):
    report = None
    with repro_torch.Session(2, scheduler=scheduler, cache=cache) as s:
        for _ in range(runs):
            st = _tiles(mat)
            report = s.run(_build(name, st))
    return _extract(name, st), report


@pytest.mark.parametrize("name", ["cholesky", "lu", "qr"])
def test_compiled_factorizations_bit_identical(x64, name):
    mat = _matrix(name)
    cache = GraphCache()
    dyn, _ = _factor_with("dynamic", None, name, mat)
    rep, _ = _factor_with("replay", cache, name, mat)
    cmp_, report = _factor_with("compiled", cache, name, mat)
    for d, r, c in zip(dyn, rep, cmp_):
        assert torch.equal(d, r)
        assert torch.equal(d, c)
    assert report.plan.mode == "compiled"
    assert 0.0 <= report.stats["dispatch_overhead_fraction"] < 1.0
    assert report.stats["fused_tasks"] >= 1
    # the reference package on the same numbers, at the linalg tests'
    # tolerance
    kw = {} if name == "cholesky" else dict(panel_threads=2)
    with repro.Session(2, scheduler="compiled") as s:
        for _ in range(2):
            jst = jax_to_tiles(jax.numpy.asarray(mat.numpy()), B)
            jreport = s.run(BUILDERS[name][1](NB, B, store=jst, **kw))
    assert jreport.plan.mode == "compiled"
    ref = {"cholesky": lambda st: (jax_cholesky_extract(st),),
           "lu": jax_lu_extract,
           "qr": lambda st: (jax_qr_extract_r(st),)}[name](jst)
    for c, r in zip(cmp_, ref):
        assert np.asarray(r).dtype == np.float64
        np.testing.assert_allclose(c.numpy(), np.asarray(r), rtol=1e-10,
                                   atol=1e-10)


def _toy_decode(params, cache, tok):
    h = cache["h"] * 31 + tok[:, 0] + 7
    logits = torch.stack([torch.sin(h[:, None].double() * (i + 1)).float()
                          for i in range(7)], dim=-1)
    return {"h": h}, logits


def _decode_loop(run, steps=6):
    from repro_torch.models import DecodeShard, DecodeState, build_decode_graph

    state = DecodeState(None, [
        DecodeShard(cache={"h": torch.full((1,), s + 1, dtype=torch.int64)},
                    tok=torch.full((1, 1), s, dtype=torch.int64))
        for s in range(3)])
    for _ in range(steps):
        run(build_decode_graph(state, _toy_decode))
    return state.tokens()


def test_compiled_decode_tokens_identical():
    with repro_torch.Session(1) as s:
        tok_dyn = _decode_loop(s.run)
    reports = []
    with repro_torch.Session(1, scheduler="compiled") as s:
        tok_cmp = _decode_loop(lambda g: reports.append(s.run(g)))
    assert torch.equal(tok_dyn, tok_cmp)
    assert reports[0].plan.mode == "record"
    assert all(r.plan.mode == "compiled" for r in reports[1:])
    # the decode specs are not jit_safe: nothing is meant for capture
    assert all(r.stats["fused_tasks"] >= 3 for r in reports[1:])


def test_session_map_parity_across_schedulers():
    mats = [random_spd(NB * B, seed=s, device="cpu") for s in (11, 12, 13)]
    dyn = []
    with repro_torch.Session(2) as s:
        for m in mats:
            st = _tiles(m)
            s.run(build_cholesky_graph(NB, B, store=st))
            dyn.append(cholesky_extract(st))
    stores = [_tiles(m) for m in mats]
    with repro_torch.Session(2, scheduler="compiled") as s:
        reports = s.map(lambda st: build_cholesky_graph(NB, B, store=st),
                        stores)
    for d, st in zip(dyn, stores):
        assert torch.equal(d, cholesky_extract(st))
    assert reports[0].plan.mode == "record"
    assert [r.plan.mode for r in reports[1:]] == ["compiled", "compiled"]


@pytest.mark.parametrize("name", ["cholesky", "lu", "qr"])
def test_reference_recording_lowers_to_the_reference_plan_meta(x64, name):
    """A recording the reference package made (4 workers, so worker
    switches and gang forks cut the segments) lowers to the same
    ``CompiledPlanMeta`` JSON in both packages, and the port's compiled
    run of it gives the port's dynamic factors."""
    mat = _matrix(name)
    jst = jax_to_tiles(jax.numpy.asarray(mat.numpy()), B)
    tiles = {k: np.asarray(v) for k, v in jst.tiles.items()}
    kw = {} if name == "cholesky" else dict(panel_threads=2)
    jg = BUILDERS[name][1](NB, B, store=jst, **kw)
    with repro.Session(4, record=True) as s:
        jrec = s.run(jg).recording
    theirs = jax_compile_recording(jg, jrec).meta.to_dict()
    rec = Recording.from_dict(jrec.to_dict())
    st = from_numpy_tiles(tiles, NB, B, device="cpu")
    g = _build(name, st)
    plan = compile_recording(g, rec)
    assert json.dumps(plan.meta.to_dict(), sort_keys=True) == \
        json.dumps(theirs, sort_keys=True)
    CompiledExecutor(g, plan).run(g)
    dyn = from_numpy_tiles(tiles, NB, B, device="cpu")
    with repro_torch.Session(4) as s:
        s.run(_build(name, dyn))
    for c, d in zip(_extract(name, st), _extract(name, dyn)):
        assert torch.equal(c, d)


# ---------------------------------------------------------------------------
# ReplayPool promotion ladder
# ---------------------------------------------------------------------------
def test_pool_promotes_after_clean_replays_and_serves_compiled():
    a = random_spd(NB * B, seed=5, device="cpu")
    with Runtime(1) as rt:
        st = _tiles(a)
        rt.run(build_cholesky_graph(NB, B, store=st))
        ref = cholesky_extract(st)
    modes, runs = [], []
    with ReplayPool(warmup_runs=1, compile_after=2) as pool:
        for _ in range(7):
            st = _tiles(a)
            run = pool.serve(build_cholesky_graph(NB, B, store=st), 1)
            modes.append(run.mode)
            runs.append(run)
            assert torch.equal(cholesky_extract(st), ref)
        assert modes[:2] == ["warmup", "record"]
        assert modes[2:4] == ["replay", "replay"]
        assert all(m == "compiled" for m in modes[4:])
        stats = runs[-1].stats
        assert stats["compiles"] == 1
        assert stats["compiled_serves"] == 3
        assert "compiled_stats" in stats
        assert 0.0 <= \
            stats["compiled_stats"]["dispatch_overhead_fraction"] < 1.0
        rec = runs[-1].recording
        meta = pool.cache.lookup_plan_meta(rec.digest, 1, "hybrid")
        assert meta is not None
        assert CompiledPlanMeta.from_dict(meta).digest == rec.digest


def test_pool_demotes_on_compiled_failure_then_repromotes():
    a = random_spd(NB * B, seed=6, device="cpu")

    class _Broken:
        stats = {}

        def run(self, graph, check_digest=False):
            raise CompiledRunError("injected stall")

    with ReplayPool(warmup_runs=1, compile_after=2) as pool:
        def serve():
            return pool.serve(build_cholesky_graph(NB, B, store=_tiles(a)), 1)

        for _ in range(5):
            run = serve()
        assert run.mode == "compiled"
        entry = next(iter(pool._entries.values()))
        entry.compiled = _Broken()
        run = serve()
        assert run.mode == "replay"
        assert run.stats["compile_failures"] == 1
        assert entry.compiled is None
        run = serve()
        assert run.mode == "replay"
        run = serve()
        assert run.mode == "compiled"
        assert run.stats["compiles"] == 2


# ---------------------------------------------------------------------------
# GraphCache plan-meta round trip
# ---------------------------------------------------------------------------
def test_cache_plan_meta_persists_and_drops_on_swap(tmp_path):
    _, _, g, rec = _record_cholesky(workers=2)
    meta = compile_recording(g, rec).meta
    cache = GraphCache(tmp_path)
    cache.store(rec)
    cache.store_plan_meta(rec.digest, rec.n_workers, "hybrid",
                          meta.to_dict())
    got = cache.lookup_plan_meta(rec.digest, rec.n_workers, "hybrid")
    assert CompiledPlanMeta.from_dict(got) == meta
    warm = GraphCache(tmp_path)
    got = warm.lookup_plan_meta(rec.digest, rec.n_workers, "hybrid")
    assert CompiledPlanMeta.from_dict(got) == meta
    assert warm.lookup_plan_meta(rec.digest, rec.n_workers + 1,
                                 "hybrid") is None
    cache.swap(rec)
    assert cache.lookup_plan_meta(rec.digest, rec.n_workers,
                                  "hybrid") is None


def test_compiled_session_stores_plan_meta_the_reference_reads(tmp_path):
    """The compiled session persists its lowering next to the recording;
    the reference package's cache reads the same file."""
    cache = GraphCache(tmp_path)
    with repro_torch.Session(2, scheduler="compiled", cache=cache) as s:
        for _ in range(2):
            report = s.run(build_cholesky_graph(
                NB, B, store=_tiles(random_spd(NB * B, seed=1,
                                               device="cpu"))))
    rec = report.recording
    ours = cache.lookup_plan_meta(rec.digest, 2, "hybrid")
    assert ours is not None and ours["digest"] == rec.digest
    assert JaxGraphCache(tmp_path).lookup_plan_meta(rec.digest, 2,
                                                    "hybrid") == ours


# ---------------------------------------------------------------------------
# launch counts under capture, and the fused-callable cache
# ---------------------------------------------------------------------------
def test_launch_counter_adds_n_and_tallies_captured_launches():
    c = cuda_lib.LaunchCounter("t")
    c.add()
    c.add(4)
    assert c.count == 5
    with cuda_lib.capturing_launches() as tally:
        c.add()
        c.add(2)
        with pytest.raises(RuntimeError, match="already capturing"):
            with cuda_lib.capturing_launches():
                pass
    assert c.count == 5 and tally == {c: 3}
    cuda_lib.add_launches(tally)
    cuda_lib.add_launches(tally)
    assert c.count == 11
    c.reset()
    assert c.count == 0


def test_same_structure_segments_share_one_composed_callable():
    before = fused_cache_info()["entries"]
    _, _, g, rec = _record_cholesky(workers=1)
    compile_recording(g, rec)
    after_one = fused_cache_info()["entries"]
    _, _, g2, rec2 = _record_cholesky(workers=1, seed=4)
    plan2 = compile_recording(g2, rec2)
    assert fused_cache_info()["entries"] == after_one >= before
    segs = [e[1] for e in plan2.program if e[0] == "fused"]
    assert all(s.graph is None for s in segs)


# ---------------------------------------------------------------------------
# a compiled run that fails part-way (ROADMAP Queue C)
# ---------------------------------------------------------------------------
def _inc(x):
    return x + 1


def _part_way_graph(pkg, state, ch):
    """``inc`` (fusible: ``x += 1`` in the fuse state), then ``waiter``,
    an opaque plain body that receives from ``ch``, and ``sender``, which
    fills it; no edge orders the last two."""
    g = pkg.Graph("part-way")
    g.fuse_state = state

    def inc_body(ctx):
        state["x"] = _inc(state["x"])

    fuse_spec = (JaxFuseSpec if pkg is repro else FuseSpec)(
        _inc, ("x",), ("x",), jit_safe=False)
    inc = g.add(inc_body, name="inc", fuse=fuse_spec)
    g.add(lambda ctx: ctx.recv(ch), name="waiter", deps=[inc])
    g.add(lambda ctx: ctx.send(ch, 1), name="sender")
    return g


@pytest.mark.xfail(strict=True, reason=(
    "a compiled run that raises CompiledRunError after some segments ran "
    "leaves their effects in the graph's state, and the session's replay "
    "fallback runs those tasks again (both packages; ROADMAP Queue C)"))
@pytest.mark.parametrize("pkg", ["repro", "repro_torch"])
def test_compiled_run_stalling_part_way_falls_back_without_double_effects(
        pkg):
    mod = repro if pkg == "repro" else repro_torch
    cache_cls = JaxGraphCache if pkg == "repro" else GraphCache
    rec_cls = JaxRecording if pkg == "repro" else Recording
    state = {"x": 0}
    ch = mod.Channel("part-way")
    g = _part_way_graph(mod, state, ch)
    with mod.Session(2, record=True) as s:
        rec = s.run(g).recording
    assert state["x"] == 1
    # pin the order that makes the compiled driver reach the receive before
    # the send: worker 0 runs inc then waiter, worker 1 the sender
    pinned = rec_cls.from_dict(rec.to_dict())
    tid = {t.name: t.tid for t in g.tasks}
    pinned.worker_orders = [[tid["inc"], tid["waiter"]], [tid["sender"]]]
    cache = cache_cls()
    cache.store(pinned)
    state["x"] = 0
    g = _part_way_graph(mod, state, mod.Channel("part-way"))
    with mod.Session(2, scheduler="compiled", cache=cache) as s:
        report = s.run(g)
    assert "compiled_fallback" in report.stats
    assert state["x"] == 1
