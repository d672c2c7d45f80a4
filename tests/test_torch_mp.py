"""The port's multi-process execution pool (``repro_torch.mp``).

``tests/test_mp.py``'s tests on the port — the pipe protocol (futures,
remote errors, timeouts, death), the cross-process GraphCache shipment
channel (writer races, plan-meta round trips) and the Session integration
(async ``submit``, sharded ``map(procs=N)`` with recording adoption) —
plus what the port adds: replies carry numpy, never torch tensors; the
children import neither JAX nor the reference package; and a sharded
Cholesky sweep gives factors bit-identical to the in-process sweep and
within 1e-12 of the reference package's factor of the same matrix.

The children resolve their task bodies in ``tests/test_torch_mp_helpers.py``
(which imports no JAX).  Tests whose pools neither kill nor shut down
their workers share one module-scoped pool.  Everything here spawns real
processes -> ``pytest.mark.mp``.
"""

import json
import multiprocessing
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
import test_torch_mp_helpers as helpers
from repro.linalg import build_cholesky_graph as jax_build_cholesky
from repro.linalg import cholesky_extract as jax_cholesky_extract
from repro.linalg import to_tiles as jax_to_tiles
from repro_torch.api.session import PlanError
from repro_torch.linalg import random_spd
from repro_torch.mp import (
    FutureTimeout,
    ProcessPool,
    WorkerDied,
    WorkerError,
    WorkerSpec,
    callable_ref,
)
from repro_torch.mp.tasks import portable
from repro_torch.replay import GraphCache

pytestmark = pytest.mark.mp


@pytest.fixture(scope="module")
def pool():
    """Two workers shared by the tests that neither kill nor shut down
    their pool; a child's session, once built, runs torch on one thread."""
    spec = WorkerSpec(workers=1, init=callable_ref(helpers.init_one_thread))
    with ProcessPool(2, spec) as p:
        yield p


def _children():
    return set(multiprocessing.active_children())


# ---------------------------------------------------------------------------
# protocol / lifecycle
def test_pool_roundtrip_ping_and_submit():
    before = _children()
    with ProcessPool(2, WorkerSpec(workers=1)) as p:
        assert p.ping(0, "tok") == "tok"
        assert p.ping(1, {"nested": [1, 2]}) == {"nested": [1, 2]}
        ids = [p.submit(helpers.whoami, proc=i).result(timeout=60)
               for i in (0, 1)]
        assert [w["index"] for w in ids] == [0, 1]
        assert len({w["pid"] for w in ids}) == 2          # real processes
        assert all(w["pid"] != os.getpid() for w in ids)
        assert p.submit(helpers.add, 19, 23).result(timeout=60) == 42
    assert _children() <= before


def test_pool_map_round_robins_in_order(pool):
    assert pool.map(helpers.echo, list(range(7)), timeout=60) == list(range(7))


def test_worker_init_builds_state_once():
    spec = WorkerSpec(workers=1, init=callable_ref(helpers.init_marker))
    with ProcessPool(1, spec) as p:
        state = p.submit(helpers.get_state, proc=0).result(timeout=60)
        assert state["index"] == 0
        assert state["init_pid"] != os.getpid()
        again = p.submit(helpers.get_state, proc=0).result(timeout=60)
        assert again == state                             # built once


def test_remote_error_ships_kind_and_traceback(pool):
    fut = pool.submit(helpers.boom, "kaboom", proc=0)
    with pytest.raises(WorkerError) as ei:
        fut.result(timeout=60)
    assert ei.value.kind == "ValueError"
    assert "kaboom" in str(ei.value)
    assert "test_torch_mp_helpers" in ei.value.remote_traceback
    # the worker survives its task's exception
    assert pool.ping(0, "alive") == "alive"


def test_callable_ref_rejects_closures_and_lambdas():
    def local_fn(ctx):
        return 1

    for bad in (local_fn, (lambda ctx: 1)):
        with pytest.raises(ValueError, match="not shippable"):
            callable_ref(bad)
    assert callable_ref(helpers.echo) == "test_torch_mp_helpers:echo"


def test_future_timeout_fires_across_spawn_then_kill_reaps():
    """A parent-side ``result(timeout=)`` fires while the child is wedged
    in a task, and killing the wedged child fails its outstanding
    futures."""
    before = _children()
    with ProcessPool(1, WorkerSpec(workers=1)) as p:
        fut = p.submit(helpers.hang, 60.0, proc=0)
        t0 = time.monotonic()
        with pytest.raises(FutureTimeout):
            fut.result(timeout=0.5)
        assert time.monotonic() - t0 < 5.0
        assert not fut.done()                 # still outstanding, not dead
        p.kill(0)
        with pytest.raises(WorkerDied) as ei:
            fut.result(timeout=30)
        assert ei.value.proc == 0
        assert not p.alive(0)
    assert _children() <= before


def test_dead_worker_refuses_new_requests_fast():
    with ProcessPool(2, WorkerSpec(workers=1)) as p:
        p.kill(1)
        fut = p.submit(helpers.echo, "x", proc=1)
        with pytest.raises(WorkerDied):
            fut.result(timeout=30)
        assert p.ping(0, 1) == 1              # sibling unaffected


# ---------------------------------------------------------------------------
# what crosses the pipe
def test_worker_replies_carry_numpy_never_tensors(pool):
    """``import torch`` registers tensor reductions with the pipe's pickler;
    the worker must not use them: tensors come back as numpy copies."""
    out = pool.submit(helpers.tensors, proc=1).result(timeout=60)
    assert not helpers.holds_tensor(out)
    np.testing.assert_array_equal(out["f32"], np.arange(6, dtype=np.float32)
                                  .reshape(2, 3))
    assert out["nested"][0].dtype == np.float32          # bf16 widened
    np.testing.assert_array_equal(out["nested"][0], np.ones(2))
    assert isinstance(out["nested"][1], tuple)
    assert out["nested"][1][0] == 7 and out["plain"] == 3


def test_run_builder_payload_holds_no_tensor(pool):
    got = pool.submit(helpers.builder_payload, 3, proc=0).result(timeout=120)
    assert not got["tensor_in_child"]     # run_builder made it portable
    payload = got["payload"]
    assert not helpers.holds_tensor(payload)
    L = helpers.factor_of(payload["results"])
    assert isinstance(L, np.ndarray) and L.dtype == np.float64
    assert L.shape == (helpers.CHOL_N, helpers.CHOL_N)
    assert payload["proc"] == 0 and payload["mode"] == "warm"


def test_portable_converts_tensors_in_containers():
    value = {"a": [torch.zeros(2), {"b": torch.ones(1, dtype=torch.bfloat16)}],
             "c": "text"}
    out = portable(value)
    assert not helpers.holds_tensor(out)
    assert out["c"] == "text" and out["a"][1]["b"].dtype == np.float32


def test_children_import_no_jax_or_reference(pool):
    """The parent imported JAX and the reference package; its children,
    having resolved helpers and run a torch task, import neither."""
    assert "jax" in sys.modules
    pool.submit(helpers.tensors, proc=0).result(timeout=60)
    for p in (0, 1):
        got = pool.submit(helpers.imported_jax_or_reference,
                          proc=p).result(timeout=60)
        assert got == []


# ---------------------------------------------------------------------------
# GraphCache as the cross-process shipment channel
def test_two_process_cache_writer_race_leaves_no_torn_files(pool, tmp_path):
    """Two worker processes store/swap/plan-meta the SAME cache key
    concurrently; afterwards every on-disk file must parse (atomic
    rename + lock) and nothing may have been quarantined."""
    path = str(tmp_path / "cache")
    futs = [pool.submit(helpers.cache_hammer, path, 40, proc=p)
            for p in (0, 1)]
    outs = [f.result(timeout=300) for f in futs]
    assert outs[0]["digest"] == outs[1]["digest"]
    names = sorted(os.listdir(path))
    assert not [n for n in names if n.endswith(".corrupt")], names
    assert not [n for n in names if n.endswith(".tmp")], names
    parsed = 0
    for n in names:
        if n.endswith(".json"):
            with open(os.path.join(path, n)) as fh:
                json.load(fh)                 # raises on a torn write
            parsed += 1
    assert parsed >= 2                        # recording + plan meta
    # lock files must be invisible to the candidates() scan
    cache = GraphCache(path)
    cands = cache.candidates(outs[0]["digest"])
    assert list(cands) == [2]


def test_plan_meta_round_trips_across_processes(pool, tmp_path):
    """Meta stored by one process is read by another (fresh instance reads
    through to disk), and a swap in process A drops the meta process B
    observes."""
    path = str(tmp_path / "cache")
    meta = {"segments": 3, "fused": 5, "source": "proc0"}
    seed = pool.submit(helpers.seed_recording, path, proc=0).result(
        timeout=120)
    args = (path, seed["digest"], seed["workers"], seed["policy"])
    pool.submit(helpers.store_plan_meta, *args, meta,
                proc=0).result(timeout=60)
    # cross-process read: proc 1 never wrote this meta
    got = pool.submit(helpers.lookup_plan_meta, *args,
                      proc=1).result(timeout=60)
    assert got == meta
    # swap in proc 0 stales the lowering; proc 1 must observe the drop
    pool.submit(helpers.swap_same_recording, *args,
                proc=0).result(timeout=60)
    gone = pool.submit(helpers.lookup_plan_meta, *args,
                       proc=1).result(timeout=60)
    assert gone is None


# ---------------------------------------------------------------------------
# Session integration: async submit + sharded map
def test_session_submit_overlaps_build_with_execution():
    with repro_torch.Session(workers=1) as s:
        futs = []
        for i in range(5):                    # build i+1 while i runs
            futs.append(s.submit(helpers.build_chain(i)))
        outs = [f.result(timeout=60) for f in futs]
    for i, rep in enumerate(outs):
        assert set(rep.results.values()) == helpers.chain_expected(i)


def test_session_submit_carries_exceptions_and_close_drains():
    def bad_graph():
        g = repro_torch.Graph("bad")
        g.add(lambda: 1 / 0, name="div")
        return g

    s = repro_torch.Session(workers=1)
    ok = s.submit(helpers.build_chain(3))
    bad = s.submit(bad_graph())
    tail = s.submit(helpers.build_chain(4))
    s.close()                                 # drains: nothing dropped
    assert set(ok.result(timeout=1).results.values()) == \
        helpers.chain_expected(3)
    assert isinstance(bad.exception(timeout=1), ZeroDivisionError)
    assert set(tail.result(timeout=1).results.values()) == \
        helpers.chain_expected(4)
    with pytest.raises(PlanError):
        s.submit(helpers.build_chain(5))


def test_session_map_shards_across_processes_with_adoption(tmp_path):
    """map(procs=2): input 0 records in-process (seeding the shared disk
    cache); every other input executes in a child that ADOPTS the seeded
    recording — mode replay, no child-side recording run."""
    cache = GraphCache(str(tmp_path / "cache"))
    with repro_torch.Session(2, scheduler="replay", cache=cache,
                             procs=2) as s:
        reports = s.map(helpers.build_chain, list(range(7)))
    assert reports[0].plan.mode == "record"   # the in-process seed
    procs_used = set()
    for i, rep in enumerate(reports[1:], start=1):
        assert set(rep.results.values()) == helpers.chain_expected(i)
        assert rep.plan.mode == "replay"      # adopted, never re-recorded
        procs_used.add(rep.stats["mp_proc"])
    assert procs_used == {0, 1}               # round-robined both children


def test_session_map_procs_rejects_unshippable_builder(tmp_path):
    cache = GraphCache(str(tmp_path / "cache"))
    with repro_torch.Session(1, scheduler="replay", cache=cache) as s:
        with pytest.raises(PlanError, match="import reference"):
            s.map(lambda x: helpers.build_chain(x), [1, 2], procs=2)


def test_session_close_shuts_pool_down():
    before = _children()
    s = repro_torch.Session(1, procs=2)
    p = s.process_pool()
    assert p.ping(0, 1) == 1
    s.close()
    deadline = time.monotonic() + 10
    while not _children() <= before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _children() <= before
    with pytest.raises(RuntimeError):
        p.request(0, "ping", 1)


def test_parent_death_sentinel_reaps_children():
    """A pool owner that exits WITHOUT calling shutdown must not strand
    children: the child's recv loop exits on pipe EOF.  Simulated by
    dropping the parent-side connections."""
    before = _children()
    p = ProcessPool(1, WorkerSpec(workers=1))
    proc = p._workers[0].process
    pid = proc.pid
    p._workers[0].conn.close()                # the EOF sentinel
    proc.join(timeout=30)
    assert proc.exitcode == 0                 # clean exit, not a reap
    p.shutdown()
    assert _children() <= before
    assert pid is not None


# ---------------------------------------------------------------------------
# a sharded Cholesky sweep against the in-process sweep and the reference
SEEDS = [0, 1, 2, 3, 4]


def _reference_factor(a: np.ndarray) -> np.ndarray:
    """The reference package's factor of ``a`` (x64 on process-wide: the
    session's worker threads do not see a scoped ``enable_x64``)."""
    b = helpers.CHOL_B
    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        store = jax_to_tiles(jnp.asarray(a), b)
        with repro.Session(2, policy="hybrid") as s:
            s.run(jax_build_cholesky(helpers.CHOL_N // b, b, store=store))
        L = np.asarray(jax_cholesky_extract(store))
    finally:
        jax.config.update("jax_enable_x64", prev)
    assert L.dtype == np.float64
    return L


def test_map_procs_cholesky_equals_in_process_and_reference(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # the children's torch
    with repro_torch.Session(2, scheduler="replay",
                             cache=GraphCache(str(tmp_path / "a"))) as s:
        local = [helpers.factor_of(r.results)
                 for r in s.map(helpers.build_cholesky, SEEDS)]
    with repro_torch.Session(2, scheduler="replay",
                             cache=GraphCache(str(tmp_path / "b")),
                             procs=2) as s:
        reports = s.map(helpers.build_cholesky, SEEDS)
    assert [r.plan.mode for r in reports] == ["record"] + ["replay"] * 4
    assert {r.stats["mp_proc"] for r in reports[1:]} == {0, 1}
    sharded = [helpers.factor_of(r.results) for r in reports]
    assert isinstance(sharded[0], torch.Tensor)            # in-process seed
    assert all(isinstance(L, np.ndarray) for L in sharded[1:])
    for seed, L, L_local in zip(SEEDS, sharded, local):
        np.testing.assert_array_equal(np.asarray(L), L_local.numpy())
        a = random_spd(helpers.CHOL_N, seed, device="cpu").numpy()
        np.testing.assert_allclose(np.asarray(L), _reference_factor(a),
                                   rtol=1e-12, atol=1e-12)
