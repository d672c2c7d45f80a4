"""The port's runtime: structural keys and simulated schedules identical to
the reference package's, and the threaded runtime's generic behaviour
(fan-in, gang regions, channel frames, deadlock detection) on a
``repro_torch.Session`` whose workers shut down with it."""

import threading

import pytest

import repro
import repro_torch
from repro.core import simulate as jax_simulate
from repro.linalg import build_cholesky_graph as jax_build_cholesky
from repro.replay import graph_key as jax_graph_key
from repro_torch.core import Channel, DeadlockError, TaskGraph, simulate
from repro_torch.core.taskgraph import live_parked_frames
from repro_torch.exec.registry import REGISTRY
from repro_torch.linalg import build_cholesky_graph, cholesky_graph_key
from repro_torch.replay import graph_key


def _port_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("exec-core", "session", "repro-worker"))]


@pytest.fixture
def session():
    with repro_torch.Session(4) as s:
        yield s
    assert REGISTRY.refcounts().get(4, 0) == 0


@pytest.mark.parametrize("nb,b", [(1, 64), (4, 48), (6, 32), (40, 192)])
def test_cholesky_graph_key_matches_reference_package(nb, b):
    port = graph_key(build_cholesky_graph(nb, b))
    ref = jax_graph_key(jax_build_cholesky(nb, b))
    assert port.digest == ref.digest
    assert port.n_tasks == ref.n_tasks
    assert cholesky_graph_key(nb, b) == port


@pytest.mark.parametrize("policy", ["history", "random", "hybrid"])
@pytest.mark.parametrize("mode", ["gang", "oversubscribe"])
def test_simulated_cholesky_schedule_matches_reference_package(policy, mode):
    port = simulate(build_cholesky_graph(10, 192), 4, policy=policy,
                    mode=mode, seed=0)
    ref = jax_simulate(jax_build_cholesky(10, 192), 4, policy=policy,
                       mode=mode, seed=0)
    assert port.makespan == ref.makespan
    assert len(port.events) == len(ref.events)
    assert ([(e.worker, e.t0, e.t1, e.kind, e.label) for e in port.events]
            == [(e.worker, e.t0, e.t1, e.kind, e.label) for e in ref.events])


def test_session_dataflow_fan_in(session):
    g = repro_torch.Graph("fan-in")
    leaves = [g.add(lambda i=i: i * i, name=f"leaf{i}") for i in range(32)]
    total = g.add(lambda *xs: sum(xs), *leaves, name="sum")
    report = session.run(g)
    assert report[total] == sum(i * i for i in range(32))
    assert report.plan.mode == "warm" and report.n_workers == 4
    assert report.wall_s > 0


def test_session_gang_region_with_blocking_barrier(session):
    hits = []
    lock = threading.Lock()

    def body(tid, region):
        with lock:
            hits.append(("pre", tid))
        region.barrier()
        with lock:
            hits.append(("post", tid))
        return tid * 10

    g = TaskGraph("gang")
    t = g.add(lambda ctx: ctx.parallel(4, body, gang=True), name="spawn")
    report = session.run(g)
    assert sorted(report[t]) == [0, 10, 20, 30]
    assert [h[0] for h in hits[:4]] == ["pre"] * 4


def test_session_channel_frame_suspends_and_resumes(session):
    g = repro_torch.Graph("frames")
    ch = Channel("port.ch")

    def consumer(ctx, base):
        v = yield ctx.recv(ch)
        return base + v

    a = g.add(lambda: 5, name="a")
    cons = g.add(consumer, a, name="cons")
    g.add(lambda ctx: ch.send(10), name="prod")
    report = session.run(g)
    assert report[cons] == 15
    assert not live_parked_frames()


def test_nongang_blocking_region_deadlock_is_detected():
    def task(ctx):
        return ctx.parallel(6, lambda tid, region: region.barrier(), gang=False)

    g = TaskGraph("fig1")
    g.add(task, name="spawn")
    with pytest.raises((DeadlockError, TimeoutError)):
        repro_torch.run_graph(g, 3, timeout=20.0)


def test_task_failure_propagates_and_session_stays_usable(session):
    g = TaskGraph("boom")
    g.add(lambda ctx: 1 / 0, name="boom")
    with pytest.raises(ZeroDivisionError):
        session.run(g)
    g2 = repro_torch.Graph("after")
    h = g2.add(lambda: 7)
    assert session.run(g2)[h] == 7


def test_session_closes_its_workers():
    with repro_torch.Session(3, shared_cores=False) as s:
        g = repro_torch.Graph("one")
        h = g.add(lambda: 1)
        assert s.run(g)[h] == 1
        assert any(t.name.startswith("session3-worker") for t in _port_threads())
    with pytest.raises(repro_torch.PlanError):
        s.run(g)
    assert not any(t.name.startswith("session3-worker") for t in _port_threads())


@pytest.mark.parametrize("kwargs", [dict(procs=2)], ids=["procs"])
def test_unported_session_modes_raise_not_implemented(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item"):
        repro_torch.Session(2, **kwargs)


def test_policy_typo_fails_at_the_session_boundary():
    with pytest.raises(repro_torch.PolicyError):
        repro_torch.Session(2, policy="hybird")
    with pytest.raises(repro.PolicyError):
        repro.Session(2, policy="hybird")
