"""The port's trace assembly and Perfetto export (``repro_torch.obs``) on
the CPU, held against the reference package's (``repro.obs``).

Mirrors the trace half of ``tests/test_obs.py``: the untraced path keeps
the no-op recorder, a traced run assembles a ``RuntimeTrace`` whose
counters reconcile exactly with ``RunReport.stats``, the Perfetto export
round-trips to an equal trace, and the session/pool plumbing surfaces
traces and their metrics.  Across packages: each package's validator
accepts the other's export (one ``repro.obs/1`` schema).  The flight
recorder's own tests (rings, the allocation-free off path) are in
``tests/test_torch_runtime.py``.
"""

import json

import pytest

import repro
import repro_torch
from repro.obs import load_trace as jax_load_trace
from repro.obs import validate_trace_json as jax_validate_trace_json
from repro.obs import write_trace as jax_write_trace
from repro_torch.core.policies import POLICIES, VictimPolicy, register_policy
from repro_torch.core.tracing import (KIND_BARRIER, KIND_COMPUTE, KIND_STEAL,
                                      KIND_SWITCH, SPAN_KINDS)
from repro_torch.obs import (NULL_RECORDER, RuntimeTrace, load_trace,
                             validate_trace_json, write_trace)
from repro_torch.obs.export import main as export_main


def _mixed_graph(pkg=repro_torch, fanout=6):
    """Fan-out of plain tasks plus a channel-coupled producer/consumer frame
    pair: exercises task, steal, frame-suspend/resume and block events."""
    g = pkg.Graph("obs-mixed")
    ch = pkg.Channel("obs.ch", capacity=1)

    def producer(ctx):
        for i in range(3):
            yield ctx.send(ch, i)
        return "done"

    def consumer(ctx):
        total = 0
        for _ in range(3):
            v = yield ctx.recv(ch)
            total += v
        return total

    root = g.add(lambda: 1, name="root")
    mids = [g.add(lambda x: x + 1, root, name=f"m{i}") for i in range(fanout)]
    p = g.add(producer, deps=[root], name="producer")
    c = g.add(consumer, deps=[root], name="consumer")
    join = g.add(lambda *xs: sum(x for x in xs if isinstance(x, int)),
                 *mids, c, deps=[p], name="join")
    return g, c, join


def _traced_run(pkg=repro_torch, workers=2):
    g, _, _ = _mixed_graph(pkg)
    with pkg.Session(workers, trace=True) as s:
        return s.run(g).trace


# ---------------------------------------------------------------------------
# session plumbing + reconciliation
# ---------------------------------------------------------------------------
def test_untraced_runtime_uses_null_recorder_singleton():
    from repro_torch.core.runtime import Runtime

    rt = Runtime(2)
    assert rt._dispatch.recorder is NULL_RECORDER
    assert rt.last_trace is None
    rt.shutdown()


def test_untraced_session_report_has_no_trace():
    g, _, join = _mixed_graph()
    with repro_torch.Session(2) as s:
        report = s.run(g)
    assert report.trace is None
    assert join in report


def test_traced_dynamic_run_reconciles_with_stats():
    g, c, _ = _mixed_graph()
    with repro_torch.Session(2, trace=True) as s:
        report = s.run(g)
    trace = report.trace
    assert isinstance(trace, RuntimeTrace)
    assert report[c] == 0 + 1 + 2
    assert trace.reconcile(report.stats) == {}
    assert trace.counters["frame_suspends"] >= 1
    assert trace.counters["tasks"] == len(g.tasks)
    assert set(e.kind for e in trace.events) <= SPAN_KINDS
    assert trace.metrics()["dropped_events"] == 0


def test_traced_one_worker_replay_reconciles_exactly():
    g1, _, _ = _mixed_graph(fanout=3)
    with repro_torch.Session(1, scheduler="replay", trace=True) as s:
        first = s.run(g1)
        assert first.plan.mode == "record"
        g2, _, _ = _mixed_graph(fanout=3)
        second = s.run(g2)
    assert second.plan.mode == "replay"
    trace = second.trace
    assert isinstance(trace, RuntimeTrace)
    assert trace.reconcile(second.stats) == {}
    assert trace.counters["frame_suspends"] == second.stats["frame_suspends"]
    assert trace.counters["fallback_steals"] == second.stats["fallback_steals"]


def test_trace_breakdown_shares_simulator_vocabulary():
    from repro_torch.core import microbatch_overlap_graph, simulate

    sim_trace = simulate(microbatch_overlap_graph(8), 2, seed=0)
    run_trace = _traced_run()
    for tr in (sim_trace, run_trace):
        assert set(tr.breakdown()) <= SPAN_KINDS
        assert 0.0 <= tr.utilization() <= 1.0
    assert run_trace.breakdown().get(KIND_COMPUTE, 0.0) > 0.0


def test_traced_factorization_spans_only_span_kinds(tmp_path):
    """Cholesky's ``lookahead`` tasks span as ``compute``: the export of a
    traced factorization validates and its steals reconcile."""
    from repro_torch.linalg import build_cholesky_graph, random_spd, to_tiles

    store = to_tiles(random_spd(64, seed=1, device="cpu"), 16, device="cpu")
    with repro_torch.Session(4, trace=True) as s:
        report = s.run(build_cholesky_graph(4, 16, store=store))
    trace = report.trace
    assert set(e.kind for e in trace.events) <= SPAN_KINDS
    assert trace.count(KIND_STEAL) == report.stats["steals"]
    assert trace.reconcile(report.stats) == {}
    path = tmp_path / "cholesky.json"
    write_trace(trace, path)
    assert validate_trace_json(path)["slices"] > 0
    assert jax_validate_trace_json(path)["slices"] > 0


# ---------------------------------------------------------------------------
# Perfetto export, in both packages
# ---------------------------------------------------------------------------
def test_perfetto_roundtrip_is_exact(tmp_path):
    trace = _traced_run()
    path = tmp_path / "trace.json"
    write_trace(trace, path)
    loaded = load_trace(path)
    assert loaded == trace
    assert loaded.metrics() == trace.metrics()


def test_perfetto_json_shape_and_validation(tmp_path):
    trace = _traced_run()
    path = tmp_path / "trace.json"
    write_trace(trace, path)
    info = validate_trace_json(path)
    assert info["schema"] == "repro.obs/1"
    assert info["rows"] == trace.n_workers + 1
    data = json.loads(path.read_text())
    events = data["traceEvents"]
    assert sum(1 for e in events if e["ph"] == "M"
               and e["name"] == "thread_name") == trace.n_workers + 1
    assert any(e["ph"] == "X" for e in events)
    if trace.steal_flows or trace.frame_flows:
        assert any(e["ph"] == "s" for e in events)
        assert any(e["ph"] == "f" for e in events)
    assert data["otherData"]["counters"] == trace.counters


def test_validate_rejects_malformed_trace(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": "x", "ts": 0, "dur": -5, "pid": 1, "tid": 0,
         "cat": "nope"}]}))
    with pytest.raises(ValueError, match="schema"):
        validate_trace_json(bad)
    with pytest.raises(ValueError, match="schema"):
        jax_validate_trace_json(bad)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_each_package_validates_and_loads_the_others_trace(tmp_path, writer):
    """One schema: a trace either package writes passes both validators
    with the same summary, and both loaders rebuild the same events."""
    path = tmp_path / "trace.json"
    if writer == "repro":
        jax_write_trace(_traced_run(repro), path)
    else:
        write_trace(_traced_run(), path)
    ours, theirs = validate_trace_json(path), jax_validate_trace_json(path)
    assert ours == theirs
    a, b = load_trace(path), jax_load_trace(path)

    def fields(t):
        return [(e.worker, e.t0, e.t1, e.kind, e.label) for e in t.events]

    assert fields(a) == fields(b) and a.counters == b.counters
    assert a.steal_flows == b.steal_flows and a.frame_flows == b.frame_flows


def test_export_cli_demo_and_validate(tmp_path, capsys):
    out = tmp_path / "demo.json"
    assert export_main(["--out", str(out), "--workers", "2",
                        "--steps", "2"]) == 0
    assert export_main(["--validate", str(out),
                        "--summarize", str(out)]) == 0
    text = capsys.readouterr().out
    assert "breakdown" in text and "steal success" in text
    assert jax_validate_trace_json(out)["schema"] == "repro.obs/1"


def test_export_cli_runs_as_a_module(tmp_path):
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    out = tmp_path / "demo.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.export", "--out", str(out),
         "--workers", "2", "--steps", "1"], cwd=src, capture_output=True,
        text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": []}))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.export", "--validate",
         str(bad)], cwd=src, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0


# ---------------------------------------------------------------------------
# pool serving stats + rolling trace metrics
# ---------------------------------------------------------------------------
def test_pool_surfaces_mode_replay_stats_and_trace_metrics():
    with repro_torch.Session(2, scheduler="pool", trace=True,
                             pool_kwargs={"warmup_runs": 1}) as s:
        modes = []
        for _ in range(3):
            g, _, _ = _mixed_graph(fanout=3)
            report = s.run(g)
            modes.append(report.stats["pool_mode"])
            assert isinstance(report.trace, RuntimeTrace)
        assert modes == ["warmup", "record", "replay"]
        rs = report.stats["replay_stats"]
        assert {"fallback_steals", "stalls", "skips", "run_ahead"} <= set(rs)
        (entry_stats,) = s.pool.describe().values()
        tm = entry_stats["trace_metrics"]
        assert {"steal_success_rate", "dispatch_overhead_fraction",
                "utilization", "resume_latency_mean_s"} <= set(tm)
        assert 0.0 <= tm["utilization"] <= 1.0


def test_untraced_pool_keeps_trace_metrics_empty():
    with repro_torch.Session(2, scheduler="pool") as s:
        g, _, _ = _mixed_graph(fanout=3)
        report = s.run(g)
        assert report.trace is None
        (entry_stats,) = s.pool.describe().values()
        assert entry_stats["trace_metrics"] == {}


# ---------------------------------------------------------------------------
# victim-policy feedback
# ---------------------------------------------------------------------------
def _spy_policy(name, observed):
    @register_policy(name)
    class SpyPolicy(VictimPolicy):
        def select(self):
            return self._rand_victim()

        def record(self, victim, success):
            pass

        def observe(self, metrics):
            observed.append(metrics)

    SpyPolicy.name = name
    return SpyPolicy


@pytest.mark.parametrize("traced", [True, False])
def test_only_traced_runs_feed_policy_observe(traced):
    observed = []
    _spy_policy(f"obs-spy-{traced}", observed)
    try:
        g, _, _ = _mixed_graph()
        with repro_torch.Session(2, policy=f"obs-spy-{traced}",
                                 trace=traced) as s:
            s.run(g)
        if traced:
            assert len(observed) == 2
            assert "steal_by_victim" in observed[0]
            assert "resume_latency" in observed[0]
        else:
            assert observed == []
    finally:
        POLICIES.pop(f"obs-spy-{traced}", None)


# ---------------------------------------------------------------------------
# assembled-span sanity, the serving engine and serve_lm
# ---------------------------------------------------------------------------
def test_assembled_spans_are_well_formed():
    trace = _traced_run()
    assert trace.events, "traced run produced no spans"
    for e in trace.events:
        assert e.t1 >= e.t0 >= 0.0
        assert -1 <= e.worker < trace.n_workers
    busy = [sum(v for k, v in w.items() if k != "idle")
            for w in trace.per_worker_breakdown()]
    assert all(b <= trace.makespan + 1e-12 for b in busy)
    for e in trace.events:
        if e.kind not in (KIND_STEAL, KIND_SWITCH, KIND_BARRIER):
            assert e.dt >= 0.0


def test_engine_report_keeps_the_most_loaded_steps_trace():
    from repro_torch.serving import ContinuousBatchingEngine, PoissonWorkload

    def decode(cache, tok):
        h = (cache["h"] * 31 + int(tok) + 7) % 10_007
        return {"h": h}, [float(h % 5 == i) for i in range(5)]

    def prefill(prompt):
        return {"h": 7}, [1.0, 0.0, 0.0, 0.0, 0.0]

    w = PoissonWorkload(200.0, 6, seed=3, prompt_len=4,
                        max_new_tokens=(2, 5), vocab_size=50)
    with repro_torch.Session(2, trace=True) as s:
        report = ContinuousBatchingEngine(
            s, decode, prefill, max_batch=3, step_time=0.01,
            sample_fn=lambda logits: max(range(5), key=logits.__getitem__),
        ).run(w.requests())
    assert isinstance(report.trace, RuntimeTrace)
    assert report.trace.counters["tasks"] > 0


@pytest.mark.parametrize("arrivals", ["batch", "poisson"])
def test_serve_lm_trace_writes_a_valid_perfetto_file(tmp_path, arrivals):
    from repro_torch.serving import serve_lm

    path = tmp_path / "serve.json"
    serve_lm.main(["--reduced", "--device", "cpu", "--layers", "2",
                   "--tokens", "4", "--prompt-len", "8", "--arrivals",
                   arrivals, "--requests", "3", "--max-new", "2:3",
                   "--trace", str(path)])
    info = validate_trace_json(path)
    assert info["slices"] > 0
    assert json.loads(path.read_text())["otherData"]["arch"].endswith("smoke")


@pytest.mark.parametrize("argv", [["--scheduler", "jit"], ["--procs", "2"]])
def test_serve_lm_trace_refuses_jit_and_procs(tmp_path, argv):
    from repro_torch.serving import serve_lm

    with pytest.raises(SystemExit):
        serve_lm.main(["--reduced", "--device", "cpu", "--trace",
                       str(tmp_path / "t.json")] + argv)
