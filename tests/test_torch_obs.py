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
from pathlib import Path

import pytest
import torch

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


# ---------------------------------------------------------------------------
# the program's spans (repro_torch.obs.spans): the compiled driver, the
# train step and flash, the serving engine
# ---------------------------------------------------------------------------
ROOT = Path(__file__).resolve().parents[1]


def _chol_graph(seed=1, n=128, b=32):
    from repro_torch.linalg import build_cholesky_graph, random_spd, to_tiles

    store = to_tiles(random_spd(n, seed=seed, device="cpu"), b, device="cpu")
    return build_cholesky_graph(n // b, b, store=store), store


def _compiled_run(trace):
    """A compiled Cholesky's second run (the first records); returns its
    report and L."""
    from repro_torch.linalg import cholesky_extract

    with repro_torch.Session(2, scheduler="compiled", trace=trace) as s:
        s.run(_chol_graph()[0])
        g, store = _chol_graph()
        report = s.run(g)
    assert report.plan.mode == "compiled"
    return report, cholesky_extract(store)


def _train_step():
    """A 1-layer qwen3-shaped train step in 2 hybrid microbatches; returns
    a callable that runs one step."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import StepConfig, make_train_step

    cfg = get_config("qwen3-14b").reduced(n_layers=1)
    state = [init_params(cfg, 0, "cpu"), None]
    state[1] = adamw_init(state[0])
    step = make_train_step(cfg, AdamWConfig(), None, StepConfig(microbatches=2))
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
             for k in ("tokens", "labels")}

    def run():
        state[0], state[1], _ = step(state[0], state[1], batch)
    return run


def _engine_step(session=None):
    """A 2-lane engine whose two queued one-token requests one step
    serves; returns a callable that queues both and runs the step."""
    from repro_torch.serving import ContinuousBatchingEngine, Request

    def prefill(prompt):
        return None, torch.tensor([[0.0, 1.0, 0.5]])

    eng = ContinuousBatchingEngine(
        session, lambda cache, tok: (cache, None), prefill, max_batch=2,
        sample_fn=lambda logits: logits[0].argmax())
    rids = iter(range(1_000_000))

    def run():
        for _ in range(2):
            eng.submit(Request(rid=next(rids), prompt=None,
                               max_new_tokens=1))
        eng.step()
    return run


@pytest.mark.parametrize("call", ["compiled", "train", "engine"])
def test_untraced_calls_record_and_allocate_nothing(call):
    """With no profiler and tracing off, a compiled run, a train step and
    an engine step open no span and allocate nothing in the recorder."""
    import tracemalloc

    from repro_torch.obs import recorder, spans

    if call == "compiled":
        run = lambda: _compiled_run(False)           # noqa: E731
    elif call == "train":
        run = _train_step()
    else:
        session = repro_torch.Session(1)
        run = _engine_step(session)
    run()                                            # warm
    spans.reset()
    files = [tracemalloc.Filter(True, spans.__file__),
             tracemalloc.Filter(True, recorder.__file__)]
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot().filter_traces(files)
        run()
        after = tracemalloc.take_snapshot().filter_traces(files)
    finally:
        tracemalloc.stop()
        if call == "engine":
            session.close()
    grown = [d for d in after.compare_to(before, "lineno") if d.size_diff > 0]
    assert grown == []
    assert spans.current() is None
    assert spans.span_trace() is None


def test_compiled_session_trace_holds_its_spans(tmp_path):
    """A compiled run of a ``trace=True`` session returns a trace of its
    ``repro.compiled.*`` spans that validates and round-trips, and its
    factor is bit-identical to an untraced run's."""
    report, L = _compiled_run(True)
    untraced, L0 = _compiled_run(False)
    assert untraced.trace is None
    assert torch.equal(L, L0)
    trace = report.trace
    assert isinstance(trace, RuntimeTrace) and trace.dropped == 0
    (run,) = [s for s in trace.spans if s.label == "repro.compiled.run"]
    kids = [s for s in trace.spans if s.parent == run.sid]
    assert {s.label for s in kids} <= {
        "repro.compiled.bind", "repro.compiled.graph",
        "repro.compiled.segment", "repro.compiled.task",
        "repro.compiled.release"}
    assert len(kids) == len(trace.spans) - 1
    entries = [s for s in kids if s.label != "repro.compiled.bind"]
    assert len(entries) == trace.counters["repro.compiled.entries"]
    assert trace.counters["repro.compiled.skip_ahead"] == \
        report.stats["skip_ahead"]
    for a, b in zip(kids, kids[1:]):            # one after another
        assert run.t0 <= a.t0 <= a.t1 <= b.t0 <= b.t1 <= run.t1
    path = write_trace(trace, str(tmp_path / "compiled.json"))
    assert validate_trace_json(path)["slices"] == len(trace.spans)
    assert load_trace(path) == trace


def _profiled_events(body):
    import os
    import tempfile

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("portbench.traced"):
            body()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def test_profiled_spans_nest_and_keep_the_benchmark_idle_names():
    """Under torch.profiler every call's spans are nested
    ``user_annotation`` events, named apart from the benchmark's spans,
    and the benchmark's reduction of the trace names its idle gaps as it
    does without them."""
    import sys

    from repro_torch.obs import spans

    sys.path.insert(0, str(ROOT))
    from portbench import harness

    train, session = _train_step(), repro_torch.Session(1)
    engine = _engine_step(session)
    graph, _ = _chol_graph()
    with repro_torch.Session(2, scheduler="compiled") as chol:
        chol.run(graph)
        plan = chol.plan(graph)

        def body():
            with torch.profiler.record_function("factor"):
                chol.run(graph, plan=plan)
            with torch.profiler.record_function("train.step"):
                train()
            with torch.profiler.record_function("engine.step"):
                engine()
        spans.reset()
        events = _profiled_events(body)
    session.close()
    ours = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith("repro.")]
    names = {e["name"] for e in ours}
    assert {"repro.compiled.run", "repro.compiled.bind",
            "repro.train.step", "repro.train.grad", "repro.train.join",
            "repro.train.update", "repro.engine.step",
            "repro.engine.prefill", "repro.engine.sample"} <= names
    # the compiled driver's entries and flash stay out of the profiler's
    # trace (their cost under it, PERF.md §6); the recorder has them
    assert not names & {"repro.compiled.segment", "repro.compiled.task",
                        "repro.flash.fwd", "repro.flash.bwd"}
    assert not names & (set(harness.SPAN_NAMES) | {"portbench.traced"})

    def inside(name, outer):
        kids = [e for e in ours if e["name"] == name]
        outs = [e for e in ours if e["name"] == outer]
        assert kids and all(any(
            o["ts"] <= k["ts"] and k["ts"] + k["dur"] <= o["ts"] + o["dur"]
            for o in outs) for k in kids), (name, outer)
    inside("repro.compiled.bind", "repro.compiled.run")
    inside("repro.train.grad", "repro.train.step")
    inside("repro.train.update", "repro.train.step")
    inside("repro.engine.prefill", "repro.engine.step")
    tr = spans.span_trace()
    assert tr.dropped == 0
    assert {s.label for s in tr.spans} >= names | {
        "repro.compiled.task", "repro.flash.fwd", "repro.flash.bwd"}
    by_id = {s.sid: s for s in tr.spans}
    for s in tr.spans:       # each child inside its parent, but a wait
        if s.parent in by_id and s.label != "repro.engine.queue":
            p = by_id[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1, (s.label, p.label)
    flash = [s for s in tr.spans if s.label.startswith("repro.flash.")]
    assert flash and all(by_id[s.parent].label == "repro.train.grad"
                         for s in flash)

    # device operations (the CPU run has none) spread over the window, so
    # gaps fall inside and between the program's spans
    window = next(e for e in events if e["name"] == "portbench.traced")
    t0, dur = float(window["ts"]), float(window["dur"])
    ops = [{"ph": "X", "cat": "kernel", "name": f"k{i}",
            "ts": t0 + dur * i / 40, "dur": dur / 120} for i in range(40)]
    with_ours = harness.reduce_trace(events + ops)
    without = harness.reduce_trace(
        [e for e in events if e not in ours] + ops)
    assert with_ours.idle_by_span == without.idle_by_span
    assert set(with_ours.idle_by_span) >= {"factor", "train.step"}


#: the five readers' spans: (name, parent, host t0, t1, device t0, t1)
_SYNTHETIC = [
    ("repro.compiled.run", None, 0.0, 10.0, 0.0, 12.0),
    ("repro.compiled.bind", "repro.compiled.run", 0.0, 1.0, 0.5, 1.5),
    ("repro.compiled.graph", "repro.compiled.run", 2.0, 4.0, 2.5, 6.0),
    ("repro.compiled.task", "repro.compiled.run", 5.0, 8.0, 6.0, 9.0),
    ("repro.compiled.release", "repro.compiled.run", 9.0, 9.5, 9.5, 11.0),
    ("repro.train.step", None, 20.0, 30.0, 20.0, 33.0),
    ("repro.train.grad", "repro.train.step", 20.5, 25.0, 21.0, 27.0),
    ("repro.flash.fwd", "repro.train.grad", 21.0, 21.5, 21.5, 22.5),
    ("repro.flash.bwd", "repro.train.grad", 23.0, 24.0, 24.0, 26.0),
    ("repro.train.update", "repro.train.step", 26.0, 29.0, 27.0, 32.0),
    ("repro.engine.step", None, 40.0, 50.0, 40.0, 52.0),
    ("repro.engine.prefill", "repro.engine.step", 41.0, 44.0, 41.5, 47.0),
    ("repro.engine.sample", "repro.engine.step", 44.0, 45.0, 47.5, 48.0),
    ("repro.engine.prefill", "repro.engine.step", 46.0, 47.0, 48.0, 50.0),
    ("repro.engine.sample", "repro.engine.step", 47.0, 48.0, 50.5, 51.0),
]


@pytest.mark.parametrize("metric, expected", [
    # gaps 1.5 -> 2.5, 6 -> 6, 9 -> 9.5: 1.5 ms in one run
    ("entry_gap_ms.chol", 1.5e3),
    # 10 - (1 + 2 + 3 + 0.5)
    ("driver_self_ms.chol", 3.5e3),
    ("update_ms.train", 5.0e3),
    ("flash_ms.train", 3.0e3),
    # 40 -> 41.5, 47 -> 47.5, 48 -> 48, 50 -> 50.5, 51 -> 52
    ("step_gap_ms.score", 3.5e3),
])
@pytest.mark.parametrize("dropped", [False, True])
def test_span_readers_on_synthetic_spans(monkeypatch, metric, expected,
                                         dropped):
    """Each per-layer metric that reads the program's spans gives its
    number on known spans (seconds here, so ms read ×1e3), and None when
    the recorder dropped events."""
    import importlib.util

    from repro_torch.obs import spans

    w = spans._Window()
    if dropped:
        w.rec = repro_torch.obs.FlightRecorder(0, 8, owned=False)
    monkeypatch.setattr(spans, "_window", w)
    devices, sids = {}, {}
    sp = spans.Spans(w, False, None, outer=False)
    for name, parent, t0, t1, d0, d1 in _SYNTHETIC:
        w.open[:] = [sids[parent]] if parent else []
        sids[name] = sid = sp.begin(name, t0)
        sp.end(sid, t1)
        devices[sid] = (d0, d1)
    monkeypatch.setattr(spans, "_devices", lambda _w: devices)
    path = ROOT / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{id(path)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = mod.read(None)
    if dropped:
        assert got is None
    else:
        assert got == pytest.approx(expected)
