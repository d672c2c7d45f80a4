"""The port's sharded multi-process serving (engine ``procs=N``).

``tests/test_serving_mp.py``'s tests on the port: sharding a request
stream across worker processes changes THROUGHPUT, never CONTENT —
per-request token streams stay bit-identical to single-process (and to
per-request, unbatched) serving, children adopt the parent-seeded
recordings instead of re-recording, backpressure crosses the pipe, and a
killed child demotes its unfinished shard to the in-process fallback
without dropping a request.  Then the port's own model: the reduced
zamba2-7b, its weights built in each child by
``serve_lm.make_serving_fns(..., device="cpu")``, served with ``procs=2``
gives the single-process engine's tokens for every request, and
``serve_lm --arrivals poisson --procs 2`` runs end to end.
"""

import threading
import time

import pytest

import repro_torch
import test_torch_mp_helpers as helpers
from repro_torch.configs import get_config
from repro_torch.mp import WorkerError
from repro_torch.replay import GraphCache
from repro_torch.serving import ContinuousBatchingEngine, PoissonWorkload
from repro_torch.serving import serve_lm
from repro_torch.serving.workload import constant_prompt_requests

pytestmark = pytest.mark.mp


def _requests(budgets, arrivals=None, prompt=(1, 2, 3)):
    arrivals = [0.0] * len(budgets) if arrivals is None else arrivals
    return constant_prompt_requests(arrivals, budgets, list(prompt))


def _pool_session(cache_dir, workers=1, procs=None):
    return repro_torch.Session(
        workers, scheduler="pool", cache=GraphCache(str(cache_dir)),
        pool_kwargs={"warmup_runs": 0}, procs=procs)


def test_procs2_bit_identical_to_single_process_and_reference(tmp_path):
    reqs = _requests([4, 6, 3, 5, 4, 6, 3, 5],
                     arrivals=[i * 0.01 for i in range(8)])
    with _pool_session(tmp_path / "a") as s:
        single = ContinuousBatchingEngine(
            s, helpers.toy_decode, helpers.toy_prefill,
            sample_fn=helpers.toy_sample, max_batch=4).run(reqs)
    with _pool_session(tmp_path / "b", procs=2) as s:
        eng = ContinuousBatchingEngine(
            s, helpers.toy_decode, helpers.toy_prefill,
            sample_fn=helpers.toy_sample, max_batch=4,
            procs=2, fns_ref="test_torch_mp_helpers:make_toy_fns")
        sharded = eng.run(reqs)
    assert sharded.tokens_by_rid() == single.tokens_by_rid()
    assert sharded.tokens_by_rid() == helpers.per_request_reference(reqs)
    assert eng.mp_stats["dead"] == []
    assert eng.mp_stats["fallback"] == 0
    # both shards actually served (rid % 2 split)
    assert [p["completed"] for p in eng.mp_stats["per_proc"]] == [4, 4]


def test_children_adopt_parent_seeded_recordings_zero_rerecords(tmp_path):
    """Steady state: the parent seeds the shared disk cache (one in-process
    drive); the mp drive's children must then serve WARM — zero child-side
    records, zero re-records, every step driven by a recording."""
    cache_dir = tmp_path / "cache"
    reqs = _requests([5, 5, 5, 5, 5, 5])
    # the seed stream has an ODD count: its singleton tail records lane
    # shape 1 as well as shape 2 — the exact shapes each 3-request child
    # shard will hit
    with _pool_session(cache_dir) as s:
        ContinuousBatchingEngine(
            s, helpers.toy_decode, helpers.toy_prefill,
            sample_fn=helpers.toy_sample, max_batch=2).run(
                _requests([5] * 7))
    with _pool_session(cache_dir, procs=2) as s:
        eng = ContinuousBatchingEngine(
            s, helpers.toy_decode, helpers.toy_prefill,
            sample_fn=helpers.toy_sample, max_batch=2,
            procs=2, fns_ref="test_torch_mp_helpers:make_toy_fns")
        report = eng.run(reqs)
    assert report.tokens_by_rid() == helpers.per_request_reference(reqs)
    for summary in eng.mp_stats["per_proc"]:
        assert summary["records"] == 0       # adopted, never recorded
        assert summary["rerecords"] == 0
        assert summary["warm_steps"] == summary["steps"] > 0


def test_admission_backpressure_crosses_the_pipe(tmp_path):
    """Raw protocol: a child whose bounded admission queue is full answers
    a serve_submit with an AdmissionFull error future the parent can
    retry — and the engine path's own throttle keeps outstanding work
    under its cap."""
    with _pool_session(tmp_path, procs=1) as s:
        pool = s.process_pool()
        pool.request(0, "serve_open", {
            "stream": 999, "fns_ref": ("test_torch_mp_helpers:make_slow_toy_fns",
                                       {"delay": 0.005}),
            "engine": {"max_batch": 1, "admission_capacity": 1,
                       "step_time": 0.01},
        }).result(timeout=60)
        reqs = _requests([30] * 6)
        futs = [pool.request(0, "serve_submit", {"stream": 999, "request": r})
                for r in reqs]
        refused = [(f, r) for f, r in zip(futs, reqs)
                   if isinstance(f.exception(timeout=120), WorkerError)]
        assert refused, "6 instant submits into 1 lane + 1 slot must refuse"
        assert all(f.exception(timeout=0).kind == "AdmissionFull"
                   for f, _ in refused)
        done = [f for f in futs if f.exception(timeout=0) is None]
        # retry the refused requests until the child accepts them all
        deadline = time.monotonic() + 120
        pending = [r for _, r in refused]
        while pending and time.monotonic() < deadline:
            fut = pool.request(0, "serve_submit",
                               {"stream": 999, "request": pending[0]})
            if isinstance(fut.exception(timeout=120), WorkerError):
                time.sleep(0.02)
                continue
            done.append(fut)
            pending.pop(0)
        assert not pending
        records = [f.result(timeout=120) for f in done]
        assert sorted(r.rid for r in records) == [r.rid for r in reqs]
        summary = pool.request(0, "serve_close",
                               {"stream": 999}).result(timeout=60)
        assert summary["completed"] == len(reqs)


def test_engine_throttle_respects_outstanding_cap(tmp_path):
    with _pool_session(tmp_path, procs=2) as s:
        eng = ContinuousBatchingEngine(
            s, helpers.toy_decode, helpers.toy_prefill,
            sample_fn=helpers.toy_sample, max_batch=2,
            admission_capacity=2, procs=2,
            fns_ref="test_torch_mp_helpers:make_toy_fns")
        report = eng.run(_requests([6] * 12))
    assert len(report.records) == 12
    cap = eng.mp_stats["cap"]
    assert cap == 4                           # admission_capacity + max_batch
    assert all(peak <= cap
               for peak in eng.mp_stats["peak_outstanding"].values())


def test_killed_child_falls_back_in_process_without_dropping(tmp_path):
    """Chaos: kill child 1 mid-stream.  Its unfinished requests must be
    re-served by the in-process fallback engine — every rid present, every
    stream still bit-identical to the per-request reference."""
    reqs = _requests([60] * 8)
    with _pool_session(tmp_path, procs=2) as s:
        pool = s.process_pool()               # pre-spawn so the killer can aim
        eng = ContinuousBatchingEngine(
            s, *helpers.make_slow_toy_fns(0.003)[:2],
            sample_fn=helpers.toy_sample, max_batch=2, procs=2,
            fns_ref=("test_torch_mp_helpers:make_slow_toy_fns",
                     {"delay": 0.003}))
        killer = threading.Timer(0.25, pool.kill, args=(1,))
        killer.start()
        try:
            report = eng.run(reqs, timeout=300)
        finally:
            killer.cancel()
    assert sorted(report.records) == [r.rid for r in reqs]
    assert report.tokens_by_rid() == helpers.per_request_reference(reqs)
    assert eng.mp_stats["dead"] == [1]
    assert eng.mp_stats["fallback"] > 0       # something was actually rescued


def test_procs_needs_a_factory_reference():
    with repro_torch.Session(1) as s:
        with pytest.raises(ValueError, match="fns_ref"):
            ContinuousBatchingEngine(s, helpers.toy_decode,
                                     helpers.toy_prefill, procs=2)
        with pytest.raises(ValueError, match="procs"):
            ContinuousBatchingEngine(s, helpers.toy_decode,
                                     helpers.toy_prefill, procs=0,
                                     fns_ref="x:y")


# ---------------------------------------------------------------------------
# the reduced zamba2-7b, built in every child by make_serving_fns
PROMPT_LEN, TOKENS = (6, 12), 5


def test_reduced_zamba2_procs2_equals_single_process(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")    # the children's torch
    factory = dict(arch="zamba2-7b", prompt_len=PROMPT_LEN[1],
                   tokens=TOKENS, reduced=True, device="cpu")
    cfg = get_config("zamba2-7b").reduced()
    reqs = PoissonWorkload(500.0, 6, seed=3, prompt_len=PROMPT_LEN,
                           max_new_tokens=(2, TOKENS),
                           vocab_size=cfg.vocab_size).requests()
    decode_fn, prefill_fn = serve_lm.make_serving_fns(**factory)
    with repro_torch.Session(1) as s:
        single = ContinuousBatchingEngine(s, decode_fn, prefill_fn,
                                          max_batch=2).run(reqs)
    with repro_torch.Session(1, procs=2) as s:
        eng = ContinuousBatchingEngine(
            s, decode_fn, prefill_fn, max_batch=2, procs=2,
            fns_ref=("repro_torch.serving.serve_lm:make_serving_fns",
                     factory))
        sharded = eng.run(reqs)
    assert sharded.completed == len(reqs)
    assert sharded.tokens_by_rid() == single.tokens_by_rid()
    assert eng.mp_stats["dead"] == [] and eng.mp_stats["fallback"] == 0
    assert [p["completed"] for p in eng.mp_stats["per_proc"]] == [3, 3]


def test_serve_lm_poisson_procs2_runs_end_to_end(monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["--arrivals", "poisson", "--reduced", "--device", "cpu",
            "--layers", "2", "--tokens", "4", "--prompt-len", "8",
            "--requests", "4", "--max-new", "2:3"]
    sharded = serve_lm.main(argv + ["--procs", "2"])
    out = capsys.readouterr().out
    assert "procs=2" in out and "proc0[pid" in out and "proc1[pid" in out
    assert "dead workers" not in out
    single = serve_lm.main(argv)
    assert sharded.completed == 4
    assert sharded.tokens_by_rid() == single.tokens_by_rid()
    with pytest.raises(SystemExit):                # batch arrivals: refused
        serve_lm.main(["--reduced", "--device", "cpu", "--procs", "2"])
