"""The port's serving layer: decode-step graphs, the continuous-batching
engine, and the reduced qwen3 LM served by the port and by the reference.

The first two groups are ``tests/test_serving.py``'s toy-decode graph
tests and ``tests/test_serving_engine.py``'s engine tests on the port,
with the ``dynamic`` scheduler in place of the pool (record-and-replay is
not ported); tests whose subject is the pool's warm replays stay in those
files.  The last group serves one seeded ``PoissonWorkload`` through both
packages' engines on the same converted weights (float32, CPU) and
requires identical token streams.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import prefill as jax_prefill
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core import run_graph
from repro_torch.kernels import launch_counts
from repro_torch.models import (DecodeShard, DecodeState, build_decode_graph,
                                decode_graph_key, decode_step, greedy_sample,
                                make_decode_state, params_from_reference,
                                prefill, shard_batch)
from repro_torch.replay import graph_key
from repro_torch.serving import (AdmissionFull, ContinuousBatchingEngine,
                                 PoissonWorkload, Request)
from repro_torch.serving.request import token_id
from repro_torch.serving.workload import constant_prompt_requests
from test_torch_models import reference_tree

# ---------------------------------------------------------------------------
# decode-step graphs over a toy decode (tests/test_serving.py)
VOCAB = 11


def _toy_decode(params, cache, tok):
    """Deterministic toy decode: cache carries a running hash, logits rotate
    with it — token streams are reproducible and shard-local."""
    h = cache["h"] * 31 + tok[:, 0] + 7
    logits = torch.stack(
        [torch.sin(h[:, None] * (i + 1)).float() for i in range(VOCAB)],
        dim=-1)
    return {"h": h}, logits


def _fresh_state(n_shards=4, per=1):
    shards = [
        DecodeShard(cache={"h": torch.full((per,), s + 1, dtype=torch.int32)},
                    tok=torch.full((per, 1), s, dtype=torch.int32))
        for s in range(n_shards)
    ]
    return DecodeState(params=None, shards=shards)


def _decode_loop(steps, workers, n_shards=4):
    state = _fresh_state(n_shards)
    for _ in range(steps):
        run_graph(build_decode_graph(state, _toy_decode), workers)
    return state.tokens().numpy()


def test_decode_graph_shape_is_stable_across_steps():
    state = _fresh_state()
    k1 = graph_key(build_decode_graph(state, _toy_decode))
    run_graph(build_decode_graph(state, _toy_decode), 2)
    k2 = graph_key(build_decode_graph(state, _toy_decode))
    assert k1 == k2
    assert k1 == decode_graph_key(4)
    assert k1 != decode_graph_key(2)


def test_decode_graph_key_matches_the_reference():
    from repro.models import decode_graph_key as jax_decode_graph_key
    for n in (1, 2, 4):
        assert decode_graph_key(n).digest == jax_decode_graph_key(n).digest


def test_decode_graph_tasks_and_results():
    state = _fresh_state(n_shards=3)
    g = build_decode_graph(state, _toy_decode)
    assert len(g) == 3 * 2 + 1
    results = run_graph(g, 2)
    gather = [t for t in g.tasks if t.name == "gather"][0]
    assert torch.equal(results[gather.tid], state.step_tokens)
    assert len(state.history) == 1
    assert state.step_tokens.shape == (3, 1)


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_decode_loop_is_schedule_independent(workers):
    ref = _decode_loop(6, workers=2)
    assert ref.shape == (4, 6)
    assert (_decode_loop(6, workers=workers) == ref).all()


def test_shard_batch():
    batch = {"tokens": torch.arange(8).reshape(4, 2)}
    shards = shard_batch(batch, 2)
    assert len(shards) == 2
    assert shards[1]["tokens"].shape == (2, 2)
    with pytest.raises(ValueError, match="shard"):
        shard_batch(batch, 3)
    with pytest.raises(ValueError, match="batch"):
        shard_batch({"a": torch.zeros((4, 1)), "b": torch.zeros((2, 1))}, 2)


def test_greedy_sample_shape_and_dtype():
    logits = torch.stack([torch.zeros((2, 3)), torch.ones((2, 3))], dim=-1)
    tok = greedy_sample(logits)
    assert tok.shape == (2, 1) and tok.dtype == torch.int32
    assert (tok == 1).all()


def test_token_id_reads_tensors_arrays_and_ints():
    assert token_id(torch.tensor([[7]], dtype=torch.int32)) == 7
    assert token_id(np.asarray([3])) == 3
    assert token_id(5) == 5
    with pytest.raises(ValueError, match="single"):
        token_id(torch.zeros(2))


# ---------------------------------------------------------------------------
# the engine over a pure-python toy model (tests/test_serving_engine.py)
EVOCAB = 13
PRIME = 10_007


def toy_prefill(prompt):
    h = (int(np.asarray(prompt).sum()) * 31 + 7) % PRIME
    return {"h": h}, _logits(h)


def toy_decode(cache, tok):
    h = (cache["h"] * 31 + int(tok) + 7) % PRIME
    return {"h": h}, _logits(h)


def _logits(h):
    row = [0.0] * EVOCAB
    row[h % EVOCAB] = 1.0
    return row


def toy_sample(logits):
    return int(np.argmax(np.asarray(logits)))


def _engine(session, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("step_time", 0.01)
    return ContinuousBatchingEngine(
        session, toy_decode, toy_prefill, sample_fn=toy_sample, **kw)


def _requests(budgets, arrivals=None, prompt=(1, 2, 3), eos=None):
    arrivals = [0.0] * len(budgets) if arrivals is None else arrivals
    return constant_prompt_requests(
        arrivals, budgets, np.asarray(prompt), eos_token=eos)


def _per_request_reference(requests):
    """Decode each request alone, serially, straight through the toy model
    (no engine, no runtime) — the ground-truth token streams."""
    out = {}
    for req in requests:
        cache, logits = toy_prefill(req.prompt)
        tok = toy_sample(logits)
        toks = [tok]
        while len(toks) < req.max_new_tokens and tok != req.eos_token:
            cache, logits = toy_decode(cache, tok)
            tok = toy_sample(logits)
            toks.append(tok)
        out[req.rid] = toks
    return out


def test_poisson_workload_deterministic_under_seed():
    a = PoissonWorkload(50.0, 20, seed=7, prompt_len=(4, 12),
                        max_new_tokens=(2, 9))
    b = PoissonWorkload(50.0, 20, seed=7, prompt_len=(4, 12),
                        max_new_tokens=(2, 9))
    assert np.array_equal(a.arrivals, b.arrivals)
    ra, rb = a.requests(), b.requests()
    assert [r.max_new_tokens for r in ra] == [r.max_new_tokens for r in rb]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(ra, rb))
    assert (np.diff(a.arrivals) >= 0).all()
    c = PoissonWorkload(50.0, 20, seed=8, prompt_len=(4, 12),
                        max_new_tokens=(2, 9))
    assert not np.array_equal(a.arrivals, c.arrivals)


def test_poisson_workload_matches_the_reference():
    from repro.serving import PoissonWorkload as JaxWorkload
    kw = dict(seed=0, prompt_len=(256, 1024), max_new_tokens=(2, 8),
              vocab_size=151936)
    ours, ref = PoissonWorkload(100.0, 12, **kw), JaxWorkload(100.0, 12, **kw)
    for x, y in zip(ours.requests(), ref.requests()):
        assert (x.rid, x.max_new_tokens, x.arrival_s) == (
            y.rid, y.max_new_tokens, y.arrival_s)
        assert np.array_equal(x.prompt, y.prompt)


def test_poisson_workload_validation():
    with pytest.raises(ValueError, match="rate"):
        PoissonWorkload(0.0, 4)
    with pytest.raises(ValueError, match="request"):
        PoissonWorkload(1.0, 0)
    with pytest.raises(ValueError, match="span"):
        PoissonWorkload(1.0, 4, max_new_tokens=(5, 2))


def test_workload_budget_and_eos_stamp():
    w = PoissonWorkload(10.0, 6, seed=0, max_new_tokens=(3, 3), eos_token=2)
    reqs = w.requests()
    assert w.total_budget() == 18
    assert all(r.max_new_tokens == 3 and r.eos_token == 2 for r in reqs)


def test_streams_bit_identical_to_per_request_baseline():
    reqs = _requests([6, 4, 8, 3, 5, 7])
    with repro_torch.Session(2) as s:
        batched = _engine(s).run(_requests([6, 4, 8, 3, 5, 7]))
    with repro_torch.Session(2) as s:
        baseline = _engine(s, max_batch=1).run(reqs)
    assert batched.tokens_by_rid() == baseline.tokens_by_rid()
    assert batched.tokens_by_rid() == _per_request_reference(reqs)
    assert batched.warm_hit_rate == baseline.warm_hit_rate == 0.0


def test_early_exit_releases_batch_slots():
    reqs = _requests([2, 5, 4])
    with repro_torch.Session(2) as s:
        report = _engine(s, max_batch=2).run(reqs)
    recs = report.records
    assert len(recs[0].tokens) == 2
    assert recs[2].admitted_s >= recs[0].done_s
    assert report.shape_counts == {2: 4}
    assert report.occupancy == 1.0
    assert [len(recs[r].tokens) for r in (0, 1, 2)] == [2, 5, 4]


def test_eos_stops_a_request_early():
    ref = _per_request_reference(_requests([10]))[0]
    idx = next(i for i in range(1, len(ref)) if ref[i] not in ref[:i])
    eos = ref[idx]
    (req,) = _requests([10], eos=eos)
    with repro_torch.Session(1) as s:
        report = _engine(s, max_batch=1).run([req])
    toks = report.records[0].tokens
    assert toks == ref[: idx + 1]
    assert toks[-1] == eos and len(toks) < 10


def test_virtual_clock_composition_is_deterministic():
    w = PoissonWorkload(200.0, 10, seed=3, prompt_len=4,
                        max_new_tokens=(2, 6), vocab_size=50)
    outs = []
    for _ in range(2):
        with repro_torch.Session(2) as s:
            outs.append(_engine(s).run(w.requests()))
    assert outs[0].shape_counts == outs[1].shape_counts
    assert outs[0].tokens_by_rid() == outs[1].tokens_by_rid()
    assert outs[0].summary() == outs[1].summary()


def test_virtual_clock_numbers_match_the_reference_engine():
    """Same workload, same toy model: the reference engine (dynamic
    session) and the port's compose the same steps and report the same
    latencies on the virtual clock."""
    w = PoissonWorkload(200.0, 10, seed=3, prompt_len=4,
                        max_new_tokens=(2, 6), vocab_size=50)
    with repro_torch.Session(2) as s:
        ours = _engine(s).run(w.requests())
    with repro.Session(2) as s:
        ref = JaxEngine(s, toy_decode, toy_prefill, sample_fn=toy_sample,
                        max_batch=3, step_time=0.01).run(w.requests())
    assert ours.shape_counts == ref.shape_counts
    assert ours.tokens_by_rid() == ref.tokens_by_rid()
    assert ours.summary() == ref.summary()


def test_admission_backpressure_under_full_queue():
    with repro_torch.Session(1) as s:
        eng = _engine(s, max_batch=1, admission_capacity=2)
        reqs = _requests([3, 3, 3, 3, 3])
        eng.submit(reqs[0])
        eng.submit(reqs[1])
        with pytest.raises(AdmissionFull, match="admission queue full"):
            eng.submit(reqs[2])
        assert not eng.try_submit(reqs[2])
        assert eng.queue_depth() == 2
        assert eng.step()
        eng.submit(reqs[2])
        with pytest.raises(AdmissionFull):
            eng.submit(reqs[3], block=True, timeout=0.01)
        t = threading.Thread(target=eng.submit, args=(reqs[3],),
                             kwargs={"block": True, "timeout": 30.0})
        t.start()
        for _ in range(40):
            if not eng.step() and not eng.queue_depth():
                break
        t.join(timeout=30.0)
        assert not t.is_alive()
        while eng.in_flight() or eng.queue_depth():
            eng.step()
        report = eng.report()
    assert sorted(report.records) == [0, 1, 2, 3]
    assert all(len(r.tokens) == 3 for r in report.records.values())


def test_duplicate_rid_rejected():
    with repro_torch.Session(1) as s:
        eng = _engine(s)
        (req,) = _requests([2])
        eng.submit(req)
        with pytest.raises(ValueError, match="duplicate"):
            eng.submit(req)
        while eng.in_flight() or eng.queue_depth():
            eng.step()


def test_prime_builds_graphs_off_the_hot_path():
    with repro_torch.Session(1) as s:
        eng = _engine(s, max_batch=3)
        eng.prime()
        assert sorted(eng._graphs) == [1, 2, 3]
        graphs_before = {k: g for k, (g, _) in eng._graphs.items()}
        eng.run(_requests([4, 3, 2]))
        assert all(eng._graphs[k][0] is g for k, g in graphs_before.items())


def test_report_refuses_requests_still_in_flight():
    with repro_torch.Session(1) as s:
        eng = _engine(s, max_batch=2)
        eng.submit(_requests([5])[0])
        eng.step()
        with pytest.raises(RuntimeError, match="in flight"):
            eng.report()
        while eng.in_flight() or eng.queue_depth():
            eng.step()
        assert eng.report().completed == 1


# ---------------------------------------------------------------------------
# the reduced qwen3 LM through both packages' engines
PROMPT_LEN, BUDGET = (8, 20), (2, 6)
MAX_LEN = PROMPT_LEN[1] + BUDGET[1] + 1


@pytest.fixture(scope="module")
def lm_pair():
    cfg = jax_get_config("qwen3-14b").reduced()
    tcfg = get_config("qwen3-14b").reduced()
    tree = reference_tree(cfg)
    model = params_from_reference(tcfg, tree, device="cpu")
    return cfg, tcfg, model, jax.tree.map(jnp.asarray, tree)


def _workload(cfg):
    return PoissonWorkload(100.0, 6, seed=0, prompt_len=PROMPT_LEN,
                           max_new_tokens=BUDGET, vocab_size=cfg.vocab_size)


def _port_engine(session, tcfg, model, **kw):
    return ContinuousBatchingEngine(
        session,
        lambda cache, tok: decode_step(model, tcfg, cache, tok),
        lambda prompt: prefill(model, tcfg, {"tokens": prompt},
                               max_len=MAX_LEN),
        step_time=0.01, **kw)


def test_engine_serves_the_reference_engines_token_streams(lm_pair):
    cfg, tcfg, model, jparams = lm_pair
    jpre = jax.jit(lambda p, b: jax_prefill(p, cfg, b, None, max_len=MAX_LEN))
    jdec = jax.jit(lambda p, c, t: jax_decode_step(p, cfg, c, t, None))
    with repro.Session(2) as s:
        ref = JaxEngine(s, lambda c, t: jdec(jparams, c, t),
                        lambda prompt: jpre(jparams, {"tokens": prompt}),
                        max_batch=3, step_time=0.01).run(
                            _workload(cfg).requests())
    with repro_torch.Session(2) as s:
        ours = _port_engine(s, tcfg, model, max_batch=3).run(
            _workload(cfg).requests())
    with repro_torch.Session(2) as s:
        alone = _port_engine(s, tcfg, model, max_batch=1).run(
            _workload(cfg).requests())
    assert ours.tokens_by_rid() == ref.tokens_by_rid()
    assert ours.tokens_by_rid() == alone.tokens_by_rid()
    assert ours.shape_counts == ref.shape_counts
    assert ours.completed == 6 and max(ours.shape_counts) > 1


def test_decode_graph_matches_the_plain_loop(lm_pair):
    """make_decode_state + build_decode_graph on a 2-worker session give
    the plain decode loop's tokens, bit for bit, at one lane per shard."""
    _, tcfg, model, _ = lm_pair
    prompts = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (4, 12), dtype=np.int32)
    steps, max_len = 6, 12 + 6 + 1
    state = make_decode_state(model, tcfg, {"tokens": prompts}, n_shards=4,
                              max_len=max_len, device="cpu")
    with repro_torch.Session(2) as s:
        for _ in range(steps - 1):
            s.run(build_decode_graph(
                state, lambda p, c, t: decode_step(p, tcfg, c, t)))
    graph_tokens = state.tokens()
    loop = []
    for b in range(4):
        cache, logits = prefill(model, tcfg, {"tokens": prompts[b:b + 1]},
                                max_len=max_len)
        tok = greedy_sample(logits)
        toks = [tok]
        for _ in range(steps - 1):
            cache, logits = decode_step(model, tcfg, cache, tok)
            tok = greedy_sample(logits)
            toks.append(tok)
        loop.append(torch.cat(toks, 1))
    assert graph_tokens.shape == (4, steps)
    assert torch.equal(graph_tokens, torch.cat(loop, 0))
    assert launch_counts()["decode_attention"] == 0     # CPU: plain versions


def test_queue_wait_runs_from_submit_to_the_requests_own_prefill():
    """On the wall clock a request submitted without a due time arrives
    when submitted and is admitted right before its own prefill, so in a
    2-lane step the second request waits at least the first's prefill, and
    ``queue_wait_s`` is submit to prefill start as a caller stamps it."""
    import time

    started, submitted = {}, {}

    def prefill(prompt):
        started[int(prompt[0])] = time.perf_counter()
        time.sleep(0.02)
        return toy_prefill(prompt)

    with repro_torch.Session(1) as s:
        eng = ContinuousBatchingEngine(s, toy_decode, prefill, max_batch=2,
                                       sample_fn=toy_sample)
        time.sleep(0.01)
        for rid in (0, 1):
            submitted[rid] = time.perf_counter()
            eng.submit(Request(rid=rid, prompt=np.asarray([rid, 5]),
                               max_new_tokens=1))
        eng.step()
        recs = eng.report().records
    assert recs[0].arrival_s >= 0.01          # its submit, not 0.0
    first_prefill = recs[0].first_token_s - recs[0].admitted_s
    assert first_prefill >= 0.02
    assert recs[1].queue_wait_s >= first_prefill
    for rid in (0, 1):
        outside = started[rid] - submitted[rid]
        assert 0.0 <= outside - recs[rid].queue_wait_s < 2e-3
