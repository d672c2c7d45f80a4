"""Trinity-Mini (AfMoE) in the port against the benchmark's plain float32
reference (``portbench/reference/afmoe.py``), on the CPU at a tiny shape.

The shape keeps every kind of layer: d 64, 4 / 2 heads of 16, 2 leading
dense layers (SwiGLU 96) then 4 MoE layers (8 experts of 32, top-2, one
shared expert of 32, sigmoid routing with a selection bias), a window of
8 on the sliding layers, layer 3 global (no rope, no window).  Weights are
the benchmark's draw (``portbench.generate_afmoe.AfmoeWeights``) in
float32, loaded into the program's ``LM``; prompts run through
``prefill`` and then ``decode_step`` through the cache, and every position's
logits are held against the reference's full forward over the same tokens.

Tolerance: ``logit_gap`` (the norm of the difference over the reference's
norm) at most ``TOL = 1e-4``.  Both sides compute in float32 and route the
same experts; they differ only in the order of their sums (flash's online
softmax against a softmax, grouped products against a loop over experts,
the float32 router's product), which reads ~1e-6; each planted fault
below (a capacity in place of dropless, weights from the biased scores,
rope on the global layers, the gate left out, pre-norms only) reads far
above it.
"""

import dataclasses
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import generate_afmoe  # noqa: E402
from portbench.drivers import score_afmoe  # noqa: E402
from portbench.reference import afmoe as reference  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.lm import (PrefillGraphs, decode_step,  # noqa: E402
                                   layer_flags, prefill)
from repro_torch.obs import spans  # noqa: E402

#: the largest logit_gap of the port against the reference (see above)
TOL = 1e-4
SEED = 2**31 + 11
PROMPT = 40
STEPS = 8

TINY = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, vocab_size=512,
            num_hidden_layers=6, num_dense_layers=2, num_experts=8,
            num_experts_per_tok=2, moe_intermediate_size=32,
            sliding_window=8, torch_dtype="float32")


def tiny_config():
    cfg = json.loads((ROOT / "portbench" / "configs" / "trinity-mini.json")
                     .read_text())
    cfg.update(TINY)
    cfg["layer_types"] = cfg["layer_types"][:cfg["num_hidden_layers"]]
    return cfg


def gap(p, r):
    return float((p - r).norm() / r.norm())


@pytest.fixture(scope="module")
def case():
    cfg = tiny_config()
    weights = generate_afmoe.AfmoeWeights(cfg, SEED, "cpu", torch.float32)
    pcfg, model = score_afmoe.program_model(cfg, weights, "cpu")
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg["vocab_size"], (1, PROMPT), generator=g)
    return cfg, weights, pcfg, model, prompt


def serve(model, pcfg, prompt, steps=STEPS):
    """Prefill, then ``steps`` greedy decode steps through the cache: the
    tokens fed ``(1, S + steps)`` and the logits at the last ``steps + 1``
    positions ``(steps + 1, V)``."""
    cache, logits = prefill(model, pcfg, {"tokens": prompt},
                            max_len=prompt.shape[1] + steps)
    outs, toks = [logits[0, -1]], [prompt]
    for _ in range(steps):
        tok = outs[-1].argmax().view(1, 1)
        toks.append(tok)
        cache, logits = decode_step(model, pcfg, cache, tok)
        outs.append(logits[0, -1])
    return torch.cat(toks, 1), torch.stack(outs)


def reference_logits(cfg, weights, tokens, last):
    return reference.logits(cfg, SEED, [tokens], "cpu", last=last,
                            weights=weights)[0]


def test_the_registry_config_is_the_published_one():
    cfg = json.loads((ROOT / "portbench" / "configs" / "trinity-mini.json")
                     .read_text())
    ours = get_config("trinity-mini")
    assert score_afmoe.program_config(cfg) == ours
    assert round(ours.param_count() / 1e9, 2) == 26.12
    flags = layer_flags(ours)
    glob = [i % 4 == 3 for i in range(32)]
    assert flags["window"] == [0 if g else 2048 for g in glob]
    assert flags["theta"] == [0.0 if g else 1e4 for g in glob]
    assert layer_flags(get_config("gemma3-12b"))["theta"].count(1e6) == 8


def test_prefill_and_decode_match_the_reference(case):
    cfg, weights, pcfg, model, prompt = case
    tokens, got = serve(model, pcfg, prompt)
    # every fed token's logits: the full forward over all of them
    want = reference_logits(cfg, weights, tokens, STEPS + 1)
    assert got.shape == want.shape
    for i in range(STEPS + 1):
        assert gap(got[i], want[i]) < TOL, (i, gap(got[i], want[i]))
    # the same bits on a second run
    _, again = serve(model, pcfg, prompt)
    assert torch.equal(got, again)


def _biased_weights(x_flat, router, bias, top_k, scale):
    """The fault: weights from the biased scores ``s + bias``."""
    s = torch.sigmoid(x_flat.float() @ router.float()) + bias
    ids = torch.topk(s, top_k, dim=-1).indices
    wts = s.gather(1, ids)
    return wts * (scale / wts.sum(-1, keepdim=True)), ids


@pytest.mark.parametrize("fault", ["capacity", "biased_weights",
                                   "rope_on_global", "no_gate",
                                   "pre_norms_only"])
def test_planted_faults_fail_the_tolerance(case, monkeypatch, fault):
    cfg, weights, pcfg, model, prompt = case
    run_cfg = pcfg
    for blk in model.blocks:
        if fault == "capacity" and hasattr(blk, "moe"):
            monkeypatch.setattr(blk.moe, "cfg", dataclasses.replace(
                blk.moe.cfg, capacity_factor=1.25))
        elif fault == "no_gate":
            monkeypatch.setattr(blk.attn, "cfg", dataclasses.replace(
                blk.attn.cfg, attn_gate=False))
        elif fault == "pre_norms_only":
            monkeypatch.setattr(blk, "cfg", dataclasses.replace(
                blk.cfg, sandwich_norm=False))
    if fault == "biased_weights":
        monkeypatch.setattr(L, "moe_route_sigmoid", _biased_weights)
    if fault == "rope_on_global":
        run_cfg = dataclasses.replace(pcfg, global_rope_theta=1e4)
    sp = spans.open_call("test.prefill", traced=True)
    try:
        tokens, got = serve(model, run_cfg, prompt, steps=0)
    finally:
        sp.close()
    dropped = spans.span_trace().counters["repro.moe.dropped"]
    spans.reset()
    want = reference_logits(cfg, weights, tokens, 1)
    assert gap(got[0], want[0]) > 10 * TOL, gap(got[0], want[0])
    assert (dropped > 0) == (fault == "capacity"), dropped


def test_a_skewed_router_matches_the_reference(case):
    """One expert chosen by every token (its bias far above the others'):
    T of the 2T pairs, more than half the tokens, the most a top-2 router
    can give one expert; the grouped products run one large group and
    seven small ones.  Same tolerance: the arithmetic is the same."""
    cfg, weights, pcfg, model, prompt = case

    class Skewed(generate_afmoe.AfmoeWeights):
        def layer(self, i):
            out = super().layer(i)
            if "moe.expert_bias" in out:
                out["moe.expert_bias"][5] += 1.0
            return out

    skewed = Skewed(cfg, SEED, "cpu", torch.float32)
    _, smodel = score_afmoe.program_model(cfg, skewed, "cpu")
    x = torch.randn(PROMPT, cfg["hidden_size"])
    _, ids = smodel.blocks[2].moe.route(x)
    assert (ids == 5).sum() == PROMPT
    tokens, got = serve(smodel, pcfg, prompt, steps=2)
    want = reference.logits(cfg, SEED, [tokens], "cpu", last=3,
                            weights=skewed)[0]
    for i in range(3):
        assert gap(got[i], want[i]) < TOL, (i, gap(got[i], want[i]))


def test_grouped_products_equal_the_per_pair_schedule(case):
    """The dropless prompt schedule (grouped products over the experts'
    sorted rows) against the per-pair schedule with every pair kept, on
    one routing: the same products on the same rows, summed in the same
    order."""
    _, _, pcfg, model, _ = case
    moe = model.blocks[3].moe
    g = torch.Generator().manual_seed(7)
    x = torch.randn(37, pcfg.d_model, generator=g)
    with torch.no_grad():
        wts, ids = moe.route(x)
        grouped = moe.combine(x, wts, ids, L.moe_capacity(37, pcfg))
        pairs = moe._combine_pairs(x, wts, ids, 37)
    torch.testing.assert_close(grouped, pairs, rtol=1e-5, atol=1e-6)


def test_the_selection_bias_changes_many_selections():
    """At the published widths (d 2,048, 128 experts, top-8) the drawn
    bias changes the selected set of a share of the tokens, without
    deciding it alone: between 10% and 90% (0.43 measured)."""
    cfg = json.loads((ROOT / "portbench" / "configs" / "trinity-mini.json")
                     .read_text())
    d, e = cfg["hidden_size"], cfg["num_experts"]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1024, d, generator=g)
    x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True))
    router = torch.randn(d, e, generator=g) / d ** 0.5
    bias = torch.randn(e, generator=g) * generate_afmoe.BIAS_STD
    _, with_bias = L.moe_route_sigmoid(x, router, bias, 8, 2.826)
    _, without = L.moe_route_sigmoid(x, router, torch.zeros(e), 8, 2.826)
    changed = (with_bias.sort(-1).values != without.sort(-1).values).any(-1)
    assert 0.1 < changed.float().mean() < 0.9


def test_moe_spans_and_counters_under_a_traced_call(case):
    """Under a traced call each MoE layer opens its five spans and counts
    its pairs through deferred counters (read when the window is): every
    routed pair computed, none dropped, the largest expert's load."""
    _, _, pcfg, model, prompt = case
    sp = spans.open_call("test.prefill", traced=True)
    try:
        prefill(model, pcfg, {"tokens": prompt})
    finally:
        sp.close()
    tr = spans.span_trace()
    moe_layers = pcfg.n_layers - pcfg.n_dense_layers
    labels = [s.label for s in tr.spans]
    for stage in ("route", "dispatch", "experts", "combine", "shared"):
        assert labels.count(f"repro.moe.{stage}") == moe_layers, stage
    pairs = pcfg.top_k * PROMPT * moe_layers
    assert tr.counters["repro.moe.assignments"] == pairs
    assert tr.counters["repro.moe.dropped"] == 0
    assert PROMPT * pcfg.top_k / pcfg.n_experts * moe_layers <= \
        tr.counters["repro.moe.max_load"] <= PROMPT * moe_layers
    spans.reset()


def test_prefill_graphs_run_eagerly_off_the_card_and_when_traced(case):
    """On a CPU model, and inside a traced call on any device, the graphed
    prefill is :func:`prefill` itself: the same cache and logits, and under
    the traced call the MoE layers' spans (a replay would record none)."""
    _, _, pcfg, model, prompt = case
    graphs = PrefillGraphs(model, pcfg)
    want_cache, want = prefill(model, pcfg, {"tokens": prompt}, max_len=48)
    for traced in (False, True):
        sp = spans.open_call("test.prefill", traced=True) if traced else None
        try:
            cache, got = graphs(prompt, max_len=48)
        finally:
            if sp is not None:
                sp.close()
        assert torch.equal(got, want)
        assert torch.equal(cache["k"], want_cache["k"])
        assert torch.equal(cache["v"], want_cache["v"])
        assert cache["index"] == want_cache["index"] == PROMPT
    labels = [s.label for s in spans.span_trace().spans]
    assert labels.count("repro.moe.experts") == pcfg.n_layers - \
        pcfg.n_dense_layers
    spans.reset()
    assert not graphs._graphs
