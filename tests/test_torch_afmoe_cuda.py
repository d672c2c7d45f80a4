"""Trinity-Mini at its published widths and depth, in bfloat16, on the
card: the benchmark cell's model and prompts.

* A prefill of an 8,192-token prompt reads nothing back to the host
  (``torch.cuda.set_sync_debug_mode("error")`` raises at any
  synchronising call), drops no routed pair, and gives the same bits
  twice.
* The prefill captured as a CUDA graph (``PrefillGraphs``) gives the
  eager prefill's bits at every replay, reads nothing back when it
  replays, and leaves what it returned as it was when another length's
  graph replays after it.
* The prefill and 16 greedy decode steps through the cache against the
  plain float32 reference's full forward over the same 8,208 tokens (a
  layer at a time, beside the model), which follows the program's
  selected experts: every position's ``logit_gap`` and the rows where
  they are not a near tie of the reference's own (``route_mismatch``)
  under the cell's own limits (``portbench/workloads/trinity-mini-score.json``), which sit
  between the program's readings and the float8 control's.
* A planted fault in one MoE layer (its routed experts left out, the
  shared one kept) reads above that limit, in the first MoE layer and in
  the last; routers that select without the selection bias leave more
  rows off a near tie than ``route_mismatch``'s limit.

Every test needs the card (``cuda``) and skips without one.  The file
imports no JAX.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import generate, generate_afmoe  # noqa: E402
from portbench.drivers import score_afmoe  # noqa: E402
from portbench.reference import afmoe as reference  # noqa: E402

pytestmark = pytest.mark.cuda

SEED = 2**31 + 29
PROMPT = 8192
STEPS = 16


@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the model runs at full size on the "
                    "card)")
    cfg = json.loads((ROOT / "portbench" / "configs" / "trinity-mini.json")
                     .read_text())
    mix = json.loads((ROOT / "portbench" / "traffic" /
                      "score-zipf-closed2-4k8k.json").read_text())
    weights = generate_afmoe.AfmoeWeights(cfg, SEED, "cuda",
                                          generate.dtype_of(cfg))
    pcfg, model = score_afmoe.program_model(cfg, weights, "cuda")
    prompt = generate_afmoe.zipf_prompts(
        [PROMPT], int(cfg["vocab_size"]), float(mix["zipf_exponent"]),
        int(mix["id_seed"]), SEED, "cuda")[0]
    yield cfg, weights, pcfg, model, prompt
    del model
    torch.cuda.empty_cache()


def _limit():
    return json.loads((ROOT / "portbench" / "workloads" /
                       "trinity-mini-score.json").read_text())["limits"]


def test_prefill_reads_nothing_back_and_repeats_its_bits(card_model):
    from repro_torch.models.lm import prefill

    cfg, _, pcfg, model, prompt = card_model
    prefill(model, pcfg, {"tokens": prompt})          # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, first = prefill(model, pcfg, {"tokens": prompt})
        _, again = prefill(model, pcfg, {"tokens": prompt})
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(first, again)
    dropped, routes = score_afmoe.routed_pass(model, pcfg, cfg, [prompt])
    assert dropped == 0
    assert len(routes[0]) == pcfg.n_layers - pcfg.n_dense_layers


def test_graphed_prefill_replays_the_eager_bits(card_model):
    from repro_torch.models.lm import PrefillGraphs, prefill

    _, _, pcfg, model, prompt = card_model
    short = prompt[:, :PROMPT // 2].contiguous()
    want = {p.shape[1]: prefill(model, pcfg, {"tokens": p})
            for p in (prompt, short)}
    graphs = PrefillGraphs(model, pcfg)
    held = {}
    for p in (prompt, prompt, short, short):           # capture, replay
        held[p.shape[1]] = graphs(p)
    assert len(graphs._graphs) == 2
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        last = graphs(prompt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for S, (cache, logits) in [*held.items(), (PROMPT, last)]:
        wcache, wlogits = want[S]
        assert torch.equal(logits, wlogits), S
        assert torch.equal(cache["k"], wcache["k"]), S
        assert torch.equal(cache["v"], wcache["v"]), S
        assert cache["index"] == S
    del graphs, held, last, want
    torch.cuda.empty_cache()


@pytest.fixture(scope="module")
def reference_run(card_model):
    """The program's prefill and 16 greedy decode steps, each MoE layer's
    selected experts recorded; the reference's logits at the same 17
    positions, following those selections, and the share of (token, MoE
    layer) rows where they are not a near tie of its own."""
    from repro_torch.models.lm import decode_step, prefill

    cfg, weights, pcfg, model, prompt = card_model
    with score_afmoe.recorded_routes(model) as picked:
        cache, logits = prefill(model, pcfg, {"tokens": prompt},
                                max_len=PROMPT + STEPS)
        outs, toks = [logits[0, -1].float()], [prompt]
        for _ in range(STEPS):
            tok = outs[-1].argmax().view(1, 1).to(prompt.dtype)
            toks.append(tok)
            cache, logits = decode_step(model, pcfg, cache, tok)
            outs.append(logits[0, -1].float())
    del cache
    n = pcfg.n_layers - pcfg.n_dense_layers
    routes = [torch.cat(picked[j::n]) for j in range(n)]
    tokens = torch.cat(toks, 1)
    follower = reference.Model(cfg, follow=[routes])
    want = reference.logits(cfg, SEED, [tokens], "cuda", last=STEPS + 1,
                            weights=weights, model=follower)[0]
    return outs, want, 100.0 * follower.mismatches / (tokens.shape[1] * n)


def test_prefill_and_decode_match_the_reference(reference_run):
    outs, want, mismatch = reference_run
    gaps = [float((outs[i] - want[i]).norm() / want[i].norm())
            for i in range(STEPS + 1)]
    print(json.dumps({"logit_gap": gaps, "route_mismatch": mismatch}))
    assert max(gaps) < _limit()["logit_gap"], gaps
    assert mismatch < _limit()["route_mismatch"], mismatch


@pytest.mark.parametrize("layer", [2, 31])
def test_one_layer_without_its_routed_experts_fails_the_limit(
        card_model, reference_run, monkeypatch, layer):
    from repro_torch.models.lm import prefill

    _, _, pcfg, model, prompt = card_model
    _, want, _ = reference_run
    moe = model.blocks[layer].moe
    monkeypatch.setattr(moe, "combine", lambda x_flat, *a, **k:
                        torch.zeros(x_flat.shape, dtype=torch.float32,
                                    device=x_flat.device))
    _, logits = prefill(model, pcfg, {"tokens": prompt})
    got = logits[0, -1].float()
    gap = float((got - want[0]).norm() / want[0].norm())
    print(json.dumps({"layer": layer, "logit_gap": gap}))
    assert gap > _limit()["logit_gap"], gap


def test_a_selection_without_the_bias_fails_the_limits(card_model,
                                                       monkeypatch):
    from repro_torch.models import layers as L
    from repro_torch.models.lm import prefill

    cfg, _, pcfg, model, prompt = card_model
    route = L.moe_route_sigmoid

    def unbiased(x_flat, router, bias, top_k, scale):
        return route(x_flat, router, torch.zeros_like(bias), top_k, scale)
    monkeypatch.setattr(L, "moe_route_sigmoid", unbiased)
    with score_afmoe.recorded_routes(model) as picked:
        _, logits = prefill(model, pcfg, {"tokens": prompt})
    got = logits[0, -1]
    out = score_afmoe.checked(cfg, SEED, [prompt], [picked], [got],
                              [int(got.argmax())], "cuda")
    print(json.dumps({"unbiased": out}))
    assert out["route_mismatch"] > _limit()["route_mismatch"], out
