"""Scoring long prompts on an AfMoE model (Trinity-Mini) through the
program's serving engine, closed loop.

The loop, the end-to-end metrics and the comparison are those of
:mod:`portbench.drivers.score`: each of ``clients`` callers sends a prompt
for one greedy token and waits for it; the clients send together; a
request's answer reaches its caller when the engine step that prefilled it
returns.  ``prefill_tok_s`` is the prompt tokens of every request
completed in the window over the window's seconds, ``ttft_p90_ms`` the
90th percentile of all of them.  Prompt lengths are the mix's own
(``length_seed``); token ids follow a Zipf law over the vocabulary
(:func:`portbench.generate_afmoe.zipf_prompts`: the mix's ``id_seed``
fixes which id holds each rank, ``--seed`` draws the ids), so frequent
ids repeat as in text and the experts' loads are uneven.

The engine prefills through the program's
:class:`~repro_torch.models.lm.PrefillGraphs`: set-up prefills one prompt
of every length twice (the first captures that length's graph, the second
replays it), and the window replays.  The traced steps run eagerly, so
the MoE layers' spans are recorded.

Correctness: a sample of the completed requests drawn from the seed, the
longest among them, is prefilled again eagerly under a traced call after
the window (:func:`routed_pass`), which records each MoE layer's selected
experts and the program's count of computed pairs.  The float32 reference
(:mod:`portbench.reference.afmoe`) scores the sample on the program's
selections and counts the rows where they differ from its own by more
than a near tie (``reference.TIE``): with random weights a top-k
selection in bfloat16 parts from float32's on near ties in some token of
most layers, and the logits would measure those flips rather than the
arithmetic.  Checks:
``logit_gap`` and ``token_gap_ratio`` of the window's last-position
logits against the reference's (:func:`portbench.drivers.score.compare`);
``route_mismatch``, the share in % of the sample's (token, MoE layer)
rows whose selection differs from the reference's by more than a near
tie; and ``dropped``, the sample's routed pairs (``num_experts_per_tok``
a token in every MoE layer) less the pairs the program computed (its
counter ``repro.moe.assignments``), which must be 0.

The float8 control: ``python3 -m portbench.drivers.score_afmoe --workload
<cell> --seeds ...`` on the card prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from statistics import median
from typing import Any, Dict

import torch

from portbench import generate, generate_afmoe, yardstick
from portbench.drivers.score import compare, pick_sample
from portbench.harness import annotate, profile
from portbench.reference import afmoe as reference

ROOT = Path(__file__).resolve().parents[2]


def program_config(cfg: Dict[str, Any]):
    """The program's ``ModelConfig`` of an AfMoE configuration file, whose
    keys are the published ``config.json``'s."""
    from repro_torch.models.config import ModelConfig

    if cfg.get("model_type") != "afmoe":
        raise ValueError(f"{cfg['name']}: no AfMoE driver for model_type "
                         f"{cfg.get('model_type')!r}")
    n, every = int(cfg["num_hidden_layers"]), int(
        cfg["global_attn_every_n_layers"])
    if generate_afmoe.is_global(cfg) != [i % every == every - 1
                                         for i in range(n)]:
        raise ValueError(f"{cfg['name']}: layer_types is not one global "
                         f"layer in every {every}")
    if (cfg["score_func"] != "sigmoid" or not cfg["route_norm"]
            or cfg["n_group"] != 1 or cfg["topk_group"] != 1):
        raise ValueError(f"{cfg['name']}: only ungrouped, renormalised "
                         f"sigmoid routing")
    fe = int(cfg["moe_intermediate_size"])
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=n,
        d_model=int(cfg["hidden_size"]),
        n_heads=int(cfg["num_attention_heads"]),
        n_kv_heads=int(cfg["num_key_value_heads"]),
        head_dim=int(cfg["head_dim"]), d_ff=int(cfg["intermediate_size"]),
        vocab_size=int(cfg["vocab_size"]), qk_norm=True,
        rope_theta=float(cfg["rope_theta"]),
        window=int(cfg["sliding_window"]), local_global_ratio=every - 1,
        global_rope_theta=0.0, attn_gate=True, sandwich_norm=True,
        embed_scale=bool(cfg["mup_enabled"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        n_experts=int(cfg["num_experts"]),
        top_k=int(cfg["num_experts_per_tok"]), d_expert=fe,
        shared_expert=int(cfg["num_shared_experts"]) > 0,
        d_shared=fe * int(cfg["num_shared_experts"]), capacity_factor=0.0,
        n_dense_layers=int(cfg["num_dense_layers"]), router_score="sigmoid",
        route_scale=float(cfg["route_scale"]), dtype=cfg["torch_dtype"],
        norm_eps=float(cfg["rms_norm_eps"]))


@torch.no_grad()
def program_model(cfg: Dict[str, Any], weights, device: str):
    """The program's ``LM`` for ``cfg`` with every leaf copied from
    ``weights`` (:class:`portbench.generate_afmoe.AfmoeWeights`), one
    layer's draw at a time."""
    from repro_torch.models.lm import LM

    pcfg = program_config(cfg)
    model = LM(pcfg, torch.device(device))
    params = dict(model.named_parameters())
    if set(params) != set(generate_afmoe.leaf_names(cfg)):
        raise ValueError(f"the program's leaves {sorted(params)} are not the "
                         f"benchmark's")
    params["embed.table"].copy_(weights.embed())
    if "unembed.out" in params:
        params["unembed.out"].copy_(weights.unembed())
    params["final_norm"].copy_(weights.final_norm())
    for i in range(pcfg.n_layers):
        for name, t in weights.layer(i).items():
            params[f"blocks.{i}.{name}"].copy_(t)
    return pcfg, model


def prompts_of(cfg: Dict[str, Any], tr: Dict[str, Any], seed: int,
               device: str):
    """The mix's lengths and one prompt of Zipf-drawn ids per length."""
    lengths = generate.prompt_lengths(tr["lengths"], int(tr["prompts"]),
                                      int(tr["length_seed"]))
    return lengths, generate_afmoe.zipf_prompts(
        lengths, int(cfg["vocab_size"]), float(tr["zipf_exponent"]),
        int(tr["id_seed"]), seed, device)


def run(r) -> None:
    # as a serving deployment runs it: no autograd bookkeeping on any op,
    # whose host cost would otherwise pace the shortest prompts on a slow
    # host (PERF.md §5)
    with torch.inference_mode():
        _run(r)


def _run(r) -> None:
    from repro_torch import Session
    from repro_torch.models.lm import PrefillGraphs, decode_step
    from repro_torch.serving import ContinuousBatchingEngine, Request

    cfg, tr, rec, dev = r.config, r.traffic, r.rec, r.device
    clients = int(tr["clients"])
    if int(tr["output_tokens"]) != 1:
        # every request a step admits is answered by that step
        raise ValueError("the scoring driver serves one token a request")
    W = generate_afmoe.AfmoeWeights(cfg, r.seed, dev, generate.dtype_of(cfg))
    pcfg, model = program_model(cfg, W, dev)
    del W
    graphs = PrefillGraphs(model, pcfg)
    lengths, prompts = prompts_of(cfg, tr, r.seed, dev)
    # which request each prompt tensor is, when its prefill began, and the
    # last-position logits the prefill returned
    rid_of, started, last = {}, {}, {}

    def prefill_fn(prompt):
        rid = rid_of[id(prompt)]
        started[rid] = time.perf_counter()
        with annotate("prefill"):
            cache, logits = graphs(prompt)
        last[rid] = logits[0, -1]
        return cache, logits

    session = Session(1)
    engine = ContinuousBatchingEngine(
        session, lambda cache, tok: decode_step(model, pcfg, cache, tok),
        prefill_fn, max_batch=clients, admission_capacity=clients)
    next_rid = 0

    def submit():
        nonlocal next_rid
        rid = next_rid
        next_rid += 1
        p = prompts[rid % len(prompts)]
        rid_of[id(p)] = rid
        engine.submit(Request(rid=rid, prompt=p,
                              max_new_tokens=int(tr["output_tokens"])))
        return rid

    try:
        # set-up: one prompt of every length, through the timed path,
        # twice: the first captures the length's graph, the second replays
        warm = {}
        for k, s in enumerate(lengths):
            warm.setdefault(s, k)
        for rep in range(2):
            for k in warm.values():
                next_rid = k + rep * len(prompts)
                submit()
                engine.step()
        next_rid = 2 * len(prompts)       # the window's rids follow

        submitted, done = {}, {}
        t0 = r.window_opens()
        while True:
            now = time.perf_counter()
            if now - t0 < r.seconds:
                while len(submitted) - len(done) < clients:
                    t = time.perf_counter()
                    submitted[submit()] = t
            if len(submitted) == len(done):
                break
            engine.step()
            t = time.perf_counter()
            for rid in submitted:
                if rid not in done:
                    done[rid] = t
        t1 = r.window_closes()
        report = engine.report()
        rids = sorted(submitted)
        plen = {rid: lengths[rid % len(prompts)] for rid in rids}
        pick = pick_sample(rids, plen, r.seed, int(tr["sample"]))
        dropped, routes = routed_pass(
            model, pcfg, cfg, [prompts[rid % len(prompts)] for rid in pick])

        if r.trace:
            traced = int(tr["traced_rounds"])

            def body():
                for _ in range(traced):
                    for _ in range(clients):
                        submit()
                    with annotate("engine.step"):
                        engine.step()
            rec.trace = profile(rec, body)
            rec.facts["traced_prompts"] = [
                lengths[k % len(prompts)]
                for k in range(next_rid - traced * clients, next_rid)]
    finally:
        session.close()

    toks = {rid: report.records[rid].tokens for rid in rids}
    served = sum(len(toks[rid]) == int(tr["output_tokens"]) for rid in rids)
    r.attempted = len(rids)
    r.failed = len(rids) - served
    window = t1 - t0
    ttft = [done[rid] - submitted[rid] for rid in rids]
    r.e2e["prefill_tok_s"] = sum(plen.values()) / window
    r.e2e["ttft_p90_ms"] = 1e3 * yardstick.percentile(ttft, 90)
    rec.facts.update(
        window_s=window, prompt_lengths=[plen[rid] for rid in rids],
        queue_s=[started[rid] - submitted[rid] for rid in rids], config=cfg)
    rec.facts["queue_ms_p50"] = 1e3 * median(rec.facts["queue_s"])

    prog = [last[rid] for rid in pick]
    del model, graphs, engine, prompts, report, last
    if dev == "cuda":
        torch.cuda.empty_cache()
    _, sample_prompts = prompts_of(cfg, tr, r.seed, dev)
    checks = checked(cfg, r.seed, [
        sample_prompts[rid % len(sample_prompts)] for rid in pick], routes,
        prog, [toks[rid][0] for rid in pick], dev)
    checks["dropped"] = dropped
    for name, value in checks.items():
        r.check(name, value)


@contextlib.contextmanager
def recorded_routes(model):
    """Every MoE layer call's selected experts ``(T, top_k)``, as the
    program's routers give them, in call order while the block runs."""
    moes = [blk.moe for blk in model.blocks if hasattr(blk, "moe")]
    picked: list = []

    def recording(route):
        def call(x_flat):
            wts, ids = route(x_flat)
            picked.append(ids)
            return wts, ids
        return call

    for m in moes:
        m.route = recording(m.route)
    try:
        yield picked
    finally:
        for m in moes:
            del m.route


def routed_pass(model, pcfg, cfg: Dict[str, Any], prompts):
    """``prompts`` prefilled eagerly under one traced call: their routed
    pairs the program's MoE layers did not compute (``num_experts_per_tok``
    a token in every MoE layer, less the program's count of computed pairs,
    ``repro.moe.assignments``), and each prompt's selected experts, a list
    over the MoE layers of ``(S, top_k)`` (:func:`recorded_routes`)."""
    from repro_torch.models.lm import prefill
    from repro_torch.obs import spans

    sp = spans.open_call("portbench.routed", traced=True)
    try:
        with recorded_routes(model) as picked:
            for p in prompts:
                prefill(model, pcfg, {"tokens": p})
    finally:
        sp.close()
    tr = spans.span_trace()
    computed = tr.counters.get("repro.moe.assignments", 0) if tr else 0
    n = len(picked) // len(prompts)
    routes = [picked[k * n:(k + 1) * n] for k in range(len(prompts))]
    dropped = int(cfg["num_experts_per_tok"]) * n * sum(
        p.shape[-1] for p in prompts) - computed
    return dropped, routes


def checked(cfg: Dict[str, Any], seed: int, prompts, routes, logits,
            served, device: str) -> Dict[str, float]:
    """The compared numbers of a run whose ``prompts`` gave last-position
    ``logits`` and ``served`` tokens, their MoE layers having selected
    ``routes``: :func:`portbench.drivers.score.compare` against the float32
    reference that follows ``routes``, and ``route_mismatch``, the share in
    % of the prompts' (token, MoE layer) rows where ``routes`` differ from
    the reference's own selection by more than a near tie."""
    follower = reference.Model(cfg, follow=routes)
    ref = reference.last_logits(cfg, seed, prompts, device, model=follower)
    out = compare(logits, ref, served)
    rows = sum(p.shape[-1] for p in prompts) * (
        int(cfg["num_hidden_layers"]) - int(cfg["num_dense_layers"]))
    out["route_mismatch"] = 100.0 * follower.mismatches / rows
    return out


def control(cell, seed: int, device: str) -> dict:
    """The float8 reference in the program's place, through the driver's
    own comparison (:func:`checked`: its last-position logits, its greedy
    tokens served, its selected experts followed), on a
    sample of the mix's requests drawn as a run draws it (the longest among
    them)."""
    cfg, tr = cell.config, cell.traffic
    lengths, prompts = prompts_of(cfg, tr, seed, device)
    pick = pick_sample(list(range(len(lengths))), dict(enumerate(lengths)),
                       seed, int(tr["sample"]))
    sample = [prompts[i] for i in pick]
    low_model = reference.Model(cfg, "fp8", record=True)
    low = reference.last_logits(cfg, seed, sample, device, model=low_model)
    routes = reference.split_routes(low_model.routes,
                                    [p.shape[-1] for p in sample])
    del low_model
    return checked(cfg, seed, sample, routes, low,
                   [int(x.argmax()) for x in low], device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the float8 control of an "
                                 "AfMoE scoring cell, one JSON line a seed")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from portbench import harness

    if not torch.cuda.is_available():
        print("score_afmoe: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        out = control(cell, seed, "cuda")
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
