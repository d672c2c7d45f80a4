"""Scoring long prompts through the program's serving engine, closed loop.

Each of ``clients`` callers sends a prompt for one greedy token and waits
for it before sending the next; the clients send together.  The benchmark
drives the program's
``ContinuousBatchingEngine``: it submits every idle client's request,
then runs one engine step, which admits and prefills them (the program's
``prefill`` and ``greedy_sample``); a request's answer reaches its caller
when the step returns, and its time to first token runs from its submit
to then.  ``prefill_tok_s`` is the prompt tokens of every request
completed in the window over the window's seconds; ``ttft_p90_ms`` the
90th percentile of all of them.  Prompt lengths are drawn independently
and uniformly from the mix's lengths by the mix's own ``length_seed``
(:func:`portbench.generate.prompt_lengths`), so every run sends the same
sizes in the same order and ``--seed`` draws the token ids.  Set-up serves
one prompt of each length.

Correctness: the timed path's last-position logits of every request are
kept; after the window a sample of the completed requests drawn from the
seed, the longest of them among it, is scored again by the float32
reference (:mod:`portbench.reference.qwen3`).  Compared (:func:`compare`):
the logits' relative gap, and how far the served token's reference logit
lies below the reference's best, over twice the logits' widest gap.
"""

from __future__ import annotations

import time
from statistics import median
from typing import Dict, List, Sequence

import torch

from portbench import generate, yardstick
from portbench.drivers import lm_common
from portbench.harness import annotate, profile
from portbench.reference import qwen3 as reference


def compare(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
            served: Sequence[int]) -> Dict[str, float]:
    """The numbers compared, worst over the sampled requests, from each
    request's last-position logits (all padded columns, which the greedy
    pick ranges over) and its served token.  ``logit_gap``: the norm of the
    program's logits less the reference's over the norm of the
    reference's.  ``token_gap_ratio``: how far the served token's reference
    logit lies below the reference's best, over twice the widest gap of a
    logit; a token that is the greedy pick of the logits compared reads at
    most 1, as the gap is at most the sum of two logits' gaps."""
    logit, ratio = 0.0, 0.0
    for p, r, tok in zip(prog, ref, served):
        p, r = p.float(), r.float()
        d = p - r
        logit = max(logit, float(d.norm() / r.norm()))
        ratio = max(ratio, float((r.max() - r[int(tok)])
                                 / (2 * d.abs().max()).clamp_min(1e-30)))
    return {"logit_gap": logit, "token_gap_ratio": ratio}


def pick_sample(rids: List[int], plen: Dict[int, int], seed: int,
                k: int) -> List[int]:
    """``k`` of ``rids``: the longest request and others drawn from the
    seed."""
    rng = generate.host_rng(seed, 6)
    longest = max(rids, key=lambda rid: (plen[rid], -rid))
    others = [rid for rid in rids if rid != longest]
    return [longest] + [others[i] for i in rng.choice(
        len(others), size=min(k - 1, len(others)), replace=False)]


def run(r) -> None:
    from repro_torch import Session
    from repro_torch.models.lm import decode_step, prefill
    from repro_torch.serving import ContinuousBatchingEngine, Request

    cfg, tr, rec, dev = r.config, r.traffic, r.rec, r.device
    clients = int(tr["clients"])
    W = generate.DenseWeights(cfg, r.seed, dev, generate.dtype_of(cfg))
    pcfg, model = lm_common.program_model(cfg, W, dev)
    del W
    if int(tr["output_tokens"]) != 1:
        # every request a step admits is answered by that step
        raise ValueError("the scoring driver serves one token a request")
    lengths = generate.prompt_lengths(tr["lengths"], int(tr["prompts"]),
                                      int(tr["length_seed"]))
    prompts = generate.prompts(lengths, pcfg.vocab_size, r.seed, dev)
    # which request each prompt tensor is, when its prefill began, and the
    # last-position logits the prefill returned
    rid_of = {}
    started = {}
    last = {}

    def prefill_fn(prompt):
        rid = rid_of[id(prompt)]
        started[rid] = time.perf_counter()
        with annotate("prefill"):
            cache, logits = prefill(model, pcfg, {"tokens": prompt})
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
        # set-up: one prompt of every length, through the timed path
        warm = {}
        for k, s in enumerate(lengths):
            warm.setdefault(s, k)
        for k in warm.values():
            next_rid = k
            submit()
            engine.step()
        next_rid = len(prompts)           # the window's rids follow

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

    rids = sorted(submitted)
    toks = {rid: report.records[rid].tokens for rid in rids}
    served = sum(len(toks[rid]) == int(tr["output_tokens"]) for rid in rids)
    r.attempted = len(rids)
    r.failed = len(rids) - served
    plen = {rid: lengths[rid % len(prompts)] for rid in rids}
    window = t1 - t0
    ttft = [done[rid] - submitted[rid] for rid in rids]
    r.e2e["prefill_tok_s"] = sum(plen.values()) / window
    r.e2e["ttft_p90_ms"] = 1e3 * yardstick.percentile(ttft, 90)
    n_params = sum(p.numel() for p in model.parameters())
    rec.facts.update(
        window_s=window, prompt_lengths=[plen[rid] for rid in rids],
        queue_s=[started[rid] - submitted[rid] for rid in rids],
        n_params=n_params, embed_params=model.embed.table.numel(),
        unembed_params=(0 if pcfg.tie_embeddings
                        else model.unembed.out.numel()),
        tied=pcfg.tie_embeddings, n_layers=pcfg.n_layers,
        n_heads=pcfg.n_heads, kv_heads=pcfg.n_kv_heads,
        head_dim=pcfg.head_dim)

    pick = pick_sample(rids, plen, r.seed, int(tr["sample"]))
    prog = [last[rid] for rid in pick]
    del model, engine, prompts, report, last
    if dev == "cuda":
        torch.cuda.empty_cache()
    sample_prompts = generate.prompts(lengths, pcfg.vocab_size, r.seed, dev)
    ref = reference.last_logits(cfg, r.seed, [
        sample_prompts[rid % len(sample_prompts)] for rid in pick], dev)
    for name, value in compare(prog, ref,
                               [toks[rid][0] for rid in pick]).items():
        r.check(name, value)
    rec.facts["queue_ms_p50"] = 1e3 * median(rec.facts["queue_s"])
