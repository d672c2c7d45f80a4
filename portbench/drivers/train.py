"""Training steps of a dense LM through the program's ``make_train_step``.

Set-up makes the weights and the token batches from the seed on the card,
builds one train step (the program's AdamW, microbatches joined under the
configured overlap) and drives it through its first steps, which warm up
every shape the window uses; the window runs the same step object on
fresh batches back to back.  ``train_tok_s`` is the tokens of every step
completed in the window over the window's seconds.

Correctness: the reference (:mod:`portbench.reference.qwen3`) trains the
same weights on the same first batches in float32.  Compared: the first
step's loss, and by the worst leaf each leaf's first gradient as the
optimizer took it (from the program's ``m`` after one step) and each
leaf's change over the first steps (leaves whose reference gradient is
below a thousandth of the median leaf's are left out of the change, as
Adam moves them by round-off alone).  Every window step's loss must be
finite.
"""

from __future__ import annotations

import math
import time
from statistics import median
from typing import Dict

import torch

from portbench import generate
from portbench.drivers import lm_common
from portbench.harness import annotate, profile, sync
from portbench.reference import qwen3 as reference

#: leaves whose reference first gradient is below this share of the
#: median leaf's are left out of the change's comparison
STILL_LEAF = 1e-3


def _feed(batches: torch.Tensor, i: int) -> Dict[str, torch.Tensor]:
    b = batches[i % batches.shape[0]]
    return {"tokens": b[:, :-1], "labels": b[:, 1:]}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: the first step's loss (relative gap), and the
    worst relative gap of the leaves' first-gradient and change norms, each
    leaf against the larger of its own reference norm and the median
    leaf's.  The later steps' losses are not compared: an Adam step turns a
    gradient's sign near zero into a whole ``lr``, so their gaps swing from
    seed to seed (PERF.md); the change's norms carry those steps."""
    loss = abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
    g_med = median(ref["grad1"].values())
    grad = max(abs(prog["grad1"][n] - g) / max(g, g_med)
               for n, g in ref["grad1"].items())
    moving = [n for n, g in ref["grad1"].items() if g >= STILL_LEAF * g_med]
    c_med = median(ref["change"][n] for n in moving)
    change = max(abs(prog["change"][n] - ref["change"][n])
                 / max(ref["change"][n], c_med) for n in moving)
    return {"loss1_gap": loss, "grad1_gap": grad, "change_gap": change}


@torch.no_grad()
def _change_norms(model, W, pcfg) -> Dict[str, float]:
    params = dict(model.named_parameters())
    out = {}
    for i in range(pcfg.n_layers):
        for name, t0 in W.layer(i).items():
            n = f"blocks.{i}.{name}"
            out[n] = float((params[n].float() - t0.float()).norm())
    for n in ("embed.table", "unembed.out", "final_norm"):
        if n in params:
            out[n] = float((params[n].float() - W.leaf(n).float()).norm())
    return out


def run(r) -> None:
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train import StepConfig, make_train_step

    cfg, tr, rec, dev = r.config, r.traffic, r.rec, r.device
    seq, gb, micro = int(tr["seq"]), int(tr["global_batch"]), \
        int(tr["microbatches"])
    first = int(tr["first_steps"])
    W = generate.DenseWeights(cfg, r.seed, dev, generate.dtype_of(cfg))
    pcfg, model = lm_common.program_model(cfg, W, dev)
    opt_cfg = AdamWConfig(**tr["optimizer"])
    opt = adamw_init(model)
    step = make_train_step(pcfg, opt_cfg, None, StepConfig(
        microbatches=micro, overlap=tr["overlap"]))
    batches = generate.lm_batches(pcfg.vocab_size, seq, gb,
                                  int(tr["batches"]), r.seed, dev)
    names = [n for n, _ in model.named_parameters()]
    n_params = sum(p.numel() for p in model.parameters())

    # the first steps, which the reference follows
    prog = {"loss": []}
    for s in range(first):
        model, opt, met = step(model, opt, _feed(batches, s))
        prog["loss"].append(float(met["loss"]))
        if s == 0:
            prog["grad1"] = {n: float(opt["m"][n].norm()) / (1 - opt_cfg.b1)
                             for n in names}
    prog["change"] = _change_norms(model, W, pcfg)

    # the window
    losses = []
    i = first
    t0 = r.window_opens()
    while time.perf_counter() - t0 < r.seconds:
        model, opt, met = step(model, opt, _feed(batches, i))
        losses.append(met["loss"])
        i += 1
    t1 = r.window_closes()
    steps = i - first
    r.attempted = steps
    r.failed = sum(not math.isfinite(float(x)) for x in losses)
    r.e2e["train_tok_s"] = steps * gb * seq / (t1 - t0)
    rec.facts.update(
        steps=steps, window_s=t1 - t0, n_params=n_params,
        embed_params=model.embed.table.numel(),
        unembed_params=(0 if pcfg.tie_embeddings
                        else model.unembed.out.numel()),
        tied=pcfg.tie_embeddings, n_layers=pcfg.n_layers,
        n_heads=pcfg.n_heads, kv_heads=pcfg.n_kv_heads,
        head_dim=pcfg.head_dim, batch=gb, micro=micro, seq=seq,
        window_peak_bytes=r.window_peak_bytes)

    if r.trace:
        traced = int(tr["traced"])

        def body():
            nonlocal model, opt
            for k in range(traced):
                with annotate("train.step"):
                    model, opt, _ = step(model, opt, _feed(batches, i + k))
        rec.trace = profile(rec, body)
        rec.facts["traced_steps"] = traced
        rec.facts["flash_pair_s"] = _flash_pair_s(pcfg, gb // micro, seq, dev)
        # one update of the whole tree, on zero gradients: the window is
        # over, and the state is thrown away after it
        grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
                 for n, p in model.named_parameters()}
        with annotate("adamw"):
            rec.facts["adamw_s"] = _event_s(
                lambda: adamw_update(opt_cfg, model, grads, opt), dev)
        del grads

    del model, opt, step, losses
    if dev == "cuda":
        torch.cuda.empty_cache()
    ref = reference.train_readings(cfg, tr["optimizer"], batches[:first],
                                   r.seed, dev, steps=first)
    for name, value in compare(prog, ref).items():
        r.check(name, value)


def _event_s(fn, dev: str, reps: int = 1) -> float:
    """Device seconds of one call of ``fn`` (CUDA events; the host clock
    on the CPU), after one call to warm it."""
    fn()
    if dev != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    sync(dev)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    sync(dev)
    return a.elapsed_time(b) * 1e-3 / reps


def _flash_pair_s(pcfg, batch: int, seq: int, dev: str) -> float:
    """The flash kernel's forward and its autograd Function's backward at
    the cell's microbatch shape, on random inputs."""
    from repro_torch.kernels.flash_attention import flash_attention

    g = generate.generator(0, 9, dev)
    shape = lambda h: (batch, h, seq, pcfg.head_dim)        # noqa: E731
    q, k, v, dout = (torch.randn(s, dtype=torch.bfloat16, device=dev,
                                 generator=g)
                     for s in (shape(pcfg.n_heads), shape(pcfg.n_kv_heads),
                               shape(pcfg.n_kv_heads), shape(pcfg.n_heads)))
    for t in (q, k, v):
        t.requires_grad_(True)

    def pair():
        with annotate("flash.pair"):
            out = flash_attention(q, k, v, causal=True)
            torch.autograd.grad(out, (q, k, v), dout)
    return _event_s(pair, dev, reps=5)
