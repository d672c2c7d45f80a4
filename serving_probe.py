#!/usr/bin/env python3
"""Where a serving lane-step's host time goes, on one NVIDIA GPU.

    python3 serving_probe.py [--steps 8]

A probe beside ``chip_smoke.py``, whose helpers and serving model it
uses; run it from the root of a checkout with one CUDA card.  It checks
nothing of the kernels: it measures what sets the pace of the decode path.
Each part prints one JSON line:

1. ``host_calibration``: the host's own time for the smallest torch op on
   the card (a one-element ``add_``), from one thread and from two threads
   at once (two workers take turns on the GIL at every op);
2. ``lane_steps``: qwen3-14b at full width and depth, four 512-token
   prompts, ``--steps`` decode steps each through the plain loop on the
   main thread, then the decode-step graphs on ``Session(1)`` and on
   ``Session(2)``: ms per lane-step of each; the three token streams must
   be bit-identical;
3. ``lane_profile``: one lane's plain ``decode_step`` under
   ``torch.profiler`` on the main thread (the profiler records the host
   ops of that thread only): device kernels, and the host ops by self time.

Exits non-zero when no CUDA device is available or a check fails.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np
import torch

import chip_smoke
from chip_smoke import BATCH, PROMPT, _device_rows, check, emit


def host_calibration(smi: str) -> None:
    def per_op_us(threads: int, ops: int = 4000) -> float:
        xs = [torch.zeros(1, device="cuda") for _ in range(threads)]
        start = threading.Barrier(threads + 1)

        def work(x):
            start.wait()
            for _ in range(ops):
                x.add_(1.0)

        ts = [threading.Thread(target=work, args=(x,)) for x in xs]
        for t in ts:
            t.start()
        torch.cuda.synchronize()
        start.wait()
        t0 = time.perf_counter()
        for t in ts:
            t.join()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        check(all(x.item() == ops for x in xs), "host calibration lost an add")
        return wall / ops * 1e6

    per_op_us(1, 500)                   # warm-up
    one, two = per_op_us(1), per_op_us(2)
    emit({"phase": "host_calibration", "op": "add_ on a 1-element tensor",
          "us_per_op_1_thread": one, "us_per_op_each_of_2_threads": two,
          "card": smi})


def lane_steps(cfg, model, steps: int, smi: str):
    """ms per lane-step of the plain loop, and of the graphs on one and on
    two workers; returns the last decode state."""
    from repro_torch import Session
    from repro_torch.models import (build_decode_graph, decode_step,
                                    greedy_sample, make_decode_state,
                                    prefill)

    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32), device="cuda")
    max_len = PROMPT + steps + 2

    def dec(p, c, t):
        return decode_step(p, cfg, c, t)

    cache, logits = prefill(model, cfg, {"tokens": prompts[:1, :16]},
                            max_len=20)                     # warm-up
    decode_step(model, cfg, cache, greedy_sample(logits))
    lanes = []
    for b in range(BATCH):
        cache, logits = prefill(model, cfg, {"tokens": prompts[b:b + 1]},
                                max_len=max_len)
        lanes.append([cache, [greedy_sample(logits)]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        for lane in lanes:
            lane[0], logits = decode_step(model, cfg, lane[0], lane[1][-1])
            lane[1].append(greedy_sample(logits))
    torch.cuda.synchronize()
    ms = {"plain_loop": (time.perf_counter() - t0) / (BATCH * steps) * 1e3}
    tokens = {"plain_loop": torch.cat([torch.cat(t, dim=1) for _, t in lanes])}
    del lanes

    for workers in (1, 2):
        state = make_decode_state(model, cfg, {"tokens": prompts},
                                  n_shards=BATCH, max_len=max_len + 1,
                                  device="cuda")
        with Session(workers) as session:
            # one step untimed: each worker thread makes its cuBLAS handle
            # on its first product
            session.run(build_decode_graph(state, dec))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                session.run(build_decode_graph(state, dec))
            torch.cuda.synchronize()
        key = f"graphs_session_{workers}"
        ms[key] = (time.perf_counter() - t0) / (BATCH * steps) * 1e3
        tokens[key] = state.tokens()[:, :steps + 1]
    emit({"phase": "lane_steps", "arch": cfg.name, "lanes": BATCH,
          "prompt": PROMPT, "steps": steps, "ms_per_lane_step": ms,
          "card": smi})
    for key, toks in tokens.items():
        check(torch.equal(toks, tokens["plain_loop"]),
              f"{key}'s tokens differ from the plain loop's")
    return state


def lane_profile(cfg, state, smi: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step

    shard = state.shards[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        shard.cache, logits = decode_step(state.params, cfg, shard.cache,
                                          shard.tok)
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    check(bool(torch.isfinite(logits).all()), "a logit is not finite")
    dev = _device_rows(prof)
    host = sorted(((e.self_cpu_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.key.startswith("aten::")), reverse=True)
    emit({"phase": "lane_profile", "wall_s": wall_s, "enqueue_s": enqueue_s,
          "device_busy_s": sum(r[0] for r in dev) / 1e6,
          "device_kernels": sum(r[2] for r in dev),
          "aten_events": sum(r[2] for r in host),   # nested ones too
          "host_top": [{"op": k, "count": c, "self_cpu_ms": us / 1e3}
                       for us, k, c in host[:12]], "card": smi})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=8,
                    help="decode steps per lane in each timed run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serving_probe: no CUDA device is available", file=sys.stderr)
        return 1
    smi = chip_smoke.card_phase()
    chip_smoke.build_phase()
    host_calibration(smi)
    cfg, model, _ = chip_smoke.serving_model()
    state = lane_steps(cfg, model, args.steps, smi)
    lane_profile(cfg, state, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
