"""Serving driver: batched prefill + decode with a KV cache, on the port.

The port of the reference's ``examples/serve_lm.py``, with its flags.  It
makes a random model from seed 0 (no checkpoint is read), prefills a batch
of prompts, then decodes ``--tokens`` tokens per request, under one of:

* ``jit``     — the plain decode loop, no task graph (named as in the
  reference, which jits it; PyTorch runs it eagerly);
* ``dynamic`` — each decode step is a task graph (per-shard decode/sample
  plus a gather join) run by a ``Session(scheduler="dynamic")``;
* ``pool``    — the same graphs served by a ``Session(scheduler="pool")``:
  each batch shape is recorded once and replayed warm after that;
  ``--cache-dir`` keeps the recordings on disk (in the reference package's
  format, so one directory serves both packages).

``--arrivals poisson`` serves a seeded Poisson stream of single-prompt
requests through the continuous-batching engine instead.

The model is ``--arch``'s published configuration (a dense, ssm or hybrid
family: qwen3-14b by default, mamba2-2.7b, zamba2-7b, ...) at full width
and depth in its own dtype, on the CUDA device: ``--reduced`` takes the
reference's small smoke configuration, ``--layers N`` cuts the depth,
``--device cpu`` runs on the host.  Prompts are drawn with numpy from seed
1 (the reference draws them with ``jax.random``, so the ids differ).
``--trace`` and ``--procs`` raise ``NotImplementedError`` (ROADMAP Queue A
items 5 and 6).  ``dynamic`` stays the default here, as the CUDA runs of
earlier slices used it.

Run:  python -m repro_torch.serving.serve_lm --reduced --device cpu
      python -m repro_torch.serving.serve_lm --arch zamba2-7b --reduced \
          --device cpu
      python -m repro_torch.serving.serve_lm --arrivals poisson \\
          --rate 100 --requests 12
      python -m repro_torch.serving.serve_lm --reduced --device cpu \\
          --scheduler pool --cache-dir /tmp/graphs
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..api.session import Session, not_ported
from ..configs import get_config
from ..linalg.tiles import resolve_device
from ..models import (build_decode_graph, decode_step, greedy_sample,
                      init_params, make_decode_state, prefill)
from ..replay import GraphCache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _session(args, **pool_kwargs) -> Session:
    """The decode session: ``--cache-dir`` backs the pool's recordings."""
    pool = args.scheduler == "pool"
    cache = GraphCache(args.cache_dir) if args.cache_dir and pool else None
    kwargs = {"pool_kwargs": pool_kwargs} if pool else {}
    return Session(args.workers, scheduler=args.scheduler, cache=cache,
                   **kwargs)


def _print_pool(args, session: Session) -> None:
    if args.scheduler == "pool":
        for ckey, stats in session.pool.describe().items():
            print(f"pool[{ckey[:20]}…]: {stats}")


def serve_poisson(args, cfg, model, device):
    """Continuous batching under streaming traffic (--arrivals poisson)."""
    from . import ContinuousBatchingEngine, PoissonWorkload

    lo, _, hi = args.max_new.partition(":")
    budget = (int(lo), int(hi or lo))
    if budget[1] > args.tokens:
        raise SystemExit(f"--max-new hi {budget[1]} exceeds --tokens "
                         f"{args.tokens} (the KV-cache budget)")
    workload = PoissonWorkload(args.rate, args.requests, seed=args.seed,
                               prompt_len=args.prompt_len,
                               max_new_tokens=budget,
                               vocab_size=cfg.vocab_size)
    print(f"arch={cfg.name} layers={cfg.n_layers} device={device} "
          f"scheduler={args.scheduler} workers={args.workers} "
          f"max_batch={args.max_batch} " + workload.describe())
    max_len = args.prompt_len + args.tokens + 1
    with _session(args, warmup_runs=0) as session:
        engine = ContinuousBatchingEngine(
            session,
            lambda cache, tok: decode_step(model, cfg, cache, tok),
            lambda prompt: prefill(model, cfg, {"tokens": prompt},
                                   max_len=max_len),
            max_batch=args.max_batch)
        engine.prime()  # step graphs + keys built before traffic starts
        report = engine.run(workload.requests())
        _print_pool(args, session)
    print(report.describe())
    s = report.summary()
    print(f"per-token p50/p99: {s['p50_tok_ms']:.2f}/{s['p99_tok_ms']:.2f} "
          f"ms, ttft p50/p99: {s['ttft_p50_ms']:.2f}/{s['ttft_p99_ms']:.2f} "
          f"ms, sustained {s['tok_s']:.0f} tok/s")
    return report


def serve_batch(args, cfg, model, device):
    """The fixed batch decoded to --tokens (--arrivals batch)."""
    max_len = args.prompt_len + args.tokens + 1
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    batch = {"tokens": torch.as_tensor(prompts, device=device)}
    print(f"arch={cfg.name} layers={cfg.n_layers} device={device} "
          f"batch={args.batch} prompt={args.prompt_len} "
          f"scheduler={args.scheduler}")
    if args.scheduler == "jit":
        t0 = time.perf_counter()
        cache, logits = prefill(model, cfg, batch, max_len=max_len)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        tok = greedy_sample(logits)
        out_tokens = [tok]
        t0 = time.perf_counter()
        for _ in range(args.tokens - 1):
            cache, logits = decode_step(model, cfg, cache, tok)
            tok = greedy_sample(logits)
            out_tokens.append(tok)
        _sync(device)
        t_decode = time.perf_counter() - t0
        gen = torch.cat(out_tokens, dim=1)
    else:
        n_shards = args.shards or args.batch
        t0 = time.perf_counter()
        state = make_decode_state(model, cfg, batch, n_shards=n_shards,
                                  max_len=max_len, device=device)
        _sync(device)
        t_prefill = time.perf_counter() - t0
        with _session(args) as session:
            t0 = time.perf_counter()
            for _ in range(args.tokens - 1):
                session.run(build_decode_graph(
                    state, lambda p, c, t: decode_step(p, cfg, c, t)))
            _sync(device)
            t_decode = time.perf_counter() - t0
            _print_pool(args, session)
        gen = state.tokens()

    print(f"prefill: {t_prefill*1e3:.1f} ms "
          f"({args.batch*args.prompt_len/t_prefill:.0f} tok/s)")
    print(f"decode:  {t_decode*1e3:.1f} ms for {args.tokens-1} steps "
          f"({args.batch*(args.tokens-1)/t_decode:.0f} tok/s)")
    print("sample token ids:", gen[0, :16].tolist())
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--scheduler", choices=("jit", "dynamic", "pool"),
                    default="dynamic")
    ap.add_argument("--workers", type=int, default=2,
                    help="runtime workers for dynamic/pool scheduling")
    ap.add_argument("--shards", type=int, default=0,
                    help="batch shards per decode graph (default: batch)")
    ap.add_argument("--cache-dir", default=None,
                    help="on-disk GraphCache dir (pool): recordings persist "
                         "across runs")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="export a Perfetto trace (not ported)")
    ap.add_argument("--arrivals", choices=("batch", "poisson"),
                    default="batch",
                    help="batch: fixed batch decoded to --tokens; poisson: "
                         "streaming requests through the continuous-"
                         "batching engine")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="poisson arrival rate, requests/s")
    ap.add_argument("--requests", type=int, default=12,
                    help="poisson stream length")
    ap.add_argument("--max-new", default="2:8", metavar="LO:HI",
                    help="poisson per-request token budget span")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="continuous-batching decode slots")
    ap.add_argument("--seed", type=int, default=0,
                    help="poisson workload seed (same seed, same stream)")
    ap.add_argument("--procs", type=int, default=0,
                    help="worker processes (not ported)")
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's small smoke configuration")
    ap.add_argument("--layers", type=int, default=0,
                    help="run only the first N layers (0: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.procs:
        raise not_ported("procs")
    if args.trace:
        raise not_ported("trace")
    if args.arrivals == "poisson" and args.scheduler == "jit":
        ap.error("--arrivals poisson needs a task-graph scheduler")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    device = resolve_device(args.device)
    model = init_params(cfg, seed=0, device=device)
    if args.arrivals == "poisson":
        return serve_poisson(args, cfg, model, device)
    return serve_batch(args, cfg, model, device)


if __name__ == "__main__":
    main()
