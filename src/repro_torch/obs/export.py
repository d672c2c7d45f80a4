"""CLI: export, validate and summarize flight-recorder traces.

Usage (``PYTHONPATH=src``)::

    # run the built-in synthetic demo workload traced, write Perfetto JSON
    python -m repro_torch.obs.export --out trace.json

    # steer the demo: workers / steps / scheduler
    python -m repro_torch.obs.export --out trace.json --workers 4 --scheduler pool

    # validate an exported file against the repro.obs/1 schema (CI)
    python -m repro_torch.obs.export --validate trace.json

    # print the breakdown / metrics tables of an exported file
    python -m repro_torch.obs.export --summarize trace.json

The demo workload needs no device on purpose — a fan-out/fan-in graph with a
producer→consumer channel pair (suspendable frames) and enough imbalance
to show steals — so the CLI works on any box the repo imports on.  Open
the result in https://ui.perfetto.dev or ``chrome://tracing``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

from .perfetto import load_trace, validate_trace_json, write_trace
from .trace import RuntimeTrace


def _demo_graph(fanout: int = 8, spin_s: float = 2e-4):
    """A traced-demo graph: root -> fanout spinners + a channel-coupled
    producer/consumer frame pair -> join."""
    import repro_torch

    g = repro_torch.Graph("obs-demo")
    ch = repro_torch.Channel("demo-ch", capacity=2)

    def spin(_=None):
        t_end = time.perf_counter() + spin_s
        x = 0
        while time.perf_counter() < t_end:
            x += 1
        return x

    def producer(ctx):
        for i in range(4):
            spin()
            yield ctx.send(ch, i)
        return "sent"

    def consumer(ctx):
        total = 0
        for _ in range(4):
            v = yield ctx.recv(ch)
            total += v
        return total

    root = g.add(spin, name="root")
    mids = [g.add(spin, root, name=f"spin{i}") for i in range(fanout)]
    p = g.add(producer, deps=[root], name="producer")
    c = g.add(consumer, deps=[root], name="consumer")
    g.add(lambda *xs: len(xs), *mids, p, c, name="join")
    return g


def run_demo(workers: int, scheduler: str, steps: int,
             fanout: int = 8) -> RuntimeTrace:
    """Run the demo workload ``steps`` times on a traced session and
    return the last run's :class:`RuntimeTrace`."""
    import repro_torch

    trace: Optional[RuntimeTrace] = None
    with repro_torch.Session(workers, scheduler=scheduler, trace=True) as s:
        for _ in range(max(1, steps)):
            report = s.run(_demo_graph(fanout=fanout))
            trace = report.trace
    if trace is None:
        raise RuntimeError("traced session produced no RuntimeTrace")
    return trace


def summarize(trace: RuntimeTrace) -> str:
    lines = [f"workers: {trace.n_workers}   events: {len(trace.events)}   "
             f"makespan: {trace.makespan * 1e3:.3f} ms   "
             f"dropped: {trace.dropped}"]
    lines.append("breakdown (fraction of worker-time):")
    for kind, frac in sorted(trace.breakdown_fraction().items(),
                             key=lambda kv: -kv[1]):
        lines.append(f"  {kind:<10s} {frac * 100:6.2f} %")
    m = trace.metrics()
    lines.append(f"steal success: {m['steal_hits']}/{m['steal_attempts']} "
                 f"({m['steal_success_rate'] * 100:.1f} %)")
    rl = m["resume_latency"]
    lines.append(f"resume latency: n={rl['count']} "
                 f"mean={rl['mean_s'] * 1e6:.1f} us "
                 f"p95={rl['p95_s'] * 1e6:.1f} us")
    lines.append(f"dispatch overhead fraction: "
                 f"{m['dispatch_overhead_fraction']:.3f}")
    lines.append("counters: " + json.dumps(trace.counters, sort_keys=True))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.export",
        description="flight-recorder trace export / validation")
    ap.add_argument("--out", default=None,
                    help="run the demo workload traced and write Perfetto "
                         "JSON here")
    ap.add_argument("--validate", default=None, metavar="PATH",
                    help="validate an exported trace file; exit non-zero "
                         "on schema violations")
    ap.add_argument("--summarize", default=None, metavar="PATH",
                    help="print breakdown/metrics tables of an exported file")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--scheduler", choices=("dynamic", "pool"),
                    default="dynamic")
    ap.add_argument("--steps", type=int, default=3,
                    help="demo iterations (last one is exported)")
    args = ap.parse_args(argv)

    did = False
    if args.validate:
        try:
            info = validate_trace_json(args.validate)
        except ValueError as e:
            print(e, file=sys.stderr)
            return 1
        print(f"OK {args.validate}: {info['slices']} slices, "
              f"{info['flows']} flows, {info['rows']} rows, "
              f"schema {info['schema']}")
        did = True
    if args.summarize:
        print(summarize(load_trace(args.summarize)))
        did = True
    if args.out:
        trace = run_demo(args.workers, args.scheduler, args.steps)
        write_trace(trace, args.out)
        print(f"wrote {args.out}")
        print(summarize(trace))
        did = True
    if not did:
        ap.error("nothing to do: pass --out, --validate or --summarize")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
