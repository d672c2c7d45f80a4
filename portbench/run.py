"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (``python3 -m portbench.run`` works too).  It
loads the program (``src/repro_torch``), warms up the cell's shapes,
measures for ``--seconds``, checks what the timed path produced against
the plain reference, and prints, as the last line of standard output, one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, with ``--trace 1``, ``breakdown``; ``checks`` comes last,
each number compared beside its limit, and the same numbers close
standard error.  It exits non-zero, printing no result, without enough
CUDA devices, or if JAX or the reference package was loaded.

Every build and kernel cache stays inside the checkout: the kernels'
``nvcc`` libraries in ``build/kernels`` (the program's own fixed place),
Triton's and PyTorch's extension caches in ``build/``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    from portbench import harness

    cell = harness.load_cell(args.workload)
    spec = harness.benchmark_spec()
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    run, line = harness.execute(cell, seed=args.seed, seconds=args.seconds,
                                trace=bool(args.trace), device="cuda",
                                t_start=T_START, spec=spec)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"portbench: modules that may not load in a run were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
