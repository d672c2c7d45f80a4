#!/usr/bin/env python3
"""Time the tile GEMM and the SSD scan of several checkouts, in turns.

    python3 kernel_ab.py DIR [DIR ...]

Run on a machine with a CUDA card and nvcc.  Each DIR is the root of a
checkout of this repository (e.g. a ``git archive`` of another commit
unpacked into a git-ignored directory, and ``.`` for this one).  For each
DIR in the order given, a fresh process builds that checkout's
``tile_matmul`` and ``ssd_scan`` and times them on the same inputs with
``chip_smoke.device_ms`` of this checkout: the float64 192^3 updates ``C -
A B^T`` and ``C - A B`` in place, and the float32 SSD scan at zamba2-7b's
and mamba2-2.7b's 512-token prefill.  It prints one JSON line per DIR,
with the card's ``nvidia-smi`` name and power limit.  Give the
directories as parent, change, change, parent to see the spread between
runs of one build beside the difference between the builds.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: (case, B, T, H, N, P) of the SSD scan, as chip_smoke's prefill cases
SSD_SHAPES = [("ssd zamba2 T=512", 1, 512, 112, 64, 64),
              ("ssd mamba2 T=512", 1, 512, 80, 128, 64)]


def child(checkout: Path) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke                    # this checkout's timing and inputs
    sys.path.insert(0, str(checkout / "src"))
    import numpy as np
    import torch

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.tile_matmul import tile_matmul

    assert Path(cuda_lib.__file__).resolve().is_relative_to(checkout.resolve())
    cuda_lib.build(["tile_matmul", "ssd_scan"])
    rng = np.random.default_rng(0)
    a, b, c = (torch.from_numpy(rng.standard_normal((192, 192))).cuda()
               for _ in range(3))
    row = {"checkout": str(checkout),
           "tile_gemm_sub f64 192^3": chip_smoke.device_ms(
               lambda: tile_matmul(a, b, c, alpha=-1.0, beta=1.0,
                                   trans_b=True, out=c), reps=200),
           "tile_gemm_nn_sub f64 192^3": chip_smoke.device_ms(
               lambda: tile_matmul(a, b, c, alpha=-1.0, beta=1.0, out=c),
               reps=200)}
    for case, B, T, H, N, P in SSD_SHAPES:
        xdt, cs, bm, cm = chip_smoke.ssd_inputs(B, T, H, N, P, 128, seed=12)
        row[case] = chip_smoke.device_ms(lambda: ssd_scan(xdt, cs, bm, cm),
                                         reps=50)
    print(json.dumps(row))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    dirs = sys.argv[1:]
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    for d in dirs:
        run = subprocess.run([sys.executable, __file__, "--child", d],
                             capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            return 1
        row = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({**row, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(Path(sys.argv[2]))
    else:
        sys.exit(main())
