#!/usr/bin/env python3
"""Planted faults in the prefill attention kernel, held to chip_smoke's limits.

    python3 attention_faults.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
For each fault a copy of ``src/`` and ``chip_smoke.py`` in a temporary
directory gets the fault written into its ``flash_attention.cu`` (the
checkout itself is never edited); a fresh process there builds that copy
and runs chip_smoke's prefill cases -- normal inputs and needle inputs, in
float32 and in bfloat16 -- with every check recorded instead of raised.
It prints one JSON line per fault: for each case the largest share of the
limit that the error used in each type (above 1.0 fails).  The faults:

* drop the causal diagonal key (``kpos <= qpos`` becomes ``<``);
* drop the sliding window's oldest key;
* drop the ragged last key (``kpos < S`` becomes ``< S - 1``);
* skip the rescale of the output carry on the second key tile.

Each is written into both of the file's kernels (bfloat16 and float32).
The script exits non-zero if the copy without a fault fails a case or if
a fault passes every bfloat16 case.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = Path("src/repro_torch/kernels/csrc/flash_attention.cu")

#: fault name -> (text, replacement) pairs, each found at least once
FAULTS = {
    "none": [],
    "drop the diagonal key": [("kpos <= qpos", "kpos < qpos")],
    "drop the window's oldest key": [("qpos - kpos < window)",
                                      "qpos - kpos < window - 1)")],
    "drop the ragged last key": [("kpos < S &&", "kpos < S - 1 &&")],
    "skip one tile's rescale": [
        ("o[x] *= corr[(x >> 1) & 1];",
         "if (t != 1) o[x] *= corr[(x >> 1) & 1];"),
        ("for (int j = 0; j < DCH; ++j) o[i][j] *= corr;",
         "for (int j = 0; j < DCH; ++j) if (k0 != kv_begin + kBK) "
         "o[i][j] *= corr;")],
}

#: (case, S, window, needle offset or None, keyword arguments)
CASES = [
    ("S=512 causal", 512, 0, None, {}),
    ("S=500 causal (ragged)", 500, 0, None, {}),
    ("S=512 window=64", 512, 64, None, {}),
    ("S=512 needle on the diagonal", 512, 0, 0, {}),
    ("S=512 window=64 needle on the oldest key", 512, 64, 63, {}),
    ("S=500 needle on the diagonal and the ragged last key", 500, 0, 0, {}),
    ("zamba2 d=112 S=512 causal", 512, 0, None,
     dict(H=32, KV=32, d=112)),
]


def child() -> None:
    """In the faulted copy: build it, run every case, print the shares."""
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke
    from repro_torch.kernels import cuda_lib

    failures = []
    chip_smoke.check = lambda ok, what: ok or failures.append(what)
    chip_smoke.emit = lambda obj: None
    cuda_lib.build(["flash_attention"])
    out = {}
    for seed, (case, S, window, needle, kw) in enumerate(CASES):
        row = chip_smoke.flash_case(case, S, window, seed=100 + seed,
                                    needle=needle, timed=False, **kw)
        out[case] = {t: e["tol_share"] for t, e in row["errors"].items()}
    print(json.dumps({"cases": out, "failed_checks": len(failures)}))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_faults: no CUDA device is available",
              file=sys.stderr)
        return 1
    ok = True
    for fault, edits in FAULTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            copy = Path(tmp)
            shutil.copytree(ROOT / "src", copy / "src",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", copy / "chip_smoke.py")
            shutil.copy(ROOT / "attention_faults.py",
                        copy / "attention_faults.py")
            src = copy / SOURCE
            text = src.read_text()
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"fault {fault!r}: {old!r} is not in "
                                     f"{SOURCE}")
                text = text.replace(old, new)
            src.write_text(text)
            run = subprocess.run([sys.executable, "attention_faults.py",
                                  "--child"], cwd=copy, capture_output=True,
                                 text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"fault {fault!r}: the run failed")
        result = json.loads(run.stdout.strip().splitlines()[-1])
        worst = max(c["bfloat16"] for c in result["cases"].values())
        fails = worst > 1.0
        ok &= (not fails) if fault == "none" else fails
        print(json.dumps({"fault": fault, "bfloat16_fails": fails,
                          "worst_bfloat16_share": worst, **result}),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
    else:
        sys.exit(main())
