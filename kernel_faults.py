#!/usr/bin/env python3
"""Planted faults in the redesigned kernels, held to chip_smoke's limits.

    python3 kernel_faults.py [--kernel flash_attention|flash_attention_bwd|tile_matmul|ssd_scan]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
For each fault a copy of ``src/`` and ``chip_smoke.py`` in a temporary
directory gets the fault written into its kernel source (the checkout
itself is never edited); a fresh process there builds that copy and runs
chip_smoke's cases for the kernel, with every check recorded instead of
raised.  It prints one JSON line per fault: for each case the largest share
of the limit that the error used (above 1.0 fails) and how many checks
failed.  The faults:

* ``flash_attention`` (prefill, encoder and cross-attention shapes; normal
  and needle inputs, float32 and bfloat16): drop the causal diagonal key;
  drop the sliding window's oldest key; drop the ragged last key; skip the
  rescale of the output carry on the second key tile; let the keys past
  Sk (the zero fill of the ragged last key tile) into the softmax; apply
  the causal mask when ``causal`` is false.  Each is written wherever the
  file has its text (the forward's two kernels, and the backward's mask
  too); only the forward's cases run.
* ``flash_attention_bwd`` (the backward kernel in the same file, through
  chip_smoke's ``flash_grad_case`` at qwen3-14b's short training shape, a
  ragged window, and non-causal cross shapes at d = 64 and 112; judged by
  the bfloat16 gradients and every check): drop the diagonal key from dS
  in both the dK/dV and the dQ kernels; read each row's log-sum-exp from
  another row; drop the low bfloat16 part of P and dS (one bfloat16
  rounding of each in the products); drop the last query tile of every
  dK/dV block; sum only the first query head of each KV group into dK and
  dV.
* ``tile_matmul`` (float64, ``C - A B^T`` and ``C - A B``): drop the last
  K split from the cluster's sum; drop the last K slice of every split.
* ``ssd_scan`` (float32 and bfloat16): skip the carried-state term
  ``e^cs C . s_{c-1}``; drop the diagonal ``j = i`` of the decay; do not
  pass the state on from one chunk to the next.

The script exits non-zero if the copy without a fault fails a case or if
a fault passes every case (for the prefill kernel: every bfloat16 case).
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = Path("src/repro_torch/kernels/csrc")

#: kernel -> fault name -> (text, replacement) pairs, each found at least once
FAULTS = {
    "flash_attention": {
        "none": [],
        "drop the diagonal key": [("kpos <= qpos", "kpos < qpos")],
        "drop the window's oldest key": [("qpos - kpos < window)",
                                          "qpos - kpos < window - 1)")],
        "drop the ragged last key": [("kpos < Sk &&", "kpos < Sk - 1 &&")],
        "skip one tile's rescale": [
            ("o[x] *= corr[(x >> 1) & 1];",
             "if (t != 1) o[x] *= corr[(x >> 1) & 1];"),
            ("for (int j = 0; j < DCH; ++j) o[i][j] *= corr;",
             "for (int j = 0; j < DCH; ++j) if (k0 != kv_begin + kBK) "
             "o[i][j] *= corr;")],
        "let keys past Sk in": [("kpos < Sk &&", "kpos < Sk + kBK &&")],
        "causal mask when causal is false": [("(!causal || kpos <= qpos)",
                                              "(kpos <= qpos)")],
    },
    "flash_attention_bwd": {
        "none": [],
        "drop the diagonal key from dS": [
            ("dp[x] = p * (dp[x] - d_s[col]);",
             "dp[x] = q0 + col == kpos ? 0.f : p * (dp[x] - d_s[col]);"),
            ("dp[x] = p * (dp[x] - d_r[i]);",
             "dp[x] = row0 + 8 * i == kpos ? 0.f : p * (dp[x] - d_r[i]);")],
        "read lse from another row": [
            ("scale_log2 - lse_s[col]", "scale_log2 - lse_s[col ^ 1]"),
            ("scale_log2 - lse_r[i]", "scale_log2 - lse_r[i ^ 1]")],
        "drop the low part of P and dS": [
            ("wgmma_pv<DP>(acc, lo, db);", "")],
        "drop each dK/dV block's last query tile": [
            ("(q_end - q_begin + kBQ - 1) / kBQ : 0;",
             "(q_end - q_begin - 1) / kBQ : 0;")],
        "sum one head of each KV group": [
            ("for (int j = 0; j < rep; ++j) {",
             "for (int j = 0; j < 1; ++j) {")],
    },
    "tile_matmul": {
        "none": [],
        "drop the last K split": [("for (int q = 0; q < splits; ++q)",
                                   "for (int q = 0; q < splits - 1; ++q)")],
        "drop each split's last K slice": [
            ("min(s_begin + per, slices) - s_begin)",
             "min(s_begin + per, slices) - s_begin - 1)")],
    },
    "ssd_scan": {
        "none": [],
        "skip the carried state C s_{c-1}": [
            ("keys<0, R>(acc, sCT + rg * R, x + Lp * P, LR, P, 0, Np);",
             "keys<0, R>(acc, sCT + rg * R, x + Lp * P, LR, P, 0, 0);")],
        "drop the diagonal j = i": [("(k <= i && i < L)", "(k < i && i < L)")],
        "do not pass the state on": [(
            "        s.x = s.x * dec[u] + d[u].x;\n"
            "        s.y = s.y * dec[u] + d[u].y;\n"
            "        s.z = s.z * dec[u] + d[u].z;\n"
            "        s.w = s.w * dec[u] + d[u].w;\n", "        s = d[u];\n")],
    },
}

#: prefill cases: (case, S, window, needle (an offset, "last", "past" or
#: None), keyword arguments)
FLASH_CASES = [
    ("S=512 causal", 512, 0, None, {}),
    ("S=500 causal (ragged)", 500, 0, None, {}),
    ("S=512 window=64", 512, 64, None, {}),
    ("S=512 needle on the diagonal", 512, 0, 0, {}),
    ("S=512 window=64 needle on the oldest key", 512, 64, 63, {}),
    ("S=500 needle on the diagonal and the ragged last key", 500, 0, 0, {}),
    ("zamba2 d=112 S=512 causal", 512, 0, None,
     dict(H=32, KV=32, d=112)),
    ("cross Sq=512 Sk=1600", 512, 0, None,
     dict(H=32, KV=8, Sk=1600, causal=False)),
    ("encoder S=1000 non-causal", 1000, 0, None,
     dict(H=16, KV=16, d=64, causal=False)),
    ("encoder S=1000 needle on the ragged last key", 1000, 0, "last",
     dict(H=16, KV=16, d=64, causal=False)),
    ("cross Sq=16 Sk=1000 needle on the ragged last key", 16, 0, "last",
     dict(H=16, KV=16, d=64, Sk=1000, causal=False)),
    ("cross Sq=16 Sk=1000 keys past Sk ignored", 16, 0, "past",
     dict(H=16, KV=16, d=64, Sk=1000, causal=False)),
    ("encoder S=1000 keys past Sk ignored", 1000, 0, "past",
     dict(H=16, KV=16, d=64, causal=False)),
]
#: flash backward cases: (case, B, H, KV, Sq, Sk, d, causal, window)
FLASH_GRAD_CASES = [
    ("qwen3 train S=1024 causal", 2, 40, 8, 1024, 1024, 128, True, 0),
    ("S=600 window=100 (ragged)", 1, 8, 2, 600, 600, 128, True, 100),
    ("cross Sq=70 Sk=530 d=64", 1, 8, 2, 70, 530, 64, False, 0),
    ("cross Sq=530 Sk=70 d=112", 1, 4, 2, 530, 70, 112, False, 0),
]
#: the source file of a fault list's kernel, where it is not its own name
SOURCES = {"flash_attention_bwd": "flash_attention"}
#: float64 GEMM cases: (M, N, K, mode)
GEMM_CASES = [(192, 192, 192, "sub_t"), (192, 192, 192, "sub_nn"),
              (200, 136, 72, "sub_t"), (20, 9, 72, "sub_t")]
#: SSD cases: (case, B, T, H, N, P, decay rate a)
SSD_CASES = [("zamba2 T=512", 1, 512, 112, 64, 64, -1.0),
             ("mamba2 T=512", 1, 512, 80, 128, 64, -1.0),
             ("zamba2 T=300 (ragged)", 1, 300, 112, 64, 64, -1.0),
             ("zamba2 T=100 (one short chunk)", 1, 100, 112, 64, 64, -1.0),
             ("zamba2 T=512 slow decay", 1, 512, 112, 64, 64, -0.02)]


def child(kernel: str) -> None:
    """In the faulted copy: build it, run the kernel's cases, print the
    shares of the limits."""
    sys.path.insert(0, str(Path.cwd()))
    import torch

    import chip_smoke
    from repro_torch.kernels import cuda_lib

    failures = []
    chip_smoke.check = lambda ok, what: ok or failures.append(what)
    chip_smoke.emit = lambda obj: None
    cuda_lib.build([SOURCES.get(kernel, kernel)])
    out = {}
    if kernel == "flash_attention_bwd":
        for seed, (case, *shape, causal, window) in enumerate(
                FLASH_GRAD_CASES):
            row = chip_smoke.flash_grad_case(case, *shape, causal=causal,
                                             window=window, seed=100 + seed,
                                             smi="")
            out[case] = {"bfloat16": max(row["bfloat16"][g]["tol_share"]
                                         for g in ("dq", "dk", "dv"))}
    elif kernel == "flash_attention":
        for seed, (case, S, window, needle, kw) in enumerate(FLASH_CASES):
            row = chip_smoke.flash_case(case, S, window, seed=100 + seed,
                                        needle=needle, timed=False, **kw)
            out[case] = {t: e["tol_share"] for t, e in row["errors"].items()}
    elif kernel == "tile_matmul":
        for seed, (M, N, K, mode) in enumerate(GEMM_CASES):
            case = f"{chip_smoke.GEMM_NAMES[mode]} {M}x{N}x{K}"
            row = chip_smoke.kernel_case(case, torch.float64, M, N, K,
                                         mode=mode, seed=100 + seed,
                                         timed=False)
            out[case] = {"float64": row["max_rel_err"]
                         / chip_smoke.F64_REL_TOL}
    else:
        for seed, (case, B, T, H, N, P, a) in enumerate(SSD_CASES):
            row = chip_smoke.ssd_case(case, B, T, H, N, P, seed=100 + seed,
                                      dtypes=(torch.float32, torch.bfloat16),
                                      timed=False, a=a)
            out[case] = {t: max(e["y"]["tol_share"], e["state"]["tol_share"])
                         for t, e in row["errors"].items()}
    print(json.dumps({"cases": out, "failed_checks": len(failures)}))


def run_fault(kernel: str, fault: str, edits) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp)
        shutil.copytree(ROOT / "src", copy / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", copy / "chip_smoke.py")
        shutil.copy(ROOT / "kernel_faults.py", copy / "kernel_faults.py")
        name = SOURCES.get(kernel, kernel)
        src = copy / CSRC / f"{name}.cu"
        text = src.read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"fault {fault!r}: {old!r} is not in "
                                 f"{CSRC / name}.cu")
            text = text.replace(old, new)
        src.write_text(text)
        run = subprocess.run([sys.executable, "kernel_faults.py", "--child",
                              kernel], cwd=copy, capture_output=True,
                             text=True, timeout=900)
    if run.returncode != 0:
        print(run.stdout[-2000:], run.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"{kernel} fault {fault!r}: the run failed")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(FAULTS), action="append",
                    help="only this kernel's faults (repeatable)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_faults: no CUDA device is available", file=sys.stderr)
        return 1
    ok = True
    for kernel in args.kernel or list(FAULTS):
        for fault, edits in FAULTS[kernel].items():
            result = run_fault(kernel, fault, edits)
            # the prefill kernel is judged at its bfloat16 limit, which the
            # needle inputs make tight; the others by every check
            if kernel == "flash_attention":
                worst = max(c["bfloat16"] for c in result["cases"].values())
                fails = worst > 1.0
            else:
                worst = max(max(c.values()) for c in result["cases"].values())
                fails = worst > 1.0 or result["failed_checks"] > 0
            ok &= (not fails) if fault == "none" else fails
            print(json.dumps({"kernel": kernel, "fault": fault,
                              "fails": fails, "worst_share": worst,
                              **result}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
