#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--n 7680] [--tile 192]

Run from the root of a checkout; it needs one CUDA card and ``nvcc``.
Phases, each printed as one JSON line:

1. the card (also the raw ``nvidia-smi`` name and power limit line);
2. the build of every kernel from ``src/repro_torch/kernels/csrc``;
3. the kernel phase: each kernel against its plain PyTorch version on the
   card at the main path's shapes, with its time, the plain version's time,
   one PyTorch library call's time and the least time the card could take;
4. the main path: a float64 tiled Cholesky of ``random_spd(n, seed=0)``
   split into ``tile``-wide tiles, built with ``build_cholesky_graph`` and
   run by ``repro_torch.Session(4)`` under the ``hybrid`` and ``history``
   victim policies; the kernel's launches, the residual, the agreement
   with ``torch.linalg.cholesky`` and the bit-identity of the two policies'
   factors are checked; beside each run, the same graph shape without
   task bodies times the session's planning and the runtime's dispatch
   alone;
5. one more ``hybrid`` run under ``torch.profiler``: device time by
   kernel and the device's busy share;
6. a ``kernels`` summary line, then the device line last.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): memory
#: bytes/s, and FLOP/s by operand type — float64 at the FP64 tensor-core
#: rate, float32 outside the tensor cores, bfloat16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12,
              torch.bfloat16: 989e12}
#: the kernel phase's tolerances: float64 normwise relative error (the
#: factorization's 1e-12 budget); float32 / bfloat16 as the reference
#: package's Pallas kernel tests (tests/test_kernels.py TOL)
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
F64_REL_TOL = 1e-12
WORKERS = 4
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/tile_matmul.cu"
KERNEL_REPLACES = "src/repro/kernels/tile_matmul.py:35"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def device_ms(fn, reps: int = 100) -> float:
    """Device milliseconds per call of ``fn``, from CUDA events around
    ``reps`` back-to-back calls.  The device is first held by a spin
    kernel so the host enqueues every call before the first one runs:
    the events then time the device's work, not the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)       # ~0.1 s of spinning at H100 clocks
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    line = smi.splitlines()[0]
    print(line, flush=True)
    emit({"phase": "card", "nvidia_smi": line,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return line


def build_phase() -> None:
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    seconds = cuda_lib.build(["tile_matmul"])
    ptxas = [ln.strip() for ln in
             cuda_lib.library_path("tile_matmul").with_suffix(".log")
             .read_text().splitlines() if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds,
          "wall_s": time.perf_counter() - t0, "ptxas": ptxas})


def kernel_case(name, dtype, M, N, K, *, gemm_sub: bool, seed: int):
    """One kernel-phase shape: compare, then time kernel / plain / library."""
    from repro_torch.kernels.ref import tile_matmul_ref
    from repro_torch.kernels.tile_matmul import tile_matmul

    rng = np.random.default_rng(seed)

    def rand(*shape):
        x = torch.from_numpy(rng.standard_normal(shape))
        return x.to(device="cuda", dtype=dtype)

    a = rand(M, K)
    if gemm_sub:                        # the trailing update: C - A B^T
        b, c = rand(N, K), rand(M, N)
        kw = dict(alpha=-1.0, beta=1.0, trans_b=True)
    else:                               # the Pallas kernel's A @ B
        b, c = rand(K, N), None
        kw = dict()
    expect = tile_matmul_ref(a, b, c, **kw)
    if gemm_sub:                        # in place, as the main path calls it
        got = c.clone()
        tile_matmul(a, b, got, out=got, **kw)
    else:
        got = tile_matmul(a, b)
    torch.cuda.synchronize()
    diff = (got.double() - expect.double()).abs()
    max_abs = diff.max().item()
    max_rel = max_abs / expect.double().abs().max().item()
    if dtype == torch.float64:
        ok = max_rel <= F64_REL_TOL
        tol = {"max_rel": F64_REL_TOL}
    else:
        t = TOL[dtype]
        ok = bool((diff <= t["atol"] + t["rtol"] * expect.double().abs()).all())
        tol = t
    check(ok, f"{name}: kernel vs plain version, max abs err {max_abs}")

    if gemm_sub:
        cw = c.clone()
        kern = lambda: tile_matmul(a, b, cw, out=cw, **kw)       # noqa: E731
        plain = lambda: tile_matmul_ref(a, b, cw, **kw)          # noqa: E731
        lib = lambda: torch.addmm(cw, a, b.mT, alpha=-1)        # noqa: E731
    else:
        kern = lambda: tile_matmul(a, b)                         # noqa: E731
        plain = lambda: tile_matmul_ref(a, b)                    # noqa: E731
        lib = lambda: torch.mm(a, b)                             # noqa: E731
    item = a.element_size()
    # each input read once, the output written once
    n_bytes = (M * K + K * N + (2 if gemm_sub else 1) * M * N) * item
    flops = 2.0 * M * N * K + (2.0 * M * N if gemm_sub else 0.0)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    row = {"phase": "kernel", "case": name, "dtype": str(dtype).split(".")[-1],
           "M": M, "N": N, "K": K, "max_abs_err": max_abs,
           "max_rel_err": max_rel, "tol": tol,
           "ms": device_ms(kern), "plain_ms": device_ms(plain),
           "library_ms": device_ms(lib),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    emit(row)
    return row


def factor(session, a, tile: int):
    """One main-path run: returns (L, report, enqueue seconds, synchronised
    wall seconds, launches, task count)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.linalg import build_cholesky_graph, cholesky_extract, to_tiles

    nb = a.shape[0] // tile
    store = to_tiles(a, tile, device="cuda")
    graph = build_cholesky_graph(nb, tile, store=store)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    report = session.run(graph)
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launch_counts()["tile_matmul"]
    return (cholesky_extract(store), report, enqueue_s, wall_s, launches,
            len(graph))


def runtime_only_s(session, nb: int, tile: int):
    """Host seconds of the session's planning (the graph hash) and of the
    runtime alone, on the main path's graph shape: the cost-model build of
    the same graph, whose tasks have no bodies, so only planning,
    scheduling and dispatch remain.  Returns (plan_s, dispatch_s)."""
    from repro_torch.linalg import build_cholesky_graph

    graph = build_cholesky_graph(nb, tile)
    t0 = time.perf_counter()
    plan = session.plan(graph)
    t1 = time.perf_counter()
    session.run(graph, plan=plan)
    return t1 - t0, time.perf_counter() - t1


def profile_phase(a, warm, tile: int, smi: str) -> None:
    """One ``hybrid`` main-path run under ``torch.profiler``: device time
    by kernel name and the device's busy share of the (profiled) wall."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import Session
    from repro_torch.linalg import build_cholesky_graph, to_tiles

    n = a.shape[0]
    store = to_tiles(a, tile, device="cuda")
    graph = build_cholesky_graph(n // tile, tile, store=store)
    with Session(WORKERS, policy="hybrid") as session:
        factor(session, warm, tile)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            session.run(graph)
            enqueue_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    device_s = sum(r[0] for r in rows) / 1e6
    emit({"phase": "profile", "policy": "hybrid", "n": n, "tile": tile,
          "tasks": len(graph), "wall_s": wall_s, "enqueue_s": enqueue_s,
          "device_busy_s": device_s,
          "device_busy_share": device_s / wall_s,
          "top": [{"name": k[:80], "count": c, "device_ms": us / 1e3}
                  for us, k, c in rows[:12]], "card": smi})


def main_path_phase(a, warm, tile: int, smi: str):
    """Factor ``a`` under ``hybrid`` and ``history`` (each after a warm-up
    factorization of ``warm``) and check every run."""
    from repro_torch import Session

    n = a.shape[0]
    nb = n // tile
    want_launches = math.comb(nb + 1, 3)
    l_ref = torch.linalg.cholesky(a)
    norm_a = torch.linalg.matrix_norm(a).item()
    factors = {}
    runs = {}
    for policy in ("hybrid", "history"):
        with Session(WORKERS, policy=policy) as session:
            factor(session, warm, tile)  # per-thread library handles, caches
            L, report, enqueue_s, wall_s, launches, n_tasks = factor(
                session, a, tile)
            plan_s, dispatch_s = runtime_only_s(session, nb, tile)
        resid = torch.linalg.matrix_norm(a - L @ L.mT).item() / norm_a
        rel_diff = ((L - l_ref).abs().max() / l_ref.abs().max()).item()
        row = {"phase": "main_path", "policy": policy, "n": n, "tile": tile,
               "nb": nb, "workers": WORKERS, "dtype": "float64",
               "tasks": n_tasks, "wall_s": wall_s, "enqueue_s": enqueue_s,
               "gflops": n ** 3 / 3.0 / wall_s / 1e9,
               "tile_matmul_launches": launches,
               "expected_launches": want_launches,
               "residual": resid, "max_rel_diff_vs_torch_cholesky": rel_diff,
               "steals": report.stats.get("steals"),
               "plan_s": plan_s, "dispatch_only_s": dispatch_s,
               "card": smi}
        emit(row)
        check(launches == want_launches,
              f"{policy}: tile_matmul launched {launches} times, expected "
              f"{want_launches}")
        check(resid <= 1e-12, f"{policy}: residual {resid} > 1e-12")
        check(rel_diff <= 1e-10,
              f"{policy}: L differs from torch.linalg.cholesky by {rel_diff}")
        check(bool(torch.isfinite(L).all()), f"{policy}: L is not finite")
        factors[policy] = L
        runs[policy] = row
    check(torch.equal(factors["hybrid"], factors["history"]),
          "the hybrid and history factors are not bit-identical")
    emit({"phase": "policies_bit_identical", "ok": True})
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=7680,
                    help="matrix order (paper sizes: 7680, 12288, 18432)")
    ap.add_argument("--tile", type=int, default=192, help="tile width b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.linalg import random_spd  # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False

    smi = card_phase()
    build_phase()
    t = args.tile
    main_case = kernel_case(f"tile_gemm_sub f64 {t}x{t}x{t}", torch.float64,
                            t, t, t, gemm_sub=True, seed=0)
    kernel_case("tile_gemm_sub f64 ragged 200x136x72", torch.float64,
                200, 136, 72, gemm_sub=True, seed=1)
    for dtype in (torch.float32, torch.bfloat16):
        for (M, K, N) in ((256, 256, 256), (512, 256, 128)):
            kernel_case(f"tile_matmul {str(dtype).split('.')[-1]} "
                        f"{M}x{K}x{N}", dtype, M, N, K, gemm_sub=False,
                        seed=2)
    check(args.n % t == 0, f"n={args.n} is not a multiple of tile={t}")
    a = random_spd(args.n, seed=0, device="cuda")
    warm = random_spd(4 * t, seed=1, device="cuda")
    runs = main_path_phase(a, warm, t, smi)
    profile_phase(a, warm, t, smi)
    emit({"kernels": [{
        "name": "tile_matmul", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": runs["hybrid"]["tile_matmul_launches"],
        "max_abs_err": main_case["max_abs_err"],
        "max_rel_err": main_case["max_rel_err"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
