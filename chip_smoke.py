#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--n 7680] [--tile 192] [--requests 12]

Run from the root of a checkout; it needs one CUDA card and ``nvcc``.
Phases, each printed as one JSON line:

1. the card (also the raw ``nvidia-smi`` name and power limit line);
2. the build of every kernel from ``src/repro_torch/kernels/csrc``, all
   ``nvcc`` processes at once, with each one's ptxas register, shared
   memory and spill lines, and the count of the tensor-core instructions
   the kernels built around the tensor cores depend on (``HGMMA`` in flash
   attention, ``DMMA`` in the tile GEMM), neither of which may be 0;
3. the kernel phase: each kernel against its plain PyTorch version on the
   card at its main paths' shapes, each twice for the same bits (the
   float64 tile GEMM's ``C - A B^T`` and ``C - A B`` at 192^3, ragged and
   at shallow K, and QR's tall ``V^T A`` and ``A - V Y``; the attention kernels in float32 and in bfloat16, on the
   same inputs, at qwen3-14b's and at zamba2-7b's head dims; decode also
   with fewer keys than splits, prefill also with needle inputs whose
   weight sits on one masked-edge key; the SSD scan at zamba2-7b's and
   mamba2-2.7b's prefill, ragged, batched (each row against its scan
   alone), short, at 4,096 tokens and with a slow head's decay, with
   inputs made as an SSM layer makes them), with its time, the plain
   version's time, one PyTorch library call's time where there is one and
   the least time the card could take;
4. the Cholesky path: a float64 tiled Cholesky of ``random_spd(n, seed=0)``
   split into ``tile``-wide tiles, built with ``build_cholesky_graph`` and
   run by ``repro_torch.Session(4)`` under the ``hybrid`` and ``history``
   victim policies; the kernel's launches, the residual, the agreement
   with ``torch.linalg.cholesky`` and the bit-identity of the two policies'
   factors are checked; beside each run, the same graph shape without
   task bodies times the session's planning and the runtime's dispatch
   alone; then one more ``hybrid`` run under ``torch.profiler``: device
   time by kernel and the device's busy share;
   compiled: the same matrix through ``Session(4, scheduler="compiled")``
   (run 1 records, run 2 captures every fused segment as a CUDA graph and
   replays it, runs 3-4 replay), each factor bit-identical to the
   ``hybrid`` one with exact launches and as many captured graphs as
   capturable segments; a run on a second matrix, after which run 3's
   factor must be unchanged; one profiled compiled run, whose GEMM kernels
   the profiler must count to the same number;
   trace: one ``trace=True`` run exported as Perfetto JSON, which must
   validate, reconcile with the run's counters and show no worker busy
   longer than the wall;
5. the LU and QR paths, at the Cholesky path's size: a float64 tiled LU
   (no pivoting) of ``random_diagdom(n, seed=0)`` and a Householder QR of
   a standard normal matrix from numpy seed 0, built with
   ``build_lu_graph`` / ``build_qr_graph`` (panels forked as gang regions
   of 4 threads, run on the host in numpy) and run by ``Session(4)`` under
   ``hybrid`` and ``history``; the residual, the agreement with
   ``torch.linalg.lu_factor_ex(pivot=False)`` (LU) or with the magnitudes
   of ``torch.linalg.qr``'s R (QR), the kernel's launches and the two
   policies' bit-identity are checked, and the panels' host seconds, the
   steals and the gang regions are printed; then one more ``hybrid`` run
   of each under ``torch.profiler``: device time by kernel and the
   device's busy share;
6. record and replay: one ``hybrid`` LU run recorded
   (``Session(4, record=True)``), stored in an on-disk ``GraphCache`` and
   replayed by ``Session(4, scheduler="replay")`` from it, then LU's static
   recording (``lu_static_recording``) replayed, each bit-identical to the
   dynamic factors and the first with the recorded gang issue order; then
   three Cholesky runs through ``Session(4, scheduler="pool")``, which
   must warm up, record and replay, with the same factors each time; then
   the LU recording compiled (one ``scheduler="compiled"`` run) and QR at
   half the order recorded and compiled, each bit-identical to its
   dynamic factors with exact launches;
7. the serving paths, each model at full width and depth in bfloat16,
   random weights made on the card from seed 0, and freed before the
   next: qwen3-14b (dense), zamba2-7b (hybrid: Mamba2 layers and a shared
   attention block) and mamba2-2.7b (ssm).  For each, batch: four
   512-token prompts (numpy seed 1) prefilled by ``make_decode_state``
   and decoded 32 tokens each by ``build_decode_graph`` steps on
   ``Session(2)``, then again by the plain loop, one prompt at a time;
   the two token streams must be bit-identical, every logit finite and
   the kernels' launches exact (every SSM layer's prefill launches the
   SSD scan; every attention layer, or use of the shared block, launches
   flash attention per prompt and decode attention per lane-step); for
   qwen3-14b and zamba2-7b the decode once more through a pool that
   promotes the step graph to a compiled plan after two clean replays
   (``compile_after=2``), whose tokens must equal the plain loop's;
8. qwen3-14b and zamba2-7b, Poisson: the ``ContinuousBatchingEngine``
   with ``max_batch=4`` over ``serve_lm``'s default stream (rate 100/s,
   12 requests, budgets 2..8) with prompts of 256..1024 tokens; every
   request's tokens must equal serving it alone (``max_batch=1``);
9. for each model one more 4-lane decode step under ``torch.profiler``:
   device time by kernel, kernels per lane-step and the device's busy
   share; then one 512-token prefill of one prompt: device time by kernel;
10. the script's seconds so far, a ``kernels`` summary line, then the
    device line last.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
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
L2_FLUSH_BYTES = 128 << 20              # more than the H100's 50 MB L2
PEAK_FLOPS = {torch.float64: 67e12, torch.float32: 67e12,
              torch.bfloat16: 989e12}
#: the kernel phase's tolerances: float64 normwise relative error (the
#: factorization's 1e-12 budget); float32 / bfloat16 as the reference
#: package's Pallas kernel tests (tests/test_kernels.py TOL)
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
F64_REL_TOL = 1e-12
#: the LU path's factors against ``torch.linalg.lu_factor_ex(pivot=False)``
#: (cuSOLVER's unpivoted LU), largest difference over the largest entry:
#: the matrix is strictly diagonally dominant, so both factorizations are
#: stable and their factors differ by rounding, as L does from
#: ``torch.linalg.cholesky`` on the Cholesky path (1e-10 there too)
LU_REF_TOL = 1e-10
#: the QR path's |R| against ``torch.linalg.qr``'s |R| (Householder signs
#: may differ by row), Frobenius norm of the difference over that of R.  R
#: is fixed by A up to those signs, but its forward error is about
#: cond(A) times the backward error: a 7680 x 7680 standard normal matrix
#: has a condition number of order 1e4 to 1e5, so agreement to 1e-8
#: leaves two orders of magnitude for the two factorizations' rounding
QR_R_TOL = 1e-8
#: the gang regions of the LU and QR panels (ULTs per region)
PANEL_THREADS = 4
WORKERS = 4
KERNELS = ("tile_matmul", "flash_attention", "decode_attention", "ssd_scan")
CSRC = "src/repro_torch/kernels/csrc"
#: the Pallas entry each kernel replaces (file:line of its function)
REPLACES = {"tile_matmul": "src/repro/kernels/tile_matmul.py:35",
            "flash_attention": "src/repro/kernels/flash_attention.py:76",
            "decode_attention": "src/repro/kernels/decode_attention.py:59",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:78"}
#: the attention kernels against their plain versions.  The plain versions
#: keep p in float32 as the Pallas kernels do.  float32: both kernels keep p
#: in float32 too, and meet tests/test_kernels.py's kernel tolerance.
#: bfloat16 decode keeps p in float32, so it differs from the plain version
#: only in the order of float32 sums, then one rounding of each output: two
#: roundings of nearly equal float32 values land at most one unit in the
#: last place apart, at most 2**-7 |x| < 1e-2 |x|, and atol covers the
#: float32 sums' ~1e-6 near zero (on an H100 the decode errors read 2.4e-4
#: on outputs near 0.07, one such unit).
ATTN_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
            torch.bfloat16: dict(rtol=1e-2, atol=1e-4)}
#: bfloat16 prefill runs p . V on the tensor cores with p rounded to
#: bfloat16 (as the reference's layers._chunked_attn does), which adds a
#: third rounding point.  With p_j = e^(s_j - m) and l = sum_j p_j (summed
#: from the float32 p), each p_j carries a relative error of at most
#: u = 2**-8 (bfloat16's unit roundoff), so the float32 output
#: sum_j p_j (1 + d_j) v_j / l differs from the plain version's by at most
#: u * sum_j p_j |v_j| / l: u times the same attention applied to |v|
#: (higher orders are below float32's sums).  The limit is therefore
#: ATTN_TOL's one-ulp bound plus FLASH_P_ROUND times that attention of |v|,
#: element by element; it is proven against planted faults with needle
#: inputs (kernel_faults.py).
FLASH_P_ROUND = 2.0 ** -8
#: the SSD scan against its plain version: the same float32 products
#: summed in another order.  float32: tests/test_kernels.py's kernel
#: tolerance (the other kernels' here); on an H100 the largest error at the
#: cases below read 1.9e-5 on outputs near 8, 0.022 of the reference's
#: own SSD limit of 1e-4.  bfloat16 y rounds once from such sums, at most
#: one unit in the last place apart (as ATTN_TOL; it read 0.75 of that
#: limit).  The final state is float32 in both.
SSD_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
           torch.bfloat16: dict(rtol=1e-2, atol=1e-4)}
#: the serving paths: (arch, whether it also serves the Poisson stream)
SERVE_ARCHS = (("qwen3-14b", True), ("zamba2-7b", True),
               ("mamba2-2.7b", False))
SERVE_WORKERS = 2                       # serve_lm's --workers default
SERVE_DEVICE = "cuda"
BATCH, PROMPT, TOKENS = 4, 512, 32
POISSON = dict(rate=100.0, prompt_len=(256, 1024), max_new_tokens=(2, 8))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def device_ms(fn, reps: int = 100, *, cold_l2: bool = False) -> float:
    """Device milliseconds per call of ``fn``, from CUDA events around
    ``reps`` back-to-back calls.  The device is first held by a spin
    kernel so the host enqueues every call before the first one runs:
    the events then time the device's work, not the host's launch rate.
    With ``cold_l2`` each call is timed alone, after a write of more than
    the 50 MB L2 cache, for inputs the real caller finds cold."""
    fn()
    torch.cuda.synchronize()
    if cold_l2:
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                            device="cuda")
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(200_000_000)
        for start, end in marks:
            flush.zero_()
            start.record()
            fn()
            end.record()
        marks[-1][1].synchronize()
        return sum(s.elapsed_time(e) for s, e in marks) / reps
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


#: the tensor-core instruction each redesigned kernel depends on: its name
#: in ``cuobjdump -sass`` (every listed word on one line) and, where the
#: toolkit has no ``cuobjdump``, in the PTX of ``nvcc -ptx``
TENSOR_CORE_OPS = {
    "flash_attention": (("HGMMA",), ("wgmma.mma_async",)),
    "tile_matmul": (("DMMA",), ("mma.sync", ".f64")),
}


def tensor_core_instructions(name: str) -> dict:
    """How many of ``name``'s tensor-core instructions
    (:data:`TENSOR_CORE_OPS`) its built library holds: ``cuobjdump -sass``
    where the toolkit has it, else the matching lines of the source's PTX
    (``nvcc -ptx``)."""
    from repro_torch.kernels import cuda_lib

    sass_words, ptx_words = TENSOR_CORE_OPS[name]
    nvcc = Path(cuda_lib.nvcc_path())
    cuobjdump = nvcc.with_name("cuobjdump")
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(cuda_lib.library_path(name))],
                              capture_output=True, text=True, check=True)
        lines, tool, words = sass.stdout.splitlines(), "cuobjdump -sass", sass_words
    else:
        ptx = subprocess.run(
            [str(nvcc), "-gencode", "arch=compute_90a,code=compute_90a",
             "-std=c++17", "-ptx", "-o", "-",
             str(cuda_lib.CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=True)
        lines, tool, words = ptx.stdout.splitlines(), "nvcc -ptx", ptx_words
    return {"tool": tool, "words": list(words),
            "count": sum(all(w in ln for w in words) for ln in lines)}


def build_phase() -> None:
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    seconds = cuda_lib.build(KERNELS)
    ptxas = {name: [ln.strip() for ln in
                    cuda_lib.library_path(name).with_suffix(".log")
                    .read_text().splitlines()
                    if "Used" in ln or "spill" in ln or "Compiling" in ln]
             for name in KERNELS}
    # the kernels designed around the tensor cores must run their products
    # there: bfloat16 prefill on wgmma, the float64 GEMM on DMMA
    found = {name: tensor_core_instructions(name) for name in TENSOR_CORE_OPS}
    emit({"phase": "build", "seconds": seconds,
          "wall_s": time.perf_counter() - t0,
          "tensor_core_instructions": found, "ptxas": ptxas})
    for name, hit in found.items():
        check(hit["count"] > 0, f"the {name} library holds no "
              f"{' '.join(hit['words'])} instruction ({hit['tool']})")


GEMM_NAMES = {"sub_t": "tile_gemm_sub", "sub_nn": "tile_gemm_nn_sub"}


def kernel_case(name, dtype, M, N, K, *, mode: str, seed: int, timed=True):
    """One tile-GEMM shape: compare (twice, for the same bits), then, if
    ``timed``, time kernel / plain / library.  ``mode`` is ``"sub_t"`` (the
    Cholesky trailing update ``C - A B^T``, in place), ``"sub_nn"`` (LU and
    QR's ``C - A B``, in place) or ``"mm"`` (the Pallas kernel's ``A @
    B``)."""
    from repro_torch.kernels.ref import tile_matmul_ref
    from repro_torch.kernels.tile_matmul import gemm_splits, tile_matmul

    rng = np.random.default_rng(seed)

    def rand(*shape):
        x = torch.from_numpy(rng.standard_normal(shape))
        return x.to(device="cuda", dtype=dtype)

    a = rand(M, K)
    if mode == "sub_t":
        b, c = rand(N, K), rand(M, N)
        kw = dict(alpha=-1.0, beta=1.0, trans_b=True)
    elif mode == "sub_nn":
        b, c = rand(K, N), rand(M, N)
        kw = dict(alpha=-1.0, beta=1.0)
    else:
        b, c = rand(K, N), None
        kw = dict()
    expect = tile_matmul_ref(a, b, c, **kw)
    runs = []
    for _ in range(2):
        if c is not None:               # in place, as the main path calls it
            got = c.clone()
            tile_matmul(a, b, got, out=got, **kw)
        else:
            got = tile_matmul(a, b)
        runs.append(got)
    torch.cuda.synchronize()
    got = runs[0]
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
    check(torch.equal(runs[0], runs[1]),
          f"{name}: two launches on the same inputs differ")
    row = {"phase": "kernel", "case": name, "dtype": str(dtype).split(".")[-1],
           "mode": mode, "M": M, "N": N, "K": K,
           "splits_per": list(gemm_splits(M, N, K)), "max_abs_err": max_abs,
           "max_rel_err": max_rel, "tol": tol}
    if not timed:
        emit(row)
        return row
    if c is not None:
        cw = c.clone()
        kern = lambda: tile_matmul(a, b, cw, out=cw, **kw)       # noqa: E731
        plain = lambda: tile_matmul_ref(a, b, cw, **kw)          # noqa: E731
        bb = b.mT if mode == "sub_t" else b
        lib = lambda: torch.addmm(cw, a, bb, alpha=-1)          # noqa: E731
    else:
        kern = lambda: tile_matmul(a, b)                         # noqa: E731
        plain = lambda: tile_matmul_ref(a, b)                    # noqa: E731
        lib = lambda: torch.mm(a, b)                             # noqa: E731
    item = a.element_size()
    # each input read once, the output written once
    n_bytes = (M * K + K * N + (2 if c is not None else 1) * M * N) * item
    flops = 2.0 * M * N * K + (2.0 * M * N if c is not None else 0.0)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    row.update({"ms": device_ms(kern), "plain_ms": device_ms(plain),
                "library_ms": device_ms(lib),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
    emit(row)
    return row


def _bound(n_bytes: float, flops: float, dtype=torch.bfloat16):
    """The least time for the work: bytes over the memory rate or
    operations over the type's peak rate, whichever is larger."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _compare(name: str, kernel, plain, arrays, slack=None):
    """Hold ``kernel`` against ``plain`` on the same numpy inputs, in
    float32 and then in bfloat16.  ``slack(*inputs)``, where given, adds an
    element-wise allowance to the bfloat16 limit.  Returns the bfloat16
    inputs and output, and per type the largest error and the largest share
    of the limit that it used (1.0 is the limit)."""
    errors = {}
    for dtype in (torch.float32, torch.bfloat16):
        xs = [torch.from_numpy(a).to(device="cuda", dtype=dtype)
              for a in arrays]
        expect = plain(*xs).float()
        got = kernel(*xs)
        again = kernel(*xs)
        torch.cuda.synchronize()
        diff = (got.float() - expect).abs()
        t = ATTN_TOL[dtype]
        limit = t["atol"] + t["rtol"] * expect.abs()
        if slack is not None and dtype == torch.bfloat16:
            limit = limit + slack(*xs)
        share = (diff / limit).max().item()
        key = str(dtype).split(".")[-1]
        errors[key] = {"max_abs_err": diff.max().item(), "tol": t,
                       "tol_share": share}
        check(share <= 1.0, f"{name} {key}: kernel vs plain version, max abs "
              f"err {diff.max().item()}, {share:.3g} of the tolerance")
        check(torch.equal(got, again),
              f"{name} {key}: two launches on the same inputs differ")
        check(bool(torch.isfinite(got.float()).all()),
              f"{name} {key}: the kernel's output is not finite")
    return xs, got, errors


def flash_slack(causal: bool, window: int):
    """The bfloat16 prefill kernel's allowance for rounding p: FLASH_P_ROUND
    times the float32 attention of |v| (see FLASH_P_ROUND)."""
    from repro_torch.kernels.ref import flash_attention_ref

    def slack(q, k, v):
        return FLASH_P_ROUND * flash_attention_ref(
            q.float(), k.float(), v.float().abs(), causal=causal,
            window=window)
    return slack


def needle_arrays(rng, B, H, KV, S, d, offset):
    """Prefill inputs where, in every row i >= offset, the key i - offset
    carries nearly all the weight: the query heads of a KV group share one
    standard-normal row u_i, and key j is 2 u_{j + offset}, so that score
    is 2 |u|^2 / sqrt(d) ~ 2 sqrt(d) against ~N(0, 4) for the others.
    offset 0 puts the needle on the causal diagonal (and, at a ragged S, on
    the last key), window - 1 on the window's oldest key: a kernel that
    drops that key is off by about |v| there."""
    u = rng.standard_normal((B, KV, S + offset, d))
    q = np.repeat(u[:, :, :S], H // KV, axis=1)
    k = 2.0 * u[:, :, offset:]
    v = rng.standard_normal((B, KV, S, d))
    return [q, k, v]


def decode_case(name, S, length, window, *, seed, B=1, H=40, KV=8, d=128):
    """One decode-attention shape: compare, then time kernel / plain /
    ``scaled_dot_product_attention`` over the same valid keys, each with
    the L2 cache flushed first: a decode step finds its layer's K/V cold,
    behind the 28 GB of weights the step streams."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_splits)
    from repro_torch.kernels.ref import decode_attention_ref

    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s) for s in ((B, H, d), (B, S, KV, d),
                                                (B, S, KV, d))]
    (q, k, v), got, errors = _compare(
        name, lambda q, k, v: decode_attention(q, k, v, length, window=window),
        lambda q, k, v: decode_attention_ref(q, k, v, length, window=window),
        arrays)
    if length == 0:
        check(not got.any(), f"{name}: an empty cache must give zeros")
    lo = max(0, length - window) if window > 0 else 0
    n = length - lo                     # the keys this call attends to
    library_ms = None
    if n > 0:
        qs = q[:, :, None]
        ks, vs = k[:, lo:length].transpose(1, 2), v[:, lo:length].transpose(1, 2)
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, enable_gqa=True), cold_l2=True)
    # q read and out written once, each valid K and V row read once
    bound_ms, bound_by = _bound(2 * (2 * B * H * d + 2 * B * n * KV * d),
                                4.0 * B * H * n * d)
    row = {"phase": "kernel", "case": name, "kernel": "decode_attention",
           "dtype": "bfloat16", "B": B, "H": H, "KV": KV, "S": S, "d": d,
           "length": length, "window": window,
           "lo_splits_per": decode_splits(length, window, KV, d),
           "max_abs_err": errors["bfloat16"]["max_abs_err"], "errors": errors,
           "ms": device_ms(lambda: decode_attention(q, k, v, length,
                                                    window=window),
                           cold_l2=True),
           "plain_ms": device_ms(lambda: decode_attention_ref(
               q, k, v, length, window=window), cold_l2=True),
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    emit(row)
    return row


def flash_case(name, S, window, *, seed, B=1, H=40, KV=8, d=128,
               needle=None, timed=True):
    """One causal prefill-attention shape: compare (bfloat16 at the derived
    limit), then, if ``timed``, time kernel / plain /
    ``scaled_dot_product_attention``.  ``needle=offset`` draws
    :func:`needle_arrays` instead of plain normal inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    rng = np.random.default_rng(seed)
    if needle is None:
        arrays = [rng.standard_normal(s) for s in
                  ((B, H, S, d), (B, KV, S, d), (B, KV, S, d))]
    else:
        arrays = needle_arrays(rng, B, H, KV, S, d, needle)
    (q, k, v), _, errors = _compare(
        name, lambda q, k, v: flash_attention(q, k, v, causal=True,
                                              window=window),
        lambda q, k, v: flash_attention_ref(q, k, v, causal=True,
                                            window=window), arrays,
        slack=flash_slack(True, window))
    if not timed:
        row = {"phase": "kernel", "case": name, "kernel": "flash_attention",
               "B": B, "H": H, "KV": KV, "S": S, "d": d, "window": window,
               "needle_offset": needle, "errors": errors}
        emit(row)
        return row
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    pairs = int(mask.sum().item())      # the (query, key) pairs computed
    if window > 0:
        lib = lambda: F.scaled_dot_product_attention(             # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(             # noqa: E731
            q, k, v, is_causal=True, enable_gqa=True)
    # q, k, v read and out written once; QK and PV, 2 flops a term each
    bound_ms, bound_by = _bound(2 * B * S * d * (2 * H + 2 * KV),
                                4.0 * B * H * d * pairs)
    row = {"phase": "kernel", "case": name, "kernel": "flash_attention",
           "dtype": "bfloat16", "B": B, "H": H, "KV": KV, "S": S, "d": d,
           "causal": True, "window": window, "p_round": FLASH_P_ROUND,
           "max_abs_err": errors["bfloat16"]["max_abs_err"], "errors": errors,
           "ms": device_ms(lambda: flash_attention(q, k, v, causal=True,
                                                   window=window), reps=20),
           "plain_ms": device_ms(lambda: flash_attention_ref(
               q, k, v, causal=True, window=window), reps=20),
           "library_ms": device_ms(lib, reps=20), "bound_ms": bound_ms,
           "bound_by": bound_by}
    emit(row)
    return row


def ssd_inputs(B, T, H, N, P, chunk, seed, a=-1.0):
    """The SSD scan's float32 inputs made as an SSM layer makes them:
    silu'd x, B and C, step sizes softplus(N(0, 0.8)), about 0.75, and
    decay rate ``a``: -1 (the seed-0 model's a_log = 0) makes cs fall to
    about -95 across a 128-step chunk, so exp(cs_i - cs_j) above the
    diagonal is inf in float32 and nothing of a chunk's state outlives the
    next chunk; a slow head's -0.02 carries the state across chunks.  Laid
    out and padded by the model's ``ssd_scan_inputs``."""
    import torch.nn.functional as F

    from repro_torch.models.ssm import ssd_scan_inputs

    rng = np.random.default_rng(seed)

    def rand(shape, scale=1.0):
        x = (scale * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(x).to("cuda")

    xs = F.silu(rand((B, T, H, P)))
    dt = F.softplus(rand((B, T, H), 0.8))
    Bm, Cm = F.silu(rand((B, T, N))), F.silu(rand((B, T, N)))
    rate = torch.full((H,), a, device="cuda")
    return ssd_scan_inputs(xs, dt, rate, Bm, Cm, chunk=chunk)


def ssd_case(name, B, T, H, N, P, *, seed, chunk=128,
             dtypes=(torch.float32,), timed=True, a=-1.0):
    """One SSD-scan shape: in each type, compare y and the final state
    with the plain version, check that a second launch gives the same
    bits (and, at B > 1, that each batch row scanned alone does), and, if
    ``timed``, time kernel and plain version.  No single PyTorch call
    computes the chunked scan, so there is no library time."""
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan

    xdt32, cs, bm32, cm32 = ssd_inputs(B, T, H, N, P, chunk, seed, a)
    _, nc, L, _, _ = xdt32.shape
    errors = {}
    for dtype in dtypes:
        xdt, bm, cm = (t.to(dtype) for t in (xdt32, bm32, cm32))
        ey, es = ssd_scan_ref(xdt, cs, bm, cm)
        y, st = ssd_scan(xdt, cs, bm, cm)
        y2, st2 = ssd_scan(xdt, cs, bm, cm)
        torch.cuda.synchronize()
        key = str(dtype).split(".")[-1]
        check(bool(torch.isfinite(y.float()).all() and torch.isfinite(st).all()),
              f"{name} {key}: the kernel's output is not finite")
        check(torch.equal(y, y2) and torch.equal(st, st2),
              f"{name} {key}: two launches on the same inputs differ")
        for b in range(B if B > 1 else 0):
            # batch invariance: a row scanned alone gives the same bits
            yb, sb = ssd_scan(*(t[b:b + 1].contiguous()
                                for t in (xdt, cs, bm, cm)))
            check(torch.equal(yb, y[b:b + 1]) and torch.equal(sb, st[b:b + 1]),
                  f"{name} {key}: batch row {b} differs from its scan alone")
        shares = {}
        for what, got, want, t in (("y", y, ey, SSD_TOL[dtype]),
                                   ("state", st, es, SSD_TOL[torch.float32])):
            diff = (got.float() - want.float()).abs()
            share = (diff / (t["atol"] + t["rtol"] * want.float().abs())
                     ).max().item()
            shares[what] = {"max_abs_err": diff.max().item(), "tol": t,
                            "tol_share": share}
            check(share <= 1.0, f"{name} {key} {what}: kernel vs plain "
                  f"version, max abs err {diff.max().item()}, {share:.3g} of "
                  f"the tolerance")
        errors[key] = shares
        if timed:
            shares["ms"] = device_ms(lambda: ssd_scan(xdt, cs, bm, cm),
                                     reps=20)
            shares["plain_ms"] = device_ms(
                lambda: ssd_scan_ref(xdt, cs, bm, cm), reps=5)
    first = errors[str(dtypes[0]).split(".")[-1]]
    item = torch.tensor([], dtype=dtypes[0]).element_size()
    # xdt read and y written, cs, B and C read, the final state written
    n_bytes = (2 * B * nc * L * H * P * item + 4 * B * nc * L * H
               + 2 * B * nc * L * N * item + 4 * B * H * N * P)
    # per chunk and head: C . s and the state update (2 L N P each), the
    # lower triangle's W . xdt; per chunk C . B^T over the lower triangle
    pairs = L * (L + 1) // 2
    flops = 2.0 * B * nc * (H * (2 * L * N * P + pairs * P) + pairs * N)
    bound_ms, bound_by = _bound(n_bytes, flops, dtypes[0])
    row = {"phase": "kernel", "case": name, "kernel": "ssd_scan",
           "dtype": str(dtypes[0]).split(".")[-1], "B": B, "T": T, "nc": nc,
           "L": L, "H": H, "N": N, "P": P, "cs_min": cs.min().item(),
           "max_abs_err": first["y"]["max_abs_err"], "errors": errors,
           "ms": first.get("ms"), "plain_ms": first.get("plain_ms"),
           "library_ms": None, "bytes": n_bytes, "flops": flops,
           "bound_ms": bound_ms, "bound_by": bound_by}
    emit(row)
    return row


def _device_rows(prof):
    """(device microseconds, kernel name, count) of every profiled kernel,
    memory copy and memset, largest first.  Only the device's own events
    count: a host op recorded on the profiling thread carries its kernels'
    device time too, and would count it twice."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    return rows


def serving_model(arch: str):
    """``arch`` at full width and depth in bfloat16, drawn on the card;
    returns (cfg, model, the bytes a B = 1 decode lane-step must read and
    write at least)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.lm import layer_flags
    from repro_torch.models.ssm import ssm_state_spec

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=SERVE_DEVICE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    # a decode lane-step reads every weight once, the shared block once per
    # layer that runs it (it does not fit the 50 MB L2), and one row of the
    # embedding table unless the table is also the unembedding
    uses = sum(layer_flags(cfg).get("use_attn", []))
    read = 0
    for name, p in model.named_parameters():
        size = p.numel() * p.element_size()
        if name == "embed.table" and not cfg.tie_embeddings:
            size = cfg.d_model * p.element_size()
        elif name.startswith("shared."):
            size *= uses
        read += size
    # and reads and writes every layer's SSM and conv states
    state = 0
    if cfg.family in ("ssm", "hybrid"):
        state = cfg.n_layers * sum(
            math.prod(shape) * torch.tensor([], dtype=dt).element_size()
            for shape, dt in ssm_state_spec(cfg, 1, cfg.torch_dtype).values())
    floor_bytes = read + 2 * state
    emit({"phase": "serving_model", "arch": cfg.name, "family": cfg.family,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
          "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
          "ssm_heads": cfg.ssm_heads, "ssm_state": cfg.ssm_state,
          "ssm_chunk": cfg.ssm_chunk if cfg.ssm_state else None,
          "shared_block_uses": uses, "vocab": cfg.vocab_size,
          "dtype": cfg.dtype, "params": n_params,
          "weight_bytes_read_per_lane_step": read,
          "state_bytes_per_lane": state,
          "floor_ms_per_lane_step": floor_bytes / HBM_BYTES_PER_S * 1e3,
          "init_s": time.perf_counter() - t0,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return cfg, model, floor_bytes


def expected_launches(cfg, prefills: int, lane_steps: int):
    """Each kernel's launches for ``prefills`` prompts and ``lane_steps``
    decode lane-steps: every attention layer (a hybrid: every use of the
    shared block) launches flash attention per prompt and decode attention
    per lane-step; every SSM layer launches the SSD scan per prompt."""
    from repro_torch.models.lm import layer_flags

    if cfg.family == "dense":
        attn, ssm = cfg.n_layers, 0
    else:
        attn, ssm = sum(layer_flags(cfg).get("use_attn", [])), cfg.n_layers
    return {"tile_matmul": 0, "flash_attention": attn * prefills,
            "decode_attention": attn * lane_steps,
            "ssd_scan": ssm * prefills}


def serving_batch_phase(cfg, model, floor_bytes, smi):
    """The fixed batch through the decode-step graphs, then through the
    plain loop; returns (the graph run's row, its decode state)."""
    from repro_torch import Session
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import (build_decode_graph, decode_step,
                                    greedy_sample, make_decode_state,
                                    prefill)

    max_len = PROMPT + TOKENS + 1
    steps = TOKENS - 1
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32),
        device=SERVE_DEVICE)

    def dec(p, c, t):
        return decode_step(p, cfg, c, t)

    with Session(SERVE_WORKERS) as session:
        # warm-up outside the counted run: cuBLAS handles on every thread
        warm = make_decode_state(model, cfg, {"tokens": prompts[:, :16]},
                                 n_shards=BATCH, max_len=20,
                                 device=SERVE_DEVICE)
        session.run(build_decode_graph(warm, dec))
        del warm
        torch.cuda.synchronize()

        reset_launch_counts()
        t0 = time.perf_counter()
        state = make_decode_state(model, cfg, {"tokens": prompts},
                                  n_shards=BATCH, max_len=max_len,
                                  device=SERVE_DEVICE)
        prefill_enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        prefill_wall_s = time.perf_counter() - t0
        prefill_launches = launch_counts()

        reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            session.run(build_decode_graph(state, dec))
        decode_enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        decode_wall_s = time.perf_counter() - t0
        decode_launches = launch_counts()
    graph_tokens = state.tokens()
    graph_finite = all(bool(torch.isfinite(sh.logits).all())
                       for sh in state.shards)

    # the plain loop at the same per-shard batch (B = 1), in the graph's
    # order: every prompt's prefill, then each step over the lanes; every
    # logit of it is checked finite (one flag on the device)
    reset_launch_counts()
    finite = torch.ones((), dtype=torch.bool, device=SERVE_DEVICE)
    t0 = time.perf_counter()
    lanes = []
    for b in range(BATCH):
        cache, logits = prefill(model, cfg, {"tokens": prompts[b:b + 1]},
                                max_len=max_len)
        finite &= torch.isfinite(logits).all()
        lanes.append([cache, [greedy_sample(logits)]])
    torch.cuda.synchronize()
    loop_prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        for lane in lanes:
            lane[0], logits = decode_step(model, cfg, lane[0], lane[1][-1])
            finite &= torch.isfinite(logits).all()
            lane[1].append(greedy_sample(logits))
    loop_enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    loop_decode_s = time.perf_counter() - t0
    loop_launches = launch_counts()
    loop_tokens = torch.cat([torch.cat(toks, dim=1) for _, toks in lanes])
    del lanes

    lane_steps = BATCH * steps
    row = {"phase": "serving_batch", "arch": cfg.name, "layers": cfg.n_layers,
           "dtype": cfg.dtype, "batch": BATCH, "prompt": PROMPT,
           "tokens": TOKENS, "max_len": max_len, "n_shards": BATCH,
           "workers": SERVE_WORKERS,
           "prefill_enqueue_s": prefill_enqueue_s,
           "prefill_wall_s": prefill_wall_s,
           "prefill_tok_s": BATCH * PROMPT / prefill_wall_s,
           "decode_steps": steps, "decode_enqueue_s": decode_enqueue_s,
           "decode_wall_s": decode_wall_s,
           "decode_tok_s": lane_steps / decode_wall_s,
           "step_ms": decode_wall_s / steps * 1e3,
           "lane_step_ms": decode_wall_s / lane_steps * 1e3,
           "floor_ms_per_lane_step": floor_bytes / HBM_BYTES_PER_S * 1e3,
           "plain_prefill_wall_s": loop_prefill_s,
           "plain_decode_enqueue_s": loop_enqueue_s,
           "plain_decode_wall_s": loop_decode_s,
           "plain_lane_step_ms": loop_decode_s / lane_steps * 1e3,
           "flash_attention_launches": prefill_launches["flash_attention"],
           "decode_attention_launches": decode_launches["decode_attention"],
           "ssd_scan_launches": prefill_launches["ssd_scan"],
           "plain_loop_launches": loop_launches,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "tokens_bit_identical": bool(torch.equal(graph_tokens,
                                                    loop_tokens)),
           "sample_tokens": graph_tokens[0, :8].tolist(), "card": smi}
    emit(row)
    want = expected_launches(cfg, BATCH, 0)
    check(prefill_launches == want,
          f"{cfg.name} prefill launched {prefill_launches}, expected {want}")
    want = expected_launches(cfg, 0, lane_steps)
    check(decode_launches == want,
          f"{cfg.name} decode launched {decode_launches}, expected {want}")
    want = expected_launches(cfg, BATCH, lane_steps)
    check(loop_launches == want,
          f"{cfg.name}: the plain loop launched {loop_launches}, expected "
          f"{want}")
    check(graph_tokens.shape == (BATCH, TOKENS),
          f"graph tokens have shape {tuple(graph_tokens.shape)}")
    check(row["tokens_bit_identical"],
          "the graph's and the plain loop's tokens differ")
    check(graph_finite and bool(finite), "a logit is not finite")
    return row, state


def serving_poisson_phase(cfg, model, n_requests: int, smi):
    """The continuous-batching engine over a seeded Poisson stream, then
    every request served alone; returns the batched run's row."""
    from repro_torch import Session
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import decode_step, prefill
    from repro_torch.serving import ContinuousBatchingEngine, PoissonWorkload

    workload = PoissonWorkload(POISSON["rate"], n_requests, seed=0,
                               prompt_len=POISSON["prompt_len"],
                               max_new_tokens=POISSON["max_new_tokens"],
                               vocab_size=cfg.vocab_size)
    max_len = POISSON["prompt_len"][1] + POISSON["max_new_tokens"][1] + 1

    def run(max_batch: int):
        with Session(SERVE_WORKERS) as session:
            engine = ContinuousBatchingEngine(
                session, lambda cache, tok: decode_step(model, cfg, cache, tok),
                lambda prompt: prefill(model, cfg, {"tokens": prompt},
                                       max_len=max_len),
                max_batch=max_batch)
            engine.prime()
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            report = engine.run(workload.requests())
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = launch_counts()
        check(report.completed == n_requests,
              f"max_batch={max_batch}: {report.completed} of {n_requests} "
              "requests completed")
        want = expected_launches(cfg, n_requests, report.lane_steps)
        check(launches == want,
              f"{cfg.name} max_batch={max_batch}: launched {launches}, "
              f"expected {want}")
        row = {"phase": "serving_poisson", "arch": cfg.name,
               "max_batch": max_batch,
               "workload": workload.describe(), "max_len": max_len,
               "wall_s": wall_s, "lane_steps": report.lane_steps,
               "steps_by_lane_count": {str(k): v for k, v in
                                       sorted(report.shape_counts.items())},
               "launches": launches, **report.summary(), "card": smi}
        return report, row

    batched, row = run(4)
    alone, alone_row = run(1)
    row["identical_to_alone"] = (batched.tokens_by_rid()
                                 == alone.tokens_by_rid())
    emit(row)
    emit(alone_row)
    check(row["identical_to_alone"],
          "continuous batching's token streams differ from serving each "
          "request alone")
    return row


def serving_profile_phase(cfg, model, state, floor_bytes, smi) -> None:
    """One more 4-lane decode step of the batch path under
    ``torch.profiler``: device time by kernel, kernels per lane-step, the
    device's busy share and the distance from the floor; then one
    ``PROMPT``-token prefill of one prompt: device time per prompt by
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import Session
    from repro_torch.models import build_decode_graph, decode_step, prefill

    with Session(SERVE_WORKERS) as session:
        graph = build_decode_graph(
            state, lambda p, c, t: decode_step(p, cfg, c, t))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            session.run(graph)
            enqueue_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    rows = _device_rows(prof)
    device_s = sum(r[0] for r in rows) / 1e6
    kernels = sum(r[2] for r in rows)
    check(kernels > 0, "the profiled decode step shows no device work")
    floor_s = state.n_shards * floor_bytes / HBM_BYTES_PER_S

    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, PROMPT), dtype=np.int32), device=SERVE_DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(model, cfg, {"tokens": prompt}, max_len=PROMPT + 1)
        torch.cuda.synchronize()
        prefill_wall_s = time.perf_counter() - t0
    prefill_rows = _device_rows(prof)
    prefill_device_s = sum(r[0] for r in prefill_rows) / 1e6
    check(prefill_device_s > 0, "the profiled prefill shows no device work")
    emit({"phase": "serving_profile", "arch": cfg.name,
          "lanes": state.n_shards,
          "wall_s": wall_s, "enqueue_s": enqueue_s,
          "device_busy_s": device_s, "device_busy_share": device_s / wall_s,
          "device_kernels": kernels,
          "kernels_per_lane_step": kernels / state.n_shards,
          "device_ms_per_lane_step": device_s / state.n_shards * 1e3,
          "host_us_per_kernel": enqueue_s / max(kernels, 1) * 1e6,
          "floor_s": floor_s, "wall_over_floor": wall_s / floor_s,
          "device_over_floor": device_s / floor_s,
          "top": [{"name": k[:80], "count": c, "device_ms": us / 1e3}
                  for us, k, c in rows[:12]],
          "prefill_tokens": PROMPT, "prefill_wall_s": prefill_wall_s,
          "prefill_device_ms": prefill_device_s * 1e3,
          "prefill_device_busy_share": prefill_device_s / prefill_wall_s,
          "prefill_top": [{"name": k[:80], "count": c, "device_ms": us / 1e3}
                          for us, k, c in prefill_rows[:8]], "card": smi})


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
    rows = _device_rows(prof)
    device_s = sum(r[0] for r in rows) / 1e6
    check(bool(rows), "the profiled factorization shows no device work")
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
    return runs, factors["hybrid"]


def expected_panel_launches(kernel: str, nb: int) -> int:
    """``tile_matmul`` launches of one LU or QR factorization with ``nb``
    block columns.  LU: step k updates nb-k-1 columns with nb-k-1 tile
    GEMMs each, sum_{m=1}^{nb-1} m^2 in all (20,540 at nb = 40).  QR: step
    k updates nb-k-1 columns with ``COL_UPDATE_LAUNCHES`` launches each
    (V^T A, T^T W and A - V Y), 3 C(nb, 2) in all (2,340 at nb = 40)."""
    if kernel == "lu":
        return sum(m * m for m in range(1, nb))
    from repro_torch.linalg.qr import COL_UPDATE_LAUNCHES
    return COL_UPDATE_LAUNCHES * math.comb(nb, 2)


class HostClock:
    """Host seconds of one LU or QR run's panel tasks (each panel task's
    body: the gather to the host, the gang region, the write-back) and of
    their gathers alone (the synchronising ``.cpu()`` copy, which first
    waits for every kernel queued before it on the stream)."""

    def __init__(self):
        self.panel_s = []
        self.gather_s = []

    @staticmethod
    def _timed(fn, sink):
        def timed(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                sink.append(time.perf_counter() - t0)
        return timed

    def wrap_panels(self, graph) -> None:
        for task in graph:
            if task.kind == "panel" and task.fn is not None:
                task.fn = self._timed(task.fn, self.panel_s)

    @contextlib.contextmanager
    def gathers(self, module):
        real = module.column_to_host
        module.column_to_host = self._timed(real, self.gather_s)
        try:
            yield
        finally:
            module.column_to_host = real

    def row(self) -> dict:
        return {"panel_host_s": sum(self.panel_s),
                "panel_gather_s": sum(self.gather_s),
                "panel_tasks": len(self.panel_s),
                "panel_max_s": max(self.panel_s, default=0.0)}


def factor_panels(session, kernel: str, a, tile: int):
    """One LU or QR run of ``a`` through ``session``: returns (store,
    report, enqueue seconds, synchronised wall seconds, launches, the
    panels' :class:`HostClock`, task count)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.linalg import KERNELS, lu, qr, to_tiles

    nb = a.shape[0] // tile
    store = to_tiles(a, tile, device="cuda")
    graph = KERNELS[kernel](nb, tile, store=store, panel_threads=PANEL_THREADS)
    clock = HostClock()
    clock.wrap_panels(graph)
    torch.cuda.synchronize()
    reset_launch_counts()
    with clock.gathers(lu if kernel == "lu" else qr):
        t0 = time.perf_counter()
        report = session.run(graph)
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return (store, report, enqueue_s, wall_s, launch_counts()["tile_matmul"],
            clock, len(graph))


def panel_factors(kernel: str, store) -> torch.Tensor:
    """Everything an LU or QR run leaves behind, flat: the packed tiles
    and, for QR, every panel's reflectors (V, V^T, T^T)."""
    parts = [store.assemble().flatten()]
    if kernel == "qr":
        parts += [x.flatten() for k in range(store.nb)
                  for x in store.vt_store[k]]
    return torch.cat(parts)


def panel_path_phase(kernel: str, a, warm, tile: int, smi: str):
    """Factor ``a`` (LU or QR) under ``hybrid`` and ``history``, each after
    a warm-up factorization of ``warm``, and check every run.  Returns
    ({policy: row}, the hybrid run's :func:`panel_factors`)."""
    from repro_torch import Session
    from repro_torch.linalg import (lu_extract, qr_extract_r,
                                    qr_reconstruct)

    n = a.shape[0]
    nb = n // tile
    want_launches = expected_panel_launches(kernel, nb)
    flops = (2.0 if kernel == "lu" else 4.0) * n ** 3 / 3.0
    norm_a = torch.linalg.matrix_norm(a).item()
    if kernel == "lu":
        ref, _, info = torch.linalg.lu_factor_ex(a, pivot=False)
        check(int(info.item()) == 0, "lu_factor_ex(pivot=False) failed")
    else:
        ref = torch.linalg.qr(a, mode="r").R.abs()
    factors, runs = {}, {}
    for policy in ("hybrid", "history"):
        with Session(WORKERS, policy=policy) as session:
            factor_panels(session, kernel, warm, tile)
            store, report, enqueue_s, wall_s, launches, clock, n_tasks = \
                factor_panels(session, kernel, a, tile)
        if kernel == "lu":
            lower, upper = lu_extract(store)
            resid = torch.linalg.matrix_norm(a - lower @ upper).item() / norm_a
            packed = store.assemble()
            ref_diff = ((packed - ref).abs().max() / ref.abs().max()).item()
            ref_name, ref_tol = "max_rel_diff_vs_lu_factor_ex", LU_REF_TOL
            del lower, upper, packed
        else:
            resid = torch.linalg.matrix_norm(
                a - qr_reconstruct(store)).item() / norm_a
            r = qr_extract_r(store)
            check(torch.equal(r, store.assemble()),
                  f"qr {policy}: nonzeros below the diagonal of R")
            ref_diff = (torch.linalg.matrix_norm(r.abs() - ref)
                        / torch.linalg.matrix_norm(ref)).item()
            ref_name, ref_tol = "rel_diff_abs_r_vs_torch_qr", QR_R_TOL
            del r
        flat = panel_factors(kernel, store)
        row = {"phase": f"{kernel}_path", "policy": policy, "n": n,
               "tile": tile, "nb": nb, "workers": WORKERS,
               "panel_threads": PANEL_THREADS, "dtype": "float64",
               "tasks": n_tasks, "wall_s": wall_s, "enqueue_s": enqueue_s,
               "gflops": flops / wall_s / 1e9,
               "tile_matmul_launches": launches,
               "expected_launches": want_launches, "residual": resid,
               ref_name: ref_diff, "ref_tol": ref_tol,
               "steals": report.stats.get("steals"),
               "gang_regions": report.stats.get("gang_regions"),
               **clock.row(), "card": smi}
        emit(row)
        check(launches == want_launches,
              f"{kernel} {policy}: tile_matmul launched {launches} times, "
              f"expected {want_launches}")
        check(resid <= 1e-12, f"{kernel} {policy}: residual {resid} > 1e-12")
        check(ref_diff <= ref_tol, f"{kernel} {policy}: {ref_name} "
              f"{ref_diff} > {ref_tol}")
        check(bool(torch.isfinite(flat).all()),
              f"{kernel} {policy}: the factors are not finite")
        check(report.stats.get("gang_regions") == nb,
              f"{kernel} {policy}: {report.stats.get('gang_regions')} gang "
              f"regions, expected one per panel ({nb})")
        factors[policy] = flat
        runs[policy] = row
        del store
    check(torch.equal(factors["hybrid"], factors["history"]),
          f"{kernel}: the hybrid and history factors are not bit-identical")
    emit({"phase": f"{kernel}_policies_bit_identical", "ok": True})
    return runs, factors["hybrid"]


def panel_profile_phase(kernel: str, a, warm, tile: int, smi: str) -> None:
    """One ``hybrid`` LU or QR run under ``torch.profiler``: device time by
    kernel name and the device's busy share, beside the panels' host
    seconds of the same run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import Session

    with Session(WORKERS, policy="hybrid") as session:
        factor_panels(session, kernel, warm, tile)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, enqueue_s, wall_s, _, clock, n_tasks = factor_panels(
                session, kernel, a, tile)
    rows = _device_rows(prof)
    device_s = sum(r[0] for r in rows) / 1e6
    check(bool(rows), f"the profiled {kernel} run shows no device work")
    emit({"phase": f"{kernel}_profile", "policy": "hybrid", "n": a.shape[0],
          "tile": tile, "tasks": n_tasks, "wall_s": wall_s,
          "enqueue_s": enqueue_s, "device_busy_s": device_s,
          "device_busy_share": device_s / wall_s, **clock.row(),
          "top": [{"name": k[:80], "count": c, "device_ms": us / 1e3}
                  for us, k, c in rows[:10]], "card": smi})


def replay_phase(lu_a, warm_lu, spd, tile: int, dynamic_lu, smi: str):
    """Record one ``hybrid`` LU run, replay it from an on-disk cache, replay
    LU's static recording, and serve three Cholesky runs through a pool;
    every factor must equal the dynamic run's bit for bit."""
    import tempfile

    from repro_torch import Session
    from repro_torch.linalg import cholesky_extract, lu_static_recording
    from repro_torch.replay import GraphCache

    n = lu_a.shape[0]
    nb = n // tile
    row = {"phase": "replay", "n": n, "tile": tile, "workers": WORKERS,
           "card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        with Session(WORKERS, record=True) as session:
            factor_panels(session, "lu", warm_lu, tile)
            store, report, enqueue_s, wall_s, _, clock, _ = factor_panels(
                session, "lu", lu_a, tile)
        rec = report.recording
        check(report.plan.mode == "record" and rec is not None,
              "the recorded LU run left no recording")
        check(torch.equal(panel_factors("lu", store), dynamic_lu),
              "the recorded LU run's factors differ from the dynamic run's")
        GraphCache(tmp).store(rec)
        row["record"] = {"wall_s": wall_s, "enqueue_s": enqueue_s,
                         "steals": report.stats.get("steals"),
                         "gang_regions": len(rec.gang_issue_order),
                         **clock.row()}
        with Session(WORKERS, scheduler="replay",
                     cache=GraphCache(tmp)) as session:
            factor_panels(session, "lu", warm_lu, tile)   # records the shape
            store, report, enqueue_s, wall_s, launches, clock, _ = \
                factor_panels(session, "lu", lu_a, tile)
            issued = list(session._replay_executor(
                report.recording).issued_gang_ids)
    recorded = [rec.gang_placements[t].gang_id for t in rec.gang_issue_order]
    row["replay"] = {"mode": report.plan.mode, "wall_s": wall_s,
                     "enqueue_s": enqueue_s, "launches": launches,
                     "issued_gang_ids_match": issued == recorded,
                     **report.stats, **clock.row()}
    check(report.plan.mode == "replay",
          f"the replay session planned {report.plan.mode!r}, not a replay")
    check(torch.equal(panel_factors("lu", store), dynamic_lu),
          "the replayed LU factors differ from the dynamic run's")
    check(issued == recorded,
          "the replay did not issue the recorded gang order")

    srec = lu_static_recording(nb, tile, n_workers=WORKERS,
                               panel_threads=PANEL_THREADS)
    scache = GraphCache()
    scache.store(srec)
    with Session(WORKERS, scheduler="replay", cache=scache) as session:
        store, report, enqueue_s, wall_s, launches, clock, _ = factor_panels(
            session, "lu", lu_a, tile)
    row["static_replay"] = {"mode": report.plan.mode,
                            "source": report.recording.source,
                            "wall_s": wall_s, "enqueue_s": enqueue_s,
                            "launches": launches, **report.stats,
                            **clock.row()}
    check(report.plan.mode == "replay" and report.recording.source == "static",
          "LU's static recording was not replayed")
    check(torch.equal(panel_factors("lu", store), dynamic_lu),
          "the static replay's LU factors differ from the dynamic run's")
    del store

    want = math.comb(nb + 1, 3)
    pool_runs, pool_factors = [], []
    with Session(WORKERS, scheduler="pool") as session:
        for _ in range(3):
            L, report, enqueue_s, wall_s, launches, _ = factor(
                session, spd, tile)
            pool_runs.append({"pool_mode": report.stats["pool_mode"],
                              "wall_s": wall_s, "enqueue_s": enqueue_s,
                              "launches": launches,
                              "replay_stats": report.stats.get("replay_stats")})
            pool_factors.append(L)
            check(launches == want, f"pool Cholesky: {launches} launches, "
                  f"expected {want}")
    row["pool_cholesky"] = pool_runs
    emit(row)
    modes = [r["pool_mode"] for r in pool_runs]
    check(modes.count("replay") >= 1, f"the pool served no warm replay: "
          f"{modes}")
    check(all(torch.equal(L, pool_factors[0]) for L in pool_factors),
          "the pool's Cholesky factors differ between runs")
    check(bool(torch.isfinite(pool_factors[0]).all()),
          "the pool's Cholesky factor is not finite")
    del pool_factors
    emit({"phase": "replay_bit_identical", "ok": True})
    return rec


def _compiled_row(report, cache, launches, want_launches, name):
    """Check one compiled run's report; return its driver counters.  Every
    capturable segment must hold its CUDA graph, and no run may fall back
    to replay."""
    stats = report.stats
    check("compiled_fallback" not in stats,
          f"{name}: the compiled run fell back: "
          f"{stats.get('compiled_fallback')}")
    check(report.plan.mode == "compiled",
          f"{name}: planned {report.plan.mode!r}, not compiled")
    meta = cache.lookup_plan_meta(report.recording.digest,
                                  report.recording.n_workers, "hybrid")
    check(meta is not None, f"{name}: no plan meta in the cache")
    check(stats["captured_graphs"] == meta["jit_segments"] > 0,
          f"{name}: {stats['captured_graphs']} captured graphs, "
          f"{meta['jit_segments']} capturable segments")
    check(launches == want_launches, f"{name}: tile_matmul launched "
          f"{launches} times, expected {want_launches}")
    return {"mode": report.plan.mode,
            "captured_graphs": stats["captured_graphs"],
            "graphs_captured_this_run": stats["graphs_captured_this_run"],
            "jit_segments": meta["jit_segments"],
            "fused_segments": meta["n_fused"],
            "fused_tasks": meta["n_fused_tasks"],
            "opaque_tasks": meta["n_opaque"],
            "capture_s": stats["capture_s"], "bind_s": stats["bind_s"],
            "driver_wall_s": stats["wall_s"], "body_s": stats["body_s"],
            "dispatch_overhead_fraction":
                stats["dispatch_overhead_fraction"],
            "launches": launches}


def _cholesky_run(session, a, tile: int):
    """One Cholesky run through ``session``; returns (store, report,
    enqueue seconds, synchronised wall seconds, launches)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.linalg import build_cholesky_graph, to_tiles

    store = to_tiles(a, tile, device="cuda")
    graph = build_cholesky_graph(a.shape[0] // tile, tile, store=store)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    report = session.run(graph)
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    return store, report, enqueue_s, wall_s, launch_counts()["tile_matmul"]


def compiled_phase(a, tile: int, dynamic_l, smi: str) -> int:
    """The Cholesky path under ``scheduler="compiled"``: run 1 records, run
    2 captures each fused segment as a CUDA graph and replays it, runs 3-4
    replay only; each factor equals the dynamic ``hybrid`` factor bit for
    bit.  Then a run on another matrix, after which run 3's factor must be
    unchanged, and one profiled run.  Returns a replay run's launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import Session
    from repro_torch.linalg import (build_cholesky_graph, cholesky_extract,
                                    random_spd, to_tiles)
    from repro_torch.replay import GraphCache

    n = a.shape[0]
    want = math.comb(n // tile + 1, 3)
    cache = GraphCache()
    rows, kept = [], None
    with Session(WORKERS, scheduler="compiled", cache=cache) as session:
        for run in range(4):
            store, report, enqueue_s, wall_s, launches = _cholesky_run(
                session, a, tile)
            row = {"run": run + 1, "wall_s": wall_s, "enqueue_s": enqueue_s,
                   "gflops": n ** 3 / 3.0 / wall_s / 1e9}
            if run == 0:
                check(report.plan.mode == "record",
                      f"compiled run 1 planned {report.plan.mode!r}")
                check(launches == want, f"compiled record run: {launches} "
                      f"launches, expected {want}")
                row.update(mode="record", launches=launches)
            else:
                row.update(_compiled_row(report, cache, launches, want,
                                         f"compiled Cholesky run {run + 1}"))
                check(row["graphs_captured_this_run"] ==
                      (row["jit_segments"] if run == 1 else 0),
                      f"run {run + 1} captured "
                      f"{row['graphs_captured_this_run']} graphs")
            check(torch.equal(cholesky_extract(store), dynamic_l),
                  f"compiled run {run + 1}'s factor differs from the dynamic "
                  "hybrid factor")
            rows.append(row)
            if run == 2:
                kept = store
        other = random_spd(n, seed=2, device="cuda")
        store, report, _, _, _ = _cholesky_run(session, other, tile)
        check(report.plan.mode == "compiled", "the run on a second matrix "
              f"planned {report.plan.mode!r}")
        other_l = cholesky_extract(store)
        resid = (torch.linalg.matrix_norm(other - other_l @ other_l.mT)
                 / torch.linalg.matrix_norm(other)).item()
        check(resid <= 1e-12, f"compiled run on a second matrix: residual "
              f"{resid}")
        check(torch.equal(cholesky_extract(kept), dynamic_l),
              "run 3's factor changed when a later compiled run replayed "
              "the same graphs on another matrix")
        del other, other_l, store
        store = to_tiles(a, tile, device="cuda")
        graph = build_cholesky_graph(n // tile, tile, store=store)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            report = session.run(graph)
            enqueue_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        check(torch.equal(cholesky_extract(store), dynamic_l),
              "the profiled compiled run's factor differs")
    prof_rows = _device_rows(prof)
    device_s = sum(r[0] for r in prof_rows) / 1e6
    gemm = sum(c for _, k, c in prof_rows if "dmma_kernel" in k)
    emit({"phase": "compiled", "n": n, "tile": tile, "workers": WORKERS,
          "dtype": "float64", "runs": rows,
          "second_matrix_residual": resid, "run3_factor_unchanged": True,
          "profiled": {"wall_s": wall_s, "enqueue_s": enqueue_s,
                       "device_busy_s": device_s,
                       "device_busy_share": device_s / wall_s,
                       "gemm_device_launches": gemm,
                       "top": [{"name": k[:80], "count": c,
                                "device_ms": us / 1e3}
                               for us, k, c in prof_rows[:8]]},
          "card": smi})
    check(gemm == want, f"the profiler saw {gemm} GEMM kernels in a compiled "
          f"run, expected {want}")
    return rows[-1]["launches"]


def compiled_panel_phase(kernel: str, a, tile: int, recording, dynamic, smi):
    """LU or QR under ``scheduler="compiled"``.  With ``recording`` (LU: the
    one ``replay_phase`` made) the first run already compiles; without
    (QR) the first run records and the second compiles.  The compiled
    factors must equal ``dynamic`` (or the record run's) bit for bit.
    Returns the compiled run's launches."""
    from repro_torch import Session
    from repro_torch.replay import GraphCache

    n = a.shape[0]
    nb = n // tile
    want = expected_panel_launches(kernel, nb)
    cache = GraphCache()
    if recording is not None:
        cache.store(recording)
    row = {"phase": f"compiled_{kernel}", "n": n, "tile": tile, "nb": nb,
           "workers": WORKERS, "panel_threads": PANEL_THREADS,
           "dtype": "float64", "card": smi}
    with Session(WORKERS, scheduler="compiled", cache=cache) as session:
        if recording is None:
            store, report, enqueue_s, wall_s, launches, clock, _ = \
                factor_panels(session, kernel, a, tile)
            check(report.plan.mode == "record",
                  f"{kernel}: the first compiled-session run planned "
                  f"{report.plan.mode!r}")
            check(launches == want, f"{kernel} record run: {launches} "
                  f"launches, expected {want}")
            dynamic = panel_factors(kernel, store)
            row["record"] = {"wall_s": wall_s, "enqueue_s": enqueue_s,
                             "launches": launches, **clock.row()}
            del store
        store, report, enqueue_s, wall_s, launches, clock, _ = \
            factor_panels(session, kernel, a, tile)
    row["compiled"] = {"wall_s": wall_s, "enqueue_s": enqueue_s,
                       **_compiled_row(report, cache, launches, want,
                                       f"compiled {kernel}"),
                       **clock.row()}
    row["bit_identical"] = bool(torch.equal(panel_factors(kernel, store),
                                            dynamic))
    emit(row)
    check(row["bit_identical"], f"compiled {kernel}: the factors differ from "
          "the dynamic run's")
    return launches


def trace_phase(a, tile: int, smi: str) -> None:
    """One traced dynamic Cholesky run, exported as Perfetto JSON to a
    temporary file: it must validate, its steal markers reconcile with the
    run's counters, and no worker is busy longer than the wall."""
    import os
    import tempfile

    from repro_torch import Session
    from repro_torch.core.tracing import BUSY_KINDS, KIND_STEAL
    from repro_torch.obs import load_trace, validate_trace_json, write_trace

    with Session(WORKERS, trace=True) as session:
        store, report, enqueue_s, wall_s, launches = _cholesky_run(
            session, a, tile)
    trace = report.trace
    check(trace is not None, "the traced run returned no trace")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cholesky_trace.json")
        t0 = time.perf_counter()
        write_trace(trace, path, extra={"n": a.shape[0], "tile": tile})
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        info = validate_trace_json(path)
        round_trip = load_trace(path) == trace
    busy = [sum(v for k, v in w.items() if k in BUSY_KINDS)
            for w in trace.per_worker_breakdown()]
    mismatch = trace.reconcile(report.stats)
    emit({"phase": "trace", "n": a.shape[0], "tile": tile,
          "workers": WORKERS, "wall_s": wall_s, "enqueue_s": enqueue_s,
          "launches": launches, "events": len(trace.events),
          "dropped": trace.dropped, "file_bytes": size,
          "write_s": write_s, "slices": info["slices"],
          "flows": info["flows"], "steals": report.stats.get("steals"),
          "steal_markers": trace.count(KIND_STEAL),
          "counters_mismatch": {k: list(v) for k, v in mismatch.items()},
          "worker_busy_s": busy, "makespan_s": trace.makespan,
          "round_trip_exact": round_trip,
          "dispatch_overhead_fraction": trace.dispatch_overhead_fraction(),
          "card": smi})
    check(trace.count(KIND_STEAL) == report.stats.get("steals"),
          f"{trace.count(KIND_STEAL)} steal markers in the trace, "
          f"{report.stats.get('steals')} steals counted")
    check(not mismatch, f"trace counters disagree with the run's: {mismatch}")
    check(all(b <= wall_s for b in busy),
          f"a worker is busy longer than the wall: {busy} > {wall_s}")
    check(round_trip, "load_trace did not rebuild the written trace")
    check(launches == math.comb(a.shape[0] // tile + 1, 3),
          f"the traced run launched {launches} GEMMs")


def serving_compiled_phase(cfg, model, batch_row, batch_tokens, smi) -> int:
    """The batch phase's decode again, through a pool that promotes the
    step graph to a compiled plan after two clean replays; the compiled
    serves' tokens must equal the plain loop's.  Returns the decode
    attention launches of the decode."""
    from repro_torch import Session
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import (build_decode_graph, decode_step,
                                    make_decode_state)

    max_len = PROMPT + TOKENS + 1
    steps = TOKENS - 1
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32),
        device=SERVE_DEVICE)

    def dec(p, c, t):
        return decode_step(p, cfg, c, t)

    state = make_decode_state(model, cfg, {"tokens": prompts},
                              n_shards=BATCH, max_len=max_len,
                              device=SERVE_DEVICE)
    torch.cuda.synchronize()
    modes, step_s = [], []
    with Session(SERVE_WORKERS, scheduler="pool",
                 pool_kwargs={"warmup_runs": 0, "compile_after": 2}) as s:
        reset_launch_counts()
        t_all = time.perf_counter()
        for _ in range(steps):
            t0 = time.perf_counter()
            report = s.run(build_decode_graph(state, dec))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            modes.append(report.stats["pool_mode"])
        wall_s = time.perf_counter() - t_all
        launches = launch_counts()
        stats = report.stats
    tokens = state.tokens()
    compiled = [t for t, m in zip(step_s, modes) if m == "compiled"]
    row = {"phase": "serving_compiled", "arch": cfg.name,
           "workers": SERVE_WORKERS, "batch": BATCH, "prompt": PROMPT,
           "tokens": TOKENS, "modes": {m: modes.count(m) for m in
                                       dict.fromkeys(modes)},
           "compiled_serves": stats.get("compiled_serves"),
           "compiles": stats.get("compiles"),
           "compiled_stats": stats.get("compiled_stats"),
           "decode_wall_s": wall_s,
           "compiled_lane_step_ms": (sum(compiled) / len(compiled) / BATCH
                                     * 1e3) if compiled else None,
           "plain_lane_step_ms": batch_row["plain_lane_step_ms"],
           "session2_lane_step_ms": batch_row["lane_step_ms"],
           "launches": launches,
           "tokens_bit_identical": bool(torch.equal(tokens, batch_tokens)),
           "card": smi}
    row["compiled_over_plain"] = (row["compiled_lane_step_ms"]
                                  / row["plain_lane_step_ms"]
                                  if compiled else None)
    emit(row)
    check(bool(compiled) and (stats.get("compiled_serves") or 0) > 0,
          f"{cfg.name}: no decode step was served compiled: {modes}")
    check(row["tokens_bit_identical"],
          f"{cfg.name}: the compiled serves' tokens differ from the plain "
          "loop's")
    want = expected_launches(cfg, 0, BATCH * steps)
    check(launches == want, f"{cfg.name} compiled serving launched "
          f"{launches}, expected {want}")
    del state
    return launches["decode_attention"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=7680,
                    help="matrix order (paper sizes: 7680, 12288, 18432)")
    ap.add_argument("--tile", type=int, default=192, help="tile width b")
    ap.add_argument("--requests", type=int, default=12,
                    help="Poisson serving phase: stream length")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.linalg import random_spd  # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False

    smi = card_phase()
    build_phase()
    t = args.tile
    main_case = kernel_case(f"tile_gemm_sub f64 {t}x{t}x{t}", torch.float64,
                            t, t, t, mode="sub_t", seed=0)
    kernel_case(f"tile_gemm_nn_sub f64 {t}x{t}x{t}", torch.float64, t, t, t,
                mode="sub_nn", seed=21)
    kernel_case("tile_gemm_sub f64 ragged 200x136x72", torch.float64,
                200, 136, 72, mode="sub_t", seed=1)
    # the DMMA fragments' edges: shallow and ragged K, tiles below a block
    for (M, N, K, mode) in ((192, 192, 1, "sub_t"), (192, 192, 3, "sub_nn"),
                            (200, 136, 17, "sub_nn"), (20, 9, 72, "sub_t")):
        kernel_case(f"{GEMM_NAMES[mode]} f64 {M}x{N}x{K}", torch.float64,
                    M, N, K, mode=mode, seed=22, timed=False)
    # QR's column update at its tallest: W = V^T A (K = n, and n/2 halfway
    # through) and A - V Y (M = n)
    for m in (args.n, args.n // 2):
        kernel_case(f"qr V^T A f64 {t}x{t}x{m}", torch.float64, t, t, m,
                    mode="mm", seed=25)
    kernel_case(f"qr A - V Y f64 {args.n}x{t}x{t}", torch.float64, args.n,
                t, t, mode="sub_nn", seed=26)
    for dtype in (torch.float32, torch.bfloat16):
        for (M, K, N) in ((256, 256, 256), (512, 256, 128)):
            kernel_case(f"tile_matmul {str(dtype).split('.')[-1]} "
                        f"{M}x{K}x{N}", dtype, M, N, K, mode="mm", seed=2)
    max_len = PROMPT + TOKENS + 1
    decode_main = decode_case(f"decode S={max_len} length={max_len}",
                              max_len, max_len, 0, seed=3)
    decode_case("decode S=4096 length=4000", 4096, 4000, 0, seed=4)
    decode_case("decode S=1033 length=1000 window=64", 1033, 1000, 64,
                seed=5)
    decode_case(f"decode S={max_len} length=0", max_len, 0, 0, seed=6)
    # three keys across sixteen splits: thirteen ranges are empty
    decode_case(f"decode S={max_len} length=3 (fewer keys than splits)",
                max_len, 3, 0, seed=17)
    flash_main = flash_case(f"prefill S={PROMPT} causal", PROMPT, 0, seed=7)
    flash_case("prefill S=500 causal (ragged)", 500, 0, seed=8)
    flash_case(f"prefill S={PROMPT} causal window=64", PROMPT, 64, seed=9)
    # needles: one masked-edge key carries nearly all of a row's weight, so
    # a kernel that drops it cannot hide under the bfloat16 limit
    flash_case(f"prefill S={PROMPT} needle on the diagonal", PROMPT, 0,
               seed=18, needle=0, timed=False)
    flash_case(f"prefill S={PROMPT} window=64 needle on the oldest key",
               PROMPT, 64, seed=19, needle=63, timed=False)
    flash_case("prefill S=500 needle on the diagonal and the ragged last key",
               500, 0, seed=20, needle=0, timed=False)
    # zamba2-7b's shared attention block: MHA, head dim 112
    decode_case(f"decode zamba2 d=112 S={max_len} length={max_len}",
                max_len, max_len, 0, seed=10, H=32, KV=32, d=112)
    flash_case(f"prefill zamba2 d=112 S={PROMPT} causal", PROMPT, 0,
               seed=11, H=32, KV=32, d=112)
    ssd_main = ssd_case(f"ssd zamba2 T={PROMPT}", 1, PROMPT, 112, 64, 64,
                        seed=12, dtypes=(torch.float32, torch.bfloat16))
    ssd_case(f"ssd mamba2 T={PROMPT}", 1, PROMPT, 80, 128, 64, seed=13)
    ssd_case("ssd zamba2 T=300 (ragged)", 1, 300, 112, 64, 64, seed=14)
    ssd_case(f"ssd zamba2 B=2 T={PROMPT}", 2, PROMPT, 112, 64, 64, seed=15)
    ssd_case("ssd zamba2 T=100 (one short chunk)", 1, 100, 112, 64, 64,
             seed=16)
    ssd_case("ssd zamba2 T=4096", 1, 4096, 112, 64, 64, seed=23)
    # a slow head's decay: the state carries across chunks, so a scan that
    # loses it between chunks cannot pass
    ssd_case(f"ssd zamba2 T={PROMPT} slow decay (a = -0.02)", 1, PROMPT, 112,
             64, 64, seed=24, a=-0.02, timed=False)

    check(args.n % t == 0, f"n={args.n} is not a multiple of tile={t}")
    a = random_spd(args.n, seed=0, device="cuda")
    warm = random_spd(4 * t, seed=1, device="cuda")
    runs, dynamic_l = main_path_phase(a, warm, t, smi)
    profile_phase(a, warm, t, smi)
    compiled_launches = compiled_phase(a, t, dynamic_l, smi)
    del dynamic_l
    trace_phase(a, t, smi)

    from repro_torch.linalg import random_diagdom

    lu_a = random_diagdom(args.n, seed=0, device="cuda")
    lu_warm = random_diagdom(4 * t, seed=1, device="cuda")
    lu_runs, lu_factors = panel_path_phase("lu", lu_a, lu_warm, t, smi)
    panel_profile_phase("lu", lu_a, lu_warm, t, smi)
    qr_a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.n, args.n))).to("cuda")
    qr_warm = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4 * t, 4 * t))).to("cuda")
    qr_runs, _ = panel_path_phase("qr", qr_a, qr_warm, t, smi)
    panel_profile_phase("qr", qr_a, qr_warm, t, smi)
    del qr_a, qr_warm
    lu_rec = replay_phase(lu_a, lu_warm, a, t, lu_factors, smi)
    compiled_lu_launches = compiled_panel_phase("lu", lu_a, t, lu_rec,
                                                lu_factors, smi)
    del a, warm, lu_a, lu_warm, lu_factors
    # QR compiled at half the order: its record run and its compiled run
    # are each set by the host panels (~30 s at n = 7680)
    half = args.n // 2 // t * t
    qr_half = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (half, half))).to("cuda")
    compiled_qr_launches = compiled_panel_phase("qr", qr_half, t, None, None,
                                                smi)
    del qr_half
    gc.collect()
    torch.cuda.empty_cache()

    batch_rows = {}
    for arch, poisson in SERVE_ARCHS:
        cfg, model, floor_bytes = serving_model(arch)
        batch_rows[arch], state = serving_batch_phase(cfg, model,
                                                      floor_bytes, smi)
        if poisson:
            # the compiled serves run for the models with a Poisson phase:
            # qwen3-14b (dense) and zamba2-7b (hybrid)
            batch_rows[arch]["compiled_decode_attention_launches"] = \
                serving_compiled_phase(cfg, model, batch_rows[arch],
                                       state.tokens(), smi)
            serving_poisson_phase(cfg, model, args.requests, smi)
        serving_profile_phase(cfg, model, state, floor_bytes, smi)
        del model, state                  # free the card for the next model
        gc.collect()
        torch.cuda.empty_cache()

    def line(name, case, launches):
        return {"name": name, "route": "cuda",
                "source": f"{CSRC}/{name}.cu", "replaces": REPLACES[name],
                "launches": launches, "max_abs_err": case["max_abs_err"],
                "ms": case["ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
                "library_ms": case["library_ms"]}

    # the tile GEMM carries three factorization paths; each was driven with
    # the counts reset just before it and read just after (hybrid runs)
    by_path = {"cholesky": runs["hybrid"]["tile_matmul_launches"],
               "lu": lu_runs["hybrid"]["tile_matmul_launches"],
               "qr": qr_runs["hybrid"]["tile_matmul_launches"],
               "cholesky_compiled": compiled_launches,
               "lu_compiled": compiled_lu_launches,
               f"qr_compiled_n{half}": compiled_qr_launches}
    gemm = line("tile_matmul", main_case, sum(by_path.values()))
    gemm["launches_by_path"] = by_path
    qwen = batch_rows["qwen3-14b"]
    decode = line("decode_attention", decode_main,
                  qwen["decode_attention_launches"]
                  + qwen["compiled_decode_attention_launches"])
    decode["launches_by_path"] = {
        "serving": qwen["decode_attention_launches"],
        "serving_compiled": qwen["compiled_decode_attention_launches"]}
    emit({"phase": "elapsed", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [
        gemm,
        line("flash_attention", flash_main,
             batch_rows["qwen3-14b"]["flash_attention_launches"]),
        decode,
        line("ssd_scan", ssd_main,
             batch_rows["zamba2-7b"]["ssd_scan_launches"])]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
