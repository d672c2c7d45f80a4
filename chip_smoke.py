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
   at shallow K, and QR's tall ``V^T A`` and ``A - V Y``; the attention
   kernels in float32 and in bfloat16, on the same inputs, at qwen3-14b's
   and at zamba2-7b's head dims and at the MoE, VLM and enc-dec models'
   shapes: llama-3.2-vision's cross prefill (512 queries over 1,600
   patches) and cross decode, seamless-m4t's non-causal encoder (1,000
   frames), cross prefill (16 over 1,000) and cross decode, qwen3-moe's
   64/4 heads, the two decoders' causal prefill and seamless-m4t's
   self-attention decode at head dim 64; decode also with fewer keys than splits, prefill also with
   needle inputs whose weight sits on one masked-edge key (the last of Sk
   too), and with every real key scored far below zero beside needles
   stored past Sk, which must stay out; the SSD scan at zamba2-7b's and
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
7. the serving paths, each model at full width in bfloat16, random
   weights made on the card from seed 0, and freed before the next:
   qwen3-14b (dense) at full depth, zamba2-7b (hybrid: Mamba2 layers and
   a shared attention block) cut to 24 of its 81 layers and mamba2-2.7b
   (ssm) cut to 32 of its 64 (``SERVE_ARCHS``).  For each, batch: four
   512-token prompts (numpy seed 1) prefilled by ``make_decode_state``
   and decoded 32 tokens each by ``build_decode_graph`` steps on
   ``Session(2)``, then again by the plain loop, one prompt at a time,
   and the first prompt once more alone, prefill to last token; the token
   streams must be bit-identical, every logit finite and
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
10. worker processes (``repro_torch.mp``), each process with its own CUDA
    context on the card.  Before the serving paths, a Cholesky sweep:
    ``Session(4, scheduler="replay", cache=GraphCache(dir),
    procs=2).map(cholesky_digest_graph, ...)`` over ``MP_SEEDS`` seeds at the
    Cholesky path's size; the builder (module-level here, so the children
    import it from this file) draws ``random_spd(n, seed)`` on the card
    and adds one sink task returning a digest of the factor (residual,
    distance from ``torch.linalg.cholesky``, sha256 of its bytes).  Input
    0 must record in-process and inputs 1-4 replay in both children with
    no re-record, every digest equal to an in-process dynamic run of its
    seed, and each child's GEMM launches, read from the child, 10,660 per
    run; the sweep's wall beside the same sweep through in-process
    ``map``; then ``Session.submit`` of three seeds' graphs, each built
    while the previous one runs.  After zamba2-7b's single-process
    phases, while its model is loaded: the Poisson stream again through
    ``ContinuousBatchingEngine(procs=2, fns_ref=make_serving_fns)`` on
    ``Session(2, scheduler="pool")``, each child building its own model;
    every request's tokens must equal the single-process phase's, no child
    may die or hand requests to the in-process rescue, both must serve,
    and each child's kernel launches, read from the child, must match its
    requests and lane-steps;
11. the MoE, VLM and enc-dec models: first qwen3-moe-235b-a22b's MoE
    layer at full width in float32 (512 tokens, tokens dropped at C = 40;
    4 tokens, the per-pair schedule) against the per-expert loop it
    replaces; then, each freed before the next, qwen3-moe-235b-a22b at
    full width cut to 12 of its 94 layers, llama-3.2-vision-11b (every
    ``xgate`` set to 1.0 after the draw) and seamless-m4t-medium at full
    width and depth: the batch path of 7 (with each request's 1,600
    patches, or 1,000 frames of encoder input and a 16-token prompt),
    and prompt 0 with another memory, whose logits must move; qwen3-moe also a 6-request Poisson stream as in 8;
    each a profiled step as in 9;
12. training: ``FlashAttentionFn`` (the kernel's forward; the backward
    kernel in bfloat16, the torch-op backward in float32) against
    autograd through the plain version in float32, at
    qwen3-14b's training shape (B = 2, 40 / 8 heads, S = 1,024, causal),
    a windowed case and llama-3.2-vision's cross shape (512 over 1,600),
    in both types: the forward bit-identical to the no-grad launch, the
    same bits twice, dq, dk and dv within limits derived from the
    kernel's rounding (``TRAIN_GRAD_F32``), one backward launch a bfloat16
    call and none a float32 one, the forward + backward pair timed beside
    the kernel forward with the torch-op backward and SDPA's pair; then
    ``make_train_step`` on qwen3-14b at
    full width cut to 4 of its 40 layers, bf16, seq 1,024, batch 4 in 2
    microbatches, ``overlap="hybrid"``, 8 steps through the prefetching
    data stream (every loss finite, the 8 trained batches' mean loss
    lower after than before, step 8's below step 1's, a held-out batch's
    loss lower after than before, flash launches exactly 16 a step, one
    ``serial`` step from the same start against hybrid's
    first; step ms, tokens/s, ``train_mfu``, peak memory, AdamW ms, one
    profiled step); the SSM and hybrid families: ``SSDScanFn`` (the
    kernel's forward, the torch-op backward) at mamba2-2.7b's and
    zamba2-7b's training shapes (B = 2, T = 1,024, chunk 128, a chunk's
    decay past float32 exp's overflow), y and the final state against the
    plain version, dxdt, dcs, dBm and dCm against autograd through the
    float64 plain version (``SSD_GRAD_F32``), the pair timed; the port of
    the reference's decode-matches-forward check at full width in float32
    (mamba2-2.7b at 4 layers, zamba2-7b at 6: a 511-token prefill and one
    decode step against ``forward``'s position 511); the same two cuts'
    training loss and every gradient on the card against the host's plain
    versions from the same weights (``SSM_GRAD_CPU_RTOL``);
    ``make_train_step`` as for qwen3-14b on mamba2-2.7b at full width cut
    to 16 of its 64 layers and on zamba2-7b at full width cut to 12 of its
    81 layers (scan
    launches layers x 2 microbatches x 2 a step, zamba2's flash 2 uses x 2
    x 2; the step-8 and held-out losses printed, not gated:
    HELD_OUT_GATED); every train step also prints each kind of leaf's
    gradient norm before the first step and after the last, the held-out
    batch's loss after every step and 8 held-out batches' mean loss; the
    zamba2 cell again from another draw of its weights
    (``train_ssm_seed_witness``); then the ``Trainer`` at the reference
    example's 100m
    configuration, float32: 40 steps, checkpoints every 20, preempted at
    25 and restored at 25 by a new trainer whose batches equal an
    uninterrupted stream's; the loss falls; checkpoint bytes and save
    seconds;
13. the sharded paths (``sharding/``, ``launch/``): in the kernel phase
    ``decode_lse`` (the decode kernel's log-sum-exp: the same output bits,
    its lse against the plain version's, a cache cut into 2 and 4 slices
    and merged against the uncut call, both timed); after qwen3-14b's
    serving phases ``sharded_serve`` (that model through ``make_ctx`` on
    an NCCL mesh of one rank, (1, 1), and under ``seq_shard_cache``: the
    tokens and logits of ``ctx=None``, launches exact); after the train
    step ``sharded_train_step`` (its cell through ``make_ctx``, FSDP on,
    and ``grad_pspecs``: step 1 against ``ctx=None``'s, the same bits
    twice, serial equal to hybrid, 16 flash launches a step, step ms and
    the collectives a step) and ``sharded_two_ranks`` (two gloo processes
    on the card: qwen3-14b and qwen3-moe-235b-a22b at full width cut to 2
    layers, float32, on meshes (1, 2) and (2, 1), the loss and every
    gradient against the single-rank run's, greedy tokens on (1, 2)); at
    the end ``dryrun`` (a CPU subprocess started after the build: the
    dry run of qwen3-14b's ``train_4k`` and ``decode_32k`` cells over a
    fake group of 256 ranks with their H100 roofline terms, and the train
    step's cell at mesh (1, 1), whose argument bytes must equal what
    ``sharded_train_step`` held on the card);
14. the script's seconds so far, a ``kernels`` summary line, then the
    device line last.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
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
KERNELS = ("tile_matmul", "flash_attention", "decode_attention", "ssd_scan",
           "adamw")
CSRC = "src/repro_torch/kernels/csrc"
#: the Pallas entry each kernel replaces (file:line of its function)
REPLACES = {"tile_matmul": "src/repro/kernels/tile_matmul.py:35",
            "flash_attention": "src/repro/kernels/flash_attention.py:76",
            "decode_attention": "src/repro/kernels/decode_attention.py:59",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:78",
            "adamw": "none: the reference's update is jnp ops "
                     "(src/repro/optim/adamw.py)",
            "flash_attention_bwd": "none: the reference differentiates "
                                   "_chunked_attn with jax.grad "
                                   "(src/repro/models/layers.py)"}
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
#: the serving paths: (arch, whether it also serves the Poisson stream,
#: layers (0: the published depth)).  qwen3-14b at full depth (the sharded
#: serve runs on it); zamba2-7b cut from 81 to 24 layers (the shared block
#: used 4 times of 13) and mamba2-2.7b from 64 to 32, to keep the script
#: inside its time limit beside the sharded phases: at full depth the run
#: took 1,260.9 s on a slower host (PERF.md, PR 22)
SERVE_ARCHS = (("qwen3-14b", True, 0), ("zamba2-7b", True, 24),
               ("mamba2-2.7b", False, 32))
#: the worker-process Cholesky sweep's seeds (five before PR 22)
MP_SEEDS = 3
SERVE_WORKERS = 2                       # serve_lm's --workers default
#: the model served again across two worker processes: zamba2-7b's three
#: copies (the parent's, kept for the engine's rescue, and one per child)
#: take 3 x 13.5 GB; qwen3-14b's would take 3 x 29.5 GB
MP_SERVE_ARCH = "zamba2-7b"
SERVE_DEVICE = "cuda"
BATCH, PROMPT, TOKENS = 4, 512, 32
POISSON = dict(rate=100.0, prompt_len=(256, 1024), max_new_tokens=(2, 8))
#: the MoE, VLM and enc-dec models, served after the others, each freed
#: before the next: (arch, layers (0: the published depth), decoder prompt
#: tokens, Poisson requests (0: none; the reference serves only
#: decoder-only families under Poisson)).  qwen3-moe-235b-a22b is cut from
#: 94 layers to 12: each layer holds 4.98 GB (the 128 experts 4.83 GB),
#: and 12 layers with the untied embedding and unembedding (2.49 GB) take
#: ~62 GB, which leaves room for the caches and a prefill on an 80 GB
#: card, where 14 (72 GB) would not.  llama-3.2-vision-11b is cut from 40
#: layers to 20 (4 of its 8 cross-attention layers) for time (PERF.md, PR
#: 22).  seamless-m4t-medium's decoder prompt is 16 tokens beside 1,000
#: encoder frames
NEW_SERVE = (("qwen3-moe-235b-a22b", 12, PROMPT, 6),
             ("llama-3.2-vision-11b", 20, PROMPT, 0),
             ("seamless-m4t-medium", 0, 16, 0))
#: free device memory qwen3-moe's 12 layers need (~62 GB of weights, the
#: float32 draw of one expert stack, caches and a prefill's activations)
MOE_FREE_BYTES = 66e9
#: every vlm ``xgate`` after the seeded draw, which leaves it at 0:
#: tanh(1.0) = 0.76 of each cross layer's output reaches the residual
XGATE = 1.0
#: the encoder input's frames per request on the card, passed to
#: ``serve_lm.memory_inputs``: a ragged length, not a multiple of the
#: 64-key tile, so the masking of the last key tile runs on the served path
#: (serve_lm's own default is the reference's 32)
CARD_ENC_FRAMES = 1000
#: when the script began: every phase's row carries its seconds since then
#: (``t_s``), so a phase's time is the difference of two rows
T_START = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# ---------------------------------------------------------------------------
# worker-process helpers: module-level, so a spawned child resolves them
# as ``__main__:<name>`` (spawn imports this file as the child's main
# module; ``main()`` runs only under the ``__main__`` check)
def factor_digest(a, store) -> dict:
    """A compact, picklable digest of the factor in ``store`` (never the
    tiles): its residual, its largest distance from
    ``torch.linalg.cholesky(a)`` (and that over L's largest entry, the
    main path's measure) and the sha256 of its bytes."""
    import hashlib

    from repro_torch.linalg import cholesky_extract

    L = cholesky_extract(store)
    norm_a = torch.linalg.matrix_norm(a)
    resid = (torch.linalg.matrix_norm(a - L @ L.mT) / norm_a).item()
    l_ref = torch.linalg.cholesky(a)
    diff = (L - l_ref).abs().max().item()
    host = L.cpu().numpy()
    return {"sha256": hashlib.sha256(host.tobytes()).hexdigest(),
            "residual": resid, "max_abs_diff_vs_torch_cholesky": diff,
            "max_rel_diff_vs_torch_cholesky": diff / l_ref.abs().max().item(),
            "finite": bool(np.isfinite(host).all()),
            "shape": list(host.shape)}


def cholesky_digest_graph(value):
    """``map`` builder: ``(seed, n, tile, device)`` -> the tiled Cholesky
    graph of ``random_spd(n, seed)`` drawn on ``device`` in the process
    that builds it, plus one sink task whose result is
    :func:`factor_digest`.  Every seed gives the same graph shape, so one
    recording serves the sweep."""
    from repro_torch.linalg import build_cholesky_graph, random_spd, to_tiles

    seed, n, tile, device = value
    a = random_spd(n, seed, device=device)
    store = to_tiles(a, tile, device=device)
    g = build_cholesky_graph(n // tile, tile, store=store)
    g.add(lambda ctx: factor_digest(a, store), name="digest", kind="compute",
          deps=[t for t in g if not g.successors(t)])
    return g


def digest_of(results) -> dict:
    """The digest among a run's results (every other task returns None)."""
    (digest,) = [v for v in results.values() if v is not None]
    return digest


def child_launch_counts(ctx, reset: bool = False) -> dict:
    """Ships to a worker process: its kernels' launch counts (counters are
    per process), then zeroes them when ``reset``; and the modules of JAX
    or the reference package it imported (there must be none)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    counts = launch_counts()
    if reset:
        reset_launch_counts()
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    return {"proc": ctx.index, "pid": os.getpid(), "counts": counts,
            "jax_or_reference_modules": foreign}


def read_children(pool, reset: bool = False) -> list:
    """Every child's launch counts, in proc order; fails if a child
    imported JAX or the reference package."""
    futs = [pool.submit(child_launch_counts, reset=reset, proc=p)
            for p in range(pool.n_procs)]
    out = [f.result(timeout=120) for f in futs]
    for c in out:
        check(not c["jax_or_reference_modules"],
              f"child {c['proc']} imported {c['jax_or_reference_modules']}")
    return out


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


def cross_needle_arrays(rng, B, H, KV, Sq, Sk, d, where):
    """Full-attention inputs of Sq queries over Sk keys, every query of a
    KV group the same standard-normal row u.  ``"last"``: key Sk - 1 is 2 u
    and carries nearly all the weight, so a kernel that drops the ragged
    tile's last key is off by about |v|.  ``"past"``: every key scores far
    below zero (k = -u plus noise, a score near -sqrt(d)), so a key past Sk
    that the mask let in, at the zero score of TMA's fill, would outweigh
    them all.  Returns q, k, v with k and v ``Sk + 64`` rows long; the
    case passes their first Sk rows (views), and rows past Sk hold 2 u, so
    a map that ran past Sk would find needles there too."""
    u = rng.standard_normal((B, KV, 1, d))
    q = np.repeat(np.repeat(u, H // KV, axis=1), Sq, axis=2)
    if where == "last":
        k = rng.standard_normal((B, KV, Sk + 64, d))
        k[:, :, Sk - 1] = 2.0 * u[:, :, 0]
    else:
        k = -u + 0.1 * rng.standard_normal((B, KV, Sk + 64, d))
    k[:, :, Sk:] = 2.0 * u
    v = rng.standard_normal((B, KV, Sk + 64, d))
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
               needle=None, timed=True, Sk=None, causal=True,
               time_float32=False):
    """One prefill-attention shape, ``S`` queries over ``Sk`` keys (default
    ``S``; unequal lengths only with ``causal=False``, the encoder's and
    cross-attention's full attention): compare (bfloat16 at the derived
    limit), then, if ``timed``, time kernel / plain /
    ``scaled_dot_product_attention`` in bfloat16 and, with
    ``time_float32``, in float32 too.  ``needle=offset`` draws
    :func:`needle_arrays` (causal, ``Sk == S``); ``"last"`` or ``"past"``
    draws :func:`cross_needle_arrays`."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref

    Sk = S if Sk is None else Sk
    rng = np.random.default_rng(seed)
    if needle is None:
        arrays = [rng.standard_normal(s) for s in
                  ((B, H, S, d), (B, KV, Sk, d), (B, KV, Sk, d))]
    elif needle in ("last", "past"):
        arrays = cross_needle_arrays(rng, B, H, KV, S, Sk, d, needle)
    else:
        arrays = needle_arrays(rng, B, H, KV, S, d, needle)

    def cut(q, k, v):                   # needles past Sk stay out of view
        return q, k[:, :, :Sk], v[:, :, :Sk]

    (q, k, v), _, errors = _compare(
        name, lambda *x: flash_attention(*cut(*x), causal=causal,
                                         window=window),
        lambda *x: flash_attention_ref(*cut(*x), causal=causal,
                                       window=window), arrays,
        slack=lambda *x: flash_slack(causal, window)(*cut(*x)))
    q, k, v = cut(q, k, v)
    shape = {"phase": "kernel", "case": name, "kernel": "flash_attention",
             "B": B, "H": H, "KV": KV, "Sq": S, "Sk": Sk, "d": d,
             "causal": causal, "window": window}
    if not timed:
        row = {**shape, "needle": needle, "errors": errors}
        emit(row)
        return row
    qpos = torch.arange(S, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones(S, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    pairs = int(mask.sum().item())      # the (query, key) pairs computed

    def times(q, k, v):
        """kernel, plain, library and bound for these inputs' type."""
        if window > 0:
            lib = lambda: F.scaled_dot_product_attention(         # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(         # noqa: E731
                q, k, v, is_causal=causal, enable_gqa=True)
        item = q.element_size()
        # q, k, v read and out written once; QK and PV, 2 flops a term each
        bound_ms, bound_by = _bound(
            item * B * d * (2 * H * S + 2 * KV * Sk),
            4.0 * B * H * d * pairs, q.dtype)
        return {"ms": device_ms(lambda: flash_attention(
                    q, k, v, causal=causal, window=window), reps=20),
                "plain_ms": device_ms(lambda: flash_attention_ref(
                    q, k, v, causal=causal, window=window), reps=20),
                "library_ms": device_ms(lib, reps=20), "bound_ms": bound_ms,
                "bound_by": bound_by}

    row = {**shape, "dtype": "bfloat16", "p_round": FLASH_P_ROUND,
           "max_abs_err": errors["bfloat16"]["max_abs_err"], "errors": errors,
           **times(q, k, v)}
    if time_float32:
        row["float32"] = times(q.float(), k.float(), v.float())
    emit(row)
    return row


def ssd_inputs(B, T, H, N, P, chunk, seed, a=-1.0, device="cuda"):
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
        return torch.from_numpy(x).to(device)

    xs = F.silu(rand((B, T, H, P)))
    dt = F.softplus(rand((B, T, H), 0.8))
    Bm, Cm = F.silu(rand((B, T, N))), F.silu(rand((B, T, N)))
    rate = torch.full((H,), a, device=device)
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


def serving_model(arch: str, layers: int = 0):
    """``arch`` at full width in bfloat16, drawn on the card, at full depth
    or cut to ``layers``; a vlm's every ``xgate`` set to ``XGATE`` after
    the draw (a fresh model's 0 would switch every cross layer off).
    Returns (cfg, model, the bytes a B = 1 decode lane-step must read and
    write at least)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.lm import layer_flags
    from repro_torch.models.ssm import ssm_state_spec

    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    free_before = torch.cuda.mem_get_info()[0]
    if cfg.family == "moe":
        # the weights alone take ~62 GB at 12 layers: stop with the numbers
        # rather than cut the depth further without saying so
        check(free_before >= MOE_FREE_BYTES,
              f"{cfg.name} at {cfg.n_layers} layers needs "
              f"{MOE_FREE_BYTES / 1e9:.0f} GB free, the card has "
              f"{free_before / 1e9:.1f} GB")
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=SERVE_DEVICE)
    xgate = None
    if cfg.family == "vlm":
        xgate = XGATE
        with torch.no_grad():
            for blk in model.blocks:
                blk.xgate.fill_(XGATE)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    # a decode lane-step reads every weight once, the shared block once per
    # layer that runs it (it does not fit the 50 MB L2), one row of the
    # embedding table unless the table is also the unembedding, of each
    # MoE layer's experts only the top_k routed ones, of a vlm's cross
    # weights only the layers that cross-attend, none of the encoder's, and
    # the memory once
    flags = layer_flags(cfg)
    uses = sum(flags.get("use_attn", []))
    cross = flags.get("use_cross", [])
    read = 0
    for name, p in model.named_parameters():
        size = p.numel() * p.element_size()
        parts = name.split(".")
        if name == "embed.table" and not cfg.tie_embeddings:
            size = cfg.d_model * p.element_size()
        elif parts[0] == "shared":
            size *= uses
        elif parts[0] == "enc_blocks":
            size = 0
        elif parts[0] == "blocks" and parts[2] in ("lnx", "xattn", "xgate") \
                and cross and not cross[int(parts[1])]:
            size = 0
        elif parts[0] == "blocks" and parts[2] == "moe" \
                and parts[3] in ("wg", "wu", "wd"):
            size = size * cfg.top_k // cfg.n_experts
        read += size
    memory_rows = {"vlm": cfg.n_patches, "encdec": CARD_ENC_FRAMES}.get(
        cfg.family, 0)
    read += memory_rows * cfg.d_model * 2
    # and reads and writes every layer's SSM and conv states
    state = 0
    if cfg.family in ("ssm", "hybrid"):
        state = cfg.n_layers * sum(
            math.prod(shape) * torch.tensor([], dtype=dt).element_size()
            for shape, dt in ssm_state_spec(cfg, 1, cfg.torch_dtype).values())
    floor_bytes = read + 2 * state
    emit({"phase": "serving_model", "arch": cfg.name, "family": cfg.family,
          "layers": cfg.n_layers, "published_layers":
              get_config(arch).n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
          "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
          "experts": cfg.n_experts, "top_k": cfg.top_k,
          "d_expert": cfg.d_expert, "enc_layers": cfg.enc_layers,
          "cross_layers": (cfg.n_layers if cfg.family == "encdec"
                           else sum(cross)),
          "memory_rows": memory_rows, "xgate": xgate,
          "ssm_heads": cfg.ssm_heads, "ssm_state": cfg.ssm_state,
          "ssm_chunk": cfg.ssm_chunk if cfg.ssm_state else None,
          "shared_block_uses": uses, "vocab": cfg.vocab_size,
          "dtype": cfg.dtype, "params": n_params,
          "param_bytes": n_params * 2,
          "weight_bytes_read_per_lane_step": read,
          "state_bytes_per_lane": state,
          "floor_ms_per_lane_step": floor_bytes / HBM_BYTES_PER_S * 1e3,
          "free_gb_before_init": free_before / 1e9,
          "init_s": time.perf_counter() - t0,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return cfg, model, floor_bytes


def expected_launches(cfg, prefills: int, lane_steps: int):
    """Each kernel's launches for ``prefills`` prompts and ``lane_steps``
    decode lane-steps: every attention layer (a hybrid: every use of the
    shared block) launches flash attention per prompt and decode attention
    per lane-step, and so does every cross-attending layer (encdec: all,
    vlm: those of ``use_cross``); every encoder layer launches flash
    attention per prompt; every SSM layer launches the SSD scan per
    prompt."""
    from repro_torch.models.lm import layer_flags

    flags = layer_flags(cfg)
    fam = cfg.family
    if fam in ("ssm", "hybrid"):
        attn, ssm = sum(flags.get("use_attn", [])), cfg.n_layers
    else:
        attn, ssm = cfg.n_layers, 0
    cross = {"encdec": cfg.n_layers,
             "vlm": sum(flags.get("use_cross", []))}.get(fam, 0)
    enc = cfg.enc_layers if fam == "encdec" else 0
    return {"tile_matmul": 0,
            "flash_attention": (attn + cross + enc) * prefills,
            "decode_attention": (attn + cross) * lane_steps,
            "ssd_scan": ssm * prefills, "adamw": 0, "flash_attention_bwd": 0}


def memory_batch(cfg, n: int, seed: int = 2) -> dict:
    """A cross-attending family's memory input for ``n`` requests on the
    card (``serve_lm.memory_inputs``: numpy ``seed``), at ``CARD_ENC_FRAMES``
    encoder frames; empty for the others."""
    from repro_torch.serving.serve_lm import memory_inputs

    return memory_inputs(cfg, n, SERVE_DEVICE, frames=CARD_ENC_FRAMES,
                         seed=seed)


def serving_batch_phase(cfg, model, floor_bytes, smi, prompt_len=PROMPT):
    """The fixed batch through the decode-step graphs, then through the
    plain loop, then the first request once more by itself, prefill to
    last token; the three must give the same tokens.  Returns (the graph
    run's row, its decode state).  A cross-attending family's batch
    carries its memory (:func:`memory_batch`), and then the same first
    prompt with another memory (numpy seed 3) must give other prefill
    logits."""
    from repro_torch import Session
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import (build_decode_graph, decode_step,
                                    greedy_sample, make_decode_state,
                                    prefill)

    max_len = prompt_len + TOKENS + 1
    steps = TOKENS - 1
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, prompt_len), dtype=np.int32),
        device=SERVE_DEVICE)
    memory = memory_batch(cfg, BATCH)
    batch = {"tokens": prompts, **memory}

    def dec(p, c, t):
        return decode_step(p, cfg, c, t)

    def lane(b, n=None):
        """request b's inputs, its prompt cut to n tokens"""
        return {k: (v[b:b + 1, :n] if k == "tokens" else v[b:b + 1])
                for k, v in batch.items()}

    with Session(SERVE_WORKERS) as session:
        # warm-up outside the counted run: cuBLAS handles on every thread
        warm = make_decode_state(
            model, cfg, {k: (v[:, :16] if k == "tokens" else v)
                         for k, v in batch.items()},
            n_shards=BATCH, max_len=20, device=SERVE_DEVICE)
        session.run(build_decode_graph(warm, dec))
        del warm
        torch.cuda.synchronize()

        reset_launch_counts()
        t0 = time.perf_counter()
        state = make_decode_state(model, cfg, batch,
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
        cache, logits = prefill(model, cfg, lane(b), max_len=max_len)
        finite &= torch.isfinite(logits).all()
        lanes.append([cache, [greedy_sample(logits)], logits])
    torch.cuda.synchronize()
    loop_prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        for ln in lanes:
            ln[0], logits = decode_step(model, cfg, ln[0], ln[1][-1])
            finite &= torch.isfinite(logits).all()
            ln[1].append(greedy_sample(logits))
    loop_enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    loop_decode_s = time.perf_counter() - t0
    loop_launches = launch_counts()
    loop_tokens = torch.cat([torch.cat(toks, dim=1) for _, toks, _ in lanes])
    first_logits = lanes[0][2]
    del lanes

    checks = {}
    if memory:
        # the cross path moves the logits: prompt 0 with another memory
        other = {"tokens": prompts[:1], **{
            k: v[:1] for k, v in memory_batch(cfg, 1, seed=3).items()}}
        _, moved = prefill(model, cfg, other, max_len=max_len)
        checks["memory_moves_logits_max_abs"] = (
            moved.float() - first_logits.float()).abs().max().item()
    t0 = time.perf_counter()
    cache, logits = prefill(model, cfg, lane(0), max_len=max_len)
    toks = [greedy_sample(logits)]
    for _ in range(steps):
        cache, logits = decode_step(model, cfg, cache, toks[-1])
        toks.append(greedy_sample(logits))
    checks["request_0_alone_identical"] = bool(torch.equal(
        torch.cat(toks, dim=1), graph_tokens[:1]))
    checks["request_0_alone_s"] = time.perf_counter() - t0
    del cache

    lane_steps = BATCH * steps
    row = {"phase": "serving_batch", "arch": cfg.name, "layers": cfg.n_layers,
           "dtype": cfg.dtype, "batch": BATCH, "prompt": prompt_len,
           "memory": {k: list(v.shape) for k, v in memory.items()},
           "tokens": TOKENS, "max_len": max_len, "n_shards": BATCH,
           "workers": SERVE_WORKERS,
           "prefill_enqueue_s": prefill_enqueue_s,
           "prefill_wall_s": prefill_wall_s,
           "prefill_tok_s": BATCH * prompt_len / prefill_wall_s,
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
           "sample_tokens": graph_tokens[0, :8].tolist(), **checks,
           "card": smi}
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
    if memory:
        check(checks["memory_moves_logits_max_abs"] > 0,
              f"{cfg.name}: another memory left prompt 0's logits unchanged")
    check(checks["request_0_alone_identical"],
          f"{cfg.name}: request 0 served alone gave other tokens")
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
    return row, batched.tokens_by_rid()


def serving_profile_phase(cfg, model, state, floor_bytes, smi,
                          prompt_len=PROMPT) -> None:
    """One more 4-lane decode step of the batch path under
    ``torch.profiler``: device time by kernel, kernels per lane-step, the
    device's busy share and the distance from the floor; then one
    ``prompt_len``-token prefill of one prompt (with its memory, for a
    cross-attending family): device time per prompt by kernel."""
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
        0, cfg.vocab_size, (1, prompt_len), dtype=np.int32),
        device=SERVE_DEVICE)
    one = {"tokens": prompt, **memory_batch(cfg, 1)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(model, cfg, one, max_len=prompt_len + 1)
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
          "prefill_tokens": prompt_len, "prefill_wall_s": prefill_wall_s,
          "prefill_device_ms": prefill_device_s * 1e3,
          "prefill_device_busy_share": prefill_device_s / prefill_wall_s,
          "prefill_top": [{"name": k[:80], "count": c, "device_ms": us / 1e3}
                          for us, k, c in prefill_rows[:8]], "card": smi})


def moe_check_phase(smi) -> dict:
    """qwen3-moe-235b-a22b's MoE layer at full width (d_model 4,096, 128
    experts of 1,536, top-8) in float32 on the card, its weights drawn from
    a seeded generator at 1/sqrt(fan-in): 512 tokens (C = 40, tokens
    dropped) through the capacity schedule and 4 tokens (a decode step's
    32 routed pairs) through the per-pair one, each against
    ``moe_loop_ref``, the reference's loop over every expert, at the model
    tests' rtol = atol = 1e-4 (the same float32 products summed in other
    orders), and twice for the same bits."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    mod = L.MoE(cfg, dtype=torch.float32, device=torch.device("cuda"))
    with torch.no_grad():
        for name in ("router", "wg", "wu", "wd"):
            w = getattr(mod, name)
            w.normal_(generator=gen).mul_(w.shape[-2] ** -0.5)
        row = {"phase": "moe_check", "arch": cfg.name, "dtype": "float32",
               "d_model": cfg.d_model, "experts": cfg.n_experts,
               "top_k": cfg.top_k, "d_expert": cfg.d_expert, "card": smi}
        for T in (PROMPT, 4):
            x = torch.randn((T, cfg.d_model), generator=gen, device="cuda")
            wts, ids = L.moe_route(x, mod.router, cfg.top_k)
            C = L.moe_capacity(T, cfg)
            counts = torch.bincount(ids.flatten(), minlength=cfg.n_experts)
            want = L.moe_loop_ref(x, wts, ids, mod.wg, mod.wu, mod.wd, C)
            got = mod.combine(x, wts, ids, C)
            again = mod.combine(x, wts, ids, C)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            share = (diff / (1e-4 + 1e-4 * want.abs())).max().item()
            case = {"tokens": T, "capacity": C,
                    "schedule": ("per_pair" if T * cfg.top_k < cfg.n_experts
                                 else "capacity"),
                    "experts_used": int((counts > 0).sum().item()),
                    "max_routed": int(counts.max().item()),
                    "dropped_pairs": int((counts - C).clamp_min(0).sum()
                                         .item()),
                    "max_abs_err": diff.max().item(), "tol_share": share,
                    "ms": device_ms(lambda: mod.combine(x, wts, ids, C),
                                    reps=5),
                    "loop_ms": device_ms(lambda: L.moe_loop_ref(
                        x, wts, ids, mod.wg, mod.wu, mod.wd, C), reps=3)}
            row[f"T{T}"] = case
            check(share <= 1.0, f"MoE T={T}: batched vs the per-expert loop, "
                  f"max abs err {case['max_abs_err']}")
            check(torch.equal(got, again), f"MoE T={T}: two runs differ")
    emit(row)
    check(row[f"T{PROMPT}"]["dropped_pairs"] > 0,
          f"MoE T={PROMPT}: no expert was routed more than C tokens")
    return row


# ---------------------------------------------------------------------------
# training: flash attention's gradient, the train step, the trainer
#
# the flash Function's gradients against autograd through the plain
# version in float32 (its inputs upcast).  The float32 backward is float32
# torch ops; the bfloat16 one is the backward kernel, whose products take
# P and dS as two bfloat16 parts each (their sum within ~2**-16 of the
# float32 value, far inside the limit below) and sum in float32.  So dv
# differs from the reference's only in the order of float32 sums
# (TRAIN_GRAD_F32, normwise: a sum of ~2,000 terms rounds by at most about
# 2,000 * 2**-24 = 1.2e-4 of its largest term, in practice far less; 1e-4
# of the tensor's largest entry) and, for bfloat16
# inputs, the one rounding of the result (2**-8 |x|).  dq and dk also read
# the forward's output O through D = rowsum(dO * O): the kernel's O differs
# from the float32 reference's by at most its own limit L_O (ATTN_TOL plus
# FLASH_P_ROUND times the attention of |v|), so D_i by at most
# B_i = sum_d |dO_id| L_O,id, dS_ij = P_ij (dP_ij - D_i) by P_ij B_i, and
# dQ_i = s sum_j dS_ij K_j by s B_i (P |K|)_i, dK_j = s sum_i dS_ij Q_i by
# s (P^T (B |Q|))_j (s = 1/sqrt(d)): the limits add these to dv's.
TRAIN_GRAD_F32 = 1e-4
BF16_ROUND = 2.0 ** -8
#: the train step: qwen3-14b at full width cut from 40 to 4 layers.  At 18
#: bytes a parameter (bf16 p, grad and carried bucket; f32 accumulator, m
#: and v) its 2.878 B parameters take 51.8 GB; 8 layers would take 75.6 GB
TRAIN_ARCH, TRAIN_LAYERS = "qwen3-14b", 4
#: the SSM and hybrid train steps (``train_step_ssm``), each at full width
#: with ``train_step_phase``'s data, schedule and checks: mamba2-2.7b cut
#: from 64 to 16 layers (its full depth, 2.703 B parameters at 18 bytes
#: each, took 48.6 GB and ~82 s of the script; cut to make room for the
#: sharded phases) and zamba2-7b cut from 81 to 12 layers (the shared
#: block used twice, at layers 5 and 11; 1.371 B parameters, 24.7 GB; all
#: 81 would take 121.5 GB)
TRAIN_SSM = (("mamba2-2.7b", 16), ("zamba2-7b", 12))
#: which train steps must also show step 8's loss below step 1's and the
#: held-out batch's loss falling.  Every train step must lower the mean
#: loss of the 8 batches it trained on (each evaluated before the first
#: step and after the last: the same batches, so no batch-to-batch noise).
#: A held-out batch shares nothing with them but the stream's law, which 8
#: steps do not learn: what falls there is a fresh model's excess over log
#: V, which qwen3-14b sheds.  The tied mamba2 starts within 0.02 of log V,
#: so it has none to shed.  zamba2 has one, but at this rate its held-out
#: loss swings by up to 0.1 between steps, and where step 8 leaves it
#: depends on the draw of the weights (``train_ssm_seed_witness``).  From
#: one tree, on the CPU, the reference's held-out loss lands on either
#: side as the port's does, and so does the reference's own against
#: itself at another chunk length (``tests/torch_lr_witness.py``; PERF.md).
#: The SSM rows print both losses without gating on them
HELD_OUT_GATED = ("qwen3-14b",)
#: the cell whose 8 steps ``train_ssm_seed_witness`` repeats from other
#: draws of its weights, and those draws' seeds
SSM_SEED_WITNESS, SSM_WITNESS_SEEDS = ("zamba2-7b", 12), (1,)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 1024, 4, 2, 8
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS,
                 clip_norm=1.0)
#: serial against hybrid after one step from the same start: the same
#: buckets in the same order, but the embedding's backward may add its
#: rows in another order on each run, and an Adam step's g / (|g| + eps)
#: turns a gradient's sign near zero into a whole +-lr: at most this share
#: of the parameters may differ, none by more than 2 lr (plus one bf16
#: unit)
STEP_DIFF_SHARE = 1e-3
#: the trainer: the reference example's 100m configuration, 40 steps,
#: checkpoints every 20, preempted at 25.  Its schedule is 5e-4 after 5
#: warmup steps, not the example's 3e-3 after 20 (EXAMPLE_OPT): from the
#: port's start (norm scales of one, each layer at its own fan-in) the
#: 100m loss rises under 3e-3 once the warmup ends, while from a draw of
#: the reference's initialisation (a zero final norm) it stays at log V
#: (trainer_lr_witness_phase); from one tree the two packages' steps agree
#: (tests/torch_lr_witness.py)
TRAINER_STEPS, TRAINER_CKPT_EVERY, TRAINER_PREEMPT = 40, 20, 25
TRAINER_OPT = dict(lr=5e-4, warmup_steps=5, total_steps=TRAINER_STEPS)
#: the reference example's schedule (``examples/train_lm.py``)
EXAMPLE_OPT = dict(lr=3e-3, warmup_steps=20, total_steps=TRAINER_STEPS)
#: the data step of the held-out batch on which each training phase's
#: loss is read before and after it trains: the same batch both times, so
#: the comparison carries no batch-to-batch noise
HELD_OUT_STEP = 1_000_000
#: the train steps also read the mean loss of this many held-out batches
#: (data steps HELD_OUT_STEP on) before and after: 32 rows of the stream
#: where the one batch holds 4
HELD_OUT_BATCHES = 8
TRAIN_DEVICE = "cuda"


def flash_grad_reference(q, k, v, dout, *, causal, window):
    """The float32 reference's output and gradients of flash attention at
    q, k, v (upcast) and, per element, the most that dq and dk may shift
    when the kernel's output is off by up to its own limit (ATTN_TOL, and
    for bfloat16 FLASH_P_ROUND's allowance), through D = rowsum(dO * O)
    (see TRAIN_GRAD_F32).  Returns (out, the kernel output's limit
    against it, (dq, dk, dv), (dq, dk shifts))."""
    from repro_torch.kernels.ref import flash_attention_ref

    kw = dict(causal=causal, window=window)
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    out = flash_attention_ref(qf, kf, vf, **kw)
    grads = torch.autograd.grad(out, (qf, kf, vf), dout.float())
    t = ATTN_TOL[q.dtype]
    with torch.no_grad():
        out_limit = t["atol"] + t["rtol"] * out.abs()
        if q.dtype == torch.bfloat16:
            out_limit = out_limit + flash_slack(causal, window)(q, k, v)
        bound = (dout.float().abs() * out_limit).sum(-1, keepdim=True)
        scale = 1.0 / math.sqrt(q.shape[-1])
        q0, k0 = qf.detach(), kf.detach()
        dq_shift = scale * bound * flash_attention_ref(q0, k0, k0.abs(), **kw)
    vv = vf.detach().clone().requires_grad_()
    (ptq,) = torch.autograd.grad(flash_attention_ref(q0, k0, vv, **kw),
                                 (vv,), bound * q0.abs())
    return out.detach(), out_limit, grads, (dq_shift, scale * ptq)


def flash_grad_share(got, want, shift, dtype):
    """``(diff, share)``: a gradient's distance from the float32 reference
    ``want``, element by element, and the largest share of its limit:
    TRAIN_GRAD_F32 of the largest entry, for bfloat16 also BF16_ROUND of
    each entry, and for dq and dk the ``shift`` from
    :func:`flash_grad_reference` (None for dv)."""
    diff = (got.float() - want).abs()
    limit = TRAIN_GRAD_F32 * want.abs().max()
    if dtype == torch.bfloat16:
        limit = limit + BF16_ROUND * want.abs()
    if shift is not None:
        limit = limit + shift
    return diff, (diff / limit).max().item()


def flash_grad_case(name, B, H, KV, Sq, Sk, d, *, causal, window, seed, smi,
                    timed=False):
    """``FlashAttentionFn`` (the kernel's forward; the backward kernel for
    bfloat16, the torch-op backward for float32) against autograd through
    the plain version, in float32 and bfloat16 on the same numpy inputs:
    the forward bit-identical to the no-grad call and within its limit of
    the float32 plain version's output, the same bits twice, each gradient
    within its derived limit, one backward-kernel launch a bfloat16 call;
    with ``timed``, the forward + backward pair against the kernel forward
    with the torch-op backward, the plain version's pair and SDPA's (the
    library call of the pair), in bfloat16."""
    import torch.nn.functional as F

    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import (backward_takes,
                                                     flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ref import flash_attention_ref

    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s) for s in
              ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d), (B, H, Sq, d))]
    kw = dict(causal=causal, window=window)
    row = {"phase": "train_flash_grad", "case": name, "B": B, "H": H,
           "KV": KV, "Sq": Sq, "Sk": Sk, "d": d, **kw, "card": smi}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[-1]
        q, k, v, dout = (torch.from_numpy(a).to(TRAIN_DEVICE, dtype)
                         for a in arrays)
        with torch.no_grad():
            direct = flash_attention(q, k, v, **kw)
        runs = []
        bwd0 = launch_counts()["flash_attention_bwd"]
        for _ in range(2):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = flash_attention(*leaves, **kw)
            runs.append((out.detach(), *torch.autograd.grad(out, leaves,
                                                            dout)))
        torch.cuda.synchronize()
        bwd = launch_counts()["flash_attention_bwd"] - bwd0
        want_bwd = 2 if backward_takes(dtype, d, "cuda") else 0
        check(bwd == want_bwd, f"{name} {key}: {bwd} backward-kernel "
              f"launches in two calls, expected {want_bwd}")
        check(torch.equal(runs[0][0], direct),
              f"{name} {key}: the Function's forward differs from the "
              f"no-grad call")
        for a, b_, what in zip(runs[0], runs[1], ("out", "dq", "dk", "dv")):
            check(torch.equal(a, b_), f"{name} {key}: two runs' {what} "
                  f"differ")
        want_out, out_limit, grads, shifts = flash_grad_reference(
            q, k, v, dout, causal=causal, window=window)
        # the forward against the float32 reference, at the kernel phase's
        # limit (ATTN_TOL, and FLASH_P_ROUND's allowance for bfloat16)
        diff = (runs[0][0].float() - want_out).abs()
        share = (diff / out_limit).max().item()
        errs = {"out": {"max_abs_err": diff.max().item(),
                        "max_abs": want_out.abs().max().item(),
                        "tol_share": share}}
        check(share <= 1.0, f"{name} {key}: the forward is off the plain "
              f"version by {diff.max().item()}, {share:.3g} of its limit")
        del want_out, out_limit, diff
        for what, got, want, shift in zip(("dq", "dk", "dv"), runs[0][1:],
                                          grads, shifts + (None,)):
            diff, share = flash_grad_share(got, want, shift, dtype)
            errs[what] = {"max_abs_err": diff.max().item(),
                          "max_abs": want.abs().max().item(),
                          "tol_share": share}
            check(share <= 1.0, f"{name} {key}: {what} off by "
                  f"{diff.max().item()}, {share:.3g} of its limit")
            check(bool(torch.isfinite(got.float()).all()),
                  f"{name} {key}: {what} is not finite")
        row[key] = errs
        row.setdefault("backward", {})[key] = ("kernel" if want_bwd
                                               else "torch ops")
        del runs, grads, shifts
    if timed:
        q, k, v, dout = (torch.from_numpy(a).to(TRAIN_DEVICE, torch.bfloat16)
                         for a in arrays)
        leaves = [t.requires_grad_() for t in (q, k, v)]

        def pair(fwd):
            return lambda: torch.autograd.grad(fwd(*leaves), leaves, dout)

        def torch_op_pair():
            with torch.no_grad():
                out = flash_attention(q, k, v, **kw)
            return flash_attention_bwd(q, k, v, out, dout, **kw)

        if window > 0:
            qpos = torch.arange(Sq, device=TRAIN_DEVICE)[:, None]
            kpos = torch.arange(Sk, device=TRAIN_DEVICE)[None, :]
            mask = (qpos >= kpos) & (qpos - kpos < window)
            lib = lambda q_, k_, v_: F.scaled_dot_product_attention(  # noqa
                q_, k_, v_, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda q_, k_, v_: F.scaled_dot_product_attention(  # noqa
                q_, k_, v_, is_causal=causal, enable_gqa=True)
        if causal:
            qi = torch.arange(Sq)[:, None]
            ki = torch.arange(Sk)[None, :]
            keep = qi >= ki
            if window > 0:
                keep &= qi - ki < window
            pairs = int(keep.sum())
        else:
            pairs = Sq * Sk
        # forward: q, k, v read, out written; backward: q, k, v, out, dout
        # read, dq, dk, dv written.  Operations: QK^T and PV forward, dP,
        # dV, dQ and dK backward, two a term each (P kept, not recomputed)
        n_bytes = 2 * B * d * (2 * H * Sq + 2 * KV * Sk
                               + 3 * H * Sq + 2 * KV * Sk
                               + H * Sq + 2 * KV * Sk)
        bound_ms, bound_by = _bound(n_bytes, 12.0 * B * H * d * pairs)
        row.update({
            "dtype": "bfloat16",
            "max_abs_err": max(e["max_abs_err"] for e in
                               row["bfloat16"].values()),
            "ms": device_ms(pair(lambda *x: flash_attention(*x, **kw)),
                            reps=10),
            "torch_op_ms": device_ms(torch_op_pair, reps=3),
            "plain_ms": device_ms(pair(lambda *x: flash_attention_ref(
                *x, **kw)), reps=3),
            "library_ms": device_ms(pair(lib), reps=10),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "forward_ms": device_ms(lambda: flash_attention(
                q.detach(), k.detach(), v.detach(), **kw), reps=10)})
    emit(row)
    return row


def train_flash_grad_phase(smi) -> tuple:
    """qwen3-14b's training shapes in both types, timed: the short train
    cell's microbatch (B = 2, H = 40, KV = 8, S = 1,024, d = 128, causal)
    and the S = 4,096 cell's (B = 1); a windowed case; llama-3.2-vision's
    cross shape (512 queries over 1,600 patches, non-causal); the trainer's
    shape (the 100m configuration's microbatch: B = 4, H = 12, KV = 4, S =
    256, d = 64, causal; it trains in float32).  Returns the two timed
    rows."""
    main = flash_grad_case("qwen3 train S=1024 causal", 2, 40, 8, 1024,
                           1024, 128, causal=True, window=0, seed=50,
                           smi=smi, timed=True)
    long = flash_grad_case("qwen3 train S=4096 causal", 1, 40, 8, 4096,
                           4096, 128, causal=True, window=0, seed=54,
                           smi=smi, timed=True)
    flash_grad_case("S=1024 causal window=256", 1, 40, 8, 1024, 1024, 128,
                    causal=True, window=256, seed=51, smi=smi)
    flash_grad_case("cross llama-vision Sq=512 Sk=1600", 1, 32, 8, 512, 1600,
                    128, causal=False, window=0, seed=52, smi=smi)
    flash_grad_case("trainer 100m S=256 causal (12/4 heads, d=64)", 4, 12, 4,
                    256, 256, 64, causal=True, window=0, seed=53, smi=smi)
    return main, long


#: the SSD scan's gradients (``SSDScanFn``: the kernel's forward, the
#: torch-op backward) against autograd through the float64 plain version
#: on the card (float64: ``exp(cs_i - cs_j)`` above the diagonal stays
#: finite, so the plain version's ``where`` after the exp is safe there).
#: Each gradient entry is a float32 sum of at most N P = 8,192 products
#: (dcs's state term at mamba2's N = 128, P = 64; the intra-chunk terms
#: sum L P = 8,192), whose rounding is at most n 2**-24 = 4.9e-4 of the
#: sum of the terms' magnitudes in the worst case and about sqrt(n)
#: 2**-24 = 5.4e-6 of it for rounding errors of random sign; the limit is
#: 1e-4 of the leaf's largest entry (TRAIN_GRAD_F32's), between the two
SSD_GRAD_F32 = 1e-4
#: the SSD scan's training shapes: B = 2 rows of a microbatch (global
#: batch 4 in 2), T = 1,024, chunk 128; (name, H, N, P) of mamba2-2.7b
#: and zamba2-7b
SSD_TRAIN = (("mamba2-2.7b", 80, 128, 64), ("zamba2-7b", 112, 64, 64))
#: the SSM decode-matches-forward check (the port of the reference's
#: ``tests/test_arch_smoke.py::test_decode_matches_forward``), float32 at
#: full width: (arch, layers), zamba2-7b's 6 layers holding one use of the
#: shared block (layer 5).  The chunked scan (the kernel) and the
#: recurrent decode step sum the same float32 terms in other orders over
#: 511 positions, through 4-6 layers of products 2,560-7,168 wide; the
#: reference holds its reduced models to 2e-2, and DECODE_FWD_TOL is 20
#: times tighter
SSM_DECODE = (("mamba2-2.7b", 4), ("zamba2-7b", 6))
#: ``train_ssm_grad_vs_cpu``: the tokens a row (two of the published
#: 128-step chunks, so the carried state takes part), and each gradient
#: leaf's limit on the card against the host, relative to its largest
#: entry (float32 sums of up to 7,168 products taken in other orders by
#: cuBLAS and the host's BLAS, the kernels against their plain versions)
SSM_GRAD_SEQ, SSM_GRAD_CPU_RTOL = 256, 1e-3
DECODE_FWD_TOL = dict(rtol=1e-3, atol=1e-3)


def ssd_grad_case(name, B, T, H, N, P, *, seed, smi, timed=True):
    """``SSDScanFn`` at one training shape, with inputs made as an SSM
    layer makes them (``ssd_inputs``: a = -1, a chunk's decay past 88): y
    and the final state against the float32 plain version at SSD_TOL;
    dxdt, dcs, dBm and dCm, with gradients of y and of the final state,
    against autograd through the float64 plain version at SSD_GRAD_F32;
    every gradient finite; the forward bit-identical to the no-grad call
    and the same bits twice.  With ``timed``, the forward + backward pair
    as training runs it (the final state's gradient None) against the
    same pair through the float32 plain version; no single PyTorch call
    computes the scan, so there is no library time."""
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan

    inputs = ssd_inputs(B, T, H, N, P, 128, seed, device=TRAIN_DEVICE)
    _, nc, L, _, _ = inputs[0].shape
    chunk_decay = -inputs[1][:, :, -1].min().item()
    check(chunk_decay > 88, f"{name}: a chunk decays by only {chunk_decay}, "
          f"not past float32 exp's overflow")
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.standard_normal(tuple(inputs[0].shape))
                          .astype(np.float32)).to(TRAIN_DEVICE)
    dfinal = torch.from_numpy(rng.standard_normal((B, H, N, P))
                              .astype(np.float32)).to(TRAIN_DEVICE)
    with torch.no_grad():
        direct = ssd_scan(*inputs)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in inputs]
        y, st = ssd_scan(*leaves)
        runs.append((y.detach(), st.detach(), *torch.autograd.grad(
            (y, st), leaves, (dy, dfinal))))
    torch.cuda.synchronize()
    check(torch.equal(runs[0][0], direct[0])
          and torch.equal(runs[0][1], direct[1]),
          f"{name}: the Function's forward differs from the no-grad call")
    names = ("y", "state", "dxdt", "dcs", "dBm", "dCm")
    for a, b_, what in zip(runs[0], runs[1], names):
        check(torch.equal(a, b_), f"{name}: two runs' {what} differ")
    errs = {}
    want_y, want_s = ssd_scan_ref(*inputs)
    for what, got, want in (("y", runs[0][0], want_y),
                            ("state", runs[0][1], want_s)):
        t = SSD_TOL[torch.float32]
        diff = (got - want).abs()
        share = (diff / (t["atol"] + t["rtol"] * want.abs())).max().item()
        errs[what] = {"max_abs_err": diff.max().item(), "tol_share": share}
        check(share <= 1.0, f"{name}: {what} off the plain version by "
              f"{diff.max().item()}, {share:.3g} of SSD_TOL")
    del want_y, want_s
    ref = [t.double().requires_grad_() for t in inputs]
    want = torch.autograd.grad(ssd_scan_ref(*ref), ref,
                               (dy.double(), dfinal.double()))
    for what, got, w in zip(names[2:], runs[0][2:], want):
        diff = (got.double() - w).abs()
        limit = SSD_GRAD_F32 * w.abs().max().item()
        errs[what] = {"max_abs_err": diff.max().item(),
                      "max_abs": w.abs().max().item(),
                      "tol_share": diff.max().item() / limit}
        check(bool(torch.isfinite(got).all()), f"{name}: {what} is not "
              f"finite")
        check(diff.max().item() <= limit, f"{name}: {what} off the float64 "
              f"autograd by {diff.max().item()}, {diff.max().item() / limit:.3g}"
              f" of its limit")
    del ref, want, runs
    row = {"phase": "train_ssd_grad", "case": name, "B": B, "T": T, "nc": nc,
           "L": L, "H": H, "N": N, "P": P, "chunk_decay": chunk_decay,
           "dtype": "float32", "errors": errs,
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "card": smi}
    if timed:
        leaves = [t.clone().requires_grad_() for t in inputs]

        def pair(fwd):
            return lambda: torch.autograd.grad(fwd(*leaves)[0], leaves, dy)

        # forward: xdt, cs, B, C read, y and the final state written;
        # backward: xdt, cs, B, C and dy read, their four gradients written
        # (float32 throughout).  Operations: the forward's (ssd_case's
        # count) three times, as a product's forward and backward
        pairs = L * (L + 1) // 2
        fwd_flops = 2.0 * B * nc * (H * (2 * L * N * P + pairs * P)
                                    + pairs * N)
        n_bytes = 4 * (B * nc * L * (5 * H * P + 3 * H + 6 * N)
                       + B * H * N * P)
        bound_ms, bound_by = _bound(n_bytes, 3 * fwd_flops, torch.float32)
        row.update({
            "ms": device_ms(pair(ssd_scan), reps=10),
            "plain_ms": device_ms(pair(ssd_scan_ref), reps=3),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "flops": 3 * fwd_flops,
            "forward_ms": device_ms(lambda: ssd_scan(*inputs), reps=10)})
        row["backward_ms"] = row["ms"] - row["forward_ms"]
    emit(row)
    return row


def train_ssd_grad_phase(smi) -> dict:
    """The scan's gradient at mamba2-2.7b's training shape (B = 2, T =
    1,024, H = 80, N = 128, P = 64, chunk 128) and at zamba2-7b's (H =
    112, N = 64), both timed; returns mamba2's row."""
    rows = [ssd_grad_case(f"{arch} train B=2 T=1024", 2, 1024, H, N, P,
                          seed=60 + i, smi=smi)
            for i, (arch, H, N, P) in enumerate(SSD_TRAIN)]
    return rows[0]


def ssm_decode_matches_forward_phase(smi) -> None:
    """For each of SSM_DECODE, float32 at full width, seed-0 weights: a
    prefill of 511 tokens (numpy seed 1, two rows) and one decode step of
    token 511 give the logits of ``forward`` over all 512 tokens at
    position 511, within DECODE_FWD_TOL: the scan kernel's chunked forward
    against the plain recurrent step, and on zamba2 flash attention's
    prefill against decode attention.  Launches exact: the scan at every
    layer of the prefill and of the forward, flash at every use of the
    shared block in both, decode attention at each use in the step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import (decode_step, forward, init_params,
                                    prefill)
    from repro_torch.models.lm import layer_flags, logits_from_hidden

    for arch, layers in SSM_DECODE:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  dtype="float32")
        uses = sum(layer_flags(cfg).get("use_attn", []))
        model = init_params(cfg, seed=0, device=TRAIN_DEVICE)
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, PROMPT), dtype=np.int32)
        s0 = PROMPT - 1
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        cache, _ = prefill(model, cfg, {"tokens": tokens[:, :s0]},
                           max_len=PROMPT + 1)
        _, dec = decode_step(model, cfg, cache, torch.from_numpy(
            tokens[:, s0:]).to(TRAIN_DEVICE, torch.int64))
        with torch.no_grad():
            h = forward(model, cfg, {"tokens": tokens})
            full = logits_from_hidden(model, cfg, h[:, s0:])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launch_counts()
        diff = (dec.float() - full.float()).abs()
        t = DECODE_FWD_TOL
        share = (diff / (t["atol"] + t["rtol"] * full.abs())).max().item()
        row = {"phase": "ssm_decode_matches_forward", "arch": arch,
               "layers": layers, "dtype": "float32", "prompt": s0,
               "max_abs_err": diff.max().item(),
               "max_abs_logit": full.abs().max().item(), "tol": t,
               "tol_share": share, "launches": counts, "seconds": seconds,
               "card": smi}
        emit(row)
        want = {"tile_matmul": 0, "flash_attention": 2 * uses,
                "decode_attention": uses, "ssd_scan": 2 * layers,
                "adamw": 0, "flash_attention_bwd": 0}
        check(counts == want, f"{arch}: launches {counts}, expected {want}")
        check(bool(torch.isfinite(dec).all() and torch.isfinite(full).all()),
              f"{arch}: a logit is not finite")
        check(share <= 1.0, f"{arch}: decode vs forward at position {s0}: "
              f"max abs err {diff.max().item()}, {share:.3g} of the "
              f"tolerance")
        del model, cache, h, full, dec
        gc.collect()
        torch.cuda.empty_cache()


def train_ssm_grad_vs_cpu_phase(smi) -> list:
    """For each of SSM_DECODE, float32 at full width, seed-0 weights: the
    training loss (``loss_fn`` with remat) and every parameter's gradient
    at one microbatch of the train steps' stream cut to SSM_GRAD_SEQ tokens
    (two chunks), on the card (the scan and flash kernels, ``SSDScanFn``'s
    and ``FlashAttentionFn``'s backwards) and on the host (their plain
    versions) from the same weights: the loss within 1e-5, each leaf's
    gradient within SSM_GRAD_CPU_RTOL of that leaf's largest entry, every
    leaf's gradient non-zero and finite.  The reduced models' losses and
    gradients are held against the reference package's on the CPU
    (tests/test_torch_train.py); this holds the card's full-width SSM and
    hybrid gradients against the same code's plain versions."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import LM, init_params, loss_fn
    from repro_torch.models.lm import layer_flags

    rows = []
    for arch, layers in SSM_DECODE:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  dtype="float32")
        batch = SyntheticLMData(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=SSM_GRAD_SEQ,
            global_batch=TRAIN_BATCH // TRAIN_MICRO, seed=0)).batch_at(0)
        card = init_params(cfg, seed=0, device=TRAIN_DEVICE)
        host = LM(cfg, torch.device("cpu"))
        host.load_state_dict({n: p.cpu() for n, p in card.state_dict().items()})
        out = {}
        for where, model in (("card", card), ("host", host)):
            dev = model.device
            model.requires_grad_(True)
            names, leaves = zip(*model.named_parameters())
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            loss = loss_fn(model, cfg, {k: torch.as_tensor(v, device=dev)
                                        for k, v in batch.items()})
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            torch.cuda.synchronize()
            out[where] = (float(loss), dict(zip(names, grads)),
                          time.perf_counter() - t0, launch_counts())
        (l_card, g_card, s_card, counts), (l_host, g_host, s_host, _) = (
            out["card"], out["host"])
        uses = sum(layer_flags(cfg).get("use_attn", []))
        check(counts["ssd_scan"] == 2 * layers
              and counts["flash_attention"] == 2 * uses,
              f"{arch}: launches {counts} in one forward + remat backward")
        check(abs(l_card - l_host) <= 1e-5 * abs(l_host),
              f"{arch}: loss on the card {l_card}, on the host {l_host}")
        worst, worst_leaf = 0.0, None
        for n, g in g_host.items():
            scale = g.abs().max().item()
            gc_ = g_card[n].cpu()
            check(scale > 0 and bool(torch.isfinite(gc_).all()),
                  f"{arch}: {n}'s gradient is zero or not finite")
            share = ((gc_ - g).abs().max().item()
                     / (SSM_GRAD_CPU_RTOL * scale))
            if share > worst:
                worst, worst_leaf = share, n
        check(worst <= 1.0, f"{arch}: {worst_leaf}'s gradient on the card "
              f"is {worst:.3g} of the limit from the host's")
        row = {"phase": "train_ssm_grad_vs_cpu", "arch": arch,
               "layers": layers, "dtype": "float32", "tokens": [
                   TRAIN_BATCH // TRAIN_MICRO, SSM_GRAD_SEQ],
               "loss": [l_card, l_host], "launches": counts,
               "worst_share": worst, "worst_leaf": worst_leaf,
               "rtol": SSM_GRAD_CPU_RTOL, "card_s": s_card,
               "host_s": s_host, "card": smi}
        emit(row)
        rows.append(row)
        del card, host, out, g_card, g_host
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def train_step_ssm_phase(smi) -> dict:
    """``train_step_phase`` on each of TRAIN_SSM, each model freed before
    the next: mamba2-2.7b at full width cut to 16 layers, zamba2-7b at
    full width cut to 12 layers; the rows by arch."""
    return {arch: train_step_phase(smi, arch, layers, phase="train_step_ssm")
            for arch, layers in TRAIN_SSM}


def _params_differ(model, before, lr):
    """(share of parameters not bit-identical to ``before`` (host copies),
    the largest difference, the largest allowed: 2 lr plus one bf16 unit
    of the largest entry)."""
    n = differ = 0
    worst = allowed = 0.0
    for name, p in model.named_parameters():
        b = before[name].to(p.device)
        d = (p.detach().float() - b.float()).abs()
        differ += int((d > 0).sum().item())
        n += d.numel()
        worst = max(worst, d.max().item())
        allowed = max(allowed, 2 * lr + BF16_ROUND * b.float().abs().max()
                      .item())
        del b, d
    return differ / n, worst, allowed


def leaf_grad_norms(model, cfg, batch, top: int = 8) -> list:
    """The ``top`` largest gradient norms of ``loss_fn`` at ``batch`` by
    kind of leaf, each over every layer's copy of it
    (``blocks.*.ssm.wdt``), before any clipping: ``[[name, norm], ...]``,
    and last ``["total", norm]``."""
    from repro_torch.models import loss_fn

    model.requires_grad_(True)
    names, leaves = zip(*model.named_parameters())
    with torch.enable_grad():
        loss = loss_fn(model, cfg, {k: torch.as_tensor(v, device=TRAIN_DEVICE)
                                    for k, v in batch.items()})
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    sq = {}
    for n, g in zip(names, grads):
        kind = re.sub(r"\.\d+\.", ".*.", n)
        sq[kind] = sq.get(kind, 0.0) + g.double().pow(2).sum().item()
    del grads, loss
    rows = sorted(([k, v ** 0.5] for k, v in sq.items()),
                  key=lambda r: -r[1])
    return rows[:top] + [["total", sum(sq.values()) ** 0.5]]


def train_launches(cfg, leaves: int) -> dict:
    """Each kernel's launches in one train step of ``cfg``: every layer's
    SSM block (ssm, hybrid) launches the scan and every attention layer, or
    use of a hybrid's shared block, launches flash attention, once per
    microbatch in the forward and once in its remat recompute, and, where
    the backward kernel takes the configuration's type and head dim, its
    backward once per microbatch; AdamW launches its norm pass and its
    update once for each of the ``leaves`` and adds the norms' partials
    once."""
    from repro_torch.kernels.flash_attention import backward_takes
    from repro_torch.models.lm import layer_flags

    if cfg.family in ("ssm", "hybrid"):
        scan = cfg.n_layers
        attn = sum(layer_flags(cfg).get("use_attn", []))
    else:
        scan, attn = 0, cfg.n_layers
    bwd = backward_takes(getattr(torch, cfg.dtype), cfg.head_dim, "cuda")
    return {"tile_matmul": 0, "flash_attention": attn * TRAIN_MICRO * 2,
            "decode_attention": 0, "ssd_scan": scan * TRAIN_MICRO * 2,
            "adamw": 2 * leaves + 1,
            "flash_attention_bwd": attn * TRAIN_MICRO if bwd else 0}


def train_model_flops(cfg, n_params: int, emb: int):
    """``(all, scan)``: a step's model FLOPs at ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` tokens, and the float32 scan's share of them: 6 N
    T over the parameters a token multiplies by (all but an untied
    embedding table, which is gathered; a tied table also serves the
    unembedding product, so it counts), plus attention's QK^T and PV over
    the causal pairs at each attention layer or use of the shared block,
    plus each SSM layer's scan products (``ssd_case``'s count), forward
    and backward (x3); remat not counted."""
    from repro_torch.models.lm import layer_flags

    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * (n_params - (0 if cfg.tie_embeddings else emb)) * tokens
    if cfg.family in ("ssm", "hybrid"):
        uses = sum(layer_flags(cfg).get("use_attn", []))
        L = min(cfg.ssm_chunk, TRAIN_SEQ)
        nc = -(-TRAIN_SEQ // L)
        pairs = L * (L + 1) // 2
        H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        scan = 2.0 * TRAIN_BATCH * nc * (H * (2 * L * N * P + pairs * P)
                                         + pairs * N)
        scan = 3 * scan * cfg.n_layers
    else:
        uses, scan = cfg.n_layers, 0.0
    flops += scan + (3 * 4 * cfg.n_heads * cfg.head_dim * TRAIN_BATCH
                     * TRAIN_SEQ * (TRAIN_SEQ + 1) / 2 * uses)
    return flops, scan


def adamw_step_case(model, opt, opt_cfg, step, batch, arch: str) -> dict:
    """The AdamW kernel against its plain version on a train step's own
    gradients: one more ``step`` at ``batch`` hands its accumulated
    float32 gradients to ``adamw_update``, which updates as usual, and a
    copy of them is kept.  Then from that tree and state, leaf by leaf,
    with the plain version's clip scale and the next step's lr and bias
    corrections, the kernel updates copies of p, m and v from the
    unclipped gradient and the plain version (the clip, then the chunked
    torch ops) the originals.  p, m and v must have the same bits, the
    kernel's norm pass must agree with the plain sum to 1e-6 relative,
    every leaf must be the kernel's, and the update must move p and m."""
    from repro_torch.kernels import adamw as K
    from repro_torch.optim import adamw as A
    from repro_torch.train import steps as S

    kept = {}

    def keep(cfg_, params, grads, state, shares=None, group=None):
        kept.update({n: g.clone() for n, g in grads.items()})
        return A.adamw_update(cfg_, params, grads, state, shares, group)

    S.adamw_update = keep
    try:
        model, opt, _ = step(model, opt, batch)
    finally:
        S.adamw_update = A.adamw_update
    named = list(model.named_parameters())
    ms, vs = opt["m"], opt["v"]
    check(all(K.takes(p, kept[n], ms[n], vs[n]) for n, p in named),
          f"{arch}: a leaf of the train step is not the AdamW kernel's")
    b1, b2 = opt_cfg.b1, opt_cfg.b2
    with torch.no_grad():
        plain_sq = A._squares(kept.items(), None)
        kernel_sq = K.sum_squares([kept[n] for n, _ in named],
                                  [1.0] * len(named))
        gn, scale = A._clip_scale(plain_sq, opt_cfg.clip_norm, None)
        nxt = opt["step"] + 1
        lr = A.lr_schedule(opt_cfg, nxt)
        bc1, bc2 = 1 - b1 ** nxt.float(), 1 - b2 ** nxt.float()
        worst, differ, p_moved, m_moved, n_all = 0.0, 0, 0, 0, 0
        for n, p in named:
            g, m, v = kept[n], ms[n], vs[n]
            fp, fm, fv = p.detach().clone(), m.clone(), v.clone()
            K.update(fp, g, fm, fv, scale, lr, bc1, bc2, b1, b2,
                     opt_cfg.eps, opt_cfg.weight_decay)
            p_moved += int(fp.ne(p).sum().item())
            m_moved += int(fm.ne(m).sum().item())
            A._clip_(g, scale)
            A._plain_leaf(opt_cfg, p.detach(), g, m, v, lr, bc1, bc2)
            for a, b in ((fp, p.detach()), (fm, m), (fv, v)):
                differ += int(a.ne(b).sum().item())
                worst = max(worst, (a.float() - b.float()).abs().max()
                            .item())
            del fp, fm, fv
            kept[n] = None
            n_all += p.numel()
    del kept
    plain_norm, kernel_norm = float(plain_sq) ** 0.5, float(kernel_sq) ** 0.5
    check(differ == 0, f"{arch}: the AdamW kernel against its plain version "
          f"on the step's gradients: {differ} elements of p, m and v differ, "
          f"by up to {worst}")
    check(abs(kernel_norm - plain_norm) <= 1e-6 * plain_norm,
          f"{arch}: the AdamW norm pass reads {kernel_norm}, the plain sum "
          f"{plain_norm}")
    check(plain_norm > 0 and p_moved > 0 and m_moved > 0,
          f"{arch}: the compared update moved nothing (gradient norm "
          f"{plain_norm}; p moved in {p_moved}, m in {m_moved} of {n_all})")
    return {"leaves": len(named), "params": n_all, "grad_norm": plain_norm,
            "kernel_grad_norm": kernel_norm, "scale": float(scale),
            "p_moved": p_moved, "m_moved": m_moved,
            "elements_differ": differ, "max_abs_err": worst}


def train_step_phase(smi, arch: str = TRAIN_ARCH, layers: int = TRAIN_LAYERS,
                     phase: str = "train_step") -> dict:
    """``make_train_step`` on ``arch`` at full width cut to ``layers``
    (qwen3-14b, 4 of 40, by default), bf16, seed-0 weights drawn on the
    card, ``SyntheticLMData`` at seq 1,024 and global batch 4 in 2
    microbatches under ``overlap="hybrid"``, 8 steps: every loss and
    gradient norm finite, the mean loss of the 8 trained batches lower
    after than before, and for HELD_OUT_GATED step 8's loss below step
    1's and a held-out batch's lower after than before; each kernel's
    launches per step exact
    (:func:`train_launches`); one ``serial`` step from the same start
    against hybrid's first; step ms, tokens/s, ``train_mfu``, peak memory,
    AdamW ms through the kernel and through its plain version (the chunked
    torch ops) on the same tree, the kernel's GB/s, the kernel against
    its plain version on a step's own gradients (:func:`adamw_step_case`),
    and one profiled step's device busy share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   adamw_update_ref)
    from repro_torch.train import StepConfig, make_eval_step, make_train_step

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=0)
    data = SyntheticLMData(data_cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()

    # one serial step from the seed-0 start, its parameters kept on the host
    model = init_params(cfg, seed=0, device=TRAIN_DEVICE)
    n_params = sum(p.numel() for p in model.parameters())
    opt = adamw_init(model)
    serial = make_train_step(cfg, opt_cfg, None, StepConfig(
        microbatches=TRAIN_MICRO, overlap="serial"))
    model, opt, m_serial = serial(model, opt, data.batch_at(0))
    serial_params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    serial_metrics = {k: float(v) for k, v in m_serial.items()}
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0

    # the main path: the hybrid step from the same start, 8 steps, the data
    # through the prefetching iterator
    model = init_params(cfg, seed=0, device=TRAIN_DEVICE)
    opt = adamw_init(model)
    step = make_train_step(cfg, opt_cfg, None, StepConfig(
        microbatches=TRAIN_MICRO, overlap="hybrid"))
    held_set = [data.batch_at(HELD_OUT_STEP + k)
                for k in range(HELD_OUT_BATCHES)]
    held_out = held_set[0]
    evaluate = make_eval_step(cfg)

    def held_set_loss():
        return sum(float(evaluate(model, b)) for b in held_set) / len(
            held_set)

    held_before = float(evaluate(model, held_out))
    held_by_step = [held_before]
    set_before = held_set_loss()
    micro0 = {k: v[:TRAIN_BATCH // TRAIN_MICRO]
              for k, v in data.batch_at(0).items()}
    norms_before = leaf_grad_norms(model, cfg, micro0)
    trained = [data.batch_at(i) for i in range(TRAIN_STEPS)]
    trained_before = sum(float(evaluate(model, b)) for b in trained) / len(
        trained)
    data.start(0)
    it = iter(data)
    losses, grad_norms, step_s, launches = [], [], [], []
    try:
        for i in range(TRAIN_STEPS):
            s, batch = next(it)
            check(s == i, f"the data stream gave step {s} at step {i}")
            torch.cuda.synchronize()
            reset_launch_counts()
            t1 = time.perf_counter()
            model, opt, metrics = step(model, opt, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            launches.append(launch_counts())
            losses.append(float(metrics["loss"]))
            grad_norms.append(float(metrics["grad_norm"]))
            held_by_step.append(float(evaluate(model, held_out)))
            if i == 0:
                hybrid_metrics = {k: float(v) for k, v in metrics.items()}
                share, worst, allowed = _params_differ(model, serial_params,
                                                       opt_cfg.lr)
                del serial_params
    finally:
        data.stop()
    peak = torch.cuda.max_memory_allocated()
    held_after = held_by_step[-1]
    set_after = held_set_loss()
    trained_after = sum(float(evaluate(model, b)) for b in trained) / len(
        trained)
    norms_after = leaf_grad_norms(model, cfg, micro0)
    del trained
    want = train_launches(cfg, len(list(model.parameters())))
    for i, c in enumerate(launches):
        check(c == want, f"{arch} train step {i + 1}: launches {c}, expected "
              f"{want} (layers or uses x microbatches x forward and remat)")
    check(all(math.isfinite(x) for x in losses + grad_norms),
          f"{arch}: losses {losses}, gradient norms {grad_norms}")
    check(trained_after < trained_before, f"{arch}: the mean loss of the "
          f"trained batches did not fall: {trained_before} -> {trained_after}")
    if arch in HELD_OUT_GATED:
        check(losses[-1] < losses[0], f"{arch}: the loss did not fall: "
              f"{losses}")
        check(held_after < held_before, f"{arch}: the held-out loss did not "
              f"fall: {held_before} -> {held_after}")
    check(serial_metrics["loss"] == hybrid_metrics["loss"],
          f"{arch}: serial and hybrid step 1 losses differ: {serial_metrics} "
          f"vs {hybrid_metrics}")
    check(abs(serial_metrics["grad_norm"] - hybrid_metrics["grad_norm"])
          <= 1e-5 * hybrid_metrics["grad_norm"],
          f"{arch}: serial and hybrid grad norms differ: {serial_metrics} vs "
          f"{hybrid_metrics}")
    check(share <= STEP_DIFF_SHARE and worst <= allowed,
          f"{arch}: serial vs hybrid parameters: {share:.3g} of them differ "
          f"(limit {STEP_DIFF_SHARE}), by up to {worst} (limit {allowed})")

    # one profiled step: device time by kernel, the busy share
    batch = data.batch_at(TRAIN_STEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        model, opt, _ = step(model, opt, batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    rows = _device_rows(prof)
    device_s = sum(r[0] for r in rows) / 1e6
    check(device_s > 0, "the profiled train step shows no device work")

    # AdamW: the kernel against its plain version on the step's own
    # gradients, then alone, on float32 gradients of the accumulated step's
    # layout: the kernel, and beside it the plain version (the chunked
    # torch ops, a yardstick the step no longer runs on the card) on the
    # same tree; the kernel's bytes: p read and written, g read by the norm
    # and the update, m and v read and written
    adamw_case = adamw_step_case(model, opt, opt_cfg, step,
                                 data.batch_at(TRAIN_STEPS + 1), arch)
    grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=TRAIN_DEVICE)
             for n, p in model.named_parameters()}
    adamw_ms = device_ms(lambda: adamw_update(opt_cfg, model, grads, opt),
                         reps=3)
    adamw_plain_ms = device_ms(
        lambda: adamw_update_ref(opt_cfg, model, grads, opt), reps=3)
    adamw_bytes = sum(p.numel() * (2 * p.element_size() + 2 * 4 + 16)
                      for p in model.parameters())
    del grads

    tokens = TRAIN_BATCH * TRAIN_SEQ
    model_flops, scan_flops = train_model_flops(
        cfg, n_params, model.embed.table.numel())
    med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    # the floor: the step's products at the bf16 peak (the scan's, which
    # are float32, at the float32 rate), and the optimizer's bytes (bf16 p
    # read and written, f32 gradient read, f32 m and v read and written)
    # at the memory rate
    floor_products_ms = ((model_flops - scan_flops)
                         / PEAK_FLOPS[torch.bfloat16]
                         + scan_flops / PEAK_FLOPS[torch.float32]) * 1e3
    floor_opt_ms = n_params * (2 + 2 + 4 + 8 + 8) / HBM_BYTES_PER_S * 1e3
    row = {"phase": phase, "arch": arch, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": n_params, "seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
           "microbatches": TRAIN_MICRO, "overlap": "hybrid",
           "opt": TRAIN_OPT, "setup_s": setup_s, "losses": losses,
           "grad_norms": grad_norms,
           "leaf_grad_norms": {"before": norms_before,
                               "after": norms_after},
           "held_out_loss": [held_before, held_after],
           "held_out_by_step": held_by_step,
           "held_out_set_loss": [set_before, set_after],
           "trained_batches_loss": [trained_before, trained_after],
           "held_out_gated": arch in HELD_OUT_GATED,
           "step_s": step_s, "median_step_ms": med * 1e3,
           "tokens_per_s": tokens / med, "model_flops": model_flops,
           "scan_flops": scan_flops,
           "train_mfu": model_flops / med / PEAK_FLOPS[torch.bfloat16],
           "peak_memory_gb": peak / 1e9,
           "launches_per_step": launches[0],
           "flash_launches_per_step": launches[0]["flash_attention"],
           "flash_launches": sum(c["flash_attention"] for c in launches),
           "flash_bwd_launches": sum(c["flash_attention_bwd"]
                                     for c in launches),
           "scan_launches": sum(c["ssd_scan"] for c in launches),
           "adamw_launches": sum(c["adamw"] for c in launches),
           "adamw": {**adamw_case, "ms": adamw_ms, "plain_ms": adamw_plain_ms,
                     "library_ms": None,
                     "bound_ms": adamw_bytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "memory", "bytes": adamw_bytes},
           "adamw_ms": adamw_ms, "adamw_plain_ms": adamw_plain_ms,
           "adamw_gb_s": adamw_bytes / adamw_ms / 1e6,
           "floor_products_ms": floor_products_ms,
           "floor_optimizer_ms": floor_opt_ms,
           "serial_vs_hybrid": {"serial": serial_metrics,
                                "hybrid": hybrid_metrics,
                                "params_differ_share": share,
                                "max_abs_diff": worst, "allowed": allowed},
           "profiled_wall_s": prof_wall, "device_busy_s": device_s,
           "device_busy_share": device_s / prof_wall,
           "device_kernels": sum(r[2] for r in rows),
           "top": [{"name": k[:80], "count": c, "device_ms": us / 1e3}
                   for us, k, c in rows[:12]], "card": smi}
    emit(row)
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return row


def trainer_phase(smi) -> dict:
    """``Trainer`` on the card at the reference example's 100m
    configuration (12 layers, d 768, vocab 32,768, float32), batch 8 of
    256 tokens in 2 microbatches: 40 steps with a checkpoint every 20; a
    ``request_preemption()`` at step 25 checkpoints and stops; a new
    ``Trainer`` restores at 25, reads the stream from step 25 (each batch
    equal to an uninterrupted stream's) and finishes at 40; the loss falls.
    Checkpoint bytes and save seconds; flash and AdamW launches exact."""
    import hashlib
    import shutil
    import tempfile

    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (StepConfig, Trainer, TrainerConfig,
                                   make_eval_step)
    from repro_torch.train.train_lm import build_cfg

    cfg = build_cfg("100m")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                          global_batch=8, seed=0)
    saves = []
    digests = []

    def make():
        tr = Trainer(cfg, AdamWConfig(**TRAINER_OPT),
                     TrainerConfig(steps=TRAINER_STEPS,
                                   ckpt_every=TRAINER_CKPT_EVERY,
                                   ckpt_dir=ckpt_dir, log_every=5),
                     data_cfg, step_cfg=StepConfig(microbatches=2,
                                                   overlap="hybrid"),
                     device=TRAIN_DEVICE)
        inner = tr.step_fn

        def step_fn(params, opt_state, batch):
            digests.append(hashlib.sha256(
                batch["tokens"].cpu().numpy().tobytes()).hexdigest())
            if len(digests) == TRAINER_PREEMPT:
                tr.request_preemption()
            return inner(params, opt_state, batch)

        tr.step_fn = step_fn
        for name in ("save", "save_async"):
            fn = getattr(tr.ckpt, name)

            def timed(step, tree, extra=None, fn=fn, name=name):
                t1 = time.perf_counter()
                out = fn(step, tree, extra)
                saves.append({"call": name, "step": step,
                              "seconds": time.perf_counter() - t1})
                return out
            setattr(tr.ckpt, name, timed)
        return tr

    evaluate = make_eval_step(cfg)
    held_out = SyntheticLMData(data_cfg).batch_at(HELD_OUT_STEP)
    held_before = float(evaluate(init_params(cfg, seed=0,
                                             device=TRAIN_DEVICE), held_out))
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        first = make().run()
        check(first["preempted"] and first["final_step"] == TRAINER_PREEMPT,
              f"the preempted run ended at {first['final_step']}, "
              f"preempted={first['preempted']}")
        second = make()
        _, _, start = second.init_or_restore()
        check(start == TRAINER_PREEMPT, f"restored at {start}, expected "
              f"{TRAINER_PREEMPT}")
        out = second.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()["flash_attention"]
        bwd_launches = launch_counts()["flash_attention_bwd"]
        adamw_launches = launch_counts()["adamw"]
        step_dir = os.path.join(ckpt_dir, f"step_{TRAINER_STEPS:08d}")
        ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(out["final_step"] == TRAINER_STEPS and not out["preempted"],
          f"the resumed run ended at {out['final_step']}")
    fresh = SyntheticLMData(data_cfg)
    want = [hashlib.sha256(fresh.batch_at(s)["tokens"].tobytes()).hexdigest()
            for s in range(TRAINER_STEPS)]
    check(digests == want, "the resumed stream's batches differ from an "
          "uninterrupted stream's")
    want_launches = cfg.n_layers * 2 * 2 * TRAINER_STEPS
    check(launches == want_launches, f"trainer: {launches} flash launches, "
          f"expected {want_launches}")
    # the backward kernel where it takes the configuration (float32: none)
    want_bwd = train_launches(cfg, 0)["flash_attention_bwd"] * TRAINER_STEPS
    check(bwd_launches == want_bwd, f"trainer: {bwd_launches} flash "
          f"backward launches, expected {want_bwd}")
    # every step's update through the AdamW kernel (float32 leaves)
    leaves = len(list(out["params"].parameters()))
    want_adamw = (2 * leaves + 1) * TRAINER_STEPS
    check(adamw_launches == want_adamw, f"trainer: {adamw_launches} adamw "
          f"launches, expected {want_adamw}")
    losses = [m["loss"] for m in first["metrics"] + out["metrics"]]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"the trainer's loss did not fall: "
          f"{losses}")
    held_after = float(evaluate(out["params"], held_out))
    check(held_after < held_before, f"the trainer's held-out loss did not "
          f"fall: {held_before} -> {held_after}")
    row = {"phase": "trainer", "config": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": sum(p.numel() for p in out["params"].parameters()),
           "steps": TRAINER_STEPS,
           "preempted_at": first["final_step"], "restored_at": start,
           "final_step": out["final_step"],
           "losses": [(m["step"], m["loss"]) for m in
                      first["metrics"] + out["metrics"]],
           "held_out_loss": [held_before, held_after], "opt": TRAINER_OPT,
           "flash_launches": launches, "flash_bwd_launches": bwd_launches,
           "adamw_launches": adamw_launches, "checkpoint_bytes": ckpt_bytes,
           "saves": saves, "wall_s": wall, "card": smi}
    emit(row)
    return row


def reference_init_(model, cfg, seed: int = 0) -> None:
    """Redraw the port's ``LM`` as a draw of the reference's
    initialisation: ``repro/models/layers.py::materialize`` applied to the
    reference's shapes, where each block leaf is stacked over the layers.
    A leaf of rank >= 2 there is a truncated normal on [-2, 2] times
    1/sqrt(fan_in), fan_in being its second-to-last dimension at rank 2 and
    the product of all but the last beyond: so a block's norm scale, (L, d)
    stacked, is drawn at fan-in L, and a block matrix at L times the
    layer's fan-in.  Other 1-D leaves are ones if named ``norm*``,
    ``gamma*`` or ``scale``, else zeros (the final norm's scale among
    them)."""
    stacks = {"blocks": cfg.n_layers, "enc_blocks": cfg.enc_layers}
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            stack = stacks.get(name.split(".", 1)[0])
            shape = ((stack,) if stack else ()) + tuple(p.shape)
            if len(shape) >= 2:
                fan_in = shape[-2] if len(shape) == 2 else math.prod(shape[:-1])
                x = torch.empty(p.shape, dtype=torch.float32, device=p.device)
                torch.nn.init.trunc_normal_(x, mean=0.0, std=1.0, a=-2.0,
                                            b=2.0, generator=gen)
                p.copy_(x.mul_(1.0 / math.sqrt(fan_in)))
            elif leaf.startswith(("norm", "gamma")) or leaf == "scale":
                p.fill_(1.0)
            else:
                p.zero_()


def trainer_lr_witness_phase(smi) -> dict:
    """The trainer's configuration (100m, batch 8 of 256 in 2 microbatches)
    at the reference example's schedule, 3e-3 after 20 warmup steps, for
    40 steps from seed-0 starts: the port's initialisation (norm scales of
    one, per-layer fan-in) under ``hybrid`` and under ``serial``, and a draw
    of the reference's (:func:`reference_init_`) under ``hybrid``.
    Per-step losses and a held-out batch's loss before and after, each
    finite.  ``tests/torch_lr_witness.py`` holds the two packages against
    each other from one tree on the CPU."""
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import StepConfig, make_eval_step, make_train_step
    from repro_torch.train.train_lm import build_cfg

    cfg = build_cfg("100m")
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                                      global_batch=8, seed=0))
    held_out = data.batch_at(HELD_OUT_STEP)
    evaluate = make_eval_step(cfg)
    row = {"phase": "trainer_lr_witness", "config": cfg.name,
           "layers": cfg.n_layers, "opt": EXAMPLE_OPT, "card": smi}
    for init, overlap in (("port", "hybrid"), ("port", "serial"),
                          ("reference", "hybrid")):
        step = make_train_step(cfg, AdamWConfig(**EXAMPLE_OPT), None,
                               StepConfig(microbatches=2, overlap=overlap))
        model = init_params(cfg, seed=0, device=TRAIN_DEVICE)
        if init == "reference":
            reference_init_(model, cfg)
        opt = adamw_init(model)
        before = float(evaluate(model, held_out))
        losses = []
        for s in range(TRAINER_STEPS):
            model, opt, metrics = step(model, opt, data.batch_at(s))
            losses.append(float(metrics["loss"]))
        after = float(evaluate(model, held_out))
        check(all(math.isfinite(x) for x in losses + [before, after]),
              f"lr witness, {init} init, {overlap}: losses {losses}, "
              f"held-out {before} -> {after}")
        row[f"{init}_init_{overlap}"] = {"losses": losses,
                                         "held_out_loss": [before, after]}
        del model, opt
    emit(row)
    gc.collect()
    torch.cuda.empty_cache()
    return row


def train_ssm_seed_witness_phase(smi) -> dict:
    """``train_step_ssm``'s zamba2-7b cell (12 layers, bf16, TRAIN_OPT, the
    same stream, batch and hybrid schedule, 8 steps) from the seed-1 and
    seed-2 draws of its weights beside the seed-0 cell: per-step losses,
    the held-out batch's loss after every step, the held-out set's and the
    trained batches' mean loss before and after, each finite.  Where 8
    steps leave the held-out loss of one draw is not where they leave
    another's."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import StepConfig, make_eval_step, make_train_step

    arch, layers = SSM_SEED_WITNESS
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH, seed=0))
    held_set = [data.batch_at(HELD_OUT_STEP + k)
                for k in range(HELD_OUT_BATCHES)]
    trained = [data.batch_at(i) for i in range(TRAIN_STEPS)]
    evaluate = make_eval_step(cfg)
    mean = lambda model, bs: sum(  # noqa: E731
        float(evaluate(model, b)) for b in bs) / len(bs)
    step = make_train_step(cfg, AdamWConfig(**TRAIN_OPT), None, StepConfig(
        microbatches=TRAIN_MICRO, overlap="hybrid"))
    row = {"phase": "train_ssm_seed_witness", "arch": arch, "layers": layers,
           "opt": TRAIN_OPT, "card": smi}
    for seed in SSM_WITNESS_SEEDS:
        model = init_params(cfg, seed=seed, device=TRAIN_DEVICE)
        opt = adamw_init(model)
        held = [float(evaluate(model, held_set[0]))]
        sets, tr = [mean(model, held_set)], [mean(model, trained)]
        losses = []
        for b in trained:
            model, opt, metrics = step(model, opt, b)
            losses.append(float(metrics["loss"]))
            held.append(float(evaluate(model, held_set[0])))
        sets.append(mean(model, held_set))
        tr.append(mean(model, trained))
        check(all(math.isfinite(x) for x in losses + held + sets + tr),
              f"{arch} seed {seed}: losses {losses}, held-out {held}")
        row[f"seed_{seed}"] = {"losses": losses, "held_out_by_step": held,
                               "held_out_set_loss": sets,
                               "trained_batches_loss": tr}
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
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


def cholesky_mp_phase(n: int, tile: int, smi: str, n_seeds: int = 5,
                      device: str = "cuda") -> dict:
    """Path A: a Cholesky sweep over ``n_seeds`` seeds through
    ``Session(4, scheduler="replay", procs=2).map``, held against an
    in-process dynamic run of each seed; the same sweep through in-process
    ``map`` for its wall; then ``Session.submit`` of three seeds' graphs.
    Returns the GEMM launches of the sweep and of the submits."""
    import tempfile

    from repro_torch import Session
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.replay import GraphCache

    nb = n // tile
    per_run = math.comb(nb + 1, 3)
    inputs = [(seed, n, tile, device) for seed in range(n_seeds)]
    row = {"phase": "cholesky_mp", "n": n, "tile": tile, "workers": WORKERS,
           "procs": 2, "seeds": n_seeds, "card": smi}

    # each seed built and factored in-process by dynamic scheduling: the
    # digests every other run must equal, and the sequential build + run
    with Session(WORKERS) as s:
        s.run(cholesky_digest_graph((n_seeds, 4 * tile, tile, device)))
        dynamic, build_s, run_s = [], 0.0, 0.0
        for x in inputs:
            t0 = time.perf_counter()
            g = cholesky_digest_graph(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dynamic.append(digest_of(s.run(g).results))
            build_s += t1 - t0
            run_s += time.perf_counter() - t1
            del g
    row["dynamic"] = {"build_s": build_s, "run_s": run_s}
    for seed, d in enumerate(dynamic):
        check(d["finite"] and d["shape"] == [n, n],
              f"seed {seed}: the dynamic factor is not finite n x n")
        check(d["residual"] <= 1e-12,
              f"seed {seed}: residual {d['residual']} > 1e-12")
        check(d["max_rel_diff_vs_torch_cholesky"] <= 1e-10,
              f"seed {seed}: L differs from torch.linalg.cholesky by "
              f"{d['max_rel_diff_vs_torch_cholesky']}")

    # the same sweep through in-process map on one session
    with tempfile.TemporaryDirectory() as tmp:
        with Session(WORKERS, scheduler="replay",
                     cache=GraphCache(tmp)) as s:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            local = s.map(cholesky_digest_graph, inputs)
            row["in_process_map_wall_s"] = time.perf_counter() - t0
    row["in_process_modes"] = [r.plan.mode for r in local]
    row["in_process_run_wall_s"] = [r.wall_s for r in local]
    check([digest_of(r.results)["sha256"] for r in local]
          == [d["sha256"] for d in dynamic],
          "the in-process map's factors differ from the dynamic runs'")
    del local

    # the sweep across two worker processes
    with tempfile.TemporaryDirectory() as tmp:
        with Session(WORKERS, scheduler="replay", cache=GraphCache(tmp),
                     procs=2) as s:
            t0 = time.perf_counter()
            pool = s.process_pool()
            read_children(pool, reset=True)   # the children are up
            row["pool_start_s"] = time.perf_counter() - t0
            reset_launch_counts()
            t0 = time.perf_counter()
            reports = s.map(cholesky_digest_graph, inputs)
            row["mp_map_wall_s"] = time.perf_counter() - t0
            parent = launch_counts()["tile_matmul"]
            children = read_children(pool)
            row["cache_entries"] = sorted(
                f for f in os.listdir(tmp) if f.endswith(".json"))
    row["mp_over_in_process"] = (row["mp_map_wall_s"]
                                 / row["in_process_map_wall_s"])
    row["modes"] = [r.plan.mode for r in reports]
    row["mp_proc"] = [r.stats.get("mp_proc") for r in reports]
    row["run_wall_s"] = [r.wall_s for r in reports]
    digests = [digest_of(r.results) for r in reports]
    row["residuals"] = [d["residual"] for d in digests]
    row["bit_identical_to_dynamic"] = ([d["sha256"] for d in digests]
                                       == [d["sha256"] for d in dynamic])
    runs = {p: row["mp_proc"].count(p) for p in (0, 1)}
    row["parent_tile_matmul_launches"] = parent
    row["child_tile_matmul_launches"] = {
        c["proc"]: c["counts"]["tile_matmul"] for c in children}
    row["child_pids"] = [c["pid"] for c in children]
    row["runs_per_child"] = runs
    row["launches_per_run"] = per_run

    # Session.submit: each graph built while the previous one runs
    with Session(WORKERS) as s:
        s.run(cholesky_digest_graph((n_seeds, 4 * tile, tile, device)))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        futs = [s.submit(cholesky_digest_graph(x)) for x in inputs[:3]]
        submitted = [digest_of(f.result(timeout=600).results) for f in futs]
        row["submit_wall_s"] = time.perf_counter() - t0
        submit_launches = launch_counts()["tile_matmul"]
    row["submit_sequential_s"] = (build_s + run_s) * 3 / n_seeds
    row["submit_launches"] = submit_launches
    row["submit_bit_identical"] = ([d["sha256"] for d in submitted]
                                   == [d["sha256"] for d in dynamic[:3]])
    emit(row)

    check(row["modes"] == ["record"] + ["replay"] * (n_seeds - 1),
          f"the sweep's plan modes are {row['modes']}: input 0 must record "
          "in-process and every child replay the adopted recording")
    check(row["mp_proc"][0] is None and set(row["mp_proc"][1:]) == {0, 1},
          f"the sweep ran on processes {row['mp_proc']}, not both children")
    check(len(row["cache_entries"]) == 1,
          f"the shared cache holds {row['cache_entries']}: a child recorded "
          "its own")
    check(row["bit_identical_to_dynamic"],
          "a factor of the sweep differs from the in-process dynamic run's")
    check(max(row["residuals"]) <= 1e-12,
          f"a residual of the sweep is {max(row['residuals'])} > 1e-12")
    check(parent == per_run, f"the in-process seed run launched the GEMM "
          f"{parent} times, expected {per_run}")
    for c in children:
        want = runs[c["proc"]] * per_run
        check(c["counts"] == {**c["counts"], "tile_matmul": want}
              and sum(c["counts"].values()) == want,
              f"child {c['proc']} launched {c['counts']}, expected "
              f"{want} GEMMs ({runs[c['proc']]} runs)")
    check(row["submit_bit_identical"],
          "a submitted run's factor differs from the dynamic run's")
    check(submit_launches == 3 * per_run,
          f"the submitted runs launched the GEMM {submit_launches} times, "
          f"expected {3 * per_run}")
    return {"cholesky_mp": parent + sum(
                c["counts"]["tile_matmul"] for c in children),
            "cholesky_submit": submit_launches}


def serving_mp_phase(cfg, model, n_requests: int, single_row: dict,
                     single_tokens: dict, smi: str, **factory) -> dict:
    """Path B: the Poisson stream of ``serving_poisson_phase`` through
    ``ContinuousBatchingEngine(procs=2)`` on ``Session(2,
    scheduler="pool")``, each child building the model with
    ``serve_lm.make_serving_fns``; the parent's model stays loaded for the
    engine's in-process rescue.  Returns the children's launches by
    kernel."""
    from repro_torch import Session
    from repro_torch.models import decode_step, prefill
    from repro_torch.serving import ContinuousBatchingEngine, PoissonWorkload

    workload = PoissonWorkload(POISSON["rate"], n_requests, seed=0,
                               prompt_len=POISSON["prompt_len"],
                               max_new_tokens=POISSON["max_new_tokens"],
                               vocab_size=cfg.vocab_size)
    max_len = POISSON["prompt_len"][1] + POISSON["max_new_tokens"][1] + 1
    factory = {"arch": cfg.name, "prompt_len": POISSON["prompt_len"][1],
               "tokens": POISSON["max_new_tokens"][1], "device": "cuda",
               **factory}
    row = {"phase": "serving_mp", "arch": cfg.name, "procs": 2,
           "workers": SERVE_WORKERS, "scheduler": "pool", "max_batch": 4,
           "workload": workload.describe(), "max_len": max_len,
           "fns_ref": "repro_torch.serving.serve_lm:make_serving_fns",
           "factory": factory, "card": smi}
    free, total = torch.cuda.mem_get_info()
    row["free_gb_before"] = free / 1e9
    with Session(SERVE_WORKERS, scheduler="pool",
                 pool_kwargs={"warmup_runs": 0}, procs=2) as session:
        t0 = time.perf_counter()
        pool = session.process_pool()
        read_children(pool, reset=True)
        row["pool_start_s"] = time.perf_counter() - t0
        # each child's serve_open round trip (it builds the child's model),
        # timed where the engine sends it; the protocol is unchanged
        opened = {}
        send = pool.request

        def timed_request(proc, op, payload=None):
            fut = send(proc, op, payload)
            if op == "serve_open":
                t = time.perf_counter()
                fut.add_done_callback(lambda f, p=proc, t=t: opened.__setitem__(
                    p, time.perf_counter() - t))
            return fut

        pool.request = timed_request
        engine = ContinuousBatchingEngine(
            session, lambda cache, tok: decode_step(model, cfg, cache, tok),
            lambda prompt: prefill(model, cfg, {"tokens": prompt},
                                   max_len=max_len),
            max_batch=4, procs=2, fns_ref=(row["fns_ref"], factory))
        t0 = time.perf_counter()
        report = engine.run(workload.requests())
        row["wall_s"] = time.perf_counter() - t0
        del pool.request
        children = read_children(pool)
        free, _ = torch.cuda.mem_get_info()
        row["free_gb_after_run"] = free / 1e9
    free, _ = torch.cuda.mem_get_info()
    row["free_gb_after_close"] = free / 1e9
    row["total_gb"] = total / 1e9
    stats = engine.mp_stats
    row["serve_open_s"] = {p: opened.get(p) for p in (0, 1)}
    row["dead"], row["fallback"] = stats["dead"], stats["fallback"]
    row["per_proc"] = [{k: s[k] for k in ("proc", "pid", "completed",
                                          "steps", "warm_steps", "lane_steps",
                                          "records", "wall_s")}
                       for s in stats["per_proc"]]
    row["child_launches"] = {c["proc"]: c["counts"] for c in children}
    row.update(report.summary())
    row["single_process"] = {k: single_row[k] for k in (
        "p50_tok_ms", "p99_tok_ms", "ttft_p50_ms", "ttft_p99_ms", "tok_s",
        "wall_s")}
    row["tokens_bit_identical"] = report.tokens_by_rid() == single_tokens
    emit(row)

    check(stats["dead"] == [] and stats["fallback"] == 0,
          f"a child died or handed requests to the in-process rescue: "
          f"dead {stats['dead']}, fallback {stats['fallback']}")
    check(report.completed == n_requests,
          f"{report.completed} of {n_requests} requests completed")
    check(sorted(s["proc"] for s in stats["per_proc"]) == [0, 1]
          and all(s["completed"] > 0 for s in stats["per_proc"]),
          f"not both children served: {row['per_proc']}")
    check(row["tokens_bit_identical"],
          "the sharded serve's tokens differ from the single-process phase's")
    by_kernel = dict.fromkeys(KERNELS, 0)
    for s in stats["per_proc"]:
        got = row["child_launches"][s["proc"]]
        want = expected_launches(cfg, s["completed"], s["lane_steps"])
        check(got == want, f"child {s['proc']} launched {got}, expected "
              f"{want}")
        for k, v in got.items():
            by_kernel[k] = by_kernel.get(k, 0) + v
    return by_kernel


# ---------------------------------------------------------------------------
# the sharded paths (sharding/, launch/)
# ---------------------------------------------------------------------------
#: the decode kernel's log-sum-exp against the plain version's: both sum
#: the same float32 exponentials, in other orders, and take one log; a sum
#: of n positive float32 terms is off by at most n * 2**-24 of itself,
#: which the log turns into an absolute error: 1,600 keys * 2**-24 < 1e-4
LSE_TOL = 1e-4
#: the (1, 1) train step against the ctx=None step: the loss's sums over
#: 151,936 vocabulary columns and 4,096 tokens run in other orders (the
#: sharded cross entropy's max and sum against torch.logsumexp), a float32
#: relative error of about sqrt(V) * 2**-24 < 2.5e-5 each, below this
SHARDED_LOSS_RTOL = 1e-4
#: the two-rank runs' limit against the single-rank run of the same tree,
#: per gradient leaf as the norm of the difference over the norm, in
#: float32: the TP all-reduce adds two float32 partial sums where one
#: product summed them all and the DP bucket adds two halves of the batch,
#: a few float32 units of each sum (2**-24 each); 1e-4 leaves room for the
#: softmax's and two layers' amplification.  (In bfloat16 the MoE's router
#: logits, rounded to 8 bits, tie at the top-k boundary, and a product
#: taken over half the tokens rounds them otherwise: a re-routed token
#: moves its experts' gradients by percents, so the comparison runs in
#: float32.)
TWO_RANK_RTOL = dict(loss=1e-5, grad=1e-4)
#: the two-rank phase's models, float32, full width cut to 2 layers, and
#: their meshes: qwen3-14b on (1, 2) (TP) and (2, 1) (DP: the bucket's
#: all-reduce, FSDP off); qwen3-moe-235b-a22b on (1, 2) (EP, the psum
#: branch), with capacity_factor 8, which drops no token (per-shard
#: capacity and the whole batch's would drop different ones: the
#: reference's own test).  The MoE's (2, 1) meshes, FSDP on two ranks and
#: the token gather (whose per-expert all-reduces each cross the host
#: under gloo), run in the CPU tests.  The last field: whether the two
#: ranks hold their references on the card at once (qwen3: 2 x 17.7 GB),
#: or one after the other on the host (the MoE's float32 parameters and
#: gradients take 48.8 GB)
TWO_RANK_ARCHS = (("qwen3-14b", 2, {}, (((1, 2), {}), ((2, 1),
                                                        {"fsdp": False})),
                   True),
                  ("qwen3-moe-235b-a22b", 2, {"capacity_factor": 8.0},
                   (((1, 2), {}),), False))
TWO_RANK_BATCH, TWO_RANK_SEQ, TWO_RANK_DECODE = 2, 256, 4
#: the dry run's cells (a subprocess over a fake group of 256 ranks) and
#: the train-step cell at mesh (1, 1) whose argument bytes the card holds
DRYRUN_CELLS = (("qwen3-14b", "train_4k", "single"),
                ("qwen3-14b", "decode_32k", "single"))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def nccl_world_of_one():
    """An NCCL process group of one rank on this card, destroyed on exit
    (before any later phase spawns children)."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def decode_lse_phase(smi) -> dict:
    """``decode_attention(return_lse=True)`` at qwen3-14b's decode shape
    (the served cache of 545 and a long one of 1,600; 40/8 heads, d 128,
    bf16): its output has the bits of the call without lse, its lse is
    within LSE_TOL of the plain version's, and the cache cut into 2 and 4
    sequence slices, each attended by the kernel and merged by their lse
    (``collectives.lse_merge``, the formula ``lse_combine`` all-reduces),
    is within three bfloat16 roundings of the uncut call (each slice's
    output, the merge's, the uncut output's); both calls timed."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref
    from repro_torch.models.layers import _local_window
    from repro_torch.sharding.collectives import lse_merge

    rows = []
    for case, S, length, seed in (("served cache", PROMPT + TOKENS + 1,
                                   PROMPT + TOKENS + 1, 50),
                                  ("long cache", 1600, 1600, 51)):
        rng = np.random.default_rng(seed)
        q, k, v = (torch.from_numpy(rng.standard_normal(s)).to(
            "cuda", torch.bfloat16) for s in ((1, 40, 128), (1, S, 8, 128),
                                              (1, S, 8, 128)))
        out = decode_attention(q, k, v, length)
        out2, lse = decode_attention(q, k, v, length, return_lse=True)
        check(torch.equal(out, out2), f"decode_lse {case}: the output "
              f"changed with return_lse")
        _, lse_ref = decode_attention_ref(q, k, v, length, return_lse=True)
        lse_err = (lse - lse_ref).abs().max().item()
        check(lse_err <= LSE_TOL, f"decode_lse {case}: lse off by {lse_err}"
              f" (limit {LSE_TOL})")
        slice_err = {}
        for n in (2, 4):
            per = -(-S // n)
            parts = [decode_attention(q, k[:, i * per:(i + 1) * per],
                                      v[:, i * per:(i + 1) * per],
                                      _local_window(i * per, min(per, S - i * per),
                                                    length, 0)[0],
                                      return_lse=True) for i in range(n)]
            lses = torch.stack([l for _, l in parts])
            merged = lse_merge(torch.stack([o for o, _ in parts]),
                               lses).float()
            # each slice's output rounds once to bfloat16 (u = 2**-8 of
            # itself) before the merge, the merge once more, the uncut
            # output once: the merge of the slices' |o| bounds the first
            abs_merged = lse_merge(torch.stack([o.float().abs()
                                                for o, _ in parts]), lses)
            bound = BF16_ROUND * (abs_merged + merged.abs()
                                  + out.float().abs()) + \
                ATTN_TOL[torch.bfloat16]["atol"]
            diff = (merged - out.float()).abs()
            ok = bool((diff <= bound).all())
            slice_err[n] = diff.max().item()
            check(ok, f"decode_lse {case}: {n} slices merged off by "
                  f"{slice_err[n]}")
        row = {"phase": "decode_lse", "case": case, "S": S,
               "length": length, "H": 40, "KV": 8, "d": 128,
               "dtype": "bfloat16", "out_bits_equal": True,
               "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
               "slices_max_abs_err": slice_err,
               "ms": device_ms(lambda: decode_attention(q, k, v, length),
                               cold_l2=True),
               "ms_lse": device_ms(lambda: decode_attention(
                   q, k, v, length, return_lse=True), cold_l2=True),
               "card": smi}
        emit(row)
        rows.append(row)
    return rows[0]


def _greedy(params, cfg, prompts, ctx, steps):
    """Prefill ``prompts`` and ``steps`` greedy decode steps; returns
    (tokens, every step's logits on the host, launches, seconds)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    cache, logits = lm.prefill(params, cfg, {"tokens": prompts}, ctx,
                               max_len=prompts.shape[1] + steps + 1)
    out, toks = [logits.float().cpu()], [logits.argmax(-1)]
    for _ in range(steps):
        cache, logits = lm.decode_step(params, cfg, cache, toks[-1], ctx)
        out.append(logits.float().cpu())
        toks.append(logits.argmax(-1))
    torch.cuda.synchronize()
    return (torch.cat(toks, 1).cpu(), out, launch_counts(),
            time.perf_counter() - t0)


def sharded_serve_phase(cfg, model, smi) -> dict:
    """qwen3-14b at full width and depth (the serving phase's seed-0 bf16
    model), 4 prompts of 512 tokens and 31 greedy decode steps through
    ``lm.prefill``/``lm.decode_step`` with ``make_ctx`` on an NCCL mesh of
    one rank, (1, 1) ``("data", "model")``, and again under
    ``seq_shard_cache`` (the lse-combine path): the tokens equal the
    ``ctx=None`` path's, its logits the same bits on the (1, 1) path (the
    same arithmetic: every collective is on one rank) and within the
    decode tolerance under ``seq_shard_cache``; launches exact."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import make_ctx

    steps = TOKENS - 1
    prompts = torch.from_numpy(np.random.default_rng(60).integers(
        0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)).to("cuda")
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * steps, "tile_matmul": 0,
            "ssd_scan": 0, "adamw": 0, "flash_attention_bwd": 0}
    toks0, logits0, _, s0 = _greedy(model, cfg, prompts, None, steps)
    rows = {}
    with nccl_world_of_one():
        mesh = make_debug_mesh(1, 1)
        for name, seq in (("mesh_1x1", False), ("seq_shard_cache", True)):
            ctx = make_ctx(mesh, cfg)
            ctx.seq_shard_cache = seq
            local = lm.shard_params(model, ctx, copy=False)
            C.reset_counts()
            toks, logits, launches, s = _greedy(local, cfg, prompts, ctx,
                                                steps)
            same = all(torch.equal(a, b) for a, b in zip(logits, logits0))
            err = max((a - b).abs().max().item()
                      for a, b in zip(logits, logits0))
            check(torch.equal(toks, toks0), f"sharded_serve {name}: tokens "
                  f"differ from ctx=None's")
            check(launches == want, f"sharded_serve {name}: launches "
                  f"{launches}, expected {want}")
            if seq:
                check(all(torch.allclose(a, b, **ATTN_TOL[torch.bfloat16])
                          for a, b in zip(logits, logits0)),
                      f"sharded_serve {name}: logits off by {err}")
            else:
                check(same, f"sharded_serve {name}: logits differ from "
                      f"ctx=None's by {err}")
            rows[name] = {"tokens_equal": True, "logits_bits_equal": same,
                          "logits_max_abs_err": err, "launches": launches,
                          "collectives": C.counts()["total_count"],
                          "seconds": s}
            del local
    row = {"phase": "sharded_serve", "arch": cfg.name, "layers":
           cfg.n_layers, "batch": BATCH, "prompt": PROMPT,
           "decode_steps": steps, "ctx_none_seconds": s0, **rows,
           "card": smi}
    emit(row)
    return row


def _held_bytes(params, opt, batch) -> int:
    from repro_torch.launch.dryrun import tree_bytes
    return tree_bytes(params) + tree_bytes(opt) + tree_bytes(
        {k: torch.as_tensor(v) for k, v in batch.items()})


def sharded_train_step_phase(smi, train_row: dict) -> dict:
    """``train_step_phase``'s cell (qwen3-14b at full width cut to 4
    layers, bf16, seq 1,024, batch 4 in 2 microbatches, hybrid) through
    ``make_ctx`` (FSDP on) and ``grad_pspecs`` on an NCCL mesh of one rank:
    step 1's loss within SHARDED_LOSS_RTOL of the ``ctx=None`` step's and
    its parameters within 2 lr plus a bf16 unit of it; the same bits
    twice; serial equal to hybrid to the
    bit; 8 steps, flash launches exactly 16 a step; step ms, a profiled
    step's busy share and NCCL kernels, the collectives' count and bytes
    a step, beside the ``ctx=None`` train step's (``train_row``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_params, lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import make_ctx
    from repro_torch.train import StepConfig, make_train_step

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH, seed=0))
    gc.collect()
    torch.cuda.empty_cache()
    batch0 = data.batch_at(0)
    model = init_params(cfg, seed=0, device="cuda")
    opt = adamw_init(model)
    plain = make_train_step(cfg, opt_cfg, None, StepConfig(
        microbatches=TRAIN_MICRO, overlap="hybrid"))
    model, opt, m_plain = plain(model, opt, batch0)
    plain_params = {n: p.detach().cpu() for n, p in model.named_parameters()}
    plain_loss = float(m_plain["loss"])
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    with nccl_world_of_one():
        ctx = make_ctx(make_debug_mesh(1, 1), cfg)
        check(ctx.fsdp, "FSDP is on by default")

        def first(overlap):
            local = lm.shard_params(init_params(cfg, seed=0, device="cuda"),
                                    ctx, copy=False)
            opt = adamw_init(local)
            step = make_train_step(cfg, opt_cfg, ctx, StepConfig(
                microbatches=TRAIN_MICRO, overlap=overlap),
                grad_pspecs=lm.param_pspecs(cfg, ctx))
            local, opt, m = step(local, opt, batch0)
            return local, opt, step, float(m["loss"])

        serial, _, _, loss_serial = first("serial")
        serial_params = {n: p.detach().cpu()
                         for n, p in serial.named_parameters()}
        del serial
        again, _, _, loss_again = first("hybrid")
        again_params = {n: p.detach().cpu()
                        for n, p in again.named_parameters()}
        del again
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        local, opt, step, loss1 = first("hybrid")
        held = _held_bytes(local, opt, batch0)
        same_twice = loss1 == loss_again and all(
            torch.equal(p.detach().cpu(), again_params[n])
            for n, p in local.named_parameters())
        serial_equal = loss1 == loss_serial and all(
            torch.equal(p.detach().cpu(), serial_params[n])
            for n, p in local.named_parameters())
        share, worst, allowed = _params_differ(local, plain_params,
                                               opt_cfg.lr)
        del again_params, serial_params, plain_params
        check(abs(loss1 - plain_loss) <= SHARDED_LOSS_RTOL * plain_loss,
              f"sharded train step: loss {loss1} against ctx=None's "
              f"{plain_loss}")
        # a step-1 AdamW update is lr * g / (|g| + eps), at most lr in
        # size whatever g: two step-1 results from one start are at most
        # 2 lr (plus a bf16 unit) apart; the share that differs at all
        # (the cross entropy's float32 sums, the embedding's backward) is
        # printed, not gated
        check(worst <= allowed, f"sharded train step vs ctx=None: "
              f"parameters up to {worst} apart (limit {allowed}; "
              f"{share:.3g} of them differ)")
        check(same_twice, "sharded train step: two runs differ")
        check(serial_equal, "sharded train step: serial and hybrid differ")
        losses, step_s, launches, colls = [loss1], [], [], []
        for i in range(1, TRAIN_STEPS):
            batch = data.batch_at(i)
            torch.cuda.synchronize()
            reset_launch_counts()
            C.reset_counts()
            t1 = time.perf_counter()
            local, opt, m = step(local, opt, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            launches.append(launch_counts())
            colls.append(C.counts())
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated()
        want = train_launches(cfg, len(list(local.parameters())))
        check(all(c == want for c in launches), f"sharded train step "
              f"launches {launches[0]}, expected {want}")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            local, opt, _ = step(local, opt, data.batch_at(TRAIN_STEPS))
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t1
        dev_rows = _device_rows(prof)
        device_s = sum(r[0] for r in dev_rows) / 1e6
        nccl = sum(c for _, k, c in dev_rows if "nccl" in k.lower())
        del local, opt, step
    med = sorted(step_s)[len(step_s) // 2]
    row = {"phase": "sharded_train_step", "arch": cfg.name,
           "layers": cfg.n_layers, "mesh": [1, 1], "fsdp": True,
           "microbatches": TRAIN_MICRO, "overlap": "hybrid",
           "loss_step1": loss1, "ctx_none_loss_step1": plain_loss,
           "params_differ_share": share, "max_abs_diff": worst,
           "allowed": allowed, "same_bits_twice": same_twice,
           "serial_equals_hybrid": serial_equal, "losses": losses,
           "step_s": step_s, "median_step_ms": med * 1e3,
           "ctx_none_median_step_ms": train_row["median_step_ms"],
           "flash_launches_per_step": launches[0]["flash_attention"],
           "flash_launches": sum(c["flash_attention"] for c in launches),
           "flash_bwd_launches": sum(c["flash_attention_bwd"]
                                     for c in launches),
           "adamw_launches": sum(c["adamw"] for c in launches),
           "collectives_per_step": colls[0]["total_count"],
           "collective_bytes_per_step": colls[0]["total_bytes"],
           "nccl_kernels_per_step": nccl,
           "device_busy_share": device_s / prof_wall,
           "ctx_none_device_busy_share": train_row["device_busy_share"],
           "held_bytes": held, "peak_memory_bytes": peak, "card": smi}
    emit(row)
    gc.collect()
    torch.cuda.empty_cache()
    return row


def _staggered(rank: int, make):
    """``make()`` on rank 0, then on rank 1 (each draws a whole model for a
    moment before cutting its shards: one at a time fits the card)."""
    import torch.distributed as dist
    out = None
    gc.collect()
    torch.cuda.empty_cache()
    for r in (0, 1):
        if r == rank:
            out = make()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def _diff_sq(g: torch.Tensor, r: torch.Tensor, rows: int = 1 << 24):
    """``(|g - r|^2, |r|^2)`` in float64 for ``g`` on the card and ``r`` on
    the card or the host, a few million elements at a time."""
    g, r = g.reshape(-1), r.reshape(-1)
    d2 = r2 = 0.0
    for i in range(0, g.numel(), rows):
        rc = r[i:i + rows].to(g.device, torch.float64)
        d2 += (g[i:i + rows].double() - rc).pow(2).sum().item()
        r2 += rc.pow(2).sum().item()
    return d2, r2


def two_rank_child(rank: int, port: int, out: str) -> None:
    """One of the two gloo ranks on the card.  For each TWO_RANK_ARCHS
    model each rank runs the single-rank reference on the whole batch
    (the loss and every gradient of ``lm.loss_fn``, and greedy decoding);
    then on each of the model's meshes, (1, 2) (TP = EP = 2, the MoE's
    psum branch) or (2, 1) (DP = 2), each rank compares every shard
    of every gradient with the same slice of the reference's, the squared
    norms of the difference and of the reference added over the ranks
    (each shard counted once), and on (1, 2) the greedy tokens; rank 0
    writes the results to ``out`` (JSON)."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_params, lm
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import make_ctx
    from repro_torch.sharding.rules import local_slices
    from repro_torch.train import steps

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    results = []
    try:
        for arch, layers, extra, meshes, ref_on_card in TWO_RANK_ARCHS:
            cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                      dtype="float32", **extra)
            rng = np.random.default_rng(70)
            tokens = rng.integers(0, cfg.vocab_size,
                                  (TWO_RANK_BATCH, TWO_RANK_SEQ),
                                  dtype=np.int32)
            batch = {"tokens": torch.from_numpy(tokens).cuda(),
                     "labels": torch.from_numpy(np.roll(tokens, -1, 1)
                                                ).cuda()}
            t0 = time.perf_counter()

            def reference():
                full = init_params(cfg, 0, "cuda").requires_grad_(True)
                loss, grads = steps._value_and_grad(full, cfg, batch, True)
                toks = _greedy(full, cfg, batch["tokens"][:, :64], None,
                               TWO_RANK_DECODE)[0]
                if not ref_on_card:
                    grads = {n: g.cpu() for n, g in grads.items()}
                return float(loss), grads, toks

            ref_loss, ref, ref_toks = (reference() if ref_on_card
                                       else _staggered(rank, reference))
            torch.cuda.empty_cache()
            ref_s = time.perf_counter() - t0
            for shape, kw in meshes:
                t0 = time.perf_counter()
                ctx = make_ctx(make_debug_mesh(*shape), cfg)
                for k, v in kw.items():
                    setattr(ctx, k, v)
                ctx.make_groups()
                local = _staggered(rank, lambda: lm.shard_params(
                    init_params(cfg, 0, "cuda"), ctx).requires_grad_(True))
                i = ctx.index(ctx.batch_axes)
                per = TWO_RANK_BATCH // ctx.dp_size
                mine = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                reset_launch_counts()
                C.reset_counts()
                loss, grads = steps._value_and_grad(local, cfg, mine, True,
                                                    ctx)
                names = steps._dp_names(cfg, ctx)
                grads = steps._Bucket(grads, names, ctx.group(
                    ctx.batch_axes) if names else None, False, False).ready()
                launches, colls = launch_counts(), C.counts()
                shares, world = steps._norm_shares(cfg, ctx)
                pspecs = lm._name_pspecs(cfg, ctx)
                sums = []
                for n, g in grads.items():
                    r = ref[n][local_slices(ref[n].shape, pspecs[n],
                                            ctx.mesh)]
                    sums += [shares[n] * x for x in _diff_sq(g, r)]
                sums = torch.tensor(sums, dtype=torch.float64)
                dist.all_reduce(sums, group=world)
                errs = {n: (sums[2 * j] / sums[2 * j + 1]).sqrt().item()
                        if sums[2 * j + 1] > 0 else sums[2 * j].sqrt().item()
                        for j, n in enumerate(grads)}
                worst = sorted(errs.items(), key=lambda kv: -kv[1])[:4]
                row = {"arch": arch, "dtype": "float32", "mesh": list(shape),
                       "options": kw, "loss": float(loss),
                       "ref_loss": ref_loss,
                       "loss_rel_err": abs(float(loss) - ref_loss) / ref_loss,
                       "launches": launches,
                       "collectives": {k: v for k, v in colls.items()
                                       if not isinstance(v, dict)
                                       or v["count"]},
                       "grad_rel_err": worst[0][1], "worst_leaves": worst,
                       "ref_s": ref_s, "mesh_s": time.perf_counter() - t0}
                del grads
                if shape == (1, 2):
                    toks, _, dl, _ = _greedy(local, cfg,
                                             batch["tokens"][:, :64], ctx,
                                             TWO_RANK_DECODE)
                    row["decode_launches"] = dl
                    row["tokens_equal"] = bool(torch.equal(toks, ref_toks))
                results.append(row)
                del local
                torch.cuda.empty_cache()
                dist.barrier()
            del ref
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(results, f)


def sharded_two_ranks_phase(smi) -> list:
    """Two gloo processes on the one card (NCCL refuses two ranks on one
    device; the collectives run on host copies) run ``two_rank_child``:
    the card sees collectives of two ranks.  Each model's loss and every
    gradient on meshes (1, 2) and (2, 1) within TWO_RANK_RTOL of the
    single-rank run's, the greedy tokens of (1, 2) (flash and decode on 20
    of 40 query heads and 4 of 8 KV heads for qwen3-14b) equal to it."""
    import tempfile

    import torch.multiprocessing as tmp

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "two_ranks.json")
        t0 = time.perf_counter()
        tmp.spawn(two_rank_child, args=(_free_port(), out), nprocs=2,
                  join=True)
        with open(out) as f:
            rows = json.load(f)
    emit({"phase": "sharded_two_ranks", "rows": rows,
          "seconds": time.perf_counter() - t0, "card": smi})
    for r in rows:
        what = f"sharded_two_ranks {r['arch']} {r['mesh']}"
        check(r["loss_rel_err"] <= TWO_RANK_RTOL["loss"], f"{what}: loss "
              f"{r['loss']} against {r['ref_loss']}")
        check(r["grad_rel_err"] <= TWO_RANK_RTOL["grad"], f"{what}: a "
              f"gradient off by {r['grad_rel_err']} of its norm")
        if "tokens_equal" in r:
            check(r["tokens_equal"], f"{what}: greedy tokens differ")
        check(r["launches"]["flash_attention"] == 2 * 2, f"{what}: flash "
              f"launches {r['launches']} (2 layers, forward and remat)")
        check(r["launches"]["flash_attention_bwd"] == 0, f"{what}: flash "
              f"backward launches {r['launches']} (float32 takes the "
              f"torch-op backward)")
    return rows


_DRYRUN_CHILD = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, perf_iter
from repro_torch.launch.mesh import make_debug_mesh
cells, cut = json.loads(sys.argv[1]), json.loads(sys.argv[2])
for arch, shape, mesh in cells:
    rec = dryrun.run_cell(arch, shape, mesh)
    rec.pop("traceback", None)
    if rec["status"] == "ok":
        rec["roofline"] = perf_iter.roofline(rec)
    print(json.dumps({"record": rec}), flush=True)
dryrun.fake_world(1)
cfg = dataclasses.replace(get_config(cut["arch"]), n_layers=cut["layers"])
cell = dryrun.build_cell(cut["arch"], "train_4k", make_debug_mesh(
    1, 1, device_type="cpu"), cfg=cfg, shape_def=cut["shape_def"],
    overrides={"micro": cut["micro"]})
print(json.dumps({"cut": dryrun.measure(cell)}), flush=True)
"""


def start_dryrun():
    """The dry run's subprocess, started at once and read at the end: it
    runs on the host's CPU (fake tensors, a fake group that must not meet
    this process's NCCL one), at the lowest priority and on one thread,
    beside the card's phases."""
    cut = {"arch": TRAIN_ARCH, "layers": TRAIN_LAYERS, "micro": TRAIN_MICRO,
           "shape_def": {"seq_len": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
                         "kind": "train"}}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    import tempfile
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        ["nice", "-n", "19", sys.executable, "-c", _DRYRUN_CHILD,
         json.dumps(DRYRUN_CELLS), json.dumps(cut)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=err, text=True)
    proc.err_file = err
    return proc


def dryrun_phase(proc, sharded_row: dict, smi) -> list:
    """The dry run's records (each cell's memory, FLOPs, collectives by
    kind and H100 roofline terms) and the (1, 1) cut cell's argument bytes,
    which must equal the bytes the sharded train step held on the card;
    its temp bytes beside the card's peak less those arguments."""
    t0 = time.perf_counter()
    stdout, _ = proc.communicate(timeout=900)
    proc.err_file.seek(0)
    stderr = proc.err_file.read()
    proc.err_file.close()
    check(proc.returncode == 0, f"the dry run failed: {stderr[-2000:]}")
    lines = [json.loads(l) for l in stdout.splitlines() if l.startswith("{")]
    records = [l["record"] for l in lines if "record" in l]
    cut = [l["cut"] for l in lines if "cut" in l][0]
    for rec in records:
        check(rec["status"] == "ok", f"dry run {rec['arch']} {rec['shape']}:"
              f" {rec.get('error')}")
        emit({"phase": "dryrun", **rec, "card": smi})
    args = cut["memory"]["argument_size_in_bytes"]
    held = sharded_row["held_bytes"]
    check(args == held, f"the (1, 1) dry run counts {args} argument bytes, "
          f"the sharded train step held {held}")
    on_card = sharded_row["peak_memory_bytes"] - held
    emit({"phase": "dryrun_vs_card", "argument_bytes": args,
          "held_bytes": held, "temp_bytes": cut["memory"][
              "temp_size_in_bytes"], "card_peak_less_arguments": on_card,
          "temp_over_card": cut["memory"]["temp_size_in_bytes"] / on_card,
          "flops": cut["hlo_dot_flops"], "collectives": cut["collectives"],
          "wait_s": time.perf_counter() - t0, "card": smi})
    return records


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=7680,
                    help="matrix order (paper sizes: 7680, 12288, 18432)")
    ap.add_argument("--tile", type=int, default=192, help="tile width b")
    ap.add_argument("--requests", type=int, default=8,
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
    # the dry run (CPU, fake tensors) runs beside every card phase
    dry = start_dryrun()
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
    lse_row = decode_lse_phase(smi)
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
    # the MoE, VLM and enc-dec models' attention: llama-3.2-vision's cross
    # prefill (512 prompt tokens over 1,600 patches) and cross decode,
    # seamless-m4t's encoder (1,000 frames, non-causal), cross prefill (a
    # 16-token prompt over them) and cross decode, qwen3-moe's prefill and
    # decode with 16 query heads per KV head; each timed in bfloat16 and the
    # flash shapes in float32 too
    flash_case(f"prefill cross llama-vision Sq={PROMPT} Sk=1600", PROMPT, 0,
               seed=30, H=32, KV=8, Sk=1600, causal=False, time_float32=True)
    flash_case("encoder seamless S=1000 non-causal", 1000, 0, seed=31, H=16,
               KV=16, d=64, causal=False, time_float32=True)
    flash_case("prefill cross seamless Sq=16 Sk=1000", 16, 0, seed=32, H=16,
               KV=16, d=64, Sk=1000, causal=False, time_float32=True)
    flash_case(f"prefill qwen3-moe S={PROMPT} causal (64/4 heads)", PROMPT, 0,
               seed=33, H=64, KV=4, time_float32=True)
    # the decoders' causal self-attention prefill: llama-3.2-vision's
    # (32/8 heads) and seamless-m4t's 16-token prompt, the one causal use of
    # the head-dim-64 template on a served path
    flash_case(f"prefill llama-vision S={PROMPT} causal (32/8 heads)", PROMPT,
               0, seed=41, H=32, KV=8)
    flash_case("prefill seamless decoder S=16 causal d=64", 16, 0, seed=42,
               H=16, KV=16, d=64)
    # the trainer's attention (the 100m configuration's microbatch of 4,
    # 12/4 heads at d = 64, S = 256, causal), which trains in float32
    flash_case("trainer 100m S=256 causal (12/4 heads, d=64)", 256, 0,
               seed=44, B=4, H=12, KV=4, d=64, time_float32=True)
    # needles: the weight on key Sk - 1; every real key far below zero with
    # needles stored past Sk, which must stay out of the sum
    flash_case(f"cross Sq={PROMPT} Sk=1600 needle on the last key", PROMPT, 0,
               seed=34, H=32, KV=8, Sk=1600, causal=False, needle="last",
               timed=False)
    flash_case("encoder S=1000 needle on the ragged last key", 1000, 0,
               seed=35, H=16, KV=16, d=64, causal=False, needle="last",
               timed=False)
    flash_case("cross Sq=16 Sk=1000 keys past Sk ignored", 16, 0, seed=36,
               H=16, KV=16, d=64, Sk=1000, causal=False, needle="past",
               timed=False)
    flash_case("encoder S=1000 keys past Sk ignored", 1000, 0, seed=37,
               H=16, KV=16, d=64, causal=False, needle="past", timed=False)
    decode_case("decode cross llama-vision length=1600", 1600, 1600, 0,
                seed=38, H=32, KV=8)
    decode_case(f"decode qwen3-moe group of 16 S={max_len}", max_len,
                max_len, 0, seed=39, H=64, KV=4)
    decode_case("decode cross seamless length=1000 d=64", 1000, 1000, 0,
                seed=40, H=16, KV=16, d=64)
    # seamless-m4t's self-attention decode: its 16 + 32 + 1-token cache
    decode_case("decode seamless S=49 length=48 d=64", 49, 48, 0, seed=43,
                H=16, KV=16, d=64)
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
    # worker processes: spawned after every kernel library was built above
    mp_launches = cholesky_mp_phase(args.n, t, smi, n_seeds=MP_SEEDS)
    gc.collect()
    torch.cuda.empty_cache()

    batch_rows = {}
    for arch, poisson, layers in SERVE_ARCHS:
        cfg, model, floor_bytes = serving_model(arch, layers)
        batch_rows[arch], state = serving_batch_phase(cfg, model,
                                                      floor_bytes, smi)
        if poisson:
            # the compiled serves run for the models with a Poisson phase:
            # qwen3-14b (dense) and zamba2-7b (hybrid)
            batch_rows[arch]["compiled_decode_attention_launches"] = \
                serving_compiled_phase(cfg, model, batch_rows[arch],
                                       state.tokens(), smi)
            poisson_row, poisson_tokens = serving_poisson_phase(
                cfg, model, args.requests, smi)
        serving_profile_phase(cfg, model, state, floor_bytes, smi)
        if arch == "qwen3-14b":
            # the sharded paths on a mesh of one rank, on the same model
            sharded_serve = sharded_serve_phase(cfg, model, smi)
        if arch == MP_SERVE_ARCH:
            # sharded serving while the parent's model is loaded (the
            # engine's rescue needs it); three copies of qwen3-14b would
            # not fit the card
            serving_mp = serving_mp_phase(cfg, model, args.requests,
                                          poisson_row, poisson_tokens, smi,
                                          layers=cfg.n_layers)
        del model, state                  # free the card for the next model
        gc.collect()
        torch.cuda.empty_cache()

    # the MoE layer against its per-expert loop at full width, then the
    # MoE, VLM and enc-dec models
    moe_check_phase(smi)
    gc.collect()
    torch.cuda.empty_cache()
    for arch, layers, prompt_len, n_poisson in NEW_SERVE:
        cfg, model, floor_bytes = serving_model(arch, layers)
        batch_rows[arch], state = serving_batch_phase(
            cfg, model, floor_bytes, smi, prompt_len=prompt_len)
        if n_poisson:
            serving_poisson_phase(cfg, model, n_poisson, smi)
        serving_profile_phase(cfg, model, state, floor_bytes, smi,
                              prompt_len=prompt_len)
        del model, state
        gc.collect()
        torch.cuda.empty_cache()

    # training: flash attention's gradient, the train step at full width,
    # the trainer with a preemption and a restart
    flash_train, flash_train_long = train_flash_grad_phase(smi)
    ssd_train = train_ssd_grad_phase(smi)
    ssm_decode_matches_forward_phase(smi)
    train_ssm_grad_vs_cpu_phase(smi)
    train_row = train_step_phase(smi)
    sharded_train = sharded_train_step_phase(smi, train_row)
    two_ranks = sharded_two_ranks_phase(smi)
    ssm_rows = train_step_ssm_phase(smi)
    train_ssm_seed_witness_phase(smi)
    trainer_row = trainer_phase(smi)
    trainer_lr_witness_phase(smi)
    dryrun_phase(dry, sharded_train, smi)

    def line(name, case, launches, source=None):
        return {"name": name, "route": "cuda",
                "source": f"{CSRC}/{source or name}.cu",
                "replaces": REPLACES[name],
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
               f"qr_compiled_n{half}": compiled_qr_launches,
               **mp_launches}
    gemm = line("tile_matmul", main_case, sum(by_path.values()))
    gemm["launches_by_path"] = by_path
    qwen = batch_rows["qwen3-14b"]
    # the MoE, VLM and enc-dec models' batch paths, each counted alone
    new_paths = {f"serving_{arch}": batch_rows[arch]
                 for arch, _, _, _ in NEW_SERVE}
    zamba = batch_rows["zamba2-7b"]
    decode_by_path = {
        "serving": qwen["decode_attention_launches"],
        "serving_zamba2-7b": zamba["decode_attention_launches"],
        "serving_compiled": qwen["compiled_decode_attention_launches"],
        "serving_mp": serving_mp["decode_attention"],
        **{k: r["decode_attention_launches"] for k, r in new_paths.items()},
        # the sharded serve on a mesh of one rank, and under
        # seq_shard_cache (lse and its combine); rank 0's decode on 20/4
        # heads of the two-rank mesh (1, 2)
        "sharded_serve": sum(sharded_serve[k]["launches"]["decode_attention"]
                             for k in ("mesh_1x1", "seq_shard_cache")),
        "sharded_two_ranks": sum(r.get("decode_launches", {}).get(
            "decode_attention", 0) for r in two_ranks)}
    decode = line("decode_attention", decode_main,
                  sum(decode_by_path.values()))
    decode["launches_by_path"] = decode_by_path
    decode["lse"] = {k: lse_row[k] for k in ("ms", "ms_lse",
                                             "lse_max_abs_err", "S")}
    # the sharded serve (zamba2-7b) in the children, beside each kernel's
    # single-process serving path
    # training: the train step's 8 steps, the trainer's 40 (each step's
    # forward and its remat recompute launch the kernel)
    flash_by_path = {"serving": qwen["flash_attention_launches"],
                     "serving_zamba2-7b": zamba["flash_attention_launches"],
                     "serving_mp": serving_mp["flash_attention"],
                     **{k: r["flash_attention_launches"]
                        for k, r in new_paths.items()},
                     "train_step": train_row["flash_launches"],
                     "train_step_zamba2-7b":
                         ssm_rows["zamba2-7b"]["flash_launches"],
                     "trainer": trainer_row["flash_launches"],
                     "sharded_serve": sum(
                         sharded_serve[k]["launches"]["flash_attention"]
                         for k in ("mesh_1x1", "seq_shard_cache")),
                     "sharded_train_step": sharded_train["flash_launches"],
                     "sharded_two_ranks": sum(
                         r["launches"]["flash_attention"]
                         + r.get("decode_launches", {}).get(
                             "flash_attention", 0) for r in two_ranks)}
    flash = line("flash_attention", flash_main, sum(flash_by_path.values()))
    flash["launches_by_path"] = flash_by_path
    # the forward + backward pair at qwen3's training shape (bf16): the
    # backward kernel's, the kernel forward with the torch-op backward's
    flash["train_pair"] = {k: flash_train[k] for k in (
        "ms", "torch_op_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "forward_ms", "max_abs_err")}
    # the backward kernel: every bfloat16 train step's backwards (one a
    # microbatch and attention layer or use), each path counted with the
    # counts reset just before it; the trainer and the two-rank children
    # train in float32 and take the torch-op backward.  Its case is the
    # pair at the S = 4,096 train cell's microbatch, the short cell's
    # beside it
    bwd_by_path = {"train_step": train_row["flash_bwd_launches"],
                   **{f"train_step_{arch}": r["flash_bwd_launches"]
                      for arch, r in ssm_rows.items()},
                   "sharded_train_step": sharded_train["flash_bwd_launches"],
                   "trainer": trainer_row["flash_bwd_launches"],
                   "sharded_two_ranks": sum(
                       r["launches"]["flash_attention_bwd"]
                       for r in two_ranks)}
    flash_bwd = line("flash_attention_bwd", flash_train_long,
                     sum(bwd_by_path.values()), source="flash_attention")
    flash_bwd["launches_by_path"] = bwd_by_path
    flash_bwd["shape"] = {k: flash_train_long[k] for k in (
        "B", "H", "KV", "Sq", "Sk", "d", "causal", "window")}
    flash_bwd["torch_op_ms"] = flash_train_long["torch_op_ms"]
    flash_bwd["forward_ms"] = flash_train_long["forward_ms"]
    flash_bwd["train_pair_s1024"] = flash["train_pair"]
    # serving: zamba2-7b's and mamba2-2.7b's batch paths and the sharded
    # serve; training: each SSM train step's 8 steps
    scan_by_path = {"serving": zamba["ssd_scan_launches"],
                    "serving_mamba2-2.7b":
                        batch_rows["mamba2-2.7b"]["ssd_scan_launches"],
                    "serving_mp": serving_mp["ssd_scan"],
                    **{f"train_step_{arch}": r["scan_launches"]
                       for arch, r in ssm_rows.items()}}
    scan = line("ssd_scan", ssd_main, sum(scan_by_path.values()))
    scan["launches_by_path"] = scan_by_path
    # the forward + backward pair at mamba2's training shape (float32)
    scan["train_pair"] = {k: ssd_train[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "forward_ms", "max_abs_err")}
    # AdamW: every train step's update (qwen3-14b, the SSM models, the
    # sharded step on a mesh of one rank) and the trainer's; the case is
    # the kernel against its plain version on qwen3-14b's step gradients
    adamw_by_path = {"train_step": train_row["adamw_launches"],
                     **{f"train_step_{arch}": r["adamw_launches"]
                        for arch, r in ssm_rows.items()},
                     "sharded_train_step": sharded_train["adamw_launches"],
                     "trainer": trainer_row["adamw_launches"]}
    adamw = line("adamw", train_row["adamw"], sum(adamw_by_path.values()))
    adamw["launches_by_path"] = adamw_by_path
    adamw["step_gradients"] = {k: train_row["adamw"][k] for k in (
        "leaves", "params", "grad_norm", "kernel_grad_norm", "scale",
        "elements_differ")}
    emit({"phase": "elapsed", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [gemm, flash, decode, scan, adamw, flash_bwd]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
