"""The benchmark's yardstick: the H100's peaks, the operations and bytes of
the kernels and steps it reports against them, and percentiles.

Copied from the program (``launch/perf_iter.py``'s peaks,
``chip_smoke.train_model_flops``, ``chip_smoke.flash_case``'s bound, the
AdamW floor and the tile GEMM's byte bound, ``serving/metrics.py``'s
percentiles) so that a change to the program cannot move the ruler it is
measured with.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

#: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F64_FLOPS = 67e12          # float64 on the tensor cores (DMMA)
HBM_BYTES_PER_S = 3.35e12

#: AdamW's floor: bf16 p read and written, f32 gradient read, f32 m and v
#: read and written
ADAMW_BYTES_PER_PARAM = 2 + 2 + 4 + 8 + 8


def cholesky_flops(n: int) -> float:
    """The factorization's operations as users count them: n^3 / 3."""
    return n ** 3 / 3.0


def tile_gemm_count(nb: int) -> int:
    """The trailing-update GEMMs of a tiled Cholesky of nb x nb tiles:
    C(nb + 1, 3)."""
    return (nb + 1) * nb * (nb - 1) // 6


def tile_gemm_bound_s(b: int, itemsize: int = 8) -> float:
    """One b^3 ``C - A B^T`` tile update's least time: A, B and C read and C
    written once at the memory rate, or 2 b^3 operations at the float64
    peak, whichever is larger (the bytes, at b = 192: 0.352 us)."""
    by = 4 * b * b * itemsize / HBM_BYTES_PER_S
    ops = 2.0 * b ** 3 / PEAK_F64_FLOPS
    return max(by, ops)


def causal_pairs(sq: int) -> int:
    """(query, key) pairs a causal attention over sq positions keeps."""
    return sq * (sq + 1) // 2


def train_model_flops(n_params: int, embed_params: int, tied: bool,
                      n_layers: int, n_heads: int, head_dim: int,
                      batch: int, seq: int) -> float:
    """A dense LM train step's model FLOPs (``chip_smoke.train_model_flops``):
    6 N T over the parameters a token multiplies by (an untied embedding
    table is gathered, so it does not count), plus attention's QK^T and PV
    over the causal pairs, forward and backward (x3); remat not counted."""
    tokens = batch * seq
    flops = 6.0 * (n_params - (0 if tied else embed_params)) * tokens
    flops += 3 * 4.0 * n_heads * head_dim * batch * causal_pairs(seq) \
        * n_layers
    return flops


def prefill_model_flops(n_params: int, embed_params: int, unembed_params: int,
                        tied: bool, n_layers: int, n_heads: int,
                        head_dim: int, seq: int) -> float:
    """One prompt's forward FLOPs: 2 per multiply-add over the block
    parameters for every position, attention's QK^T and PV over the causal
    pairs, and the unembedding of the one sampled position."""
    blocks = n_params - embed_params - (0 if tied else unembed_params)
    unembed = embed_params if tied else unembed_params
    return (2.0 * blocks * seq
            + 4.0 * n_heads * head_dim * causal_pairs(seq) * n_layers
            + 2.0 * unembed)


def flash_pair_bound_s(batch: int, heads: int, head_dim: int,
                       seq: int) -> float:
    """The causal flash forward + backward pair's least time: 12 FLOPs a
    kept pair per head dimension (4 forward, 8 backward) at the bf16 peak
    (65.2 us at B 2, 40 heads, d 128, S 1,024)."""
    return (12.0 * batch * heads * head_dim * causal_pairs(seq)
            / PEAK_BF16_FLOPS)


def flash_forward_bound_s(batch: int, heads: int, kv_heads: int,
                          head_dim: int, seq: int, itemsize: int = 2) -> float:
    """One causal flash forward's least time (``chip_smoke.flash_case``): q,
    k, v read and out written once at the memory rate, or 4 FLOPs a kept
    pair per head dimension at the bf16 peak, whichever is larger."""
    by = itemsize * batch * head_dim * (2 * heads * seq + 2 * kv_heads * seq)
    ops = 4.0 * batch * heads * head_dim * causal_pairs(seq)
    return max(by / HBM_BYTES_PER_S, ops / PEAK_BF16_FLOPS)


def adamw_floor_s(n_params: int) -> float:
    return n_params * ADAMW_BYTES_PER_PARAM / HBM_BYTES_PER_S


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile over every value, interpolated linearly
    (``serving/metrics.py``'s ``_pct``)."""
    if not len(values):
        raise ValueError("a percentile of no values")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
