"""The operations and bytes an AfMoE cell's metrics count, from the
configuration file's published keys (the program's arithmetic is not
read, so a change to the program cannot move the ruler)."""

from __future__ import annotations

from typing import Any, Dict

from portbench.generate_afmoe import is_global
from portbench.yardstick import causal_pairs


def window_pairs(seq: int, window: int) -> int:
    """(query, key) pairs a causal attention keeps within ``window``
    (``q - k < window``)."""
    if seq <= window:
        return causal_pairs(seq)
    return causal_pairs(window) + (seq - window) * window


def prefill_flops(cfg: Dict[str, Any], seq: int) -> float:
    """One prompt's forward FLOPs, 2 a multiply-add: for every position the
    attention's projections (q, k, v, o and the gate), the dense layers'
    MLPs, the MoE layers' router and ``num_experts_per_tok`` routed and
    ``num_shared_experts`` shared experts; attention's QK^T and PV over the
    kept pairs (causal, within the window on sliding layers); the
    unembedding of the one sampled position."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    n, dense = cfg["num_hidden_layers"], cfg["num_dense_layers"]
    fe = cfg["moe_intermediate_size"]
    proj = d * hd * (3 * h + 2 * kv)
    mlp = 3 * d * cfg["intermediate_size"]
    moe = d * cfg["num_experts"] + 3 * d * fe * (
        cfg["num_experts_per_tok"] + cfg["num_shared_experts"])
    per_pos = n * proj + dense * mlp + (n - dense) * moe
    pairs = sum(causal_pairs(seq) if g else
                window_pairs(seq, cfg["sliding_window"])
                for g in is_global(cfg))
    return 2.0 * per_pos * seq + 4.0 * h * hd * pairs \
        + 2.0 * d * cfg["vocab_size"]


def expert_call_bound_s(cfg: Dict[str, Any], pairs: int,
                        peak_flops: float, bytes_per_s: float,
                        itemsize: int = 2) -> float:
    """One MoE layer call's routed-expert products' least time: ``6 d
    d_e`` FLOPs a (token, expert) pair at the peak, or the bytes (every
    expert's three matrices read once, the pairs' rows read and their
    outputs written once) at the memory rate, whichever is larger."""
    d, fe, e = (cfg["hidden_size"], cfg["moe_intermediate_size"],
                cfg["num_experts"])
    ops = 6.0 * d * fe * pairs
    by = itemsize * (3 * e * d * fe + 2 * pairs * d)
    return max(ops / peak_flops, by / bytes_per_s)


def flash_prompt_bound_s(cfg: Dict[str, Any], seq: int, peak_flops: float,
                         bytes_per_s: float, itemsize: int = 2) -> float:
    """One prompt's flash forwards' least time over every layer: each
    layer's q, k, v read and its output written once at the memory rate,
    or 4 FLOPs a kept pair per head dimension (causal on global layers,
    within the window on sliding ones) at the peak, whichever is larger."""
    hd = cfg["head_dim"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    by = itemsize * hd * (2 * h * seq + 2 * kv * seq)
    total = 0.0
    for g in is_global(cfg):
        pairs = causal_pairs(seq) if g else window_pairs(
            seq, cfg["sliding_window"])
        total += max(by / bytes_per_s, 4.0 * h * hd * pairs / peak_flops)
    return total
