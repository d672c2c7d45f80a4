"""LM substrate of the port: configs, the transformer and MoE layers, the
Mamba2 (SSD) block, the models of all six families (dense, moe, ssm,
hybrid, encdec, vlm), and the decode-step serving graphs.

The reference's sharding and training names (``param_pspecs``,
``cache_pspecs``, ``loss_fn``, ``forward``, ``abstract_params``) wait for
the training slice (ROADMAP Queue A item 11).
"""

from .config import ModelConfig
from .lm import (
    LM,
    cache_struct,
    decode_step,
    init_params,
    model_spec,
    n_attn_slots,
    params_from_reference,
    prefill,
    zeros_cache,
)
from .ssm import SSM, ssd_chunked, ssm_state_spec
from .serving import (
    DecodeShard,
    DecodeState,
    build_decode_graph,
    decode_graph_key,
    greedy_sample,
    make_decode_state,
    shard_batch,
)

__all__ = [
    "DecodeShard",
    "DecodeState",
    "build_decode_graph",
    "decode_graph_key",
    "greedy_sample",
    "make_decode_state",
    "shard_batch",
    "LM",
    "ModelConfig",
    "SSM",
    "ssd_chunked",
    "ssm_state_spec",
    "cache_struct",
    "decode_step",
    "init_params",
    "model_spec",
    "n_attn_slots",
    "params_from_reference",
    "prefill",
    "zeros_cache",
]
