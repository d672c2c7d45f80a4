"""LM substrate of the port: configs, the dense layers and model, and the
decode-step serving graphs.

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
    params_from_reference,
    prefill,
    zeros_cache,
)
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
    "cache_struct",
    "decode_step",
    "init_params",
    "model_spec",
    "params_from_reference",
    "prefill",
    "zeros_cache",
]
