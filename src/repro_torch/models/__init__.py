"""LM substrate of the port: configs, the transformer and MoE layers, the
Mamba2 (SSD) block, the models of all six families (dense, moe, ssm,
hybrid, encdec, vlm), and the decode-step serving graphs.

The training names ``forward``, ``loss_fn``, ``sharded_ce_loss`` and
``abstract_params`` run all six families, with or without a mesh; the
sharding names (``param_pspecs``, ``cache_pspecs``, ``shard_params``,
``gather_params``) lay the parameters and the decode cache out over
``torch.distributed`` device meshes, one shard per rank.
"""

from .config import ModelConfig
from .lm import (
    LM,
    abstract_params,
    cache_pspecs,
    cache_struct,
    decode_step,
    forward,
    gather_params,
    init_params,
    loss_fn,
    model_spec,
    n_attn_slots,
    param_pspecs,
    params_from_reference,
    prefill,
    shard_params,
    sharded_ce_loss,
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
    "abstract_params",
    "cache_pspecs",
    "cache_struct",
    "decode_step",
    "forward",
    "gather_params",
    "init_params",
    "loss_fn",
    "model_spec",
    "n_attn_slots",
    "param_pspecs",
    "params_from_reference",
    "prefill",
    "shard_params",
    "sharded_ce_loss",
    "zeros_cache",
]
