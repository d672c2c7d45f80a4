"""trinity-mini [moe] — AfMoE: 128 sigmoid-routed experts top-8 plus one
shared expert, 2 leading dense layers, gated attention with four norms a
layer, 3 sliding-window (2,048) layers to 1 global layer without rope
[hf:arcee-ai/Trinity-Mini config.json].

The published keys map one to one (``num_dense_layers`` 2,
``intermediate_size`` 6,144 for the dense MLPs, ``moe_intermediate_size``
1,024 for each routed and the shared expert, ``score_func`` sigmoid,
``route_norm`` and ``route_scale`` 2.826, ``global_attn_every_n_layers``
4, ``sliding_window`` 2,048, ``mup_enabled``).  Not in the config, and
taken from the family's description: the sigmoid gate on the attention
output, the post-sublayer norms, no rope on the global layers and the
embedding scaled by sqrt(d_model); the experts' selection bias is a
checkpoint buffer (its training-time update is not part of serving).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="trinity-mini",
    family="moe",
    n_layers=32,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,          # GQA
    head_dim=128,
    d_ff=6144,             # the two leading dense layers' MLP
    vocab_size=200192,
    qk_norm=True,
    rope_theta=1e4,        # sliding layers; global layers have no rope
    window=2048,
    local_global_ratio=3,  # layers 3, 7, 11, ... are global
    global_rope_theta=0.0,
    attn_gate=True,
    sandwich_norm=True,
    embed_scale=True,
    n_experts=128,
    top_k=8,
    d_expert=1024,
    shared_expert=True,
    d_shared=1024,         # moe_intermediate_size x num_shared_experts
    capacity_factor=0.0,   # dropless
    n_dense_layers=2,
    router_score="sigmoid",
    route_scale=2.826,
    norm_eps=1e-5,
)
