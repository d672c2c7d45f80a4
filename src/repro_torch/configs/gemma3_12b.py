"""gemma3-12b [dense] — 5:1 local:global sliding window, 128k context
[hf:google/gemma-3-1b-pt; unverified]."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,          # GQA
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    qk_norm=True,
    window=1024,           # local layers: 1024-token sliding window
    local_global_ratio=5,  # 5 local : 1 global
    rope_theta=1e4,        # local layers' theta
    global_rope_theta=1e6,
    tie_embeddings=True,
)
