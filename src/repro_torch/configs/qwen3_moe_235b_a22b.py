"""qwen3-moe-235b-a22b [moe] — 128 experts top-8
[hf:Qwen/Qwen3-30B-A3B; hf]."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,          # GQA
    head_dim=128,
    d_ff=1536,             # (dense d_ff unused; experts below)
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    n_experts=128,
    top_k=8,
    d_expert=1536,
)
