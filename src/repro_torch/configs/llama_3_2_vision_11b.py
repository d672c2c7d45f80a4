"""llama-3.2-vision-11b [vlm] — cross-attention image layers every 5th
layer [hf:meta-llama/Llama-3.2-11B-Vision; unverified].  The vision tower is
a stub: input_specs() provides precomputed patch embeddings (B, 1600, D)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,          # GQA
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
    cross_attn_every=5,
    n_patches=1600,
)
