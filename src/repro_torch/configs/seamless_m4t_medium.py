"""seamless-m4t-medium [audio] — enc-dec transformer backbone
[arXiv:2308.11596; hf].  The audio frontend is a stub: input_specs() provides
precomputed frame embeddings (B, S_src, d_model)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,           # decoder layers
    enc_layers=12,         # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,         # MHA
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
)
