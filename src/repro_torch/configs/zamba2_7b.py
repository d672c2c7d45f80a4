"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; unverified].

Deviation (DESIGN.md): one shared attention+MLP block applied every 6th
layer (the real model alternates two shared blocks).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,         # MHA shared block
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    ssm_chunk=128,
)
