"""llama4-maverick-400b-a17b [moe] — 128 routed experts top-1 + shared
expert, early fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Deviation (DESIGN.md section Arch-applicability): the real model interleaves
dense/MoE layers 1:1 (hence ~400B total).  We keep EVERY assigned
hyperparameter exactly (48L, d_model 5120, 40H/kv8, d_ff 8192, vocab
202048, 128 experts top-1) in a homogeneous scan-friendly stack, which
lands at ~770B *stored* params; the *active* params per token (~17B:
shared + top-1 routed + attention) match a17b, so the roofline compute
terms are faithful.  The dry-run proves the stored size still fits.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,          # GQA
    head_dim=128,
    d_ff=8192,             # shared-expert width
    vocab_size=202048,
    rope_theta=5e5,
    n_experts=128,
    top_k=1,
    d_expert=8192,
    shared_expert=True,
)
