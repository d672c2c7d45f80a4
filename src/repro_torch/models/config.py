"""Unified model configuration covering all assigned architecture families
(dense / MoE / SSM / hybrid / enc-dec / VLM).

A copy of the reference package's ``repro/models/config.py`` as data; the
one change is ``torch_dtype`` in place of the JAX dtype property.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000

    # attention variants
    qk_norm: bool = False
    rope_theta: float = 1e4
    window: int = 0              # sliding-window size for local layers (0 = full)
    local_global_ratio: int = 0  # gemma3: N local layers per global layer
    global_rope_theta: float = 0.0  # global layers' rope theta (0 = no rope)
    attn_logit_softcap: float = 0.0
    tie_embeddings: bool = False
    attn_gate: bool = False      # afmoe: o * sigmoid(x wgate) before wo
    sandwich_norm: bool = False  # afmoe: sublayer outputs normed before the add
    embed_scale: bool = False    # afmoe (muP): embeddings times sqrt(d_model)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    shared_expert: bool = False
    d_shared: int = 0         # shared expert's width (0 = d_ff or d_expert)
    capacity_factor: float = 1.25  # 0 = dropless: every routed pair computed
    moe_every: int = 1        # llama4: 2 => alternate dense/MoE layers
    n_dense_layers: int = 0   # afmoe: leading layers with a d_ff MLP
    router_score: str = "softmax"  # "softmax" | "sigmoid" (with expert bias)
    route_scale: float = 1.0  # routed weights' scale after renormalising

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0          # hybrid: shared attention block period

    # enc-dec
    enc_layers: int = 0
    # vlm
    cross_attn_every: int = 0
    n_patches: int = 0

    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    # ----------------------------------------------------------------- #
    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim if self.ssm_state else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model if self.ssm_state else 0

    def validate(self) -> "ModelConfig":
        assert self.family in ("dense", "moe", "ssm", "hybrid", "encdec", "vlm"), self.family
        if self.family in ("dense", "moe", "encdec", "vlm"):
            assert self.n_heads > 0 and self.head_dim > 0
            assert self.n_heads % max(1, self.n_kv_heads) == 0
        if self.family == "moe":
            assert self.n_experts > 0 and self.top_k > 0 and self.d_expert > 0
            assert self.router_score in ("softmax", "sigmoid")
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
            assert self.d_inner % self.ssm_head_dim == 0
        return self

    def reduced(self, **overrides) -> "ModelConfig":
        """A small same-family config for CPU smoke tests."""
        base = dict(
            n_layers=min(self.n_layers, 4),
            d_model=128,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=32 if self.n_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_expert=64 if self.d_expert else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=32,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            n_patches=16 if self.n_patches else 0,
            window=min(self.window, 64) if self.window else 0,
            attn_every=2 if self.attn_every else 0,
            cross_attn_every=2 if self.cross_attn_every else 0,
            dtype="float32",
            name=self.name + "-smoke",
        )
        # keep MHA for models whose kv == heads
        if self.n_kv_heads and self.n_kv_heads == self.n_heads:
            base["n_kv_heads"] = base["n_heads"]
        base.update(overrides)
        return dataclasses.replace(self, **base).validate()

    # -- parameter counting (for roofline MODEL_FLOPS = 6*N*D) ----------- #
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; ``active_only`` counts MoE experts
        at top_k/n_experts weight (for 6*N_active*D)."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        att = 0
        if self.n_heads:
            q = d * self.n_heads * self.head_dim
            kv = 2 * d * self.n_kv_heads * self.head_dim
            o = self.n_heads * self.head_dim * d
            att = q + kv + o + (q if self.attn_gate else 0)
        ffn = 3 * d * self.d_ff if self.d_ff else 0
        moe = 0
        if self.n_experts:
            per_expert = 3 * d * self.d_expert
            n_eff = self.top_k if active_only else self.n_experts
            moe = per_expert * n_eff + d * self.n_experts  # + router
            if self.shared_expert:
                moe += 3 * d * (self.d_shared or self.d_ff or self.d_expert)
        ssm = 0
        if self.ssm_state:
            di = self.d_inner
            ssm = d * (2 * di + 2 * self.ssm_state + self.ssm_heads) + di * d + di
        per_layer = (att + (moe if self.n_experts else ffn)
                     + (ssm if self.family in ("ssm", "hybrid") else 0))
        if self.family == "ssm":
            per_layer = ssm
        if self.family == "hybrid":
            # mamba layers + one shared attention/ffn block
            return emb + self.n_layers * ssm + (att + ffn)  # shared block counted once
        n = self.n_layers + (self.enc_layers if self.family == "encdec" else 0)
        # leading dense layers of a MoE stack hold the d_ff MLP instead
        return emb + n * per_layer + self.n_dense_layers * (ffn - moe)
