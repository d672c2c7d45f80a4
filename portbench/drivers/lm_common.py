"""What the language-model drivers share: the program's configuration made
from a configuration file's published keys, and the program's model
filled with the benchmark's weights."""

from __future__ import annotations

from typing import Any, Dict

import torch


def program_config(cfg: Dict[str, Any]):
    """The program's ``ModelConfig`` of a dense (qwen3-style) configuration
    file, whose keys are the published ``config.json``'s."""
    from repro_torch.models.config import ModelConfig

    if cfg.get("model_type") != "qwen3":
        raise ValueError(f"{cfg['name']}: no dense driver for model_type "
                         f"{cfg.get('model_type')!r}")
    return ModelConfig(
        name=cfg["name"], family="dense",
        n_layers=int(cfg["num_hidden_layers"]),
        d_model=int(cfg["hidden_size"]),
        n_heads=int(cfg["num_attention_heads"]),
        n_kv_heads=int(cfg["num_key_value_heads"]),
        head_dim=int(cfg["head_dim"]), d_ff=int(cfg["intermediate_size"]),
        vocab_size=int(cfg["vocab_size"]), qk_norm=True,
        rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        dtype=cfg["torch_dtype"], norm_eps=float(cfg["rms_norm_eps"]))


@torch.no_grad()
def program_model(cfg: Dict[str, Any], weights, device: str):
    """The program's ``LM`` for ``cfg`` with every leaf copied from
    ``weights`` (:class:`portbench.generate.DenseWeights`), one layer's draw
    at a time."""
    from repro_torch.models.lm import LM

    pcfg = program_config(cfg)
    model = LM(pcfg, torch.device(device))
    params = dict(model.named_parameters())
    params["embed.table"].copy_(weights.embed())
    if "unembed.out" in params:
        params["unembed.out"].copy_(weights.unembed())
    params["final_norm"].copy_(weights.final_norm())
    for i in range(pcfg.n_layers):
        for name, t in weights.layer(i).items():
            params[f"blocks.{i}.{name}"].copy_(t)
    if set(params) != set(_names(cfg)):
        raise ValueError(f"the program's leaves {sorted(params)} are not the "
                         f"benchmark's")
    return pcfg, model


def _names(cfg):
    from portbench.generate import dense_leaf_names
    return dense_leaf_names(cfg)
