"""Assigned-architecture registry: ``get_config(arch_id)`` / ``ARCHS``.

Each module defines ``CONFIG`` with the exact published configuration; the
files are the reference package's ``repro/configs/`` as data.  Only the
``dense`` family runs in the port so far (see ``repro_torch.models.lm``).
"""

from importlib import import_module

from ..models.config import ModelConfig

_MODULES = {
    "deepseek-67b": "deepseek_67b",
    "command-r-plus-104b": "command_r_plus_104b",
    "gemma3-12b": "gemma3_12b",
    "qwen3-14b": "qwen3_14b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "zamba2-7b": "zamba2_7b",
    "mamba2-2.7b": "mamba2_2p7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; one of {sorted(_MODULES)}")
    mod = import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG.validate()
