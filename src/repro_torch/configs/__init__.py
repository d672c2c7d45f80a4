"""Architecture registry: ``get_config(arch_id)``, ``ARCHS`` and
``PORT_ARCHS``.

Each module defines ``CONFIG`` with the exact published configuration.
``ARCHS`` are the reference package's ``repro/configs/`` as data;
``PORT_ARCHS`` are configurations the port runs and the reference package
does not have.
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

#: configurations of the port alone
_PORT_MODULES = {
    "trinity-mini": "trinity_mini",
}

ARCHS = tuple(_MODULES)
PORT_ARCHS = tuple(_PORT_MODULES)


def get_config(arch: str) -> ModelConfig:
    mods = {**_MODULES, **_PORT_MODULES}
    if arch not in mods:
        raise KeyError(f"unknown arch {arch!r}; one of {sorted(mods)}")
    mod = import_module(f".{mods[arch]}", __package__)
    return mod.CONFIG.validate()
