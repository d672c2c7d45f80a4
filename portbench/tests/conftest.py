"""Fixtures of the benchmark's tests: tiny cells that run the harness on
the CPU, and the card for the tests marked ``cuda``."""

from __future__ import annotations

import copy

import pytest

from portbench import harness

#: a qwen3-shaped configuration small enough for the CPU
TINY_LM = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, vocab_size=500,
               num_hidden_layers=2)


def tiny_cell(name: str) -> harness.Cell:
    """The benchmark's cell ``name`` cut to a CPU's size: its driver, mix
    and configuration as committed, with every size made small."""
    cell = copy.deepcopy(harness.load_cell(name))
    if cell.driver == "factor":
        cell.config.update(n=192, tile=48)
    elif cell.driver == "train":
        # float32: the limits are set for the cell's own size in bfloat16,
        # where Adam's steps span many units of the weights' last place
        cell.config.update(TINY_LM, torch_dtype="float32")
        cell.traffic.update(seq=32, batches=8)
    elif cell.driver == "score":
        cell.config.update(TINY_LM)
        cell.traffic.update(lengths=[16, 24, 32], prompts=12)
    return cell


def cpu_run(cell: harness.Cell, seed: int = 2**31 + 7, seconds: float = 0.3,
            trace: bool = False):
    """One run of ``cell`` on the CPU; returns ``(run, result line)``."""
    return harness.execute(cell, seed=seed, seconds=seconds, trace=trace,
                           device="cpu")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs at its own size on "
                    "the card")
    return "cuda"
