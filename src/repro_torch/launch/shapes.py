"""The assigned input-shape set and per-cell input specs.

The port of the reference's ``repro/launch/shapes.py`` (pure: the same
values):

* ``train_4k``     seq_len=4096,   global_batch=256  -> a train step
* ``prefill_32k``  seq_len=32768,  global_batch=32   -> a prefill
* ``decode_32k``   seq_len=32768,  global_batch=128  -> a decode step
                   (one new token against a seq_len KV cache)
* ``long_500k``    seq_len=524288, global_batch=1    -> a decode step; only
                   for sub-quadratic archs (ssm/hybrid/sliding-window)

``input_specs`` gives ``(shape, dtype)`` pairs (torch dtypes) of the whole
batch; the ``[audio]``/``[vlm]`` frontends are stubs given precomputed
frame/patch embeddings.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..models.config import ModelConfig

__all__ = ["LONG_OK_FAMILIES", "SHAPES", "SHAPE_DEFS", "Spec",
           "cell_applicable", "decode_cache_len", "enc_len_for",
           "input_specs", "long_ok"]

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

SHAPE_DEFS = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

#: archs allowed to run long_500k (sub-quadratic attention)
LONG_OK_FAMILIES = ("ssm", "hybrid")


class Spec(NamedTuple):
    """An input's shape and dtype (the reference's ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def long_ok(cfg: ModelConfig) -> bool:
    if cfg.family in LONG_OK_FAMILIES:
        return True
    # sliding-window archs (gemma3: 5/6 layers local) qualify
    return bool(cfg.local_global_ratio and cfg.window)


def cell_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and not long_ok(cfg):
        return False, "pure full-attention arch: long_500k skipped (DESIGN.md)"
    return True, ""


def enc_len_for(cfg: ModelConfig, seq_len: int) -> int:
    # audio frontend stub: one frame embedding per target token position
    return seq_len


def input_specs(cfg: ModelConfig, shape: str,
                shape_def: Dict = None) -> Dict[str, Spec]:
    """The whole batch's inputs of this cell (``shape_def`` in place of
    ``SHAPE_DEFS[shape]`` for a cut cell)."""
    sd = shape_def or SHAPE_DEFS[shape]
    b, s = sd["global_batch"], sd["seq_len"]
    i32, dt = torch.int32, cfg.torch_dtype
    if sd["kind"] == "decode":
        return {"tokens": Spec((b, 1), i32)}
    batch = {"tokens": Spec((b, s), i32)}
    if sd["kind"] == "train":
        batch["labels"] = Spec((b, s), i32)
    if cfg.family == "encdec":
        batch["enc_input"] = Spec((b, enc_len_for(cfg, s), cfg.d_model), dt)
    if cfg.family == "vlm":
        batch["patches"] = Spec((b, cfg.n_patches, cfg.d_model), dt)
    return batch


def decode_cache_len(shape: str) -> int:
    return SHAPE_DEFS[shape]["seq_len"]
