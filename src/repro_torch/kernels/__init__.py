"""Hand-written Hopper kernels of the port, their plain PyTorch versions and
their launch counts.

* :mod:`~repro_torch.kernels.ops` — public entry points
  (``ops.tile_matmul``, ``ops.flash_attention``, ``ops.decode_attention``,
  ``ops.ssd_scan``),
  dispatched by the device of the tensors;
* :mod:`~repro_torch.kernels.tile_matmul` — the wrapper of the tile GEMM
  with epilogue that carries the factorizations' trailing update
  (``csrc/tile_matmul.cu``);
* :mod:`~repro_torch.kernels.flash_attention` — prefill attention and
  training's attention gradient (``csrc/flash_attention.cu``: the forward,
  and the backward counted as ``flash_attention_bwd``);
* :mod:`~repro_torch.kernels.decode_attention` — the attention of a decode
  step over the KV cache (``csrc/decode_attention.cu``);
* :mod:`~repro_torch.kernels.ssd_scan` — the Mamba2 SSD chunk scan of an
  SSM layer's prefill, scoring and training (``csrc/ssd_scan.cu``; its
  gradient through ``SSDScanFn``);
* :mod:`~repro_torch.kernels.adamw` — the optimizer's norm pass and fused
  clip-and-update pass (``csrc/adamw.cu``; its plain version is
  ``optim/adamw.py``'s chunked torch ops);
* :mod:`~repro_torch.kernels.ref` — the plain versions;
* :func:`launch_counts` / :func:`reset_launch_counts` — every kernel's
  launch count, for showing that a run went through the kernels.
"""

from typing import Dict

from . import ops, ref
from .adamw import launches as _adamw_launches
from .decode_attention import launches as _decode_attention_launches
from .flash_attention import bwd_launches as _flash_attention_bwd_launches
from .flash_attention import launches as _flash_attention_launches
from .ssd_scan import launches as _ssd_scan_launches
from .tile_matmul import launches as _tile_matmul_launches

#: every kernel's launch counter, by kernel name
COUNTERS = {c.name: c for c in (_tile_matmul_launches,
                                _flash_attention_launches,
                                _decode_attention_launches,
                                _ssd_scan_launches,
                                _adamw_launches,
                                _flash_attention_bwd_launches)}


def launch_counts() -> Dict[str, int]:
    return {name: c.count for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


__all__ = ["COUNTERS", "launch_counts", "ops", "ref", "reset_launch_counts"]
