"""Perf-iteration harness: run one (arch x shape) cell's per-rank program
under a named variant over a fake process group and report its roofline
terms on the H100.

    PYTHONPATH=src python -m repro_torch.launch.perf_iter --arch qwen3-14b \\
        --shape train_4k --set micro=4 --set fsdp=false

Variants are the reference's overrides: ``micro``, ``remat_group``,
``fsdp``, ``compress``, ``overlap``, ``moe_wire_bf16``,
``moe_gather_tokens``, ``no_shard_kv``.

The roofline's constants are the H100's (NVIDIA H100 data sheet, SXM5
part at 700 W): 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of
HBM3, NVLink 4 at 450 GB/s each way.  The collective term takes every
byte over NVLink; a mesh wider than one 8-card host crosses a slower
network between hosts, so there the term is a lower bound.  The FLOPs are
the plain versions' that ran on fake CPU tensors (the plain flash
attention computes the whole S x S square, not the causal half).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict

import torch.distributed as dist

from ..configs import get_config
from .dryrun import build_cell, fake_world, measure
from .mesh import make_production_mesh

__all__ = ["HBM_BW", "HBM_BYTES", "NVLINK_BW", "PEAK_FLOPS", "compile_cell",
           "report", "roofline"]

#: dense bf16 tensor-core rate, FLOP/s (H100 SXM5)
PEAK_FLOPS = 989e12
#: HBM3 rate, bytes/s
HBM_BW = 3.35e12
#: NVLink 4, bytes/s each way
NVLINK_BW = 450e9
#: HBM3 capacity, bytes
HBM_BYTES = 80e9
_KIND_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


def compile_cell(arch: str, shape: str, overrides: Dict[str, Any],
                 multi_pod: bool = False):
    """``(cell, seconds)``: the cell built with ``overrides`` over a fake
    group of 256 (512 with ``multi_pod``) ranks, which this call sets
    up."""
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    t0 = time.time()
    cell = build_cell(arch, shape, mesh, overrides=overrides)
    return cell, time.time() - t0


def roofline(rec: Dict[str, Any]) -> Dict[str, Any]:
    """The H100 roofline terms of a dry-run record (``dryrun.measure``'s
    keys): the products at the bf16 peak, the arguments read once at the
    HBM rate, every collective byte over NVLink (an all-reduce twice)."""
    coll = rec["collectives"]
    coll_t = sum(coll.get(k, {}).get("bytes", 0.0) * f / NVLINK_BW
                 for k, f in _KIND_FACTOR.items())
    dots = rec["hlo_dot_flops"]
    compute_t = dots / PEAK_FLOPS
    temp = rec["memory"]["temp_size_in_bytes"]
    args = rec["memory"]["argument_size_in_bytes"]
    return {
        "temp_gib": temp / 2 ** 30,
        "argument_gib": args / 2 ** 30,
        "fits_80g": temp + args < HBM_BYTES,
        "hlo_dot_flops": dots,
        "compute_s": compute_t,
        "memory_s": args / HBM_BW,
        "collective_s": coll_t,
        "coll_by_kind": {k: v["bytes"] / 2 ** 30 for k, v in coll.items()
                         if isinstance(v, dict) and v["bytes"]},
        "dominant": "collective" if coll_t > compute_t else "compute",
        "constants": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                      "nvlink_bw": NVLINK_BW,
                      "source": "NVIDIA H100 data sheet, SXM5, 700 W"},
    }


def report(arch: str, shape: str, overrides: Dict[str, Any],
           multi_pod: bool = False) -> Dict[str, Any]:
    """The roofline terms of one variant of one cell."""
    try:
        cell, dt = compile_cell(arch, shape, overrides, multi_pod)
        rec = measure(cell)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return {"arch": arch, "shape": shape, "overrides": overrides,
            "micro": cell.micro, **roofline(rec), "build_s": dt,
            "run_s": rec["run_s"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="key=value overrides (micro, remat_group, fsdp, "
                         "compress, overlap, moe_wire_bf16, "
                         "moe_gather_tokens, no_shard_kv)")
    args = ap.parse_args(argv)
    get_config(args.arch)
    overrides: Dict[str, Any] = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = {"true": True, "false": False}.get(v.lower(), v)
    print(json.dumps(report(args.arch, args.shape, overrides, args.multi),
                     indent=1))


if __name__ == "__main__":
    main()
