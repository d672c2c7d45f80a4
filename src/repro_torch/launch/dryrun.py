"""Dry run of every (arch x shape x mesh) cell over a fake process group.

The port's counterpart of the reference's ``launch/dryrun.py``, which
lowers and compiles each cell on 512 placeholder host devices: here one
process joins a fake process group of 256 (``single``) or 512 (``multi``)
ranks as rank 0, builds rank 0's share of the cell (its parameter,
optimizer, batch and cache shards) as fake tensors, and runs its program
once (:func:`~repro_torch.launch.analysis.analyze`): no memory is held,
no device works, and every collective is a no-op that is counted.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k --mesh single --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Each record holds the reference's keys where they mean something here:
``memory.argument_size_in_bytes`` (this rank's parameter, optimizer-state,
batch and cache shards, counted exactly), ``memory.temp_size_in_bytes``
(the most bytes the program's own tensors hold at once, counted under
fake tensors by :class:`~repro_torch.launch.analysis.LiveBytes`), ``flops``
and ``hlo_dot_flops`` (``FlopCounterMode``'s count of the products that
ran: the kernels' plain versions, the plain flash attention computing the
whole S x S square), ``collectives`` by kind, ``params``,
``params_active``, ``microbatches`` and ``cache_bytes_per_dev``.  The fake
group is set up by the command line (or :func:`fake_world`), never at
import.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..configs import ARCHS, get_config
from ..models import lm
from ..optim.adamw import AdamWConfig, adamw_init
from ..sharding.rules import make_ctx
from ..train.steps import StepConfig, make_train_step
from .analysis import analyze
from .mesh import make_production_mesh
from .shapes import SHAPE_DEFS, SHAPES, cell_applicable

__all__ = ["Cell", "build_cell", "fake_world", "pick_microbatches",
           "run_cell", "tree_bytes"]

OPT_CFG = AdamWConfig()


def fake_world(world: int) -> None:
    """Join (as rank 0) a fake process group of ``world`` ranks, leaving any
    group that is up first."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def pick_microbatches(cfg, shape: str, dp: int,
                      shape_def: Optional[Dict] = None) -> int:
    """Smallest power-of-two microbatch count whose per-microbatch remat
    carry stash (n_layers x per-seq residual stream, bf16) fits a ~4 GiB
    budget per device (the reference's arithmetic)."""
    sd = shape_def or SHAPE_DEFS[shape]
    if sd["kind"] != "train":
        return 1
    b_local = max(1, sd["global_batch"] // dp)
    n_layers = cfg.n_layers + getattr(cfg, "enc_layers", 0)
    per_seq = n_layers * sd["seq_len"] * cfg.d_model * 2  # bf16 carry
    budget = 4 * 2 ** 30
    need = max(1, -(-b_local * per_seq // budget))
    micro = 1
    while micro < need and micro < b_local:
        micro *= 2
    return micro


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree (an ``LM``, dicts, tensors); a host
    ``int`` counts as the reference's int32 scalar."""
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, int):
        return 4
    return 0


@dataclasses.dataclass
class Cell:
    """Rank 0's share of a cell: ``fn(*args)`` is its program, ``args``
    fake tensors made under ``mode``."""
    fn: Any
    args: tuple
    cfg: Any
    ctx: Any
    mode: Any
    micro: int
    cache_bytes: int = 0


def build_cell(arch: str, shape: str, mesh, *,
               step_cfg: Optional[StepConfig] = None,
               overrides: Optional[Dict[str, Any]] = None,
               cfg=None, shape_def: Optional[Dict] = None,
               device: str = "cpu") -> Cell:
    """The cell's per-rank program and its fake arguments.  ``overrides``
    sets ``ShardCtx`` fields (``fsdp``, ``remat_group``, ``moe_wire_bf16``,
    ``moe_gather_tokens``, ``no_shard_kv``); ``cfg`` and ``shape_def`` cut
    a cell (a config cut in depth, a smaller batch)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or get_config(arch)
    sd = shape_def or SHAPE_DEFS[shape]
    ov = overrides or {}
    ctx = make_ctx(mesh, cfg)
    ctx.seq_shard_cache = shape == "long_500k"
    ctx.fsdp = bool(ov.get("fsdp", True))
    ctx.remat_group = int(ov.get("remat_group", 1))
    ctx.moe_wire_bf16 = bool(ov.get("moe_wire_bf16", False))
    ctx.moe_gather_tokens = bool(ov.get("moe_gather_tokens", False))
    if ov.get("no_shard_kv"):
        ctx.shard_kv = False
    ctx.make_groups()
    dp = ctx.dp_size
    b = sd["global_batch"]
    # a batch of one (long_500k) is whole on every rank, as the
    # reference's replicated batch sharding
    b_local = b // dp if b % dp == 0 and b > 1 else b
    s = sd["seq_len"]
    mode = FakeTensorMode()
    kind = sd["kind"]
    with mode:
        params = lm.local_params(cfg, ctx, device)
        dt = cfg.torch_dtype
        if kind == "decode":
            n_patches = cfg.n_patches if cfg.family == "vlm" else (
                256 if cfg.family == "encdec" else 0)
            cache = lm.zeros_cache(cfg, b, s, device, n_patches=n_patches,
                                   ctx=ctx)
            tokens = torch.zeros((b_local, 1), dtype=torch.int32,
                                 device=device)
            # the cache as the prompt left it: one position short of full
            cache["index"] = s - 1
            return Cell(lambda p, c, t: lm.decode_step(p, cfg, c, t, ctx),
                        (params, cache, tokens), cfg, ctx, mode, 1,
                        cache_bytes=tree_bytes(cache))
        batch = {"tokens": torch.zeros((b_local, s), dtype=torch.int32,
                                       device=device)}
        if kind == "train":
            batch["labels"] = torch.zeros((b_local, s), dtype=torch.int32,
                                          device=device)
        if cfg.family == "encdec":
            batch["enc_input"] = torch.zeros((b_local, s, cfg.d_model),
                                             dtype=dt, device=device)
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros((b_local, cfg.n_patches,
                                            cfg.d_model), dtype=dt,
                                           device=device)
        if kind == "prefill":
            return Cell(lambda p, bt: lm.prefill(p, cfg, bt, ctx,
                                                 max_len=s + 1),
                        (params, batch), cfg, ctx, mode, 1)
        opt_state = adamw_init(params)
    micro = int(ov.get("micro", 0)) or pick_microbatches(cfg, shape, dp, sd)
    sc = step_cfg or StepConfig(microbatches=micro,
                                overlap=ov.get("overlap", "hybrid"),
                                compress_grads=bool(ov.get("compress",
                                                           False)))
    fn = make_train_step(cfg, OPT_CFG, ctx, sc,
                         grad_pspecs=lm.param_pspecs(cfg, ctx))
    return Cell(fn, (params, opt_state, batch), cfg, ctx, mode,
                sc.microbatches)


def measure(cell: Cell) -> Dict[str, Any]:
    """Run the cell's program once under its fake mode; the record's
    measured keys."""
    args_bytes = tree_bytes(cell.args)
    t0 = time.time()
    with cell.mode:
        a = analyze(cell.fn, *cell.args)
    run_s = time.time() - t0
    return {
        "run_s": round(run_s, 2),
        "memory": {"argument_size_in_bytes": args_bytes,
                   "temp_size_in_bytes": a["temp_bytes"]},
        "flops": a["dot_flops"],
        "hlo_dot_flops": a["dot_flops"],
        "collectives": a["collectives"],
    }


def run_cell(arch: str, shape: str, mesh_kind: str) -> Dict[str, Any]:
    """One cell's record over a fake group of 256 or 512 ranks (which this
    call sets up)."""
    t0 = time.time()
    cfg = get_config(arch)
    ok, why = cell_applicable(cfg, shape)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_kind}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec
    multi = mesh_kind == "multi"
    try:
        fake_world(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        cell = build_cell(arch, shape, mesh)
        t_build = time.time()
        rec.update(measure(cell))
        sd = SHAPE_DEFS[shape]
        rec.update({
            "status": "ok",
            "build_s": round(t_build - t0, 2),
            "n_devices": mesh.size(),
            "params": cfg.param_count(),
            "params_active": cfg.param_count(active_only=True),
            "microbatches": cell.micro,
            "cache_bytes_per_dev": cell.cache_bytes,
            "cell_meta": {
                "seq_len": sd["seq_len"], "global_batch": sd["global_batch"],
                "kind": sd["kind"],
                "n_layers": cfg.n_layers + (cfg.enc_layers or 0),
                "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                "head_dim": cfg.head_dim, "window": cfg.window,
                "local_global_ratio": cfg.local_global_ratio,
            },
        })
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=SHAPES)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        cells = [(a, s, m) for a in ARCHS for s in SHAPES for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    failures = 0
    for a, s, m in cells:
        fname = os.path.join(args.out, f"{a}__{s}__{m}.json")
        if os.path.exists(fname):
            with open(fname) as f:
                prev = json.load(f)
            if prev.get("status") in ("ok", "skipped"):
                print(f"[cached] {a} {s} {m}: {prev['status']}")
                continue
        rec = run_cell(a, s, m)
        with open(fname, "w") as f:
            json.dump(rec, f, indent=1)
        status = rec["status"]
        extra = ""
        if status == "ok":
            tmp = rec["memory"]["temp_size_in_bytes"]
            extra = (f" flops={rec['flops']:.3g} temp={tmp / 2**30:.2f}GiB "
                     f"coll={rec['collectives']['total_bytes'] / 2**30:.2f}"
                     f"GiB ({rec['run_s']}s run)")
        elif status == "error":
            extra = " " + rec["error"][:200]
            failures += 1
        print(f"[{status}] {a} {s} {m}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
