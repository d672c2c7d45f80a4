"""The port's ``launch/``: the cell shapes against the reference's, and the
dry run over a fake process group at the production mesh.

The dry run joins a fake group of 256 ranks, which is global to a process,
and the reference's ``launch.dryrun`` sets ``XLA_FLAGS`` when imported: both
run in subprocesses.  The argument bytes of each dry-run record are held
to a count made here from ``param_pspecs``/``cache_pspecs`` and the
reference-layout shapes alone.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from repro.configs import get_config as jax_get_config
from repro.launch import shapes as jax_shapes
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import shapes
from repro_torch.models import lm
from repro_torch.sharding import make_ctx
from repro_torch.sharding.rules import local_shape

SRC = str(Path(__file__).resolve().parents[1] / "src")
ROOT = str(Path(__file__).resolve().parents[1])


def _run(code: str, timeout: int = 600) -> str:
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=timeout, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_shapes_equal_the_reference():
    assert shapes.SHAPES == jax_shapes.SHAPES
    assert shapes.SHAPE_DEFS == jax_shapes.SHAPE_DEFS
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), jax_get_config(arch)
        assert shapes.long_ok(cfg) == jax_shapes.long_ok(rcfg), arch
        for s in shapes.SHAPES:
            assert shapes.cell_applicable(cfg, s) == \
                jax_shapes.cell_applicable(rcfg, s), (arch, s)
            mine = shapes.input_specs(cfg, s)
            theirs = jax_shapes.input_specs(rcfg, s)
            assert sorted(mine) == sorted(theirs), (arch, s)
            for k, spec in mine.items():
                assert spec.shape == tuple(theirs[k].shape), (arch, s, k)
                assert str(spec.dtype).split(".")[-1] == str(
                    theirs[k].dtype), (arch, s, k)
            assert shapes.decode_cache_len(s) == \
                jax_shapes.decode_cache_len(s)
            assert shapes.enc_len_for(cfg, 77) == \
                jax_shapes.enc_len_for(rcfg, 77)


def test_pick_microbatches_equals_the_reference():
    """The reference's ``launch.dryrun`` sets XLA_FLAGS when imported: its
    numbers come from a subprocess."""
    code = ("import json\n"
            "from repro.configs import ARCHS, get_config\n"
            "from repro.launch.dryrun import pick_microbatches\n"
            "print(json.dumps({f'{a} {s} {dp}': pick_microbatches("
            "get_config(a), s, dp) for a in ARCHS for s in ('train_4k', "
            "'decode_32k') for dp in (16, 32)}))\n")
    theirs = json.loads(_run(code).strip().splitlines()[-1])
    from repro_torch.launch.dryrun import pick_microbatches
    for key, want in theirs.items():
        a, s, dp = key.split()
        assert pick_microbatches(get_config(a), s, int(dp)) == want, key


# ---------------------------------------------------------------------------
# the dry run at the production mesh (a fake group of 256 ranks)
# ---------------------------------------------------------------------------
#: one reduced config per family, cut so that every sharded dimension
#: divides the (16, 16) mesh (16 experts, 16 SSM heads); 4 query heads
#: over 16 model ranks are regrouped into whole, zero-padded heads
FAMILY_CUTS = {
    "qwen3-14b": {},
    "qwen3-moe-235b-a22b": {"n_experts": 16},
    "mamba2-2.7b": {"ssm_head_dim": 16},
    "zamba2-7b": {"ssm_head_dim": 16},
    "seamless-m4t-medium": {},
    "llama-3.2-vision-11b": {},
}
CELL_SHAPES = {"train": dict(seq_len=64, global_batch=32, kind="train"),
               "prefill": dict(seq_len=64, global_batch=16, kind="prefill"),
               "decode": dict(seq_len=64, global_batch=16, kind="decode")}

_DRY = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
cells = json.loads(sys.argv[1])
dryrun.fake_world(256)
mesh = make_production_mesh(device_type="cpu")
out = {}
for name, (arch, cut, sd, ov) in cells.items():
    cfg = get_config(arch).reduced(**cut)
    cell = dryrun.build_cell(arch, "train_4k", mesh, cfg=cfg, shape_def=sd,
                             overrides=ov)
    rec = dryrun.measure(cell)
    rec["micro"] = cell.micro
    out[name] = rec
print("RESULT:" + json.dumps(out))
"""


def _dry(cells):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _DRY, json.dumps(cells)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("RESULT:")][0]
    return json.loads(line[len("RESULT:"):])


def _ctx(cfg, **ov):
    mesh = SimpleNamespace(shape=(16, 16), mesh_dim_names=("data", "model"))
    ctx = make_ctx(mesh, cfg)
    for k, v in ov.items():
        setattr(ctx, k, v)
    return ctx


def _local_bytes(shape_tree, spec_tree, sizes, stacked=0, itemsize=None):
    """Bytes of every leaf's shard, walking the port's shape tree
    (``model_spec``/``cache_struct``) beside the reference-layout specs."""
    total = 0
    for k, shp in shape_tree.items():
        if isinstance(shp, dict):
            total += _local_bytes(shp, spec_tree[k], sizes, stacked,
                                  itemsize)
            continue
        dt = None
        if isinstance(shp, tuple) and len(shp) == 2 and not isinstance(
                shp[1], int):
            shp, dt = shp
        shape = ((stacked,) if stacked else ()) + tuple(shp)
        n = math.prod(local_shape(shape, spec_tree[k], sizes))
        total += n * (itemsize or dt.itemsize)
    return total


def _param_bytes(cfg, ctx, itemsize):
    spec, pspecs = lm.model_spec(cfg), lm.param_pspecs(cfg, ctx)
    sizes = {"data": 16, "model": 16}
    total = 0
    for k, sub in spec.items():
        n = {"blocks": cfg.n_layers, "enc_blocks": cfg.enc_layers}.get(k, 0)
        sub = sub if isinstance(sub, dict) else {"_": sub}
        sp = pspecs[k] if isinstance(pspecs[k], dict) else {"_": pspecs[k]}
        total += _local_bytes(sub, sp, sizes, n, itemsize)
    return total


def _expected_args(cfg, ctx, sd):
    sizes = {"data": 16, "model": 16}
    b, s = sd["global_batch"], sd["seq_len"]
    bl = b // 16
    isz = cfg.torch_dtype.itemsize
    if sd["kind"] == "decode":
        n_patches = cfg.n_patches if cfg.family == "vlm" else (
            256 if cfg.family == "encdec" else 0)
        struct = lm.cache_struct(cfg, b, s, n_patches)
        index = struct.pop("index")
        assert index is int
        cp = lm.cache_pspecs(cfg, ctx)
        cache = _local_bytes(struct, cp, sizes) + 4
        return _param_bytes(cfg, ctx, isz) + cache + bl * 4
    batch = bl * s * 4 * (2 if sd["kind"] == "train" else 1)
    if cfg.family == "encdec":
        batch += bl * s * cfg.d_model * isz
    if cfg.family == "vlm":
        batch += bl * cfg.n_patches * cfg.d_model * isz
    if sd["kind"] == "prefill":
        return _param_bytes(cfg, ctx, isz) + batch
    # params, AdamW's float32 m and v, its int32 step
    return (_param_bytes(cfg, ctx, isz) + 2 * _param_bytes(cfg, ctx, 4) + 4
            + batch)


@pytest.mark.mp
def test_dry_run_at_the_production_mesh():
    """Each family's reduced config in a train, a prefill and a decode cell
    of rank 0 of (16, 16): argument bytes equal to the shard count made
    from the pspecs; every expected collective kind present (FSDP's
    all-gather and reduce-scatter, TP's all-reduce; with FSDP off the DP
    bucket's all-reduce, with no reduce-scatter; the MoE's token gather's
    all-to-all); FLOPs positive and linear in the layer count."""
    cells = {}
    for arch, cut in FAMILY_CUTS.items():
        for kind, sd in CELL_SHAPES.items():
            cells[f"{arch} {kind}"] = (arch, cut, sd, {})
    # 16 heads: whole heads on every model rank, so no regrouping
    # all-gather (and its reduce-scatter) either
    cells["qwen3-14b train nofsdp"] = ("qwen3-14b", {"n_heads": 16},
                                       CELL_SHAPES["train"], {"fsdp": False})
    cells["moe train gather"] = ("qwen3-moe-235b-a22b", {"n_experts": 16},
                                 CELL_SHAPES["train"],
                                 {"moe_gather_tokens": True})
    for n in (2, 3, 4):
        cells[f"layers {n}"] = ("qwen3-14b", {"n_layers": n},
                                CELL_SHAPES["train"], {})
    got = _dry(cells)
    for name, (arch, cut, sd, ov) in cells.items():
        rec = got[name]
        cfg = get_config(arch).reduced(**cut)
        ctx = _ctx(cfg, fsdp=ov.get("fsdp", True))
        assert rec["memory"]["argument_size_in_bytes"] == _expected_args(
            cfg, ctx, sd), name
        assert rec["hlo_dot_flops"] > 0, name
        assert rec["memory"]["temp_size_in_bytes"] > 0, name
        coll = rec["collectives"]
        assert coll["all-reduce"]["count"] > 0, name    # TP's row-parallel
        if sd["kind"] == "train" and ov.get("fsdp", True):
            assert coll["all-gather"]["count"] > 0, name
            assert coll["reduce-scatter"]["count"] > 0, name
    nofsdp = got["qwen3-14b train nofsdp"]["collectives"]
    assert nofsdp["reduce-scatter"]["count"] == 0
    cfg = get_config("qwen3-14b").reduced(n_heads=16)
    # the DP bucket: every parameter's gradient, once a microbatch
    assert nofsdp["all-reduce"]["bytes"] >= _param_bytes(
        cfg, _ctx(cfg, fsdp=False), 4)
    assert got["moe train gather"]["collectives"]["all-to-all"]["count"] > 0
    assert got["qwen3-moe-235b-a22b train"]["collectives"]["all-to-all"][
        "count"] == 0
    f = [got[f"layers {n}"]["hlo_dot_flops"] for n in (2, 3, 4)]
    assert f[2] - f[1] == f[1] - f[0] > 0


@pytest.mark.mp
def test_dryrun_command_line_and_perf_iter(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on qwen3-14b's decode cell at
    full size writes a record whose argument bytes equal the shard count,
    and skips it when run again (the reference's cached-record skip);
    ``perf_iter`` reports the H100's constants."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "qwen3-14b", "--shape", "decode_32k", "--mesh", "single",
           "--out", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads((tmp_path / "qwen3-14b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config("qwen3-14b")
    sd = shapes.SHAPE_DEFS["decode_32k"]
    assert rec["memory"]["argument_size_in_bytes"] == _expected_args(
        cfg, _ctx(cfg), sd)
    assert rec["n_devices"] == 256 and rec["microbatches"] == 1
    # KV heads (8) do not divide 16: the cache's sequence is cut
    assert rec["cache_bytes_per_dev"] == 40 * 2 * 8 * 2048 * 8 * 128 * 2 + 4
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=600)
    assert "[cached]" in r.stdout
    code = ("import json, dataclasses\n"
            "from repro_torch.launch import perf_iter\n"
            "print(json.dumps(perf_iter.report('qwen3-14b', 'decode_32k', "
            "{})))\n")
    rep = json.loads(_run(code).strip().splitlines()[-1])
    assert rep["constants"]["peak_flops"] == 989e12
    assert rep["constants"]["hbm_bw"] == 3.35e12
    assert rep["constants"]["nvlink_bw"] == 450e9
    assert rep["collective_s"] > 0 and rep["compute_s"] > 0
    from repro_torch.launch import perf_iter
    assert (perf_iter.PEAK_FLOPS, perf_iter.HBM_BW, perf_iter.NVLINK_BW) \
        == (989e12, 3.35e12, 450e9)
