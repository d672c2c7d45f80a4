"""The port's sharding against the reference's, on the CPU.

* the rules: ``param_pspecs``, ``cache_pspecs`` and ``make_ctx`` equal the
  reference's for all ten configs at the production meshes (16, 16) and
  (2, 16, 16); no device is needed (both packages get a stand-in mesh);
* the plain decode attention's log-sum-exp against float64, and slices of
  a cache combined against the uncut call;
* on gloo process groups of CPU ranks (``tests/torch_sharding_helpers.py``,
  marker ``mp``): the sharded MoE (both EP branches, bf16 wire) against the
  reference's sharded MoE on an 8-device host mesh; one sharded train step
  (FSDP, hybrid and serial) against the reference's jitted sharded step; the
  vocab-sharded embedding and cross entropy against the reference's
  ``ctx=None`` forms; sharded prefill and decode on every cache layout
  against the port's ``ctx=None`` path; elastic restore across meshes.

The reference's sharded runs need 8 host devices (``XLA_FLAGS``) and a mesh
of Auto axes (this JAX's ``jax.make_mesh`` makes Explicit ones, which its
``with_sharding_constraint`` refuses): each runs in a subprocess with its
mesh built in the script.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro.sharding import rules as jax_rules
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.models import lm
from repro_torch.sharding import ShardCtx, make_ctx
from repro_torch.sharding.collectives import lse_merge

import torch_sharding_helpers as H

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(kind):
    shape, names = MESHES[kind]
    ref = SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names,
                          devices=SimpleNamespace(size=math.prod(shape)))
    port = SimpleNamespace(shape=shape, mesh_dim_names=names)
    return ref, port


def _norm(tree):
    """A PartitionSpec tree as nested tuples (either package's)."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if tree is None:
        return None
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in tree)


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_rules_and_pspecs_equal_the_reference(kind):
    assert ARCHS == JAX_ARCHS
    ref_mesh, port_mesh = _meshes(kind)
    for arch in ARCHS:
        rcfg, cfg = jax_get_config(arch), get_config(arch)
        rctx, ctx = jax_rules.make_ctx(ref_mesh, rcfg), make_ctx(port_mesh,
                                                                 cfg)
        assert ctx.shard_kv == rctx.shard_kv, arch
        assert ctx.batch_axes == rctx.batch_axes, arch
        assert ctx.rules() == {k: v for k, v in rctx.rules().items()}, arch
        assert _norm(lm.param_pspecs(cfg, ctx)) == _norm(
            jax_lm.param_pspecs(rcfg, rctx)), arch
        for seq in (False, True):
            rctx.seq_shard_cache = ctx.seq_shard_cache = seq
            assert _norm(lm.cache_pspecs(cfg, ctx)) == _norm(
                jax_lm.cache_pspecs(rcfg, rctx)), (arch, seq)
    # and without a mesh
    assert lm.cache_pspecs(get_config("qwen3-14b"), None) == {
        "k": None, "v": None, "index": None}


def test_decode_attention_ref_returns_its_log_sum_exp():
    rng = np.random.default_rng(0)
    B, H, KV, S, d = 2, 8, 2, 37, 16
    q = torch.from_numpy(rng.standard_normal((B, H, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, KV, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KV, d)).astype(np.float32))
    for length, window in ((S, 0), (30, 0), (30, 7), (0, 0)):
        out, lse = decode_attention_ref(q, k, v, length, window=window,
                                        return_lse=True)
        assert torch.equal(out, decode_attention_ref(q, k, v, length,
                                                     window=window))
        assert lse.dtype == torch.float32 and lse.shape == (B, H)
        # float64 log-sum-exp of the scaled scores over the valid keys
        lo = max(0, length - window) if window else 0
        s = torch.einsum("bhd,bshd->bhs", q.double(),
                         k.double().repeat_interleave(H // KV, 2))
        s = s[..., lo:length] / math.sqrt(d)
        want = torch.logsumexp(s, -1) if length else torch.full(
            (B, H), -math.inf, dtype=torch.float64)
        if length:
            np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=0,
                                       atol=1e-5)
        else:
            assert torch.isinf(lse).all() and (lse < 0).all()
        # the cache cut into slices and combined equals the uncut call
        for n in (2, 3, 5):
            per = -(-S // n)
            outs, lses = [], []
            for i in range(n):
                st = i * per
                ln = min(max(length - st, 0), min(per, S - st))
                lo_l = max(lo - st, 0)
                ln, w = (0, 0) if lo_l >= ln else (
                    ln, ln - lo_l if lo_l > 0 else 0)
                o, l = decode_attention_ref(q, k[:, st:st + per],
                                            v[:, st:st + per], ln, window=w,
                                            return_lse=True)
                outs.append(o)
                lses.append(l)
            merged = lse_merge(torch.stack(outs), torch.stack(lses))
            assert torch.isfinite(merged).all()
            np.testing.assert_allclose(merged.numpy(), out.numpy(), rtol=0,
                                       atol=2e-6)


def test_shard_ctx_without_a_mesh_is_one_rank():
    ctx = ShardCtx(mesh=None)
    assert (ctx.model_size, ctx.dp_size, ctx.index("model")) == (1, 1, 0)
    assert ctx.group("model") is None
    assert make_ctx(None).mesh is None


# ---------------------------------------------------------------------------
# the reference's sharded runs (subprocess: 8 host devices, Auto axes)
# ---------------------------------------------------------------------------
_REF_HEAD = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

def auto_mesh(shape, names):
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))
"""

_REF_MOE = _REF_HEAD + r"""
from repro.configs import get_config
from repro.models import layers as L
from repro.sharding.rules import ShardCtx

mesh = auto_mesh((2, 4), ("data", "model"))
cfg = get_config("qwen3-moe-235b-a22b").reduced(
    n_layers=1, d_model=64, n_experts=8, top_k=2, d_expert=32,
    vocab_size=512, dtype="float32", capacity_factor=8.0)
p = L.materialize(L.moe_spec(cfg), jax.random.PRNGKey(0), jnp.float32)
x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 64), jnp.float32)
out = {"x": np.asarray(x), "ref": np.asarray(L.moe(p, cfg, x))}
for name in ("router", "wg", "wu", "wd"):
    out[name] = np.asarray(p[name])
for gather in (False, True):
    for wire in (False, True):
        ctx = ShardCtx(mesh=mesh)
        ctx.moe_gather_tokens = gather
        ctx.moe_wire_bf16 = wire
        with mesh:
            y = jax.jit(lambda pp, xx: L.moe(pp, cfg, xx, shard_ctx=ctx))(p, x)
        out[("gather" if gather else "psum") + ("_bf16" if wire else "")] = \
            np.asarray(y)
np.savez(sys.argv[1], **out)
"""


def _run_reference(script: str, *args) -> None:
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.mark.mp
def test_sharded_moe_matches_the_reference_sharded_moe(tmp_path):
    """Both EP branches on a (2, 4) mesh of 8 gloo ranks against the
    reference's on 8 host devices, to its own test's limits (relative to
    the output's largest magnitude: 1e-5 for the psum branch, 1e-4 for the
    token gather); the bf16 wire against the reference's bf16 wire within
    one bf16 rounding of each expert's sum (2^-8 relative)."""
    npz = tmp_path / "moe.npz"
    _run_reference(_REF_MOE, npz)
    out = tmp_path / "moe.pt"
    H.spawn(8, "run_moe", str(npz), str(out))
    ref = np.load(npz)
    got = torch.load(out, weights_only=False)
    scale = np.abs(ref["ref"]).max()
    for name, limit in (("psum", 1e-5), ("gather", 1e-4),
                        ("psum_bf16", 2 ** -8), ("gather_bf16", 2 ** -8)):
        y = got[name].reshape(ref[name].shape)
        err = np.abs(y - ref[name]).max() / scale
        assert err < limit, (name, err)
        # and against the unsharded layer (no token is dropped at
        # capacity_factor 8)
        assert np.abs(y - ref["ref"]).max() / scale < max(limit, 1e-5), name


_REF_STEP = _REF_HEAD + r"""
import json
from repro.configs import get_config
from repro.models import lm
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.sharding.rules import make_ctx
from repro.train.steps import StepConfig, make_train_step

kw = json.loads(sys.argv[2])
micro = int(sys.argv[3])
cfg = get_config("deepseek-67b").reduced(**kw)
mesh = auto_mesh((4, 2), ("data", "model"))
ctx = make_ctx(mesh, cfg)
pspecs = lm.param_pspecs(cfg, ctx)
param_sh = jax.tree.map(lambda p: NamedSharding(mesh, p), pspecs,
                        is_leaf=lambda x: isinstance(x, P))
# every leaf drawn at scale ~1 from numpy (the reference's fresh tree
# zeroes its norms, and with them most gradients)
rng = np.random.default_rng(0)
abstract = lm.abstract_params(cfg)
tree = jax.tree.map(lambda s: (rng.standard_normal(s.shape) /
                               np.sqrt(s.shape[-2] if len(s.shape) > 1
                                       else 1.0) * (0.5 if len(s.shape) > 1
                                                    else 1.0)
                               ).astype(np.float32), abstract)
B, S = 8, 32
tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
params = jax.tree.map(lambda a, s: jax.device_put(a, s), tree, param_sh)
batch_sh = NamedSharding(mesh, P(("data",), None))
opt = adamw_init(params)
step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=0), ctx,
                       StepConfig(microbatches=micro, overlap="hybrid"),
                       grad_pspecs=param_sh)
with mesh:
    new, _, m = jax.jit(step)(params, opt, {
        "tokens": jax.device_put(tokens, batch_sh),
        "labels": jax.device_put(labels, batch_sh)})
np.savez(sys.argv[1], tree=np.array(tree, dtype=object), tokens=tokens,
         labels=labels, new=np.array(jax.tree.map(np.asarray, new),
                                     dtype=object),
         loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
"""

#: the config of the reference's test_dryrun_small.py, in float32 so that
#: one step is held to float32 limits (in bf16 a sign flip of Adam's
#: g / (|g| + eps) near zero moves a parameter by a whole lr)
STEP_CFG = dict(n_layers=3, d_model=128, vocab_size=1024, n_heads=4,
                n_kv_heads=2, head_dim=32, d_ff=256, dtype="float32")


@pytest.mark.mp
def test_sharded_train_step_matches_the_reference_sharded_step(tmp_path):
    """One step on a (4, 2) mesh, FSDP on, 2 microbatches, from one tree:
    the loss within 1e-5 relative, the gradient norm within 1e-4; the
    parameters after it within lr * 1e-3 of the reference's on all but
    0.1% of the elements (a near-zero gradient's sign may flip Adam's
    g / (|g| + eps)), none off by more than 2 lr; hybrid equal to serial
    to the bit."""
    npz = tmp_path / "step.npz"
    micro = 2
    _run_reference(_REF_STEP, npz, json.dumps(STEP_CFG), micro)
    out = tmp_path / "step.pt"
    H.spawn(8, "run_train_step", STEP_CFG, str(npz), micro, str(out))
    ref = np.load(npz, allow_pickle=True)
    got = torch.load(out, weights_only=False)
    hyb, ser = got["hybrid"], got["serial"]
    assert hyb["loss"] == ser["loss"]
    for n, p in hyb["params"].items():
        assert torch.equal(p, ser["params"][n]), n
    np.testing.assert_allclose(hyb["loss"], float(ref["loss"]), rtol=1e-5)
    np.testing.assert_allclose(hyb["grad_norm"], float(ref["grad_norm"]),
                               rtol=1e-4)
    cfg = get_config("deepseek-67b").reduced(**STEP_CFG)
    want = lm.params_from_reference(cfg, ref["new"].item(), device="cpu")
    lr = 1e-3
    off = total = 0
    for n, p in want.named_parameters():
        diff = (hyb["params"][n] - p).abs()
        assert float(diff.max()) <= 2 * lr, n
        off += int((diff > lr * 1e-3).sum())
        total += diff.numel()
    assert off <= 1e-3 * total, (off, total)


@pytest.mark.mp
def test_vocab_sharded_embedding_and_cross_entropy(tmp_path):
    """On a (2, 2) mesh: the embedding equals the reference's ``table[ids]``
    bit for bit; the loss (a padded vocabulary, masked labels, 2,200
    tokens a rank: one whole 2,048-token chunk and a ragged one) within
    1e-6 relative of the reference's ``ctx=None`` loss, and the gradients
    of h and of the unembedding within 1e-5 of the port's ``ctx=None``
    autograd."""
    import jax.numpy as jnp
    cfg = get_config("qwen3-14b").reduced(vocab_size=600, d_model=32)
    rcfg = jax_get_config("qwen3-14b").reduced(vocab_size=600, d_model=32)
    V = lm.padded_vocab(cfg)
    rng = np.random.default_rng(5)
    B, S, D = 4, 1100, 32
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, cfg.vocab_size, (B, 7))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    labels[rng.random((B, S)) < 0.1] = -1
    ref_loss = float(jax_lm.sharded_ce_loss(jnp.asarray(h), jnp.asarray(w),
                                            jnp.asarray(labels), rcfg, None))
    ref_embed = np.asarray(jax_lm.embed_lookup(jnp.asarray(table),
                                               jnp.asarray(ids), None))
    pt = tmp_path / "ce_in.pt"
    torch.save({"cfg": cfg, "h": torch.from_numpy(h),
                "w": torch.from_numpy(w), "table": torch.from_numpy(table),
                "ids": torch.from_numpy(ids),
                "labels": torch.from_numpy(labels)}, pt)
    out = tmp_path / "ce.pt"
    H.spawn(4, "run_embed_ce", str(pt), str(out))
    got = torch.load(out, weights_only=False)
    assert np.array_equal(got["embed"].numpy(), ref_embed)
    np.testing.assert_allclose(float(got["loss"]), ref_loss, rtol=1e-6)
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    loss = lm.sharded_ce_loss(th, tw, torch.from_numpy(labels), cfg)
    gh, gw = torch.autograd.grad(loss, (th, tw))
    np.testing.assert_allclose(got["gh"].numpy(), gh.numpy(), rtol=0,
                               atol=1e-5 * float(gh.abs().max()))
    np.testing.assert_allclose(got["gw"].numpy(), gw.numpy(), rtol=0,
                               atol=1e-5 * float(gw.abs().max()))


#: name -> (arch, reduced() overrides, mesh, ShardCtx fields, decode steps)
SERVE_CASES = {
    # the KV heads divide the model axis: heads on "model"
    "dense_kv_divides": ("qwen3-14b", {}, (2, 2), {}, 4),
    # they do not: the cache's sequence on "model", the lse combine; a
    # window cutting across the slices
    "dense_kv_seq_sharded": ("gemma3-12b", {"window": 8}, (1, 4), {}, 6),
    # 6 heads over 4 ranks: whole heads regrouped, zero-padded
    "dense_heads_padded": ("qwen3-14b", {"n_heads": 6, "n_kv_heads": 2},
                           (1, 4), {}, 3),
    # long context: the sequence on the batch axes (and "model")
    "seq_shard_cache": ("qwen3-14b", {"n_kv_heads": 1}, (2, 2),
                        {"seq_shard_cache": True}, 4),
    # the hybrid family: SSM heads on "model", the shared block's cache
    "hybrid": ("zamba2-7b", {}, (2, 2), {}, 4),
    "moe": ("qwen3-moe-235b-a22b", {"capacity_factor": 8.0}, (2, 2), {}, 3),
}


@pytest.mark.mp
def test_sharded_prefill_and_decode_give_the_unsharded_tokens(tmp_path):
    """Prefill and greedy decode on every cache layout ``cache_pspecs``
    makes: the tokens equal the ``ctx=None`` path's on every rank, the
    logits within 1e-4 (float32: only the sums' order differs)."""
    cases = SERVE_CASES
    out = tmp_path / "serve.pt"
    H.spawn(4, "run_serve", cases, str(out))
    got = torch.load(out, weights_only=False)
    for name in cases:
        r = got[name]
        assert r["same_tokens"] and r["all_same"], name
        assert r["err"] < 1e-4, (name, r["err"])
    # the layouts: heads on "model", or the sequence cut
    assert got["dense_kv_divides"]["cache_k"][2:] == (24, 1, 32)
    assert got["dense_kv_seq_sharded"]["cache_k"][2:] == (7, 2, 32)
    assert got["seq_shard_cache"]["cache_k"][1:3] == (4, 6)


@pytest.mark.mp
def test_elastic_restore_across_meshes(tmp_path):
    """A trainer on (2, 2) (FSDP, 2 microbatches) saves whole leaves from
    rank 0; a (4, 1) trainer restores its shards, which gathered have the
    same bits, and resumes at the saved step; a (1, 1) mesh's placements
    restore every leaf whole, the same bits."""
    out = tmp_path / "elastic.pt"
    H.spawn(4, "run_elastic", str(tmp_path / "ckpt"), str(out))
    got = torch.load(out, weights_only=False)
    assert got["final_step"] == 2 and got["start4"] == 2
    assert all(math.isfinite(x) for x in got["losses"])
    assert got["same4"] and got["same1"] and got["m_whole"]
    # (4, 1): d_ff whole over one model rank, d_model over four data ranks
    assert got["local4_shape"] == (32, 256)
