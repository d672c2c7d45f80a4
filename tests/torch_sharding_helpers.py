"""Bodies of the port's gloo processes for ``test_torch_sharding.py``.

Each ``run_*`` function runs in every rank of a process group that
:func:`spawn` sets up on the CPU (``gloo``, ``tcp://localhost``), reads its
inputs from ``.npz``/``.pt`` files the test wrote, and rank 0 writes what
the test checks to ``out`` (a ``.pt`` file).  No JAX here: the children
import the port alone.
"""

from __future__ import annotations

import socket
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn_name, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        getattr(sys.modules[__name__], fn_name)(rank, *args)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def spawn(world: int, fn_name: str, *args) -> None:
    """Run ``fn_name(rank, *args)`` in ``world`` gloo processes."""
    mp.spawn(_entry, args=(world, free_port(), fn_name, args), nprocs=world,
             join=True)


def _mesh(shape, ctx_kw=None, cfg=None):
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import make_ctx
    mesh = make_debug_mesh(*shape, device_type="cpu")
    ctx = make_ctx(mesh, cfg)
    for k, v in (ctx_kw or {}).items():
        setattr(ctx, k, v)
    ctx.make_groups()
    return ctx


def _rows(x, ctx):
    """This rank's rows of a whole batch."""
    per = len(x) // ctx.dp_size
    i = ctx.index(ctx.batch_axes)
    return x[i * per:(i + 1) * per]


def _gather_rows(t, ctx):
    from repro_torch.sharding import collectives as C
    return C.all_gather(t, 0, ctx.group(ctx.batch_axes))


# ---------------------------------------------------------------------------
# the MoE layer on a (2, 4) mesh, both EP branches
# ---------------------------------------------------------------------------
def run_moe(rank, npz, out):
    from repro_torch.configs import get_config
    from repro_torch.models.layers import MoE, moe_axes
    from repro_torch.sharding.rules import local_slices, logical_to_pspec
    data = np.load(npz)
    cfg = get_config("qwen3-moe-235b-a22b").reduced(
        n_layers=1, d_model=64, n_experts=8, top_k=2, d_expert=32,
        vocab_size=512, dtype="float32", capacity_factor=8.0)
    results = {}
    for name, kw in (("psum", dict(fsdp=False)),
                     ("psum_bf16", dict(fsdp=False, moe_wire_bf16=True)),
                     ("gather", dict(moe_gather_tokens=True)),
                     ("gather_bf16", dict(moe_gather_tokens=True,
                                          moe_wire_bf16=True))):
        ctx = _mesh((2, 4), kw, cfg)
        layer = MoE(cfg, dtype=torch.float32, device=torch.device("cpu"))
        axes = moe_axes(cfg)
        for leaf, p in layer.named_parameters():
            # the experts' shards as the layer takes them (2D under FSDP,
            # which the token gather never gathers); the router whole, as
            # FSDP's per-block gather gives it to the layer
            w = torch.from_numpy(data[leaf])
            if leaf != "router":
                spec = logical_to_pspec(axes[leaf], ctx)
                w = w[local_slices(w.shape, spec, ctx.mesh)].contiguous()
            p.data = w
        x = torch.from_numpy(_rows(data["x"], ctx))
        with torch.no_grad():
            y = layer(x, ctx)
        results[name] = _gather_rows(y, ctx).numpy()
    if rank == 0:
        torch.save(results, out)


# ---------------------------------------------------------------------------
# one train step on a (4, 2) mesh against the reference's
# ---------------------------------------------------------------------------
def run_train_step(rank, cfg_kw, npz, micro, out):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import StepConfig, make_train_step
    data = np.load(npz, allow_pickle=True)
    cfg = get_config("deepseek-67b").reduced(**cfg_kw)
    tree = data["tree"].item()
    ctx = _mesh((4, 2), None, cfg)
    B = data["tokens"].shape[0]
    per_mb, dp = B // micro, ctx.dp_size
    # rank r's rows: its share of each of the reference's microbatches,
    # so that microbatch i here is the reference's microbatch i
    r = ctx.index(ctx.batch_axes)
    rows = np.concatenate([np.arange(i * per_mb + r * per_mb // dp,
                                     i * per_mb + (r + 1) * per_mb // dp)
                           for i in range(micro)])
    batch = {k: torch.from_numpy(data[k][rows]) for k in ("tokens", "labels")}
    res = {}
    for overlap in ("hybrid", "serial"):
        full = lm.params_from_reference(cfg, tree, device="cpu")
        local = lm.shard_params(full, ctx)
        step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=0),
                               ctx, StepConfig(microbatches=micro,
                                               overlap=overlap),
                               grad_pspecs=lm.param_pspecs(cfg, ctx))
        local, _, m = step(local, adamw_init(local), batch)
        whole = lm.gather_params(local, ctx)
        res[overlap] = {"loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "params": {n: p.detach().clone()
                                   for n, p in whole.named_parameters()}}
    if rank == 0:
        torch.save(res, out)


# ---------------------------------------------------------------------------
# the vocab-sharded embedding and cross entropy on a (2, 2) mesh
# ---------------------------------------------------------------------------
def run_embed_ce(rank, pt, out):
    from repro_torch.models import lm
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import local_slices, PartitionSpec
    d = torch.load(pt, weights_only=False)
    cfg = d["cfg"]
    ctx = _mesh((2, 2), None, cfg)
    m = ctx.model_axis
    table = d["table"][local_slices(d["table"].shape,
                                    PartitionSpec(m, None), ctx.mesh)]
    wout = d["w"][local_slices(d["w"].shape, PartitionSpec(None, m),
                               ctx.mesh)].clone().requires_grad_(True)
    h = _rows(d["h"], ctx).clone().requires_grad_(True)
    labels = _rows(d["labels"], ctx)
    emb = lm.embed_lookup(table, _rows(d["ids"], ctx), ctx)
    loss = lm.sharded_ce_loss(h, wout, labels, cfg, ctx)
    gh, gw = torch.autograd.grad(loss, (h, wout))
    # the weight's gradient is each rank's rows' share: add them over the
    # batch axes, as the train step does
    C.all_reduce_(gw, ctx.group(ctx.batch_axes))
    res = {"loss": loss.detach(), "embed": _gather_rows(emb, ctx),
           "gh": _gather_rows(gh, ctx),
           "gw": C.all_gather(gw, 1, ctx.group(m))}
    if rank == 0:
        torch.save(res, out)


# ---------------------------------------------------------------------------
# prefill and decode on every cache layout, against ctx=None
# ---------------------------------------------------------------------------
def run_serve(rank, cases, out):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    res = {}
    for name, (arch, cfg_kw, shape, ctx_kw, steps) in cases.items():
        cfg = get_config(arch).reduced(**cfg_kw)
        full = lm.init_params(cfg, 0, "cpu")
        ctx = _mesh(shape, ctx_kw, cfg)
        local = lm.shard_params(full, ctx)
        rng = np.random.default_rng(3)
        B, S = 4, 20
        tokens = rng.integers(0, cfg.vocab_size, (B, S))
        mine = tokens if ctx.seq_shard_cache else _rows(tokens, ctx)
        c0, o0 = lm.prefill(full, cfg, {"tokens": tokens}, max_len=S + steps)
        c1, o1 = lm.prefill(local, cfg, {"tokens": mine}, ctx,
                            max_len=S + steps)
        rows = (np.arange(B) if ctx.seq_shard_cache
                else _rows(np.arange(B), ctx))
        err = [float((o1 - o0[rows]).abs().max())]
        same = True
        t0, t1 = o0.argmax(-1), o1.argmax(-1)
        for _ in range(steps):
            c0, o0 = lm.decode_step(full, cfg, c0, t0)
            c1, o1 = lm.decode_step(local, cfg, c1, t1, ctx)
            err.append(float((o1 - o0[rows]).abs().max()))
            t0, t1 = o0.argmax(-1), o1.argmax(-1)
            same &= bool(torch.equal(t1, t0[rows]))
        res[name] = {"err": max(err), "same_tokens": same,
                     "cache_k": tuple(c1["k"].shape) if "k" in c1 else None}
        # every rank must agree
        flag = torch.tensor([int(same)])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        res[name]["all_same"] = bool(flag.item())
    if rank == 0:
        torch.save(res, out)


# ---------------------------------------------------------------------------
# elastic restore: a (2, 2) trainer's checkpoint on (4, 1) and (1, 1)
# ---------------------------------------------------------------------------
def run_elastic(rank, ckpt_dir, out):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import ShardCtx
    from repro_torch.train import StepConfig, Trainer, TrainerConfig
    cfg = get_config("qwen3-14b").reduced(n_layers=2)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                      seed=0)
    tcfg = TrainerConfig(steps=2, ckpt_every=1, ckpt_dir=ckpt_dir,
                         log_every=1)
    ctx = _mesh((2, 2), None, cfg)
    tr = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=0), tcfg, dcfg,
                 ctx=ctx, step_cfg=StepConfig(microbatches=2),
                 device="cpu")
    run = tr.run()
    saved = lm.gather_leaves(cfg, ctx, dict(run["params"].named_parameters()))
    dist.barrier()
    res = {"losses": [m["loss"] for m in run["metrics"]],
           "final_step": run["final_step"]}
    # (4, 1): the trainer's own restore, then gathered whole
    ctx4 = _mesh((4, 1), None, cfg)
    tr4 = Trainer(cfg, AdamWConfig(), tcfg, dcfg, ctx=ctx4, device="cpu")
    params4, opt4, start4 = tr4.init_or_restore()
    whole4 = lm.gather_leaves(cfg, ctx4, dict(params4.named_parameters()))
    m4 = lm.gather_leaves(cfg, ctx4, opt4["m"])
    res["start4"] = start4
    res["same4"] = all(torch.equal(whole4[n], saved[n]) for n in saved)
    res["local4_shape"] = tuple(params4.get_parameter(
        "blocks.0.mlp.wg").shape)
    if rank == 0:
        # (1, 1): a one-rank mesh's placements (every leaf whole)
        class One:
            mesh_dim_names = ("data", "model")
            shape = (1, 1)

            @staticmethod
            def get_coordinate():
                return [0, 0]

        tree, _ = Checkpointer(ckpt_dir).restore(
            device="cpu", shardings=Trainer.shardings_of(
                cfg, ShardCtx(mesh=One)), mesh=One)
        res["same1"] = all(torch.equal(tree["params"][n], saved[n])
                           for n in saved)
        res["m_whole"] = all(torch.equal(tree["opt_state"]["m"][n], m4[n])
                             for n in m4)
        torch.save(res, out)
