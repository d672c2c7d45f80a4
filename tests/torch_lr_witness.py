"""The reference's and the port's training trajectories from one parameter
tree, at the reference example's schedule (``examples/train_lm.py``: lr
3e-3 after 20 warmup steps, batch 8 of 256 tokens in 2 microbatches,
``overlap="hybrid"``).

Two initialisations of one configuration are run through both packages:

* ``reference``: the reference's own ``init_params``.  Its final norm
  scale starts at zero (so a fresh model's logits are zero); its block
  leaves are stacked over the layers and drawn at the stack's fan-in: the
  norm scales, (layers, d), as matrices at fan-in ``n_layers``, and the
  block matrices at ``n_layers * d``, not ``d``.
* ``port``: the port's ``init_params``: norm scales at one, each layer's
  matrices at its own fan-in (ROADMAP Queue C).

Each tree goes through the reference's jitted step and the port's step on
the CPU, so a trajectory that differs between the two packages is the
port's fault, and one that differs between the two trees is the
initialisation's.  ``tests/test_torch_train.py`` runs it at a tiny size;
run it at the example's ``100m`` width, cut in depth, with::

    PYTHONPATH=src:tests python tests/torch_lr_witness.py --layers 2

``--arch`` runs another configuration's ``reduced`` cut instead (widths
and depth from ``--cut``, a JSON object), at a schedule, stream and
microbatch count of one's choosing; ``chip_smoke.train_step_phase``'s SSM
train steps, narrowed for the CPU, with::

    PYTHONPATH=src:tests python tests/torch_lr_witness.py \
        --arch zamba2-7b --cut '{"n_layers": 12, "d_model": 896, ...}' \
        --lr 1e-3 --warmup 2 --steps 8 --seq 256 --batch 4 --micro 2 \
        --inits port

It prints one JSON object per (initialisation, package) with the loss of
every step and the loss of a held-out batch before and after, and the
mean loss of the trained batches before and after.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.train.steps import StepConfig as JaxStepConfig
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.models import init_params, params_from_reference
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import StepConfig, make_eval_step, make_train_step

#: the reference example's schedule and stream (``examples/train_lm.py``)
EXAMPLE_OPT = dict(lr=3e-3, warmup_steps=20, total_steps=40)
EXAMPLE_DATA = dict(seq_len=256, global_batch=8, seed=0)
EXAMPLE_MICRO = 2
#: the data step of the held-out batch (as ``chip_smoke.HELD_OUT_STEP``)
HELD_OUT_STEP = 1_000_000


def example_cfgs(scale: str = "100m", **cut):
    """The reference example's configuration in both packages, cut by
    ``cut`` (``n_layers`` and, for the tests, widths)."""
    kw = dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
              head_dim=64, d_ff=2048, vocab_size=32768, dtype="float32")
    if scale != "100m":
        raise ValueError(f"unknown scale {scale!r}")
    kw.update(cut)
    return (jax_get_config("deepseek-67b").reduced(**kw),
            get_config("deepseek-67b").reduced(**kw))


def arch_cfgs(arch: str, **cut):
    """``arch``'s ``reduced`` configuration in both packages, with
    ``cut``."""
    return (jax_get_config(arch).reduced(**cut),
            get_config(arch).reduced(**cut))


def reference_init_tree(jcfg, seed: int = 0):
    """The reference's fresh tree, as numpy."""
    return jax.tree.map(np.asarray,
                        jax_lm.init_params(jcfg, jax.random.PRNGKey(seed)))


def port_init_tree(jcfg, cfg, seed: int = 0):
    """The port's fresh ``LM`` in the reference's layout: each block leaf
    stacked over the layers (``blocks/attn/wq[i]`` from ``blocks.i.attn.wq``)."""
    params = {n: p.detach().numpy()
              for n, p in init_params(cfg, seed=seed,
                                      device="cpu").named_parameters()}
    layout = reference_init_tree(jcfg, seed)

    def fill(path, x):
        keys = [p.key for p in path]
        if keys[0] in ("blocks", "enc_blocks"):
            y = np.stack([params[".".join([keys[0], str(i)] + keys[1:])]
                          for i in range(x.shape[0])])
        else:
            y = params[".".join(keys)]
        assert y.shape == x.shape, (keys, y.shape, x.shape)
        return y.astype(x.dtype)

    return jax.tree_util.tree_map_with_path(fill, layout)


def _batches(cfg, steps, data_kw):
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, **data_kw))
    return [data.batch_at(s) for s in range(steps)], data.batch_at(HELD_OUT_STEP)


def reference_losses(jcfg, tree, steps, opt_kw, data_kw, micro):
    """(per-step losses, held-out loss before and after, the trained
    batches' mean loss before and after) of the reference's jitted hybrid
    step from ``tree``."""
    batches, held = _batches(jcfg, steps, data_kw)
    step = jax.jit(jax_make_train_step(
        jcfg, JaxAdamWConfig(**opt_kw), None,
        JaxStepConfig(microbatches=micro, overlap="hybrid")))
    evaluate = jax.jit(lambda p, b: jax_lm.loss_fn(p, jcfg, b, None))
    params = jax.tree.map(jnp.asarray, tree)
    state = jax_adamw_init(params)
    held_j = {k: jnp.asarray(v) for k, v in held.items()}
    jbs = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    before = float(evaluate(params, held_j))
    trained = [np.mean([float(evaluate(params, b)) for b in jbs])]
    losses = []
    for b in jbs:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    trained.append(np.mean([float(evaluate(params, b)) for b in jbs]))
    return losses, [before, float(evaluate(params, held_j))], trained


def port_losses(jcfg, cfg, tree, steps, opt_kw, data_kw, micro):
    """(per-step losses, held-out loss before and after, the trained
    batches' mean loss before and after) of the port's hybrid step from
    ``tree``, on the CPU."""
    batches, held = _batches(cfg, steps, data_kw)
    model = params_from_reference(cfg, tree, device="cpu")
    state = adamw_init(model)
    step = make_train_step(cfg, AdamWConfig(**opt_kw), None,
                           StepConfig(microbatches=micro, overlap="hybrid"))
    evaluate = make_eval_step(cfg)
    before = float(evaluate(model, held))
    trained = [np.mean([float(evaluate(model, b)) for b in batches])]
    losses = []
    for b in batches:
        model, state, m = step(model, state, b)
        losses.append(float(m["loss"]))
    trained.append(np.mean([float(evaluate(model, b)) for b in batches]))
    return losses, [before, float(evaluate(model, held))], trained


def trajectories(jcfg, cfg, steps, opt_kw=EXAMPLE_OPT, data_kw=EXAMPLE_DATA,
                 micro=EXAMPLE_MICRO, inits=("reference", "port")):
    """{init: {package: (losses, held-out before/after, trained batches
    before/after)}}."""
    out = {}
    for init in inits:
        tree = (reference_init_tree(jcfg) if init == "reference"
                else port_init_tree(jcfg, cfg))
        out[init] = {
            "reference": reference_losses(jcfg, tree, steps, opt_kw, data_kw,
                                          micro),
            "port": port_losses(jcfg, cfg, tree, steps, opt_kw, data_kw,
                                micro)}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2,
                    help="depth of the 100m configuration (12 uncut)")
    ap.add_argument("--arch", default=None,
                    help="another configuration, cut by --cut")
    ap.add_argument("--cut", default="{}",
                    help="JSON overrides of --arch's reduced configuration")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lr", type=float, default=EXAMPLE_OPT["lr"])
    ap.add_argument("--warmup", type=int,
                    default=EXAMPLE_OPT["warmup_steps"])
    ap.add_argument("--seq", type=int, default=EXAMPLE_DATA["seq_len"])
    ap.add_argument("--batch", type=int, default=EXAMPLE_DATA["global_batch"])
    ap.add_argument("--micro", type=int, default=EXAMPLE_MICRO)
    ap.add_argument("--data-seed", type=int, default=EXAMPLE_DATA["seed"])
    ap.add_argument("--seed", type=int, default=0,
                    help="the initialisations' seed")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--inits", nargs="+", default=["reference", "port"],
                    choices=["reference", "port"])
    ap.add_argument("--packages", nargs="+", default=["reference", "port"],
                    choices=["reference", "port"])
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    if args.arch is None:
        jcfg, cfg = example_cfgs(n_layers=args.layers)
    else:
        jcfg, cfg = arch_cfgs(args.arch, **json.loads(args.cut))
    opt_kw = dict(EXAMPLE_OPT, lr=args.lr, warmup_steps=args.warmup,
                  total_steps=args.steps)
    data_kw = dict(seq_len=args.seq, global_batch=args.batch,
                   seed=args.data_seed)
    for init in args.inits:
        tree = (reference_init_tree(jcfg, args.seed) if init == "reference"
                else port_init_tree(jcfg, cfg, args.seed))
        for package in args.packages:
            t0 = time.perf_counter()
            if package == "reference":
                losses, held, trained = reference_losses(
                    jcfg, tree, args.steps, opt_kw, data_kw, args.micro)
            else:
                losses, held, trained = port_losses(
                    jcfg, cfg, tree, args.steps, opt_kw, data_kw, args.micro)
            print(json.dumps({"init": init, "seed": args.seed,
                              "package": package,
                              "arch": args.arch or "100m",
                              "layers": cfg.n_layers, "opt": opt_kw,
                              "data": data_kw, "micro": args.micro,
                              "losses": losses, "held_out_loss": held,
                              "trained_batches_loss": trained,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)


if __name__ == "__main__":
    main()
