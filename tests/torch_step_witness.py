"""How far three free-running train steps of the port carry reduced
mamba2 and zamba2 from the reference's, and why.

From one tree (``test_torch_train.ssm_tree``) and the same three
``SyntheticLMData`` batches as
``test_torch_train.test_three_ssm_train_steps_match_the_reference``, each
package runs three ``single`` steps (lr 1e-3, clipping at 1.0) on the
CPU.  For each model it prints the share of parameters more than
``STEP_ATOL`` apart after step 3:

* ``free``: each package from its own state;
* ``step1_params``: the port's parameters after step 1 replaced by the
  reference's (its own ``m`` and ``v`` kept);
* ``from_reference``: each of the port's steps from the reference's
  parameters and Adam state;

and after step 1 the number of parameters apart with the largest clipped
step-1 gradient among them.  Run with::

    PYTHONPATH=src:tests python tests/torch_step_witness.py
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import lm as jax_lm
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.models import params_from_reference
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import StepConfig, make_train_step
from test_torch_train import (STEP_ATOL, JaxAdamWConfig, JaxStepConfig,
                              _by_port_name, _cfgs, jax_adamw_init,
                              jax_make_train_step, ssm_tree)

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, clip_norm=1.0)
DATA = dict(seq_len=64, global_batch=4, seed=3)
#: (arch, cut): zamba2 with its shared block in both layers (the test's
#: ``CUTS``) and in one
MODELS = (("mamba2-2.7b", {}), ("zamba2-7b", {}),
          ("zamba2-7b", {"attn_every": 2}))


def _load(model, state, jp, jst, cfg, what):
    """Copy the reference's parameters (``"p"``) and Adam state
    (``"s"``) into the port's."""
    with torch.no_grad():
        if "p" in what:
            ref = _by_port_name(cfg, jp)
            for n, p in model.named_parameters():
                p.copy_(torch.from_numpy(np.array(ref[n])))
        if "s" in what:
            for k in ("m", "v"):
                ref = _by_port_name(cfg, jst[k])
                for n, t in state[k].items():
                    t.copy_(torch.from_numpy(np.array(ref[n])))
            state["step"].fill_(int(jst["step"]))


def _apart(model, jp, cfg):
    ref = _by_port_name(cfg, jp)
    return {n: np.abs(p.detach().numpy() - ref[n]) > STEP_ATOL
            for n, p in model.named_parameters()}


def witness(arch, cut):
    jcfg, cfg = _cfgs(arch, **cut)
    tree = ssm_tree(jcfg, seed=1)
    batches = [SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, **DATA))
               .batch_at(s) for s in range(3)]
    jbs = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    jstep = jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(**OPT), None,
                                        JaxStepConfig(microbatches=1)))
    g = _by_port_name(cfg, jax.grad(
        lambda p: jax_lm.loss_fn(p, jcfg, jbs[0], None))(
            jax.tree.map(jnp.asarray, tree)))
    norm = np.sqrt(sum(np.sum(np.square(x, dtype=np.float64))
                       for x in g.values()))
    out = {"arch": arch, "cut": cut}
    for mode, load in (("free", ""), ("step1_params", "p"),
                       ("from_reference", "ps")):
        jp = jax.tree.map(jnp.asarray, tree)
        jst = jax_adamw_init(jp)
        model = params_from_reference(cfg, tree, device="cpu")
        state = adamw_init(model)
        step = make_train_step(cfg, AdamWConfig(**OPT), None,
                               StepConfig(microbatches=1))
        for i, (b, jb) in enumerate(zip(batches, jbs)):
            if mode == "from_reference":
                _load(model, state, jp, jst, cfg, load)
            jp, jst, _ = jstep(jp, jst, jb)
            model, state, _ = step(model, state, b)
            if i == 0 and mode == "free":
                far = _apart(model, jp, cfg)
                clip = min(1.0, OPT["clip_norm"] / norm)
                grads = np.concatenate([np.abs(g[n][f]) * clip
                                        for n, f in far.items()])
                out["step1_apart"] = int(grads.size)
                out["step1_apart_max_clipped_grad"] = float(grads.max())
            if i == 0 and mode == "step1_params":
                _load(model, state, jp, jst, cfg, load)
        far = _apart(model, jp, cfg)
        out[mode] = (sum(int(f.sum()) for f in far.values())
                     / sum(f.size for f in far.values()))
    out["params"] = sum(f.size for f in far.values())
    return out


def main():
    torch.set_num_threads(4)
    for arch, cut in MODELS:
        print(json.dumps(witness(arch, cut)), flush=True)


if __name__ == "__main__":
    main()
