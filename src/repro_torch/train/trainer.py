"""Fault-tolerant training loop.

The port of the reference's ``repro/train/trainer.py`` on one device:

* checkpoint/restart: async checkpoints every ``ckpt_every`` steps; on
  start the trainer restores the latest checkpoint and the data pipeline
  resumes deterministically from the restored step;
* preemption: SIGTERM (or :meth:`Trainer.request_preemption`) stops the
  loop at the next step boundary, after which a synchronous final
  checkpoint is written, as at the end of every run — a restart resumes
  exactly;
* the input pipeline's prefetch thread keeps the device from waiting for
  the host, and the step's hybrid schedule joins each microbatch's
  gradient bucket beside the next microbatch's compute.

The trainer runs on ``device`` (CUDA by default, raising without one;
``device="cpu"`` runs on the host).  Its checkpoint holds ``{"params":
{name: tensor}, "opt_state": {"m", "v", "step"}}``, whole leaves.

With a mesh in ``ctx`` (every rank of the process group runs the same
trainer) each rank trains its shards on its rows of every batch; a
checkpoint gathers the parameters and moments whole (every rank takes
part) and rank 0 alone writes it; a restart restores each rank's shards
elastically (``shardings``: placements over the saved tree, by default
those of ``ctx``), so a run saved on one mesh resumes on another.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Dict, Optional, Union

import torch

import torch.distributed as dist

from ..checkpoint import Checkpointer
from ..data import DataConfig, SyntheticLMData
from ..linalg.tiles import resolve_device
from ..models import lm
from ..models.config import ModelConfig
from ..models.layers import sharded
from ..sharding.rules import named
from ..optim.adamw import AdamWConfig, adamw_init
from .steps import StepConfig, make_train_step

__all__ = ["Trainer", "TrainerConfig"]

Device = Union[str, torch.device, None]


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                 tcfg: TrainerConfig, data_cfg: DataConfig,
                 ctx=None, step_cfg: StepConfig = StepConfig(),
                 shardings: Optional[Dict[str, Any]] = None,
                 device: Device = None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.ctx = ctx
        self.device = resolve_device(device)
        self.data = SyntheticLMData(data_cfg)
        self.ckpt = Checkpointer(tcfg.ckpt_dir)
        self.step_fn = make_train_step(cfg, opt_cfg, ctx, step_cfg)
        if shardings is None and sharded(ctx):
            shardings = self.shardings_of(cfg, ctx)
        self.shardings = shardings
        self._preempted = False
        self.metrics_log = []

    @staticmethod
    def shardings_of(cfg: ModelConfig, ctx) -> Dict[str, Any]:
        """The placements of every leaf of the trainer's checkpoint tree
        under ``ctx`` (the moments take their parameter's)."""
        per = named(lm._name_pspecs(cfg, ctx), ctx.mesh)
        return {"params": per, "opt_state": {"m": per, "v": per,
                                             "step": None}}

    def _writes(self) -> bool:
        """Whether this rank writes checkpoints (rank 0 of a mesh)."""
        return not sharded(self.ctx) or dist.get_rank() == 0

    def request_preemption(self, *_args) -> None:
        """SIGTERM handler / test hook: checkpoint and stop at the next
        step boundary."""
        self._preempted = True

    # ------------------------------------------------------------------
    def init_or_restore(self):
        """``(params, opt_state, start_step)``: the latest checkpoint's, or
        a fresh model from ``tcfg.seed`` at step 0; the parameters require
        grad."""
        ctx = self.ctx
        restored, manifest = self.ckpt.restore(
            device=self.device, shardings=self.shardings,
            mesh=ctx.mesh if sharded(ctx) else None)
        if restored is not None:
            params = (lm.local_params(self.cfg, ctx, self.device)
                      if sharded(ctx) else lm.LM(self.cfg, self.device))
            params.load_state_dict(restored["params"])
            opt_state = restored["opt_state"]
            start = int(manifest["step"])
        else:
            params = lm.init_params(self.cfg, self.tcfg.seed, self.device)
            if sharded(ctx):
                params = lm.shard_params(params, ctx)
            opt_state = adamw_init(params)
            start = 0
        params.requires_grad_(True)
        return params, opt_state, start

    def _batch(self, host_batch) -> Dict[str, torch.Tensor]:
        """A host batch on the device (with a mesh, this rank's rows), with
        an encdec's encoder input (16 frames) or a vlm's patches as zeros
        when the data has none, as the reference's trainer adds them."""
        dev, cfg, ctx = self.device, self.cfg, self.ctx
        if sharded(ctx):
            per = len(host_batch["tokens"]) // ctx.dp_size
            i = ctx.index(ctx.batch_axes)
            host_batch = {k: v[i * per:(i + 1) * per]
                          for k, v in host_batch.items()}
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in host_batch.items()}
        b = batch["tokens"].shape[0]
        if cfg.family == "encdec" and "enc_input" not in batch:
            batch["enc_input"] = torch.zeros((b, 16, cfg.d_model),
                                             dtype=cfg.torch_dtype, device=dev)
        if cfg.family == "vlm" and "patches" not in batch:
            batch["patches"] = torch.zeros((b, cfg.n_patches, cfg.d_model),
                                           dtype=cfg.torch_dtype, device=dev)
        return batch

    def _tree(self, params, opt_state) -> Dict[str, Any]:
        """The checkpoint tree, every leaf whole (gathered over the mesh:
        collective)."""
        named_params = dict(params.named_parameters())
        if not sharded(self.ctx):
            return {"params": named_params, "opt_state": opt_state}
        whole = lambda d: lm.gather_leaves(self.cfg, self.ctx, d)  # noqa
        return {"params": whole(named_params),
                "opt_state": {"m": whole(opt_state["m"]),
                              "v": whole(opt_state["v"]),
                              "step": opt_state["step"]}}

    def run(self, install_sigterm: bool = False) -> Dict[str, Any]:
        if install_sigterm:
            signal.signal(signal.SIGTERM, self.request_preemption)
        params, opt_state, start = self.init_or_restore()
        self.data.start(from_step=start)
        it = iter(self.data)
        step = start
        t0 = time.perf_counter()
        try:
            while step < self.tcfg.steps and not self._preempted:
                _, host_batch = next(it)
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, self._batch(host_batch))
                step += 1
                if step % self.tcfg.log_every == 0 or step == self.tcfg.steps:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step
                    m["sec"] = time.perf_counter() - t0
                    self.metrics_log.append(m)
                if step % self.tcfg.ckpt_every == 0:
                    tree = self._tree(params, opt_state)
                    if self._writes():
                        self.ckpt.save_async(
                            step, tree,
                            extra={"data": self.data.state_dict()})
                    del tree
        finally:
            self.data.stop()
        # preemption or completion: synchronous final checkpoint
        tree = self._tree(params, opt_state)
        if self._writes():
            self.ckpt.save(step, tree,
                           extra={"data": self.data.state_dict(),
                                  "preempted": self._preempted})
        del tree
        self.ckpt.wait()
        if sharded(self.ctx):
            dist.barrier()
        return {"final_step": step, "params": params, "opt_state": opt_state,
                "metrics": self.metrics_log, "preempted": self._preempted}
