"""Train and eval steps, with microbatch buckets that join the gradient
accumulator one microbatch late.

The port of the reference's ``repro/train/steps.py`` on one device.  The
reference's ``hybrid`` schedule (the paper's Fig. 2) carries microbatch
i's gradient bucket into iteration i + 1, where it joins the float32
accumulator alongside microbatch i + 1's compute, so that a data-parallel
reduction of the bucket would overlap that compute; ``serial`` adds each
bucket as soon as it exists.  Both sum the same buckets in the same order.
Here, on a CUDA device, the hybrid step issues each bucket's join on a
side stream that waits for the bucket and runs beside the next
microbatch's forward and backward on the main stream; the main stream
waits for the side stream before the optimizer.  On the CPU the join runs
in line.

``compress_grads`` is the reference's bf16 wire format: each bucket is
rounded to bfloat16 before it joins (hybrid only, as in the reference).
The accumulated gradient is the mean over microbatches.  A sharding
(``ctx``, ``grad_pspecs``) raises: ROADMAP Queue A item 12.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..models import lm
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig, adamw_update

__all__ = ["StepConfig", "make_decode_step", "make_eval_step",
           "make_prefill_step", "make_train_step"]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    overlap: str = "hybrid"        # "hybrid" (paper) | "serial" (baseline)
    compress_grads: bool = False   # bf16 wire format of each bucket
    remat: bool = True


def _value_and_grad(params, cfg: ModelConfig, batch, remat: bool):
    """``(loss, {name: grad})`` of ``lm.loss_fn`` at ``batch``; every
    parameter gets a gradient (zeros where it took no part, as
    ``jax.value_and_grad`` gives)."""
    names, leaves = zip(*params.named_parameters())
    with torch.enable_grad():
        loss = lm.loss_fn(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), {n: g.contiguous() for n, g in zip(names, grads)}


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _join(acc: Dict[str, torch.Tensor], bucket: Dict[str, torch.Tensor],
          compress: bool, stream: Optional["torch.cuda.Stream"]) -> None:
    """``acc += wire(bucket)``, leaf by leaf (float32 accumulator).  With a
    side ``stream``, the adds are issued there after the bucket is ready on
    the current stream, and the bucket's memory is kept until they ran."""
    def add():
        for n, g in bucket.items():
            acc[n].add_(g.to(torch.bfloat16) if compress else g)

    if stream is None:
        add()
        return
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        add()
    for g in bucket.values():
        g.record_stream(stream)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, ctx=None,
                    step_cfg: StepConfig = StepConfig(), grad_pspecs=None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, metrics ``{"loss", "lr", "grad_norm"}`` as device scalars.

    ``params`` is an :class:`~repro_torch.models.lm.LM`; the step turns its
    gradients on and **updates it and ``opt_state`` in place** (the
    reference returns new trees), and returns them.  ``batch`` holds
    ``"tokens"`` and ``"labels"`` ``(B, S)`` (and an encdec's
    ``"enc_input"`` or a vlm's ``"patches"``), numpy or tensors; with
    ``microbatches = m`` it is cut into m equal slices of the batch axis."""
    if ctx is not None or grad_pspecs is not None:
        raise NotImplementedError(
            "sharded train steps are not ported to repro_torch yet; see "
            "ROADMAP Queue A item 12 (sharding/)")
    if step_cfg.overlap not in ("hybrid", "serial"):
        raise ValueError(f"overlap must be 'hybrid' or 'serial', got "
                         f"{step_cfg.overlap!r}")
    micro = step_cfg.microbatches
    streams: Dict[torch.device, "torch.cuda.Stream"] = {}

    def single(params, opt_state, batch):
        params.requires_grad_(True)
        batch = _on_device(batch, params.device)
        loss, grads = _value_and_grad(params, cfg, batch, step_cfg.remat)
        params, opt_state, info = adamw_update(opt_cfg, params, grads,
                                               opt_state)
        return params, opt_state, {"loss": loss, **info}

    if micro == 1:
        return single

    def accumulated(params, opt_state, batch):
        params.requires_grad_(True)
        dev = params.device
        batch = _on_device(batch, dev)
        b = batch["tokens"].shape[0]
        if b % micro:
            raise ValueError(f"a batch of {b} does not split into {micro} "
                             f"microbatches")
        per = b // micro
        mbs = [{k: x[i * per:(i + 1) * per] for k, x in batch.items()}
               for i in range(micro)]
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for n, p in params.named_parameters()}
        loss_sum = 0.0
        if step_cfg.overlap == "serial":
            for mb in mbs:
                loss, g = _value_and_grad(params, cfg, mb, step_cfg.remat)
                _join(acc, g, False, None)
                loss_sum = loss_sum + loss
                del g
        else:
            # bucket i joins while microbatch i + 1 computes; the
            # reference's first join adds a zero bucket, which changes no
            # bit and is skipped
            stream = None
            if dev.type == "cuda":
                stream = streams.setdefault(dev, torch.cuda.Stream(dev))
            prev = None
            for mb in mbs:
                if prev is not None:
                    _join(acc, prev, step_cfg.compress_grads, stream)
                loss, prev = _value_and_grad(params, cfg, mb, step_cfg.remat)
                loss_sum = loss_sum + loss
            _join(acc, prev, step_cfg.compress_grads, stream)
            del prev
            if stream is not None:
                torch.cuda.current_stream().wait_stream(stream)
        for a in acc.values():
            a.div_(micro)
        params, opt_state, info = adamw_update(opt_cfg, params, acc,
                                               opt_state)
        return params, opt_state, {"loss": loss_sum / micro, **info}

    return accumulated


def make_eval_step(cfg: ModelConfig, ctx=None, remat: bool = False):
    """``step(params, batch) -> loss`` without gradients."""
    def step(params, batch):
        with torch.no_grad():
            return lm.loss_fn(params, cfg, _on_device(batch, params.device),
                              ctx, remat=remat)
    return step


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig, ctx, max_len: int):
    def step(params, batch):
        return lm.prefill(params, cfg, batch, ctx, max_len=max_len)
    return step


def make_decode_step(cfg: ModelConfig, ctx):
    def step(params, cache, tokens):
        return lm.decode_step(params, cfg, cache, tokens, ctx)
    return step
