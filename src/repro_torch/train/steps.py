"""Train and eval steps, with microbatch buckets whose data-parallel
reduction overlaps the next microbatch's compute.

The port of the reference's ``repro/train/steps.py``.  The reference's
``hybrid`` schedule (the paper's Fig. 2) carries microbatch i's gradient
bucket into iteration i + 1, where it joins the float32 accumulator
alongside microbatch i + 1's compute; ``serial`` adds each bucket as soon
as it exists.  Both sum the same buckets in the same order.

On a mesh (``ctx`` with a mesh; each rank holds its shards and its rows of
the batch) the bucket's data-parallel reduction is real: the gradients of
the leaves no batch axis shards are added over the batch axes in one
all-reduce a bucket.  ``hybrid`` issues bucket i's all-reduce
(``async_op=True``) as soon as its backward is done and waits for it only
when the bucket joins in iteration i + 1, so it runs beside microbatch
i + 1's compute; ``serial`` reduces each bucket at once.  Leaves FSDP
shards over the batch axes (their ``embed`` dimension) are summed by the
reduce-scatter of their per-block gather's backward instead, and the
MoE's ``gather_tokens`` experts see every rank's tokens and need no sum.

On a CUDA device the hybrid step issues each bucket's join on a side
stream that waits for the bucket (and its all-reduce) and runs beside the
next microbatch's forward and backward on the main stream; the main
stream waits for the side stream before the optimizer.  On the CPU the
join runs in line.

A step under a torch profiler records its spans
(:mod:`repro_torch.obs.spans`): ``repro.train.step``, and inside it
``repro.train.grad`` (a microbatch's forward and backward),
``repro.train.join`` (a bucket's join, its device interval on the join's
own stream) and ``repro.train.update`` (AdamW), each with its device
interval on CUDA, and the counters ``repro.train.microbatches`` and
``repro.train.joins``.

``compress_grads`` is the reference's bf16 wire format: each bucket is
rounded to bfloat16 before it joins, and all-reduced in bfloat16 (hybrid
only, as in the reference).  The accumulated gradient is the mean over
microbatches.  Gradients stay in the parameters' layout (``grad_pspecs``,
when given, must be ``lm.param_pspecs(cfg, ctx)``: the reference's
sharding constraint holds by construction).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..models import lm
from ..models.config import ModelConfig
from ..models.layers import sharded
from ..obs import spans
from ..optim.adamw import AdamWConfig, adamw_update
from ..sharding import collectives as C
from ..sharding.rules import axes_of

__all__ = ["StepConfig", "make_decode_step", "make_eval_step",
           "make_prefill_step", "make_train_step"]

_STEP, _GRAD, _JOIN, _UPDATE = ("repro.train.step", "repro.train.grad",
                                "repro.train.join", "repro.train.update")


@dataclasses.dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    overlap: str = "hybrid"        # "hybrid" (paper) | "serial" (baseline)
    compress_grads: bool = False   # bf16 wire format of each bucket
    remat: bool = True


def _value_and_grad(params, cfg: ModelConfig, batch, remat: bool, ctx=None):
    """``(loss, {name: grad})`` of ``lm.loss_fn`` at ``batch``; every
    parameter gets a gradient (zeros where it took no part, as
    ``jax.value_and_grad`` gives)."""
    names, leaves = zip(*params.named_parameters())
    with torch.enable_grad():
        loss = lm.loss_fn(params, cfg, batch, ctx, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), {n: g.contiguous() for n, g in zip(names, grads)}


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class _Bucket:
    """One microbatch's gradients and the all-reduce, over the batch
    axes, of those no batch axis shards (``names``): one buffer (in
    bfloat16 with ``compress``), issued at once."""

    def __init__(self, grads: Dict[str, torch.Tensor], names, group,
                 compress: bool, async_op: bool):
        self.grads, self.names = grads, names
        self.flat = self.work = None
        if group is None or not names:
            return
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        self.flat = flat.to(torch.bfloat16) if compress else flat
        self.work = C.all_reduce_(self.flat, group, async_op=async_op)

    def ready(self) -> Dict[str, torch.Tensor]:
        """The gradients, the reduced leaves summed over the batch axes
        (waiting for the all-reduce on the current stream)."""
        if self.flat is None:
            return self.grads
        if self.work is not None:
            self.work.wait()
        i = 0
        for n in self.names:
            g = self.grads[n]
            self.grads[n] = self.flat[i:i + g.numel()].view(g.shape)
            i += g.numel()
        return self.grads


def _join(acc: Dict[str, torch.Tensor], bucket: _Bucket, compress: bool,
          stream: Optional["torch.cuda.Stream"],
          sp: Optional[spans.Spans]) -> None:
    """``acc += wire(bucket)``, leaf by leaf (float32 accumulator).  With a
    side ``stream``, the wait for the bucket's all-reduce and the adds are
    issued there after the bucket is ready on the current stream, and the
    bucket's memory is kept until they ran.  ``sp`` takes the join's span
    on the stream the adds run on."""
    def add():
        sid = sp.begin(_JOIN, stream=stream) if sp is not None else 0
        grads = bucket.ready()
        for n, g in grads.items():
            acc[n].add_(g.to(torch.bfloat16) if compress else g)
        if sp is not None:
            sp.end(sid, stream=stream)
        return grads

    if stream is None:
        add()
        return
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        grads = add()
    for g in list(grads.values()) + ([bucket.flat] if bucket.flat is not None
                                     else []):
        g.record_stream(stream)


def _dp_names(cfg: ModelConfig, ctx):
    """The leaves whose gradients the step adds over the batch axes: those
    no batch axis shards."""
    if not sharded(ctx) or ctx.dp_size == 1:
        return ()
    batch = set(ctx.batch_axes)
    return tuple(n for n, spec in lm._name_pspecs(cfg, ctx).items()
                 if not any(set(axes_of(e)) & batch for e in spec))


def _norm_shares(cfg: ModelConfig, ctx):
    """``(shares, group)`` for the global gradient norm over the mesh: each
    leaf's squared sum counted once over the ranks holding the same shard
    (None without a mesh)."""
    if not sharded(ctx):
        return None, None
    world = ctx.size(ctx.batch_axes + (ctx.model_axis,))
    shares = {}
    for n, spec in lm._name_pspecs(cfg, ctx).items():
        shards = 1
        for e in spec:
            shards *= ctx.size(axes_of(e))
        shares[n] = shards / world
    return shares, ctx.group(ctx.batch_axes + (ctx.model_axis,))


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
    if grad_pspecs is not None and (not sharded(ctx) or grad_pspecs
                                    != lm.param_pspecs(cfg, ctx)):
        raise ValueError("gradients take the parameters' layout: "
                         "grad_pspecs must be lm.param_pspecs(cfg, ctx)")
    if step_cfg.overlap not in ("hybrid", "serial"):
        raise ValueError(f"overlap must be 'hybrid' or 'serial', got "
                         f"{step_cfg.overlap!r}")
    micro = step_cfg.microbatches
    streams: Dict[torch.device, "torch.cuda.Stream"] = {}
    names = _dp_names(cfg, ctx)
    group = ctx.group(ctx.batch_axes) if names else None
    shares, norm_group = _norm_shares(cfg, ctx)

    def update(params, grads, opt_state, sp):
        sid = sp.begin(_UPDATE) if sp is not None else 0
        out = adamw_update(opt_cfg, params, grads, opt_state, shares,
                           norm_group)
        if sp is not None:
            sp.end(sid)
        return out

    def grad(params, batch, sp):
        sid = sp.begin(_GRAD) if sp is not None else 0
        out = _value_and_grad(params, cfg, batch, step_cfg.remat, ctx)
        if sp is not None:
            sp.end(sid)
        return out

    def traced(body):
        """``body`` with the step's span around it when spans are on."""
        def step(params, opt_state, batch):
            sp = spans.open_call(_STEP)
            if sp is None:
                return body(params, opt_state, batch, None)
            try:
                return body(params, opt_state, batch, sp)
            finally:
                sp.close()
        return step

    @traced
    def single(params, opt_state, batch, sp):
        params.requires_grad_(True)
        batch = _on_device(batch, params.device)
        loss, grads = grad(params, batch, sp)
        grads = _Bucket(grads, names, group, False, False).ready()
        params, opt_state, info = update(params, grads, opt_state, sp)
        if sp is not None:
            sp.count("repro.train.microbatches", 1)
        return params, opt_state, {"loss": loss, **info}

    if micro == 1:
        return single

    @traced
    def accumulated(params, opt_state, batch, sp):
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
                loss, g = grad(params, mb, sp)
                _join(acc, _Bucket(g, names, group, False, False), False,
                      None, sp)
                loss_sum = loss_sum + loss
                del g
        else:
            # bucket i's all-reduce runs while microbatch i + 1 computes,
            # and the bucket joins then; the reference's first join adds a
            # zero bucket, which changes no bit and is skipped
            stream = None
            if dev.type == "cuda":
                stream = streams.setdefault(dev, torch.cuda.Stream(dev))
            prev = None
            for mb in mbs:
                if prev is not None:
                    _join(acc, prev, step_cfg.compress_grads, stream, sp)
                loss, g = grad(params, mb, sp)
                prev = _Bucket(g, names, group, step_cfg.compress_grads,
                               True)
                loss_sum = loss_sum + loss
            _join(acc, prev, step_cfg.compress_grads, stream, sp)
            del prev
            if stream is not None:
                torch.cuda.current_stream().wait_stream(stream)
        for a in acc.values():
            a.div_(micro)
        params, opt_state, info = update(params, acc, opt_state, sp)
        if sp is not None:
            sp.count("repro.train.microbatches", micro)
            sp.count("repro.train.joins", micro)
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
