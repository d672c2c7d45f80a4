"""AdamW with global-norm clipping and a warmup + cosine schedule.

The port of the reference's ``repro/optim/adamw.py`` over an :class:`LM`'s
named parameters.  The optimizer state mirrors them: ``{"m": {name:
tensor}, "v": {name: tensor}, "step": tensor}``, ``m`` and ``v`` float32
on the parameters' device, ``step`` an int32 scalar there.  Gradients are
a ``{name: tensor}`` dict in the same names.

The arithmetic is the reference's, operation by operation: the clipped
gradients are rounded back to their own type; ``m`` and ``v`` take the
float32 gradient; the bias corrections divide them; the update is ``p32 -
lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p32)``, rounded once to
the parameter's type; weight decay applies to every leaf, norms included.
Unlike the reference, which returns new trees, the update works in place
and in chunks of :data:`CHUNK` elements, so no temporary is larger than a
chunk: written leaf by leaf, a 778.6 M-element embedding would make
several 3.1 GB float32 temporaries.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

__all__ = ["AdamWConfig", "CHUNK", "adamw_init", "adamw_update",
           "clip_by_global_norm", "lr_schedule"]

#: elements per chunk of the in-place update (a 128 MB float32 temporary)
CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), as a float32 tensor on its
    device: linear warmup to ``cfg.lr``, then a cosine down to
    ``min_lr_frac * lr`` at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = (step - cfg.warmup_steps) / max(1.0,
                                           cfg.total_steps - cfg.warmup_steps)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: nn.Module) -> Dict[str, object]:
    """Zero float32 ``m`` and ``v`` for every named parameter, on its
    device, and ``step`` 0."""
    named = list(params.named_parameters())
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,   # noqa: E731
                                  device=p.device)
    return {"m": {n: zeros(p) for n, p in named},
            "v": {n: zeros(p) for n, p in named},
            "step": torch.zeros((), dtype=torch.int32,
                                device=named[0][1].device)}


def _chunks(*tensors: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Views of :data:`CHUNK` consecutive elements of each (contiguous)
    tensor, side by side."""
    flat = [t.view(-1) for t in tensors]
    for i in range(0, flat[0].numel(), CHUNK):
        yield tuple(f[i:i + CHUNK] for f in flat)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        shares: Optional[Dict[str, float]] = None,
                        group=None):
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-12))``,
    ``norm`` the float32 global norm, each rounded back to its own type,
    **in place**; returns ``(grads, norm)`` with the norm before
    clipping.

    Sharded gradients (each rank holding its shards): ``shares[name]`` is
    the part of a leaf's squared sum this rank counts (1 over the ranks
    holding the same shard), and the weighted sum is added over ``group``
    (every rank of the mesh)."""
    with torch.no_grad():
        sq = None
        for name, g in grads.items():
            w = shares.get(name, 1.0) if shares else 1.0
            for (c,) in _chunks(g):
                part = c.float().square().sum()
                if w != 1.0:
                    part = part * w
                sq = part if sq is None else sq + part
        if group is not None:
            from ..sharding import collectives
            collectives.all_reduce_(sq, group)
        gn = torch.sqrt(sq)
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
        for g in grads.values():
            # a bfloat16 product is taken in float32 and rounded once:
            # the reference's (g.astype(f32) * scale).astype(g.dtype)
            g.mul_(scale)
    return grads, gn


def adamw_update(cfg: AdamWConfig, params: nn.Module,
                 grads: Dict[str, torch.Tensor], state: Dict[str, object],
                 shares: Optional[Dict[str, float]] = None, group=None):
    """One AdamW step: clips ``grads`` (in place; ``shares`` and ``group``
    as :func:`clip_by_global_norm` takes them, for sharded leaves), then
    updates every parameter of ``params`` and the state's ``m`` and ``v``
    **in place**.  Returns ``(params, state, {"lr", "grad_norm"})`` with
    ``state["step"]`` advanced, the reference's return."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, shares, group)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    stepf = step.float()
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    with torch.no_grad():
        for name, p in params.named_parameters():
            for pc, gc, mc, vc in _chunks(p, grads[name], state["m"][name],
                                          state["v"][name]):
                g32 = gc.float()
                mc.mul_(b1).add_((1 - b1) * g32)
                vc.mul_(b2).add_((1 - b2) * g32 * g32)
                del g32
                p32 = pc.float()
                delta = (mc / bc1) / (torch.sqrt(vc / bc2) + eps)
                delta += wd * p32
                pc.copy_(p32 - lr * delta)
    state = {"m": state["m"], "v": state["v"], "step": step}
    return params, state, {"lr": lr, "grad_norm": gnorm}
