"""Module-level task bodies shipped to pool workers by reference.

``session.map(builder, inputs)`` with ``procs=N`` round-robins inputs to
worker processes as ``run_builder`` calls: the child resolves the builder
ref, builds its own graph from the input, runs it through the child
session (adopting the parent's recordings from the shared on-disk cache
when one is configured) and sends back a compact, picklable outcome —
results, plan mode, scheduler stats, wall clock.

No torch tensor crosses the pipe.  ``import torch`` registers the tensor
reductions of :mod:`torch.multiprocessing` with the pickler a
``multiprocessing`` connection uses, so a tensor sent as it is would travel
as a shared-memory segment (CPU) or a CUDA IPC handle into the child's
device memory, alive only while the child keeps it.  :func:`portable`
turns every tensor of a reply into a numpy array on the host instead, as
the reference's replies carry numpy arrays.
"""

from __future__ import annotations

import sys
from typing import Any, Dict

from .pool import resolve_ref

__all__ = ["portable", "run_builder"]


def portable(value: Any) -> Any:
    """``value`` with every torch tensor in it — at the top or inside
    lists, tuples and dicts — replaced by a numpy copy on the host
    (bfloat16, which numpy lacks, widens exactly to float32); everything
    else passes through."""
    torch = sys.modules.get("torch")         # no tensor exists without it
    if torch is None:
        return value
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    if isinstance(value, dict):
        return {k: portable(v) for k, v in value.items()}
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(portable(v) for v in value))
    if isinstance(value, (list, tuple)):
        return type(value)(portable(v) for v in value)
    return value


def _portable_stats(stats: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in stats.items():
        if isinstance(v, (int, float, str, bool, type(None))):
            out[k] = v
        elif isinstance(v, dict):
            out[k] = _portable_stats(v)
        else:
            out[k] = repr(v)
    return out


def run_builder(ctx: Any, ref: str, value: Any, *,
                record: Any = None, timeout: float = 300.0) -> Dict[str, Any]:
    """Build ``resolve_ref(ref)(value)`` and run it on the child session.

    Returns a plain dict (never a live RunReport — graphs, recordings and
    traces stay in the child): ``results`` keyed by tid, the executed plan
    ``mode`` (``replay``/``pool``/... — ``pool_mode`` distinguishes adopt
    vs record for pool sessions), the run ``stats`` and ``wall_s``.
    """
    builder = resolve_ref(ref)
    graph = builder(value)
    report = ctx.session.run(graph, record=record, timeout=timeout)
    return {
        "results": {tid: portable(v) for tid, v in report.results.items()},
        "mode": report.plan.mode,
        "remapped_from": report.plan.remapped_from,
        "digest": report.plan.digest,
        "stats": _portable_stats(report.stats),
        "wall_s": report.wall_s,
        "n_workers": report.n_workers,
        "scheduler": report.scheduler,
        "proc": ctx.index,
    }
