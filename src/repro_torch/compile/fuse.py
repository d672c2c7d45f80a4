"""Fusion metadata for compiled plans.

A task body is *fusible* when the graph builder attaches a :class:`FuseSpec`
to the task (``g.add(..., fuse=FuseSpec(...))``): a pure kernel plus the keys
it reads and writes in the graph's shared ``fuse_state`` (a mapping-like
store — :class:`~repro_torch.linalg.tiles.TileStore` for the
factorizations).  ``Task.meta`` is excluded from the structural
:func:`~repro_torch.replay.graph_key` digest, so fuse metadata never
perturbs recording/cache keys.

Only the metadata is ported so far; the fused-segment composer arrives with
the compiled scheduler (ROADMAP Queue A item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

__all__ = ["FuseSpec", "fuse_spec_of"]


@dataclasses.dataclass(frozen=True)
class FuseSpec:
    """Declares a task body as a pure kernel over ``graph.fuse_state`` keys.

    ``fn(*[state[k] for k in reads])`` must return the new value for the
    single write key, or a tuple matching ``writes``.  ``result_key`` names
    which written key's value becomes ``results[tid]`` (``None`` → the task
    result is ``None``, matching store-mutating bodies).  ``fn`` must be a
    stable module-level callable — fused-callable caching keys on its
    identity.
    """

    fn: Callable[..., Any]
    reads: Tuple[Any, ...]
    writes: Tuple[Any, ...]
    result_key: Optional[Any] = None
    jit_safe: bool = True


def fuse_spec_of(task) -> Optional[FuseSpec]:
    """The task's :class:`FuseSpec`, or ``None`` for opaque bodies."""
    meta = getattr(task, "meta", None)
    if not meta:
        return None
    spec = meta.get("fuse")
    return spec if isinstance(spec, FuseSpec) else None
