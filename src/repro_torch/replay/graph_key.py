"""Canonical structural hashing of task graphs.

A :class:`GraphKey` identifies a :class:`~repro_torch.core.taskgraph.TaskGraph` by
*shape*: topology (dependency edges), task kinds, analytical costs,
priorities, names, and parallel-region specs.  Callables are deliberately
excluded — two builds of the same tiled factorization over different tile
stores close over different data but produce the same key, which is exactly
what lets an iterative sweep reuse one recording for every iteration.

Floats are canonicalized with ``float.hex()`` (exact, no repr drift);
the digest is SHA-256 over a line-per-task serialization.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

from ..core.taskgraph import ParallelSpec, TaskGraph


@dataclasses.dataclass(frozen=True, eq=False)
class GraphKey:
    """Structural identity of a task graph.  Equality and hashing use only
    the digest; ``name``/``n_tasks`` are carried for diagnostics."""

    digest: str
    n_tasks: int
    name: str = ""

    def __eq__(self, other: object) -> bool:
        if isinstance(other, GraphKey):
            return self.digest == other.digest
        if isinstance(other, str):
            return self.digest == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.digest)

    def short(self) -> str:
        return self.digest[:16]

    def __str__(self) -> str:
        return f"GraphKey({self.name or '?'}, {self.short()}, n={self.n_tasks})"


def _canon_float(x: float) -> str:
    return float(x).hex()


def _canon_parallel(spec: Optional[ParallelSpec]) -> str:
    if spec is None:
        return "-"
    return "|".join((
        str(spec.n_threads),
        "B" if spec.blocking else "n",
        {None: "?", True: "G", False: "g"}[spec.gang],
        _canon_float(spec.cost_per_thread),
        str(spec.n_barriers),
    ))


def _canon_resources(graph: TaskGraph, t) -> str:
    """Resource declarations by structural identity: rindex (first-use
    order), name and capacity — not the process-wide uid, so two builds of
    the same graph over fresh handles share a key.  Empty for tasks with no
    declarations, which keeps resource-free digests byte-identical to the
    pre-resource format."""
    if not t.uses and not t.uses_shared:
        return ""
    index = graph.resource_index()
    def enc(r, tag):
        return f"{tag}{index[id(r)]}:{r.name}:{r.capacity}"
    parts = sorted(
        [enc(r, "x") for r in t.uses] + [enc(r, "s") for r in t.uses_shared])
    return ";" + ",".join(parts)


def graph_key(graph: TaskGraph) -> GraphKey:
    """Compute the structural key of ``graph`` (O(tasks + edges))."""
    h = hashlib.sha256()
    h.update(graph.name.encode())
    for t in graph.tasks:
        line = ";".join((
            str(t.tid),
            t.name,
            t.kind,
            _canon_float(t.cost),
            str(t.priority),
            ",".join(map(str, t.deps)),
            _canon_parallel(t.parallel),
        )) + _canon_resources(graph, t)
        h.update(line.encode())
        h.update(b"\n")
    return GraphKey(digest=h.hexdigest(), n_tasks=len(graph), name=graph.name)
