"""Fusion metadata and fused-callable construction for compiled plans.

A task body is *fusible* when the graph builder attaches a :class:`FuseSpec`
to the task (``g.add(..., fuse=FuseSpec(...))``): a pure kernel plus the keys
it reads and writes in the graph's shared ``fuse_state`` (a mapping-like
store — :class:`~repro_torch.linalg.tiles.TileStore` for the
factorizations, a small adapter for the decode step).  ``Task.meta`` is
excluded from the structural :func:`~repro_torch.replay.graph_key` digest,
so fuse metadata never perturbs recording/cache keys.

Consecutive fusible tasks from one worker's run list are lowered into a
single :class:`FusedSegment`: the per-task Python dispatch (context
creation, result bookkeeping, scheduler hand-off) collapses into one call
that gathers the segment's external inputs from the state, runs the kernel
sequence, and scatters the outputs back.  The composed callables are cached
process-wide by segment *structure*, so same-shaped segments across rebuilt
graphs share one.

When every spec in the segment is ``jit_safe`` (``FusedSegment.jitted``, the
reference package's name: there the sequence is wrapped in one
``jax.jit``) and the segment runs against CUDA tensors, its first run
captures the whole kernel sequence as one CUDA graph, which every later run
replays (:mod:`repro_torch.compile.capture`).  On the CPU, and for segments
that are not ``jit_safe``, the composed callable runs plainly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["FuseSpec", "FusedSegment", "fuse_spec_of", "fused_cache_info"]


@dataclasses.dataclass(frozen=True)
class FuseSpec:
    """Declares a task body as a pure kernel over ``graph.fuse_state`` keys.

    ``fn(*[state[k] for k in reads])`` must return the new value for the
    single write key, or a tuple matching ``writes``.  ``result_key`` names
    which written key's value becomes ``results[tid]`` (``None`` → the task
    result is ``None``, matching store-mutating bodies).  ``fn`` must be a
    stable module-level callable — fused-callable caching keys on its
    identity.  ``jit_safe`` says ``fn`` may be captured into a CUDA graph:
    it launches device work only, never synchronises the host (no
    ``.cpu()``, ``.item()`` or numpy) and reads no host state that changes
    between runs.
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


# process-wide cache of composed callables keyed by segment structure
# (kernel identities + read/write slot topology).  Only the plain callables
# are shared: a captured CUDA graph binds its segment's own buffers, so each
# segment captures its own.
_FUSED_CACHE: Dict[Tuple[Any, ...], Callable[..., Any]] = {}


def fused_cache_info() -> Dict[str, int]:
    return {"entries": len(_FUSED_CACHE)}


def _compose(norm: Tuple[Tuple[Callable, Tuple[int, ...], Tuple[int, ...], int], ...],
             ext_slots: Tuple[int, ...], out_slots: Tuple[int, ...]):
    def run(*ext_vals):
        vals: Dict[int, Any] = dict(zip(ext_slots, ext_vals))
        res: List[Any] = []
        for fn, reads, writes, result_slot in norm:
            out = fn(*(vals[s] for s in reads))
            if len(writes) == 1:
                vals[writes[0]] = out
            else:
                for s, v in zip(writes, out):
                    vals[s] = v
            res.append(vals[result_slot] if result_slot >= 0 else None)
        return tuple(vals[s] for s in out_slots), tuple(res)

    return run


class FusedSegment:
    """One run of consecutive fusible tasks lowered to a single callable.

    Holds state *keys* and tids only, so a segment compiled from one graph
    executes against any same-digest graph's ``fuse_state`` (same structure
    → same keys and kernels).  On CUDA it also holds its captured graph
    (``graph``), bound to the storage of the executor that runs it.
    """

    __slots__ = ("tids", "ext_keys", "out_keys", "jitted", "_run", "ext_deps",
                 "graph")

    def __init__(self, items: Sequence[Tuple[int, FuseSpec]], *,
                 jit_fuse: bool = True,
                 dep_map: Optional[Dict[int, Sequence[int]]] = None):
        slot: Dict[Any, int] = {}

        def sid(key: Any) -> int:
            if key not in slot:
                slot[key] = len(slot)
            return slot[key]

        norm: List[Tuple[Callable, Tuple[int, ...], Tuple[int, ...], int]] = []
        ext: List[int] = []
        written: set = set()
        for _tid, spec in items:
            reads = []
            for k in spec.reads:
                s = sid(k)
                if s not in written and s not in ext:
                    ext.append(s)
                reads.append(s)
            writes = [sid(k) for k in spec.writes]
            written.update(writes)
            result_slot = sid(spec.result_key) if spec.result_key is not None else -1
            norm.append((spec.fn, tuple(reads), tuple(writes), result_slot))

        by_slot = {s: k for k, s in slot.items()}
        out_slots = tuple(sorted(written))
        self.tids = tuple(tid for tid, _ in items)
        self.ext_keys = tuple(by_slot[s] for s in ext)
        self.out_keys = tuple(by_slot[s] for s in out_slots)
        # external dependencies: predecessor tids outside the segment
        members = set(self.tids)
        deps: set = set()
        if dep_map:
            for tid in self.tids:
                deps.update(d for d in dep_map.get(tid, ()) if d not in members)
        self.ext_deps = frozenset(deps)

        structure = (tuple(norm), tuple(ext), out_slots)
        all_jit_safe = all(spec.jit_safe for _, spec in items)
        self.jitted = bool(jit_fuse and all_jit_safe)
        run = _FUSED_CACHE.get(structure)
        if run is None:
            run = _compose(tuple(norm), tuple(ext), out_slots)
            _FUSED_CACHE[structure] = run
        self._run = run
        self.graph = None         # the segment's SegmentGraph, once captured

    def __call__(self, state, results: Dict[int, Any], binding=None) -> None:
        """Run the segment against ``state``.  ``binding`` is the executor's
        :class:`~repro_torch.compile.capture.DeviceBinding` when the state
        lives on CUDA: a ``jitted`` segment then replays its CUDA graph,
        capturing it first if this is its first run."""
        if binding is not None and self.jitted:
            if self.graph is None:
                from .capture import SegmentGraph
                self.graph = SegmentGraph(self, state, binding)
            self.graph.replay(state, results)
            return
        outs, res = self._run(*(state[k] for k in self.ext_keys))
        for k, v in zip(self.out_keys, outs):
            state[k] = v
        for tid, rv in zip(self.tids, res):
            results[tid] = rv
