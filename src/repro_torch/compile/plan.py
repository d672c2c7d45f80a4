"""Lower a validated :class:`~repro_torch.replay.Recording` into a compiled plan.

The recording's per-worker run lists are merged into one deterministic
serial program (the compiled driver is single-threaded — that is the whole
point: the multi-worker decode collapse is GIL-bound Python dispatch, so the
fastest dispatcher is no dispatcher).  The merge walks worker cursors
round-robin, emitting entries whose dependencies are already emitted; within
one worker's list, consecutive fusible tasks are grouped into
:class:`~repro_torch.compile.fuse.FusedSegment` entries and segment boundaries are
recorded with their reasons (worker switch, opaque body, gang fork, frame
resume) — the observable shape of the lowering, round-tripped through
:class:`CompiledPlanMeta` into the on-disk cache.

Program entry forms::

    ("fused", FusedSegment)     # >= 1 fusible tasks, one callable
    ("task", tid)               # opaque body (noop joins, gang forks, frames)
    ("resume", tid, seg)        # parked frame's seg'th resume

Gang ULT entries ``(spawn_tid, thread)`` from the recording are consumed
silently: the driver runs the whole nested region inline (with real threads
for the barrier protocol) when the spawn task executes.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..core.taskgraph import FrameResume, TaskGraph
from ..replay.recording import Recording
from ..resources.arbiter import grants_by_resource, task_needs
from .fuse import FuseSpec, FusedSegment, fuse_spec_of

__all__ = ["CompiledPlan", "CompiledPlanMeta", "compile_recording", "CompileError"]


class CompileError(RuntimeError):
    """The recording cannot be lowered (stale digest, uncoverable entries)."""


@dataclasses.dataclass
class CompiledPlanMeta:
    """JSON-serializable description of a lowering — cached alongside the
    recording so warm processes can report plan shape without recompiling."""

    digest: str
    n_workers: int
    n_tasks: int
    n_segments: int
    n_fused: int          # fused program entries
    n_fused_tasks: int    # tasks covered by fused entries
    n_opaque: int
    n_resumes: int
    jit_segments: int
    boundaries: Dict[str, int] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CompiledPlanMeta":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class CompiledPlan:
    """A lowered recording: the serial program plus its descriptive meta.
    Executable via :class:`~repro_torch.compile.CompiledExecutor`; reusable across
    any graph with the recording's digest."""

    program: List[Tuple[Any, ...]]
    meta: CompiledPlanMeta
    recording: Recording


def _last_segments(recording: Recording) -> Dict[int, int]:
    """tid -> highest recorded resume segment (0 when the task never parks)."""
    last: Dict[int, int] = {}
    for entries in recording.worker_orders:
        for e in entries:
            if isinstance(e, FrameResume):
                last[e.tid] = max(last.get(e.tid, 0), e.seg)
    return last


def compile_recording(graph: TaskGraph, recording: Recording, *,
                      jit_fuse: bool = True) -> CompiledPlan:
    """Merge ``recording``'s per-worker run lists into a compiled plan for
    ``graph`` (which must match the recording's digest — callers validate)."""
    tasks = graph.tasks
    dep_map = {t.tid: t.deps for t in tasks}
    last_seg = _last_segments(recording)
    # resource gating: the merged serial order must reproduce the recorded
    # per-resource grant order (conflicting tasks have no edges between
    # them, so dependency gating alone could invert it).  A declaring task
    # is emittable only at the head of every relevant derived grant queue.
    # *Contended* resources (>= 2 declaring tasks) additionally cut the
    # fuse so each contended task is trackable in the executor's grant log;
    # a sole-user resource needs neither a cut nor gating beyond its queue.
    needs_map: Dict[int, Tuple[Tuple[int, bool], ...]] = {
        t.tid: task_needs(graph, t.tid) for t in tasks
        if getattr(t, "uses", ()) or getattr(t, "uses_shared", ())}
    rqueues: Dict[int, "deque"] = {
        r: deque(tids)
        for r, tids in grants_by_resource(
            graph, recording.resource_grants).items()}
    contended = {r for r, q in rqueues.items() if len(q) >= 2}
    orders = [list(w) for w in recording.worker_orders]
    n_workers = len(orders)
    cursors = [0] * n_workers
    emitted_done: set = set()     # tids whose final entry has been emitted
    started: set = set()          # tids whose initial entry has been emitted
    next_seg: Dict[int, int] = {}

    program: List[Tuple[Any, ...]] = []
    boundaries: Dict[str, int] = {}
    n_opaque = n_resumes = n_fused_tasks = jit_segments = 0
    pending_fuse: List[Tuple[int, FuseSpec]] = []
    pending_worker = -1

    def cut(reason: str) -> None:
        nonlocal pending_fuse, n_fused_tasks, jit_segments
        if pending_fuse:
            seg = FusedSegment(pending_fuse, jit_fuse=jit_fuse, dep_map=dep_map)
            program.append(("fused", seg))
            n_fused_tasks += len(pending_fuse)
            jit_segments += int(seg.jitted)
            pending_fuse = []
        boundaries[reason] = boundaries.get(reason, 0) + 1

    total = sum(len(w) for w in orders)
    consumed = 0
    while consumed < total:
        progressed = False
        for w in range(n_workers):
            while cursors[w] < len(orders[w]):
                entry = orders[w][cursors[w]]
                if isinstance(entry, FrameResume):
                    if entry.tid not in started or \
                            next_seg.get(entry.tid, 1) != entry.seg:
                        break
                    cut("resume")
                    program.append(("resume", entry.tid, entry.seg))
                    n_resumes += 1
                    next_seg[entry.tid] = entry.seg + 1
                    if entry.seg >= last_seg.get(entry.tid, 0):
                        emitted_done.add(entry.tid)
                elif isinstance(entry, tuple):
                    # gang ULT placement: no serial program entry — the
                    # driver runs the whole nested region inline (real
                    # threads) when the spawn task executes, so placements
                    # are consumed unconditionally
                    pass
                else:
                    tid = int(entry)
                    if any(d not in emitted_done for d in dep_map.get(tid, ())):
                        break
                    needs = needs_map.get(tid)
                    if needs is not None and any(
                            rqueues[r] and rqueues[r][0] != tid
                            for r, _ in needs):
                        break           # not this task's recorded grant turn
                    task = tasks[tid]
                    spec = fuse_spec_of(task)
                    if needs is not None:
                        for r, _ in needs:
                            if rqueues[r] and rqueues[r][0] == tid:
                                rqueues[r].popleft()
                        if any(r in contended for r, _ in needs):
                            cut("resource")
                    if spec is not None:
                        if pending_fuse and pending_worker != w:
                            cut("worker_switch")
                        pending_fuse.append((tid, spec))
                        pending_worker = w
                    else:
                        reason = "gang" if getattr(task, "parallel", None) is not None \
                            else "opaque"
                        cut(reason)
                        program.append(("task", tid))
                        n_opaque += 1
                    started.add(tid)
                    if last_seg.get(tid, 0) == 0:
                        emitted_done.add(tid)
                    else:
                        next_seg[tid] = 1
                cursors[w] += 1
                consumed += 1
                progressed = True
        if not progressed:
            stuck = {w: orders[w][cursors[w]] for w in range(n_workers)
                     if cursors[w] < len(orders[w])}
            raise CompileError(
                f"recording cannot be serialized for {graph.name!r}: "
                f"no ready entry (cursors stuck at {stuck!r}) — "
                "the recording is stale for this graph")
    cut("end")

    n_fused_entries = sum(1 for kind, *_ in program if kind == "fused")
    meta = CompiledPlanMeta(
        digest=recording.digest,
        n_workers=recording.n_workers,
        n_tasks=len(tasks),
        n_segments=len(program),
        n_fused=n_fused_entries,
        n_fused_tasks=n_fused_tasks,
        n_opaque=n_opaque,
        n_resumes=n_resumes,
        jit_segments=jit_segments,
        boundaries=boundaries,
    )
    return CompiledPlan(program=program, meta=meta, recording=recording)
