"""Recordings of task-graph executions.

A :class:`Recording` captures everything the replay executor needs to re-run
a graph of the same shape without making any scheduling decisions:

* ``worker_orders`` — for each worker, the entries it executed in start
  order.  An entry is a task id (``int``), a gang ULT
  ``(spawn_tid, thread_num)`` pair (stored as a 2-list in JSON), or a
  :class:`~repro_torch.core.taskgraph.FrameResume` — resume segment ``seg`` of a
  suspended task frame (stored as ``["r", tid, seg]``), which is what lets
  replay reproduce a run's frame interleaving bit-identically;
* ``gang_placements`` — for each region-forking task, the recorded gang id
  and the worker that ran each ULT (index = ``thread_num``);
* ``gang_issue_order`` — spawn-task ids in fork (gang-id) order: the
  monotonic-gang-id discipline replay must reproduce;
* ``steals`` — the dynamic run's successful steal decisions
  ``(thief, victim, entry)``, kept for analysis (the run lists already
  incorporate their effect);
* ``collective_order`` — comm-task ids in issue order (from the static
  schedule's total order when seeded from one, from completion order when
  recorded dynamically).

Recordings are plain data (ints/floats/strings) — JSON round-trippable for
the on-disk :class:`~repro_torch.replay.cache.GraphCache`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple, Union

from ..core.static_schedule import StaticSchedule
from ..core.taskgraph import FrameResume, TaskGraph
from .graph_key import GraphKey, graph_key

# an executed unit: a task id, (spawn_tid, thread_num) for a gang ULT, or
# FrameResume(tid, seg) for a suspended frame's resume segment
Entry = Union[int, Tuple[int, int], FrameResume]


@dataclasses.dataclass
class GangPlacement:
    spawn_tid: int
    gang_id: int
    workers: List[int]          # workers[i] ran thread_num i


class RecordingError(ValueError):
    """A recording does not match the graph it is being replayed against."""


@dataclasses.dataclass
class Recording:
    digest: str                                  # GraphKey digest recorded for
    graph_name: str
    n_workers: int
    policy: str
    worker_orders: List[List[Entry]]
    gang_placements: Dict[int, GangPlacement] = dataclasses.field(default_factory=dict)
    gang_issue_order: List[int] = dataclasses.field(default_factory=list)
    steals: List[Tuple[int, int, Entry]] = dataclasses.field(default_factory=list)
    collective_order: List[int] = dataclasses.field(default_factory=list)
    # (tid, seg) -> winning source index of a ctx.wait_any select resolved
    # at that resume segment; replay pins the recorded choice
    wait_choices: Dict[Tuple[int, int], int] = dataclasses.field(default_factory=dict)
    # global resource-grant order: tids of resource-declaring tasks in the
    # order the arbiter granted them (each exactly once — acquisition is
    # all-or-nothing per task).  Replay derives per-resource queues from
    # this and re-grants bit-identically; worker-slot independent, so
    # remapping across worker counts preserves it verbatim.
    resource_grants: List[int] = dataclasses.field(default_factory=list)
    source: str = "dynamic"                      # "dynamic" | "static"

    # ------------------------------------------------------------------
    def owner_of(self) -> Dict[int, int]:
        """tid -> recorded worker, for plain task entries."""
        out: Dict[int, int] = {}
        for w, order in enumerate(self.worker_orders):
            for e in order:
                if isinstance(e, int):
                    out[e] = w
        return out

    def n_tasks(self) -> int:
        """Number of distinct tasks the recording covers (plain entries;
        frame-resume segments belong to an already-counted task)."""
        return sum(1 for order in self.worker_orders
                   for e in order if isinstance(e, int))

    def validate_against(self, graph: TaskGraph, *, check_digest: bool = True) -> None:
        """Raise :class:`RecordingError` unless this recording covers exactly
        the tasks of ``graph`` (each tid once) and — when ``check_digest`` —
        was recorded for a graph of identical structure."""
        if check_digest:
            key = graph_key(graph)
            if key.digest != self.digest:
                raise RecordingError(
                    f"recording is for graph {self.graph_name!r} "
                    f"(digest {self.digest[:16]}) but got {key}")
        seen: Dict[int, int] = {}
        resumes: Dict[Tuple[int, int], int] = {}
        for order in self.worker_orders:
            for e in order:
                if isinstance(e, int):
                    seen[e] = seen.get(e, 0) + 1
                elif isinstance(e, FrameResume):
                    resumes[(e.tid, e.seg)] = resumes.get((e.tid, e.seg), 0) + 1
        n = len(graph)
        missing = [t for t in range(n) if seen.get(t, 0) != 1]
        extra = [t for t in seen if t >= n]
        if missing or extra:
            raise RecordingError(
                "recording does not cover graph 1:1 "
                f"(bad/missing tids {missing[:8]}, out-of-range {extra[:8]})")
        bad_resumes = [k for k, c in resumes.items()
                       if c != 1 or k[0] >= n or k[1] < 1]
        if bad_resumes:
            raise RecordingError(
                f"bad frame-resume entries {bad_resumes[:8]} (each (tid, seg) "
                "must appear once, for an in-range task, with seg >= 1)")
        bad_choices = [(k, i) for k, i in self.wait_choices.items()
                       if k[0] >= n or k[1] < 1 or i < 0]
        if bad_choices:
            raise RecordingError(
                f"bad wait_any choices {bad_choices[:8]} (keys must be "
                "in-range (tid, seg >= 1) with a non-negative winner index)")
        declaring = {t.tid for t in graph.tasks if t.uses or t.uses_shared}
        granted = list(self.resource_grants)
        if declaring or granted:
            counts: Dict[int, int] = {}
            for tid in granted:
                counts[tid] = counts.get(tid, 0) + 1
            bad_grants = sorted(
                (set(counts) ^ declaring)
                | {t for t, c in counts.items() if c != 1})
            if bad_grants:
                raise RecordingError(
                    f"resource_grants does not cover the graph's resource-"
                    f"declaring tasks 1:1 (bad tids {bad_grants[:8]})")

    # ------------------------------------------------------------------
    # serialization (plain data; gang entries become 2-lists)
    def to_dict(self) -> Dict[str, Any]:
        def enc(e: Entry):
            if isinstance(e, int):
                return e
            if isinstance(e, FrameResume):
                return ["r", int(e.tid), int(e.seg)]
            return [int(e[0]), int(e[1])]
        return {
            "digest": self.digest,
            "graph_name": self.graph_name,
            "n_workers": self.n_workers,
            "policy": self.policy,
            "worker_orders": [[enc(e) for e in o] for o in self.worker_orders],
            "gang_placements": {
                str(tid): {"spawn_tid": p.spawn_tid, "gang_id": p.gang_id,
                           "workers": list(p.workers)}
                for tid, p in self.gang_placements.items()},
            "gang_issue_order": list(self.gang_issue_order),
            "steals": [[t, v, enc(e)] for t, v, e in self.steals],
            "collective_order": list(self.collective_order),
            "wait_choices": [[tid, seg, idx] for (tid, seg), idx
                             in sorted(self.wait_choices.items())],
            "resource_grants": list(self.resource_grants),
            "source": self.source,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Recording":
        def dec(e) -> Entry:
            if isinstance(e, int):
                return e
            if len(e) == 3 and e[0] == "r":
                return FrameResume(int(e[1]), int(e[2]))
            return (int(e[0]), int(e[1]))
        return cls(
            digest=d["digest"],
            graph_name=d.get("graph_name", ""),
            n_workers=int(d["n_workers"]),
            policy=d.get("policy", "hybrid"),
            worker_orders=[[dec(e) for e in o] for o in d["worker_orders"]],
            gang_placements={
                int(tid): GangPlacement(p["spawn_tid"], p["gang_id"],
                                        list(p["workers"]))
                for tid, p in d.get("gang_placements", {}).items()},
            gang_issue_order=list(d.get("gang_issue_order", [])),
            steals=[(s[0], s[1], dec(s[2])) for s in d.get("steals", [])],
            collective_order=list(d.get("collective_order", [])),
            wait_choices={(int(c[0]), int(c[1])): int(c[2])
                          for c in d.get("wait_choices", [])},
            resource_grants=[int(t) for t in d.get("resource_grants", [])],
            source=d.get("source", "dynamic"),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "Recording":
        return cls.from_dict(json.loads(s))

    # ------------------------------------------------------------------
    @classmethod
    def from_static_schedule(
        cls,
        sched: StaticSchedule,
        graph: TaskGraph,
        key: Optional[GraphKey] = None,
        *,
        gangs: bool = True,
    ) -> "Recording":
        """Seed a recording from a frozen :class:`StaticSchedule`: slot i's
        item order (by frozen start time) becomes worker i's run list, and
        the schedule's collective total order is carried over.

        With ``gangs`` (default) the simulator's gang reservations
        (``sched.gangs``) are synthesized into recorded placements: each
        region-forking task gets a :class:`GangPlacement` on the reserved
        slots, its ULT entries are inserted into those slots' run lists at
        the fork's virtual time, and the fork order becomes the recording's
        monotonic gang-id issue order — so e.g. numeric LU/QR panel forks
        replay *placed* instead of hitting the dynamic fallback.  Pass
        ``key`` explicitly when the recording should drive a same-shaped
        twin of ``graph`` (the numeric build of a cost-model schedule)."""
        if key is None:
            key = graph_key(graph)
        # (slot, sort-key, end-time) per scheduled task
        place: Dict[int, Tuple[int, float, float]] = {}
        for slot, items in sched.order.items():
            for i, it in enumerate(items):
                place[it.tid] = (slot, float(i), it.t1)
        # Tasks missing from the frozen trace (zero-cost joins filtered from
        # sim events) go immediately after their latest-finishing dependency
        # on that dependency's slot: at that point every dep has completed,
        # so the recorded start order stays dependency-consistent.
        eps = 1.0 / (len(graph) + 2)
        for t in graph.topological_order():
            if t.tid in place:
                continue
            best: Optional[Tuple[float, int, float]] = None   # (t1, slot, seq)
            for d in t.deps:
                slot_d, seq_d, t1_d = place[d]
                if best is None or t1_d > best[0]:
                    best = (t1_d, slot_d, seq_d)
            if best is None:                                   # root task
                place[t.tid] = (0, -1.0 + eps * t.tid, 0.0)
            else:
                place[t.tid] = (best[1], best[2] + eps * (t.tid + 1), best[0])
        rows: List[Tuple[int, float, int, Entry]] = [
            (slot, seq, 0, tid) for tid, (slot, seq, _) in place.items()]

        # gang reservations -> recorded placements + slot-ordered ULT entries
        placements: Dict[int, GangPlacement] = {}
        issue_order: List[int] = []
        if gangs and sched.gangs:
            import bisect

            slot_starts: List[List[float]] = [[] for _ in range(sched.n_slots)]
            for it in sched.items:
                slot_starts[it.slot].append(it.t0)
            for s in slot_starts:
                s.sort()
            for g in sorted(sched.gangs, key=lambda g: (g.t, g.gang_id)):
                placements[g.spawn_tid] = GangPlacement(
                    g.spawn_tid, g.gang_id, list(g.workers))
                issue_order.append(g.spawn_tid)
                for i, wk in enumerate(g.workers):
                    # fractional seq: after every item starting at or before
                    # the fork, before the next one (ULTs run right after
                    # their fork on the reserved slot)
                    seq = bisect.bisect_right(slot_starts[wk], g.t) - 0.5
                    rows.append((wk, seq, 1, (g.spawn_tid, i)))

        orders: List[List[Entry]] = [[] for _ in range(sched.n_slots)]
        for slot, _, _, entry in sorted(rows, key=lambda r: (r[0], r[1], r[2])):
            orders[slot].append(entry)
        # synthesize the resource-grant order from the frozen start times
        # (the simulator grants at task start; ties break by tid, matching
        # its deterministic event order)
        t0_of: Dict[int, float] = {it.tid: it.t0 for it in sched.items}
        resource_grants = sorted(
            (t.tid for t in graph.tasks if t.uses or t.uses_shared),
            key=lambda tid: (t0_of.get(tid, place[tid][2]), tid))
        return cls(
            digest=key.digest,
            graph_name=graph.name,
            n_workers=sched.n_slots,
            policy=sched.policy,
            worker_orders=orders,
            gang_placements=placements,
            gang_issue_order=issue_order,
            collective_order=sched.collective_order(),
            resource_grants=resource_grants,
            source="static",
        )
