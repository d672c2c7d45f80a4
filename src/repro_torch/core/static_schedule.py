"""Static schedule extraction: frozen schedules from the simulator.

A statically compiled program has no work stealing.  What *can* be
controlled ahead of time is (a) the order in which independent tasks (tile
ops, microbatch steps) are placed into the program, and (b) the order in
which collective-bearing regions ("gangs") issue their collectives — which
must be a global total order across participants or the fabric deadlocks,
exactly the paper's monotonic-gang-id discipline.  In the port the frozen
order seeds record-and-replay
(:meth:`~repro_torch.replay.Recording.from_static_schedule`).

:class:`ListScheduler` therefore runs the *deterministic* discrete-event
scheduler (same Algorithm 1/2 implementation as the dynamic runtime) against
the task graph's cost model and freezes the resulting per-worker execution
order into a :class:`StaticSchedule`:

* ``order[slot]``      — the frozen task order for each of the P slots
                         (device groups / host executor lanes),
* ``waves()``          — a barrier-free wave decomposition (tasks grouped by
                         frozen start time) used by the distributed tiled
                         factorization executor (`repro_torch.linalg.dist`),
* ``collective_order`` — gang-id-ordered list of collective-bearing tasks;
                         every participant must issue these in this order,
* ``makespan``         — the cost-model makespan (the hillclimbing metric).

The victim policy changes the frozen interleaving — ``history`` reproduces
the locality-first serialization, ``hybrid`` the paper's overlapped order —
so the paper's scheduling effect survives compilation.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List

from .simulator import Simulator
from .taskgraph import TaskGraph
from .tracing import Trace


@dataclasses.dataclass
class ScheduledItem:
    tid: int
    name: str
    kind: str
    slot: int
    t0: float
    t1: float


@dataclasses.dataclass
class GangReservation:
    """A gang-scheduled region's frozen reservation: the simulator reserved
    ``workers[i]`` for ULT ``i`` of the region forked by ``spawn_tid`` at
    virtual time ``t``.  Carried into static-seeded replay recordings so
    panel forks replay *placed* instead of falling back to dynamic."""

    spawn_tid: int
    gang_id: int
    workers: List[int]
    t: float


@dataclasses.dataclass
class StaticSchedule:
    n_slots: int
    items: List[ScheduledItem]
    makespan: float
    policy: str
    gangs: List[GangReservation] = dataclasses.field(default_factory=list)

    @property
    def order(self) -> Dict[int, List[ScheduledItem]]:
        out: Dict[int, List[ScheduledItem]] = defaultdict(list)
        for it in sorted(self.items, key=lambda i: (i.slot, i.t0)):
            out[it.slot].append(it)
        return dict(out)

    def waves(self) -> List[List[int]]:
        """Group task ids into execution waves: tasks whose frozen intervals
        overlap the same wave window run concurrently.  Greedy sweep by start
        time; a new wave opens when a task starts after the current wave's
        minimum end time (so within a wave, no task depends on another)."""
        items = sorted(self.items, key=lambda i: (i.t0, i.t1))
        waves: List[List[int]] = []
        wave_end = -1.0
        for it in items:
            if not waves or it.t0 >= wave_end - 1e-12:
                waves.append([it.tid])
                wave_end = it.t1
            else:
                waves[-1].append(it.tid)
                wave_end = min(wave_end, it.t1)
        return waves

    def collective_order(self) -> List[int]:
        """Task ids of comm-kind tasks in frozen issue order — the gang-id
        total order every SPMD participant must respect."""
        return [it.tid for it in sorted(self.items, key=lambda i: (i.t0, i.tid))
                if it.kind == "comm"]

    def slot_utilization(self) -> List[float]:
        busy = [0.0] * self.n_slots
        for it in self.items:
            busy[it.slot] += it.t1 - it.t0
        return [b / self.makespan if self.makespan else 0.0 for b in busy]

    def overlap_fraction(self) -> float:
        """Fraction of total comm time that is hidden under concurrently
        running compute on other slots — the paper's Fig. 2 metric."""
        comm = [(it.t0, it.t1) for it in self.items if it.kind == "comm"]
        compute = [(it.t0, it.t1) for it in self.items if it.kind != "comm"]
        total = sum(t1 - t0 for t0, t1 in comm)
        if total == 0:
            return 0.0
        # sweep: time where >=1 comm and >=1 compute are simultaneously active
        points = sorted({t for iv in comm + compute for t in iv})
        hidden = 0.0
        for a, b in zip(points[:-1], points[1:]):
            mid = (a + b) / 2
            if any(t0 <= mid < t1 for t0, t1 in comm) and any(t0 <= mid < t1 for t0, t1 in compute):
                hidden += b - a
        return hidden / total


class ListScheduler:
    """Freeze a dynamic-scheduler run into a static schedule."""

    def __init__(self, n_slots: int, *, policy: str = "hybrid", seed: int = 0,
                 mode: str = "gang"):
        self.n_slots = n_slots
        self.policy = policy
        self.seed = seed
        self.mode = mode

    def schedule(self, graph: TaskGraph) -> StaticSchedule:
        sim = Simulator(self.n_slots, policy=self.policy, mode=self.mode,
                        seed=self.seed, trace=True)
        trace: Trace = sim.run(graph)
        by_name = {t.name: t for t in graph}
        items: List[ScheduledItem] = []
        for e in trace.events:
            task = by_name.get(e.label)
            if task is None or e.kind in ("barrier", "idle"):
                continue
            items.append(ScheduledItem(task.tid, task.name, task.kind, e.worker, e.t0, e.t1))
        gangs = [GangReservation(tid, gid, list(workers), t)
                 for tid, gid, workers, t in sim.gang_log]
        return StaticSchedule(self.n_slots, items, trace.makespan, self.policy,
                              gangs=gangs)


def microbatch_overlap_graph(
    n_microbatches: int,
    *,
    compute_cost: float = 1.0,
    comm_cost: float = 0.4,
    name: str = "grad-accum",
) -> TaskGraph:
    """The paper's Fig. 2 scenario rendered as gradient accumulation: each
    microbatch has a compute task (fwd+bwd) and a comm task (its gradient
    bucket's DP all-reduce).  Compute tasks chain (sequential on the device);
    comm_i depends on compute_i; the optimizer update depends on all comms.
    Under ``history`` scheduling the comms serialize after the computes;
    under ``hybrid`` each comm overlaps the next microbatch's compute."""
    g = TaskGraph(name)
    prev = None
    comms = []
    for i in range(n_microbatches):
        deps = [prev] if prev is not None else []
        c = g.add(name=f"mb{i}.compute", kind="compute", cost=compute_cost, deps=deps)
        r = g.add(name=f"mb{i}.allreduce", kind="comm", cost=comm_cost, deps=[c])
        comms.append(r)
        prev = c
    g.add(name="optimizer.update", kind="compute", cost=compute_cost * 0.1, deps=comms)
    return g


def issue_offsets_from_schedule(sched: StaticSchedule, n_microbatches: int) -> List[int]:
    """Derive, for each microbatch's gradient bucket, how many microbatches
    later its all-reduce is issued (0 = immediately).  Consumed by the train
    step's bucketed grad-accumulation loop to realize the frozen overlap
    (the collective for bucket i is embedded in iteration i+offset)."""
    comm_start = {}
    compute_end = {}
    for it in sched.items:
        if it.name.endswith(".allreduce"):
            comm_start[int(it.name.split(".")[0][2:])] = it.t0
        elif it.name.endswith(".compute"):
            compute_end[int(it.name.split(".")[0][2:])] = it.t1
    offsets = []
    for i in range(n_microbatches):
        off = 0
        for j in range(i, n_microbatches):
            if comm_start.get(i, 0.0) <= compute_end.get(j, float("inf")) + 1e-12:
                off = j - i
                break
        else:
            off = n_microbatches - 1 - i
        offsets.append(off)
    return offsets
