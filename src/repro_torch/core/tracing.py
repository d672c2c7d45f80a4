"""Execution tracing for the runtime and simulator: one event vocabulary.

Traces are lists of ``(worker, t0, t1, kind, label)`` events.  ``kind`` is
one of ``compute / comm / panel / idle / steal / barrier / switch`` — the
categories the paper's Fig. 8 (critical path) and Fig. 11d (idle/compute/
MPI breakdown) are built from.  The same :class:`Event` schema and kind
vocabulary are shared by the offline :class:`~repro_torch.core.simulator.Simulator`
(:class:`Trace`) and the live executor's flight recorder
(:class:`~repro_torch.obs.trace.RuntimeTrace`), so ``breakdown()`` /
``utilization()`` / per-worker tables read identically on both.

The flight recorder additionally emits *point* events (``EV_*`` below):
raw timestamped markers (task start/end, steal attempt/hit, gang
reserve/enter/exit, frame suspend/wake/resume, plain-body block/unblock,
deadlock polls, worker park/wake, replay deviations) that
:mod:`repro_torch.obs.trace` assembles into the span kinds above.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# span kinds (simulator Trace + assembled RuntimeTrace share these)
KIND_COMPUTE = "compute"
KIND_COMM = "comm"
KIND_PANEL = "panel"
KIND_IDLE = "idle"
KIND_STEAL = "steal"
KIND_BARRIER = "barrier"
KIND_SWITCH = "switch"

#: every span kind a Trace/RuntimeTrace event may carry
SPAN_KINDS = frozenset({KIND_COMPUTE, KIND_COMM, KIND_PANEL, KIND_IDLE,
                        KIND_STEAL, KIND_BARRIER, KIND_SWITCH})
#: kinds that count as useful work in utilization()/busy_time()
BUSY_KINDS = (KIND_COMPUTE, KIND_COMM, KIND_PANEL)

# ---------------------------------------------------------------------------
# point-event kinds emitted by the live executors' flight recorder
EV_TASK_START = "task_start"          # a=tid                label="kind|name"
EV_TASK_END = "task_end"              # a=tid
EV_STEAL_ATTEMPT = "steal_attempt"    # a=victim
EV_STEAL_HIT = "steal_hit"            # a=victim             label=unit kind
EV_GANG_RESERVE = "gang_reserve"      # a=spawn_tid, b=n     label="g<gang_id>"
EV_GANG_ENTER = "gang_enter"          # a=rid, b=thread_num
EV_GANG_EXIT = "gang_exit"            # a=rid, b=thread_num
EV_BARRIER_WAIT = "barrier_wait"      # a=rid
EV_BARRIER_DONE = "barrier_done"      # a=rid
EV_FRAME_SUSPEND = "frame_suspend"    # a=tid, b=seg   label="req(chan)@uid"
EV_FRAME_WAKE = "frame_wake"          # a=tid, b=seg (emitted on waker thread)
EV_FRAME_RESUME = "frame_resume"      # a=tid, b=seg         label="kind|name"
EV_BLOCK = "block"                    # a=tid                label=what
EV_UNBLOCK = "unblock"                # a=tid
EV_DEADLOCK_POLL = "deadlock_poll"
EV_PARK = "park"                      # worker went idle (no schedulable work)
EV_WAKE = "wake"                      # worker found work after idling
EV_REPLAY_FALLBACK = "replay_fallback"  # a=tid or -1        label=unit kind
EV_REPLAY_STALL = "replay_stall"
EV_REPLAY_SKIP = "replay_skip"        # a=tid
EV_RUN_AHEAD = "run_ahead"            # a=tid
EV_RESOURCE_ACQUIRE = "resource_acquire"  # a=tid, b=n_res   label=task name
EV_RESOURCE_WAIT = "resource_wait"    # a=tid (task deferred on contention)
EV_RESOURCE_RELEASE = "resource_release"  # a=tid, b=n_res
# spans of the program's top-level calls (repro_torch.obs.spans)
EV_SPAN_BEGIN = "span_begin"          # a=span id, b=parent id    label=name
EV_SPAN_END = "span_end"              # a=span id, b=shared id (a rid, or -1)
EV_SPAN_COUNT = "span_count"          # a=span id, b=value        label=counter

EVENT_KINDS = frozenset({
    EV_TASK_START, EV_TASK_END, EV_STEAL_ATTEMPT, EV_STEAL_HIT,
    EV_GANG_RESERVE, EV_GANG_ENTER, EV_GANG_EXIT, EV_BARRIER_WAIT,
    EV_BARRIER_DONE, EV_FRAME_SUSPEND, EV_FRAME_WAKE, EV_FRAME_RESUME,
    EV_BLOCK, EV_UNBLOCK, EV_DEADLOCK_POLL, EV_PARK, EV_WAKE,
    EV_REPLAY_FALLBACK, EV_REPLAY_STALL, EV_REPLAY_SKIP, EV_RUN_AHEAD,
    EV_RESOURCE_ACQUIRE, EV_RESOURCE_WAIT, EV_RESOURCE_RELEASE,
    EV_SPAN_BEGIN, EV_SPAN_END, EV_SPAN_COUNT,
})


@dataclasses.dataclass
class Event:
    """One span of a worker's time.  A span of the program's own
    (:mod:`repro_torch.obs.spans`) also carries its id, its parent's id
    (-1 at the top), the id it shares with other spans (a request's rid,
    or -1), and the device's interval between its start and end, on the
    same clock as ``t0``/``t1`` (None where no device event was taken)."""

    worker: int
    t0: float
    t1: float
    kind: str
    label: str = ""
    sid: int = -1
    parent: int = -1
    key: int = -1
    dev: Optional[Tuple[float, float]] = None

    @property
    def dt(self) -> float:
        return self.t1 - self.t0


class Trace:
    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self.events: List[Event] = []

    def record(self, worker: int, t0: float, t1: float, kind: str, label: str = "") -> None:
        self.events.append(Event(worker, t0, t1, kind, label))

    @property
    def makespan(self) -> float:
        return max((e.t1 for e in self.events), default=0.0)

    def busy_time(self, kinds=BUSY_KINDS) -> float:
        return sum(e.dt for e in self.events if e.kind in kinds)

    def breakdown(self) -> Dict[str, float]:
        """Total seconds per event kind, plus derived idle time
        (makespan * workers - busy)."""
        out: Dict[str, float] = defaultdict(float)
        for e in self.events:
            out[e.kind] += e.dt
        accounted = sum(out.values())
        out[KIND_IDLE] += max(0.0, self.makespan * self.n_workers - accounted)
        return dict(out)

    def breakdown_fraction(self) -> Dict[str, float]:
        b = self.breakdown()
        total = self.makespan * self.n_workers
        return {k: (v / total if total else 0.0) for k, v in b.items()}

    def per_worker_breakdown(self) -> List[Dict[str, float]]:
        outs: List[Dict[str, float]] = [defaultdict(float) for _ in range(self.n_workers)]
        for e in self.events:
            outs[e.worker][e.kind] += e.dt
        res = []
        for w, o in enumerate(outs):
            busy = sum(o.values())
            o = dict(o)
            o[KIND_IDLE] = max(0.0, self.makespan - busy)
            res.append(o)
        return res

    def utilization(self) -> float:
        if not self.events:
            return 0.0
        return self.busy_time() / (self.makespan * self.n_workers)

    def count(self, kind: str) -> int:
        return sum(1 for e in self.events if e.kind == kind)
