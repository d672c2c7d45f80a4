"""Assemble flight-recorder point events into a simulator-schema trace.

:class:`RuntimeTrace` extends :class:`~repro_torch.core.tracing.Trace`, so every
analysis written for the offline simulator — ``breakdown()``,
``breakdown_fraction()``, ``per_worker_breakdown()``, ``utilization()``,
``count()`` — reads a live run identically (the paper's Fig. 11d tables
for the *real* executor).

Assembly walks each worker's event stream in time order keeping a stack of
open units: task bodies, frame resume segments and gang ULTs open/close
spans (``compute``/``comm``/``panel`` per the task kind, ``compute`` for
a kind outside the span vocabulary); plain-body
blocks and blocking barriers open ``barrier`` spans; explicit worker
park/wake windows open ``idle`` spans.  Inline nesting (a join-waiter
serving other work, a ``ctx.recv`` poll loop stealing) *splits* the outer
span instead of double-counting it, so per-worker busy time never exceeds
wall clock.  Steals, replay fallbacks and frame suspensions additionally
land as zero-length ``steal``/``switch`` marker events so ``count()``
reconciles exactly with ``RunReport.stats``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from ..core.tracing import (
    EV_BARRIER_DONE,
    EV_BARRIER_WAIT,
    EV_BLOCK,
    EV_DEADLOCK_POLL,
    EV_FRAME_RESUME,
    EV_FRAME_SUSPEND,
    EV_FRAME_WAKE,
    EV_GANG_ENTER,
    EV_GANG_EXIT,
    EV_GANG_RESERVE,
    EV_PARK,
    EV_REPLAY_FALLBACK,
    EV_REPLAY_SKIP,
    EV_REPLAY_STALL,
    EV_RESOURCE_ACQUIRE,
    EV_RESOURCE_RELEASE,
    EV_RESOURCE_WAIT,
    EV_RUN_AHEAD,
    EV_STEAL_ATTEMPT,
    EV_STEAL_HIT,
    EV_TASK_END,
    EV_TASK_START,
    EV_UNBLOCK,
    EV_WAKE,
    KIND_BARRIER,
    KIND_COMPUTE,
    KIND_IDLE,
    KIND_PANEL,
    KIND_STEAL,
    KIND_SWITCH,
    SPAN_KINDS,
    Event,
    Trace,
)

__all__ = ["RuntimeTrace", "assemble"]

#: counter name -> point-event kind it mirrors (RunReport.stats parity)
_COUNTER_EVENTS = {
    "steals": EV_STEAL_HIT,
    "steal_attempts": EV_STEAL_ATTEMPT,
    "frame_suspends": EV_FRAME_SUSPEND,
    "frame_resumes": EV_FRAME_RESUME,
    "fallback_steals": EV_REPLAY_FALLBACK,
    "stalls": EV_REPLAY_STALL,
    "skips": EV_REPLAY_SKIP,
    "run_ahead": EV_RUN_AHEAD,
    "gang_regions": EV_GANG_RESERVE,
    "deadlock_polls": EV_DEADLOCK_POLL,
    "blocks": EV_BLOCK,
    "tasks": EV_TASK_END,
    "resource_acquires": EV_RESOURCE_ACQUIRE,
    "resource_waits": EV_RESOURCE_WAIT,
    "resource_releases": EV_RESOURCE_RELEASE,
}


def _split_label(label: str) -> Tuple[str, str]:
    """``"kind|name"`` -> (span kind, display name).  A task kind outside
    the span vocabulary (the factorizations' ``lookahead``) is work, and
    spans as ``compute``: the exported file then validates, and its time
    counts as busy."""
    if "|" in label:
        kind, name = label.split("|", 1)
        return (kind if kind in SPAN_KINDS else KIND_COMPUTE), name
    return KIND_COMPUTE, label


class RuntimeTrace(Trace):
    """A live-executor trace in the simulator's ``Event`` schema, plus the
    runtime-only extras: exact point-event ``counters`` (reconciling with
    ``RunReport.stats``), steal / frame-wake flow edges (Perfetto arrows),
    ring-overflow ``dropped`` count, and multi-run :meth:`metrics`."""

    def __init__(self, n_workers: int):
        super().__init__(n_workers)
        self.counters: Dict[str, int] = {}
        self.dropped = 0
        #: (victim worker, thief worker, t, unit label) per successful steal
        self.steal_flows: List[Tuple[int, int, float, str]] = []
        #: (waker worker, t_wake, resume worker, t_resume, label) per
        #: frame wakeup that reached its resume segment (channel send→recv)
        self.frame_flows: List[Tuple[int, float, int, float, str]] = []
        #: resume-latency samples (s): frame wake -> segment start
        self.resume_latencies: List[float] = []
        #: per-victim steal histogram: victim -> [attempts, hits]
        self.steal_victims: Dict[int, List[int]] = {}
        #: frame resume segments executed per worker — the workers that
        #: host suspended continuations (frame-aware victim selection)
        self.frame_resumes_by_worker: Dict[int, int] = {}
        #: (tid, t_deferred, t_granted) per resource-contended task — the
        #: arbiter defer window (task time, not worker time: the deferring
        #: worker moves on)
        self.resource_waits: List[Tuple[int, float, float]] = []
        self._metrics_cache: Optional[Dict[str, Any]] = None

    # -- equality is exact: events, counters and flow edges round-trip ----
    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RuntimeTrace):
            return NotImplemented
        return (self.n_workers == other.n_workers
                and self.events == other.events
                and self.counters == other.counters
                and self.dropped == other.dropped
                and self.steal_flows == other.steal_flows
                and self.frame_flows == other.frame_flows)

    __hash__ = None  # type: ignore[assignment]

    # ------------------------------------------------------------------
    def reconcile(self, stats: Dict[str, Any]) -> Dict[str, Tuple[int, int]]:
        """Compare this trace's exact event counters against a
        ``RunReport.stats`` dict; returns ``{key: (stats value, trace
        value)}`` for every shared counter that disagrees (empty == the
        trace accounts for every counted event)."""
        out: Dict[str, Tuple[int, int]] = {}
        for key in _COUNTER_EVENTS:
            if key in stats and key in self.counters:
                if int(stats[key]) != self.counters[key]:
                    out[key] = (int(stats[key]), self.counters[key])
        return out

    def dispatch_overhead_fraction(self) -> float:
        """Fraction of total worker-time NOT spent in task/ULT bodies —
        scheduling, steal scans, GIL waits, blocked communication, idle.
        ``1 - utilization()``; the per-phase number behind the serving
        bench's dispatch-collapse row."""
        if not self.events:
            return 0.0
        return max(0.0, 1.0 - self.utilization())

    def metrics(self) -> Dict[str, Any]:
        """Aggregate run metrics: steal success rate and per-victim
        histogram, resume-latency stats, per-worker idle fractions,
        barrier/blocked wait time, replay fallback rate."""
        if self._metrics_cache is not None:
            return dict(self._metrics_cache)
        c = self.counters
        attempts = c.get("steal_attempts", 0)
        hits = c.get("steals", 0)
        lat = sorted(self.resume_latencies)
        n_tasks = max(1, c.get("tasks", 0))
        per_worker = self.per_worker_breakdown()
        mk = self.makespan
        idle_frac = [
            (w.get(KIND_IDLE, 0.0) / mk if mk else 0.0) for w in per_worker]
        metrics: Dict[str, Any] = {
            "steal_attempts": attempts,
            "steal_hits": hits,
            "steal_success_rate": (hits / attempts) if attempts else 0.0,
            "steal_by_victim": {v: list(ah)
                                for v, ah in sorted(self.steal_victims.items())},
            "frame_resumes_by_worker": dict(
                sorted(self.frame_resumes_by_worker.items())),
            "resume_latency": {
                "count": len(lat),
                "mean_s": (sum(lat) / len(lat)) if lat else 0.0,
                # upper nearest-rank percentile (rounds up on small n)
                "p95_s": lat[-max(1, len(lat) - int(0.95 * len(lat)))]
                if lat else 0.0,
                "max_s": lat[-1] if lat else 0.0,
            },
            "per_worker_idle_fraction": idle_frac,
            "barrier_wait_s": self.breakdown().get(KIND_BARRIER, 0.0),
            "resource_waits": c.get("resource_waits", 0),
            "resource_wait_s": sum(t1 - t0
                                   for _, t0, t1 in self.resource_waits),
            "resource_wait_fraction":
                (sum(t1 - t0 for _, t0, t1 in self.resource_waits)
                 / (mk * self.n_workers)) if mk else 0.0,
            "replay_fallback_rate": c.get("fallback_steals", 0) / n_tasks,
            "dispatch_overhead_fraction": self.dispatch_overhead_fraction(),
            "utilization": self.utilization(),
            "makespan_s": mk,
            "dropped_events": self.dropped,
        }
        self._metrics_cache = metrics
        return dict(metrics)

    @classmethod
    def from_recorder(cls, recorder, n_workers: Optional[int] = None
                      ) -> "RuntimeTrace":
        return assemble(recorder.snapshot(),
                        n_workers if n_workers is not None
                        else recorder.n_workers,
                        dropped=recorder.dropped)


# boundary events: these open/close the per-worker unit stack
_OPENERS = {EV_TASK_START, EV_FRAME_RESUME, EV_GANG_ENTER, EV_BLOCK,
            EV_BARRIER_WAIT, EV_PARK}
_CLOSERS = {EV_TASK_END: EV_TASK_START, EV_FRAME_SUSPEND: EV_FRAME_RESUME,
            EV_GANG_EXIT: EV_GANG_ENTER, EV_UNBLOCK: EV_BLOCK,
            EV_BARRIER_DONE: EV_BARRIER_WAIT, EV_WAKE: EV_PARK}


def _unit_for(ev: str, label: str, a: int, b: int) -> Tuple[Any, str, str]:
    """(match key, span kind, span label) of an opening boundary event."""
    if ev == EV_TASK_START:
        kind, name = _split_label(label)
        return ("t", a), kind, name
    if ev == EV_FRAME_RESUME:
        kind, name = _split_label(label)
        return ("t", a), kind, f"{name}#s{b}"
    if ev == EV_GANG_ENTER:
        return ("g", a, b), KIND_PANEL, label or f"r{a}.t{b}"
    if ev == EV_BLOCK:
        return ("blk", a), KIND_BARRIER, label
    if ev == EV_BARRIER_WAIT:
        return ("bar", a), KIND_BARRIER, label or f"barrier r{a}"
    return ("idle",), KIND_IDLE, ""


def _close_key(ev: str, a: int, b: int) -> Any:
    if ev == EV_TASK_END or ev == EV_FRAME_SUSPEND:
        return ("t", a)
    if ev == EV_GANG_EXIT:
        return ("g", a, b)
    if ev == EV_UNBLOCK:
        return ("blk", a)
    if ev == EV_BARRIER_DONE:
        return ("bar", a)
    return ("idle",)


def assemble(snapshot: List[Tuple[int, float, str, str, int, int]],
             n_workers: int, *, dropped: int = 0) -> RuntimeTrace:
    """Build a :class:`RuntimeTrace` from a recorder snapshot (``(worker,
    t, kind, label, a, b)`` tuples, any order).  Timestamps are shifted so
    the earliest event is ``t=0`` (simulator convention; keeps
    ``makespan`` meaningful)."""
    rt = RuntimeTrace(n_workers)
    rt.dropped = dropped
    if not snapshot:
        rt.counters = {k: 0 for k in _COUNTER_EVENTS}
        return rt
    events = sorted(snapshot, key=lambda e: e[1])
    t_base = events[0][1]
    t_end = events[-1][1] - t_base

    counters: Dict[str, int] = defaultdict(int)
    victims: Dict[int, List[int]] = {}
    # frame flow matching: (tid, seg) -> pending suspend/wake timestamps
    suspends: Dict[Tuple[int, int], Tuple[int, float, str]] = {}
    wakes: Dict[Tuple[int, int], Tuple[int, float]] = {}
    # resource wait matching: tid -> defer timestamp (closed by the grant)
    res_pending: Dict[int, float] = {}

    per_worker: Dict[int, List[Tuple[float, str, str, int, int]]] = \
        defaultdict(list)
    for (w, t, ev, label, a, b) in events:
        per_worker[w].append((t - t_base, ev, label, a, b))

    spans: List[Event] = []
    for w in range(n_workers):
        stack: List[Tuple[Any, str, str]] = []
        cur_t = 0.0
        for (t, ev, label, a, b) in per_worker.get(w, ()):
            if ev in _OPENERS:
                if stack and t > cur_t:
                    _, k, lbl = stack[-1]
                    spans.append(Event(w, cur_t, t, k, lbl))
                stack.append(_unit_for(ev, label, a, b))
                cur_t = t
            elif ev in _CLOSERS:
                if stack and t > cur_t:
                    _, k, lbl = stack[-1]
                    spans.append(Event(w, cur_t, t, k, lbl))
                key = _close_key(ev, a, b)
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i][0] == key:
                        del stack[i]
                        break
                cur_t = t
                if ev == EV_FRAME_SUSPEND:
                    spans.append(Event(w, t, t, KIND_SWITCH, label))
                    suspends[(a, b)] = (w, t, label)
            elif ev == EV_STEAL_HIT:
                spans.append(Event(w, t, t, KIND_STEAL, label))
                rt.steal_flows.append((a, w, t, label))
            elif ev == EV_REPLAY_FALLBACK:
                spans.append(Event(w, t, t, KIND_STEAL, f"fallback:{label}"))
            elif ev == EV_RESOURCE_WAIT:
                spans.append(Event(w, t, t, KIND_SWITCH, f"res-wait:{label}"))
            elif ev == EV_RESOURCE_ACQUIRE:
                spans.append(Event(w, t, t, KIND_SWITCH,
                                   f"res-acquire:{label}"))
            elif ev == EV_RESOURCE_RELEASE:
                spans.append(Event(w, t, t, KIND_SWITCH,
                                   f"res-release:{label}"))
        # close dangling units (aborted runs / ring truncation) at trace end
        while stack:
            _, k, lbl = stack.pop()
            if t_end > cur_t:
                spans.append(Event(w, cur_t, t_end, k, lbl))
                cur_t = t_end

    # flows + counters need the global stream (wakes land on other workers)
    for (w, t, ev, label, a, b) in events:
        t -= t_base
        for cname, ckind in _COUNTER_EVENTS.items():
            if ev == ckind:
                counters[cname] += 1
        if ev == EV_RESOURCE_WAIT:
            res_pending[a] = t
        elif ev == EV_RESOURCE_ACQUIRE:
            t0 = res_pending.pop(a, None)
            if t0 is not None:
                rt.resource_waits.append((a, t0, t))
        elif ev == EV_STEAL_ATTEMPT:
            victims.setdefault(a, [0, 0])[0] += 1
        elif ev == EV_STEAL_HIT:
            victims.setdefault(a, [0, 0])[1] += 1
        elif ev == EV_FRAME_WAKE:
            wakes[(a, b)] = (w, t)
        elif ev == EV_FRAME_RESUME:
            resumes_by_w = rt.frame_resumes_by_worker
            resumes_by_w[w] = resumes_by_w.get(w, 0) + 1
            wake = wakes.pop((a, b), None)
            if wake is not None:
                src_w, t_wake = wake
                parked = suspends.pop((a, b), None)
                flow_label = parked[2] if parked is not None else label
                rt.frame_flows.append((src_w, t_wake, w, t, flow_label))
                rt.resume_latencies.append(max(0.0, t - t_wake))

    spans.sort(key=lambda e: (e.t0, e.worker, e.t1))
    rt.events = spans
    for k in _COUNTER_EVENTS:
        counters.setdefault(k, 0)
    rt.counters = dict(counters)
    rt.steal_victims = victims
    return rt
