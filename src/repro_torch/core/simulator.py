"""Discrete-event simulator of the paper's scheduler.

Runs a :class:`~repro_torch.core.taskgraph.TaskGraph` on ``n_workers`` virtual
workers under a victim-selection policy (Algorithm 2) and one of three
nested-parallel-region modes:

* ``gang``          — the paper: regions are gang-scheduled onto reserved
                      workers (Algorithm 1); gang ULTs are stealable by
                      eligible workers; barriers are safe by construction.
* ``oversubscribe`` — the LLVM-OMP baseline: each nested region brings its
                      own thread pool; its threads timeshare the cores near
                      the spawner (processor-sharing approximation plus a
                      per-phase context-switch penalty).
* ``ult_naive``     — ULTs multiplexed on workers with *blocking* barriers
                      and no gang coordination (paper Fig. 1a): the sim
                      detects the resulting deadlock and raises
                      :class:`DeadlockError`.

Virtual time is event-driven; all randomness comes from the policy seeds, so
runs are reproducible.  The output is a :class:`~repro_torch.core.tracing.Trace`
(makespan, per-kind breakdowns) — the substrate for the Fig. 7/8/9/11
benchmark analogues.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from .gang import GangState, is_eligible_to_sched
from .policies import VictimPolicy, make_policy
from .taskgraph import ParallelSpec, Task, TaskGraph
from .tracing import KIND_BARRIER, KIND_COMM, Trace


class DeadlockError(RuntimeError):
    """All workers are blocked on barriers while runnable ULTs remain —
    the paper's Fig. 1 scenario."""


@dataclasses.dataclass
class _Region:
    rid: int
    gang_id: int          # -1 when not gang-scheduled
    nest_level: int
    spec: ParallelSpec
    spawn_task: Optional[Task]
    spawn_worker: int
    kind: str
    arrived: List[int] = dataclasses.field(default_factory=list)
    parked: List[List["_ULTJob"]] = dataclasses.field(default_factory=list)
    done_threads: int = 0

    def __post_init__(self):
        n_phases = max(1, self.spec.n_barriers)
        self.arrived = [0] * n_phases
        self.parked = [[] for _ in range(n_phases)]

    @property
    def n_phases(self) -> int:
        return max(1, self.spec.n_barriers)


@dataclasses.dataclass
class _ULTJob:
    region: _Region
    thread_num: int
    phase: int = 0
    worker: int = -1        # worker currently running / last ran this ULT
    park_t: float = 0.0

    @property
    def gang_id(self) -> int:
        return self.region.gang_id

    @property
    def nest_level(self) -> int:
        return self.region.nest_level

    @property
    def name(self) -> str:
        return f"r{self.region.rid}.t{self.thread_num}.p{self.phase}"


class _Worker:
    __slots__ = ("wid", "local", "gang_deq", "suspended", "policy", "context",
                 "blocked", "co_resident", "fail_streak", "busy_until",
                 "last_family")

    def __init__(self, wid: int, policy: VictimPolicy):
        self.wid = wid
        self.local: Deque[Task] = deque()
        self.gang_deq: Deque[_ULTJob] = deque()
        self.suspended: Deque[Task] = deque()
        self.policy = policy
        self.context: List[Tuple[int, int]] = []   # (gang_id, nest_level) stack
        self.blocked = False
        self.co_resident = 0
        self.fail_streak = 0
        self.busy_until = 0.0
        self.last_family = None

    @property
    def cur_gang_id(self) -> int:
        return self.context[-1][0] if self.context else -1

    @property
    def nest_level(self) -> int:
        return self.context[-1][1] if self.context else 0

    def has_queued(self) -> bool:
        return bool(self.local or self.gang_deq or self.suspended)


# event kinds in the heap: ("w", worker_id) dispatch, ("c", cont_id) continuation
class Simulator:
    def __init__(
        self,
        n_workers: int,
        *,
        ranks: int = 1,
        policy: str = "hybrid",
        mode: str = "gang",
        seed: int = 0,
        steal_latency: float = 2e-6,
        ctx_switch: float = 5e-6,
        fork_overhead: float = 2e-6,
        respect_priority: bool = False,
        locality_penalty: float = 0.10,
        trace: bool = True,
    ):
        if mode not in ("gang", "oversubscribe", "ult_naive"):
            raise ValueError(f"unknown mode {mode!r}")
        if n_workers % ranks != 0:
            raise ValueError(f"n_workers={n_workers} not divisible by ranks={ranks}")
        self.n_workers = n_workers
        # MPI-rank partitioning: workers are split into `ranks` pools; work
        # stealing and gang reservation stay within a pool, and tasks pinned
        # via meta['rank'] are enqueued on their rank's pool (the paper's
        # multi-rank SLATE runs: 2-4 ranks/node x 10-20 threads/rank).
        self.ranks = ranks
        self.rank_width = n_workers // ranks
        self.mode = mode
        self.policy_name = policy
        self.seed = seed
        self.steal_latency = steal_latency
        self.ctx_switch = ctx_switch
        self.fork_overhead = fork_overhead
        # LLVM OMP (the paper's baseline) ignores the OpenMP `priority`
        # clause — "supported by only a few OpenMP runtime systems such as
        # GNU OpenMP" (paper §5.1) — so plain LIFO is the default.
        self.respect_priority = respect_priority
        # data-locality model: sibling tasks of one family (same kind+step,
        # e.g. trailing children of one step sharing the panel column in
        # cache) run at full speed back-to-back; switching families on a
        # worker pays a cold-cache penalty.  This is the locality term that
        # makes pure-random stealing lose (paper §3.2: "random stealing,
        # however, suffers from a loss of data locality").
        self.locality_penalty = locality_penalty
        self.trace_enabled = trace

    # ------------------------------------------------------------------
    def run(self, graph: TaskGraph) -> Trace:
        graph.validate()
        self.graph = graph
        self.trace = Trace(self.n_workers)
        # victim policies operate on local (within-rank) worker ids
        self.workers = [
            _Worker(w, make_policy(self.policy_name, w % self.rank_width,
                                   self.rank_width, self.seed + 1000 * (w // self.rank_width)))
            for w in range(self.n_workers)
        ]
        # per-rank gang state: reservations never cross rank pools
        self.gang_states = [GangState(self.rank_width) for _ in range(self.ranks)]
        self.gang_state = self.gang_states[0]  # back-compat alias (ranks=1)
        self.indeg = graph.indegrees()
        self.remaining = len(graph)
        # declarative resources: virtual holder counters + a FIFO of
        # deferred (task, worker, defer_t) waiters.  A deferred task costs
        # the *task* time, not the worker (the worker moves on — the
        # arbiter's work-conserving contract); the wait surfaces in the
        # trace as a barrier-kind span labelled "res:<task>".
        from ..resources.arbiter import task_needs
        self._res_needs = {
            t.tid: task_needs(graph, t.tid) for t in graph.tasks
            if getattr(t, "uses", ()) or getattr(t, "uses_shared", ())}
        n_res = len(getattr(graph, "resources", ()))
        self._res_excl = [0] * n_res
        self._res_shared = [0] * n_res
        self._res_caps = [r.capacity for r in getattr(graph, "resources", ())]
        self._res_held: Dict[int, Any] = {}
        self._res_wait: List[Tuple[Task, int, float]] = []
        # gang reservations in fork order: (spawn_tid, gang_id, workers, t)
        # — consumed by ListScheduler to synthesize replayable placements
        self.gang_log: List[Tuple[int, int, List[int], float]] = []
        self._region_ids = itertools.count()
        self._seq = itertools.count()
        self._heap: List[Tuple[float, int, Tuple[str, int]]] = []
        self._conts: Dict[int, Tuple[_Worker, _ULTJob]] = {}
        self._next_cont = itertools.count()

        # Roots are created by each rank's master thread => lead worker's
        # local queue (this is what makes history serialization observable).
        for t in graph.roots():
            r = t.meta.get("rank") or 0
            self.workers[r * self.rank_width].local.append(t)

        self._actions: Dict[int, Any] = {}
        self._next_action = itertools.count()

        now = 0.0
        for w in range(self.n_workers):
            self._event(0.0, ("w", w))

        guard, max_events = 0, 500 * (len(graph) + 8) * max(1, self.n_workers) + 500_000
        while self._heap and self.remaining > 0:
            guard += 1
            if guard > max_events:
                raise RuntimeError("simulator exceeded event budget (livelock?)")
            now, _, (ekind, arg) = heapq.heappop(self._heap)
            if ekind == "w":
                self._dispatch(self.workers[arg], now)
            elif ekind == "a":
                self._actions.pop(arg)(now)
            else:
                w, ult = self._conts.pop(arg)
                self._arrive_barrier(w, ult, now)
            if self.remaining > 0 and not self._heap:
                self._deadlock_check(now, final=True)
        if self.remaining > 0:
            self._deadlock_check(now, final=True)
        return self.trace

    # ------------------------------------------------------------------
    def _event(self, t: float, payload: Tuple[str, int]) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), payload))

    def _cont(self, t: float, w: _Worker, ult: _ULTJob) -> None:
        cid = next(self._next_cont)
        self._conts[cid] = (w, ult)
        self._event(t, ("c", cid))

    def _action(self, t: float, fn) -> None:
        aid = next(self._next_action)
        self._actions[aid] = fn
        self._event(t, ("a", aid))

    def _record(self, w: int, t0: float, t1: float, kind: str, label: str = "") -> None:
        if self.trace_enabled and t1 > t0:
            self.trace.record(w, t0, t1, kind, label)

    # -- dispatch: the scheduling-point logic ---------------------------
    def _dispatch(self, w: _Worker, now: float) -> None:
        if w.blocked or self.remaining == 0:
            return
        if now < w.busy_until - 1e-15:
            return  # stale wake-up while executing; completion event follows
        job = self._next_job(w)
        if job is None:
            w.fail_streak += 1
            backoff = self.steal_latency * min(64, w.fail_streak)
            self._event(now + backoff, ("w", w.wid))
            return
        w.fail_streak = 0
        if isinstance(job, Task):
            self._run_task(w, job, now)
        else:
            self._run_ult_phase(w, job, now)

    def _next_job(self, w: _Worker):
        # priority: suspended > own gang deque (eligible) > local > steal
        if w.suspended:
            return w.suspended.popleft()
        g = self._pop_gang(w, w)
        if g is not None:
            return g
        if w.local:
            return self._pop_local(w)
        return self._steal(w)

    def _pop_local(self, w: _Worker) -> Task:
        if not self.respect_priority:
            return w.local.pop()        # plain LIFO (LLVM OMP semantics)
        # priority-clause support: scan a bounded window from the newest end
        best_i, best_p = len(w.local) - 1, w.local[-1].priority
        for i in range(len(w.local) - 1, max(-1, len(w.local) - 9), -1):
            if w.local[i].priority > best_p:
                best_i, best_p = i, w.local[i].priority
        t = w.local[best_i]
        del w.local[best_i]
        return t

    def _pop_gang(self, thief: _Worker, victim: _Worker) -> Optional[_ULTJob]:
        """FIFO pop of the victim's gang deque, subject to Algorithm 1's
        eligibility predicate evaluated against the *thief*."""
        if not victim.gang_deq:
            return None
        head = victim.gang_deq[0]
        if is_eligible_to_sched(head.gang_id, head.nest_level, thief.cur_gang_id, thief.nest_level):
            return victim.gang_deq.popleft()
        return None

    def _steal(self, w: _Worker):
        local_victim = w.policy.select()
        victim_id = (w.wid // self.rank_width) * self.rank_width + local_victim
        victim = self.workers[victim_id]
        job: Any = None
        if victim_id != w.wid:
            job = self._pop_gang(w, victim)       # gang ULTs: highest steal priority
            if job is None and victim.local:
                job = victim.local.popleft()      # FIFO side (oldest = biggest subtree)
        w.policy.record(local_victim, job is not None)
        return job

    def _deadlock_check(self, now: float, final: bool = False) -> None:
        blocked = sum(1 for w in self.workers if w.blocked)
        queued = sum(len(w.local) + len(w.gang_deq) + len(w.suspended) for w in self.workers)
        if self.remaining > 0 and blocked > 0 and blocked == self.n_workers:
            raise DeadlockError(
                f"t={now:.6f}: all {blocked} workers blocked at barriers, "
                f"{queued} runnable ULTs/tasks starved, {self.remaining} tasks unfinished"
            )
        if final and self.remaining > 0:
            if blocked > 0:
                raise DeadlockError(
                    f"t={now:.6f}: {blocked}/{self.n_workers} workers blocked at barriers "
                    f"with no waking event; {self.remaining} tasks unfinished"
                )
            raise RuntimeError(
                f"simulation stalled at t={now:.6f} with {self.remaining} tasks unfinished"
            )

    # -- declarative resources -------------------------------------------
    def _res_available(self, needs) -> bool:
        for rindex, shared in needs:
            if shared:
                if self._res_excl[rindex] > 0:
                    return False
            elif (self._res_shared[rindex] > 0
                    or self._res_excl[rindex] >= self._res_caps[rindex]):
                return False
        return True

    def _res_grant(self, tid: int, needs) -> None:
        for rindex, shared in needs:
            if shared:
                self._res_shared[rindex] += 1
            else:
                self._res_excl[rindex] += 1
        self._res_held[tid] = needs

    def _res_release(self, task: Task, t: float) -> None:
        """Free a completing holder's resources and grant deferred waiters
        in FIFO order (a blocked earlier waiter shadows later overlapping
        ones — the arbiter's fairness rule), re-queueing each granted task
        on its deferring worker."""
        needs = self._res_held.pop(task.tid, None)
        if needs is None:
            return
        for rindex, shared in needs:
            if shared:
                self._res_shared[rindex] -= 1
            else:
                self._res_excl[rindex] -= 1
        if not self._res_wait:
            return
        shadow: set = set()
        still: List[Tuple[Task, int, float]] = []
        for waiter, wid, t0 in self._res_wait:
            wneeds = self._res_needs[waiter.tid]
            if (not any(r in shadow for r, _ in wneeds)
                    and self._res_available(wneeds)):
                self._res_grant(waiter.tid, wneeds)
                self._record(wid, t0, t, KIND_BARRIER, f"res:{waiter.name}")
                self.workers[wid].local.append(waiter)
                self._event(t, ("w", wid))
            else:
                still.append((waiter, wid, t0))
                shadow.update(r for r, _ in wneeds)
        self._res_wait = still

    # -- graph tasks ------------------------------------------------------
    def _run_task(self, w: _Worker, task: Task, now: float) -> None:
        needs = self._res_needs.get(task.tid)
        if needs is not None and task.tid not in self._res_held:
            mine = {r for r, _ in needs}
            overtakes = any(         # FIFO fairness: no overtaking an
                r in mine            # earlier waiter on a shared resource
                for wt, _, _ in self._res_wait
                for r, _ in self._res_needs[wt.tid])
            if overtakes or not self._res_available(needs):
                self._res_wait.append((task, w.wid, now))
                self._event(now, ("w", w.wid))   # worker stays work-conserving
                return
            self._res_grant(task.tid, needs)
        dur = task.cost
        if self.mode == "oversubscribe" and w.co_resident > 0:
            dur = dur * (1 + w.co_resident) + self.ctx_switch * w.co_resident
        if self.locality_penalty and task.kind != KIND_COMM:
            family = (task.kind, task.meta.get("step"))
            if w.last_family is not None and family != w.last_family:
                dur *= 1.0 + self.locality_penalty
            w.last_family = family
        end = now + dur
        self._record(w.wid, now, end, task.kind, task.name)
        w.busy_until = end

        def _finish(t: float, w=w, task=task) -> None:
            if task.parallel is not None and task.parallel.n_threads > 0:
                self._fork_region(w, task, t)
            else:
                self._complete_task(w, task, t)
            self._event(t, ("w", w.wid))

        self._action(end, _finish)

    def _complete_task(self, w: _Worker, task: Task, t: float) -> None:
        self.remaining -= 1
        self._res_release(task, t)
        my_rank = w.wid // self.rank_width
        for s in self.graph.successors(task):
            self.indeg[s.tid] -= 1
            if self.indeg[s.tid] == 0:
                r = s.meta.get("rank")
                if r is None or r == my_rank:
                    w.local.append(s)   # ready tasks go to the resolving worker
                else:
                    # cross-rank readiness (an MPI message landing): enqueue
                    # on the destination rank's lead worker
                    dst = self.workers[r * self.rank_width]
                    dst.local.append(s)
                    self._event(t, ("w", dst.wid))

    # -- nested parallel regions -----------------------------------------
    def _fork_region(self, w: _Worker, task: Task, t: float) -> None:
        spec = task.parallel
        assert spec is not None
        gang = spec.gang if spec.gang is not None else (self.mode == "gang")
        region = _Region(
            rid=next(self._region_ids),
            gang_id=-1,
            nest_level=w.nest_level + 1,
            spec=spec,
            spawn_task=task,
            spawn_worker=w.wid,
            kind=task.kind,
        )
        n = spec.n_threads
        if self.mode == "gang" and gang:
            # Algorithm 1: GANG_SCHED under the fork lock (per-rank pool)
            rank = w.wid // self.rank_width
            gs = self.gang_states[rank]
            region.gang_id = gs.next_gang_id() + rank * 1_000_000
            reserved = gs.get_workers(w.wid % self.rank_width, n)
            gs.account_gang([reserved[i % len(reserved)] for i in range(n)])
            base = rank * self.rank_width
            members = [base + reserved[i % len(reserved)] for i in range(n)]
            self.gang_log.append((task.tid, region.gang_id, members, t))
            for i in range(n):
                target = self.workers[members[i]]
                target.gang_deq.append(_ULTJob(region, i))
                self._event(t + self.fork_overhead, ("w", target.wid))
        elif self.mode == "oversubscribe":
            # fresh thread pool co-resident on cores near the spawner
            for i in range(n):
                core = self.workers[(w.wid + i) % self.n_workers]
                core.co_resident += 1
                ult = _ULTJob(region, i, worker=core.wid)
                self._start_oversubscribed_phase(core, ult, t + self.fork_overhead)
        else:
            # ult_naive (or explicitly non-gang regions): ULTs queue on the
            # spawner as stealable work — Fig. 1 hazard if blocking.
            for i in range(n):
                w.gang_deq.append(_ULTJob(region, i))
            self._event(t, ("w", w.wid))

    def _phase_cost(self, region: _Region) -> float:
        return region.spec.cost_per_thread / region.n_phases

    # -- ULT execution: gang / ult_naive paths -----------------------------
    def _run_ult_phase(self, w: _Worker, ult: _ULTJob, now: float) -> None:
        region = ult.region
        ult.worker = w.wid
        w.context.append((region.gang_id, region.nest_level))
        end = now + self._phase_cost(region)
        self._record(w.wid, now, end, region.kind, ult.name)
        w.busy_until = end
        w.context.pop()
        self._cont(end, w, ult)

    def _arrive_barrier(self, w: _Worker, ult: _ULTJob, t: float) -> None:
        region = ult.region
        phase = ult.phase
        region.arrived[phase] += 1
        if region.arrived[phase] == region.spec.n_threads:
            parked = region.parked[phase]
            region.parked[phase] = []
            for p in parked:
                self._wake_parked(p, t)
            self._advance_ult(self.workers[ult.worker], ult, t)
        else:
            region.parked[phase].append(ult)
            ult.park_t = t
            if self.mode == "ult_naive" and region.spec.blocking:
                # blocking barrier on a kernel thread: the worker spins
                w.blocked = True
                self._deadlock_check(t)
            else:
                # cooperative barrier / gang join point: worker schedules
                # other eligible work (paper's scheduling point)
                self._event(t, ("w", w.wid))

    def _wake_parked(self, ult: _ULTJob, t: float) -> None:
        region = ult.region
        w = self.workers[ult.worker]
        self._record(w.wid, ult.park_t, t, KIND_BARRIER, ult.name)
        if self.mode == "ult_naive" and region.spec.blocking:
            w.blocked = False
        self._advance_ult(w, ult, t)

    def _advance_ult(self, w: _Worker, ult: _ULTJob, t: float) -> None:
        region = ult.region
        ult.phase += 1
        if ult.phase >= region.n_phases:
            self._finish_ult(w, ult, t)
            self._event(t, ("w", w.wid))
            return
        if self.mode == "oversubscribe":
            self._start_oversubscribed_phase(w, ult, t)
        elif self.mode == "ult_naive" and region.spec.blocking:
            # continue next phase in place on the (just-woken) worker
            end = t + self._phase_cost(region)
            self._record(w.wid, t, end, region.kind, ult.name)
            self._cont(end, w, ult)
        else:
            # gang / cooperative: re-enqueue at the front of this worker's
            # gang deque (locality); eligible workers may steal it.
            w.gang_deq.appendleft(ult)
            self._event(t, ("w", w.wid))

    def _finish_ult(self, w: _Worker, ult: _ULTJob, t: float) -> None:
        region = ult.region
        region.done_threads += 1
        if self.mode == "oversubscribe":
            core = self.workers[ult.worker]
            core.co_resident = max(0, core.co_resident - 1)
        if region.gang_id >= 0:
            rank = w.wid // self.rank_width
            self.gang_states[rank].release_gang_thread(w.wid % self.rank_width)
        if region.done_threads == region.spec.n_threads:
            if region.spawn_task is not None:
                self._complete_task(self.workers[region.spawn_worker], region.spawn_task, t)
                self._event(t, ("w", region.spawn_worker))

    # -- oversubscribe path -------------------------------------------------
    def _start_oversubscribed_phase(self, core: _Worker, ult: _ULTJob, t: float) -> None:
        region = ult.region
        share = max(1, core.co_resident)
        busy_now = 1 if core.busy_until > t else 0
        dur = self._phase_cost(region) * (share + busy_now) \
            + self.ctx_switch * max(0, share + busy_now - 1)
        end = t + dur
        self._record(core.wid, t, end, region.kind, ult.name)
        self._cont(end, core, ult)


def simulate(
    graph: TaskGraph,
    n_workers: int,
    *,
    policy: str = "hybrid",
    mode: str = "gang",
    seed: int = 0,
    **kw: Any,
) -> Trace:
    """One-shot convenience wrapper."""
    return Simulator(n_workers, policy=policy, mode=mode, seed=seed, **kw).run(graph)
