"""Dynamic dispatch: work-stealing deques + Algorithm-1 gang scheduling.

The scheduling brain of the paper's integrated runtime, extracted from the
old monolithic ``Runtime`` so it runs on the shared
:class:`~repro_torch.exec.core.ExecutorCore` substrate:

* per-worker work-stealing deques; ready tasks are pushed to the queue of
  the worker that resolved their last dependency (paper §2.1);
* Algorithm 2 victim selection (``history`` / ``random`` / ``hybrid``);
* Algorithm 1 gang scheduling: parallel regions spawned by tasks are
  gang-scheduled onto reserved workers under the fork lock with a monotonic
  gang id; gang ULTs are stealable subject to ``is_eligible_to_sched``;
* region barriers: gang regions may use *blocking* barriers safely (all
  members are guaranteed distinct workers); at the *join* barrier a gang
  ULT steals eligible work instead of idling (the paper's scheduling
  point); non-gang regions with blocking barriers reproduce the Fig. 1
  deadlock, which the core's detector raises as
  :class:`~repro_torch.core.simulator.DeadlockError`.

Record-and-replay instrumentation (per-worker start orders, steals, gang
placements, fork order) lives here too: recording is a property of the
*dynamic* schedule, not of the substrate.

Suspendable task frames (the paper's ULT-style preemption): a task body
written as a generator compiles into a :class:`~repro_torch.core.taskgraph.TaskFrame`.
Yielding ``ctx.recv``/``ctx.wait``/``ctx.yield_`` parks the frame on the
waited-on primitive and *frees the worker*; a matching ``send``/``set``
moves the frame onto the resume deque of the worker that last ran it
(resume locality — siblings keep their cache affinity), where it is a
stealable work item under the same Algorithm-2 victim policies as fresh
tasks.  Suspended frames are soft-blocked: they are excluded from the
Fig.-1 hard-block count, and a run whose only remaining work is frames
nobody can resume is detected as a *suspension* deadlock instead of
hanging.  With recording on, every yield point suspends (no inline fast
path) so each resume segment lands in the run lists as a
:class:`~repro_torch.core.taskgraph.FrameResume` entry and replay can reproduce
the exact frame interleaving.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from types import GeneratorType
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ..core.gang import GangState, is_eligible_to_sched
from ..core.policies import make_policy
from ..core.simulator import DeadlockError
from ..core.taskgraph import (
    Channel,
    FrameResume,
    Task,
    TaskContext,
    TaskEvent,
    TaskFrame,
    TaskGraph,
    WaitAnyRequest,
    activity_epoch,
    note_parked,
    note_unparked,
)
from ..core.tracing import (
    EV_BLOCK,
    EV_DEADLOCK_POLL,
    EV_FRAME_WAKE,
    EV_GANG_ENTER,
    EV_GANG_EXIT,
    EV_GANG_RESERVE,
    EV_PARK,
    EV_RESOURCE_ACQUIRE,
    EV_RESOURCE_RELEASE,
    EV_RESOURCE_WAIT,
    EV_STEAL_ATTEMPT,
    EV_STEAL_HIT,
    EV_TASK_END,
    EV_UNBLOCK,
    EV_WAKE,
)
from ..obs.recorder import NULL_RECORDER, FlightRecorder
from ..resources.arbiter import ResourceArbiter
from .core import DispatchStrategy, ExecutorCore, GangRegion


class _GangULT:
    __slots__ = ("region", "thread_num")

    def __init__(self, region: GangRegion, thread_num: int):
        self.region = region
        self.thread_num = thread_num

    @property
    def gang_id(self) -> int:
        return self.region.gang_id

    @property
    def nest_level(self) -> int:
        return self.region.nest_level


class DynamicDispatch(DispatchStrategy):
    """Work-stealing + gang-scheduling dispatch (the paper's scheduler)."""

    def __init__(
        self,
        n_workers: int,
        *,
        policy: str = "hybrid",
        gang_default: bool = True,
        seed: int = 0,
        steal_backoff: float = 20e-6,
        trace: bool = False,
    ):
        self.core: Optional[ExecutorCore] = None
        self.n_workers = n_workers
        self.policy_name = policy
        self.gang_default = gang_default
        self.seed = seed
        self.steal_backoff = steal_backoff
        self.trace_enabled = trace
        # flight recorder: hot paths call emit unconditionally — with
        # tracing off this is the no-op singleton (one attribute call)
        self.recorder = FlightRecorder(n_workers) if trace else NULL_RECORDER

        self._fork_lock = threading.Lock()          # the paper's fork-phase lock
        self.gang_state = GangState(n_workers)
        self._region_ids = itertools.count()

        self._locals: List[Deque[Task]] = [deque() for _ in range(n_workers)]
        self._local_locks = [threading.Lock() for _ in range(n_workers)]
        self._gang_deqs: List[Deque[_GangULT]] = [deque() for _ in range(n_workers)]
        self._gang_locks = [threading.Lock() for _ in range(n_workers)]
        # resumed frames: per-worker deques keyed by resume locality (the
        # worker that last ran the frame); stealable like fresh tasks
        self._resume_deqs: List[Deque[TaskFrame]] = [deque() for _ in range(n_workers)]
        self._resume_locks = [threading.Lock() for _ in range(n_workers)]
        self._policies = [make_policy(policy, w, n_workers, seed)
                          for w in range(n_workers)]

        # parked (suspended) frames of the current run, keyed by task id
        self._suspended: Dict[int, TaskFrame] = {}
        self._suspend_lock = threading.Lock()
        # no-progress detection inputs: per-worker unit-nesting depth and a
        # "top of stack is blocked in ctx.recv/ctx.wait" flag (each worker
        # writes only its own slot; readers confirm via the wakeup epochs)
        self._depth = [0] * n_workers
        self._stalled = [False] * n_workers
        # live gang regions (abort must wake their barrier waiters promptly)
        self._live_regions: Dict[int, GangRegion] = {}
        self._region_lock = threading.Lock()

        # worker context stacks: list of (gang_id, nest_level)
        self._contexts: List[List[Tuple[int, int]]] = [[] for _ in range(n_workers)]

        self._graph: Optional[TaskGraph] = None
        self._indeg: List[int] = []
        self._indeg_lock = threading.Lock()
        self._results: Dict[int, Any] = {}
        self._results_lock = threading.Lock()
        self._remaining = 0
        self._remaining_lock = threading.Lock()
        self._work_available = threading.Condition()

        # record-and-replay instrumentation; populated when recording is on
        self._recording = False
        self._rec_entries: List[List[Any]] = []
        self._rec_steals: List[List[Tuple[int, Any]]] = []
        self._rec_forks: List[Tuple[int, int, int]] = []
        self._rec_comms: List[int] = []
        self._rec_comm_lock = threading.Lock()
        # wait_any winners: (tid, seg) -> winning source index (replay pins
        # the recorded choice, making selects deterministic)
        self._rec_wait_choices: Dict[Tuple[int, int], int] = {}

        # conflict-aware resource grants (declarative `uses=`; ROADMAP 3)
        self.arbiter = ResourceArbiter()

        # always-on lightweight run counters (surfaced in RunReport.stats);
        # gang_regions counts the Algorithm-1 regions forked (the port's
        # addition: it shows the LU/QR panels ran as gangs)
        self.run_stats: Dict[str, int] = {
            "steals": 0, "steal_attempts": 0, "frame_suspends": 0,
            "gang_regions": 0}

    # ------------------------------------------------------------------
    # DispatchStrategy interface
    def set_recording(self, record: bool) -> None:
        self._recording = record

    def begin_run(self, graph: TaskGraph) -> None:
        self._graph = graph
        self._indeg = graph.indegrees()
        self._results = {}
        self._remaining = len(graph)
        # a previous aborted run may have left stale queue entries / context;
        # discarded gang ULTs must also release their GangState accounting
        # or get_workers' load balancing skews forever on a reused runtime
        for dq in self._locals:
            dq.clear()
        for w, dq in enumerate(self._gang_deqs):
            for ult in dq:
                if ult.region.gang_id >= 0:
                    self.gang_state.release_gang_thread(w)
            dq.clear()
        # frames of an aborted run: cancel parked ones, close resumed-but-
        # never-rerun ones (the orphaned-frame leak check covers both).
        # Stale arbiter waiters are discarded first: their suspension
        # accounting died with the old run's state and must not touch the
        # fresh run's counters.
        self.arbiter.abort()
        self.drain_frames()
        for w, dq in enumerate(self._resume_deqs):
            with self._resume_locks[w]:
                stale = list(dq)
                dq.clear()
            for frame in stale:
                frame.close()
        with self._region_lock:
            self._live_regions.clear()
        self._depth = [0] * self.n_workers
        self._stalled = [False] * self.n_workers
        self._contexts = [[] for _ in range(self.n_workers)]
        if self._recording:
            self._rec_entries = [[] for _ in range(self.n_workers)]
            self._rec_steals = [[] for _ in range(self.n_workers)]
            self._rec_forks = []
            self._rec_comms = []
            self._rec_wait_choices = {}
        self.run_stats = {"steals": 0, "steal_attempts": 0,
                          "frame_suspends": 0, "resource_acquires": 0,
                          "resource_waits": 0, "resource_releases": 0,
                          "gang_regions": 0}
        self.arbiter.begin(graph)
        self.recorder.begin_run()
        # master thread (worker 0's queue) receives the roots
        for t in graph.roots():
            self._locals[0].append(t)

    @property
    def drained(self) -> bool:
        return self._remaining <= 0

    def results(self) -> Dict[int, Any]:
        return dict(self._results)

    def pending_units(self) -> int:
        return (sum(len(d) for d in self._gang_deqs)
                + sum(len(d) for d in self._locals)
                + sum(len(d) for d in self._resume_deqs))

    def wake_all(self) -> None:
        with self._work_available:
            self._work_available.notify_all()
        # barrier waiters inside live gang regions must observe the abort
        # promptly (and drain their hard-blocked accounting on the way out);
        # non-blocking: the caller may itself hold a region cv (a barrier
        # waiter runs the deadlock detector inside `with region.cv`)
        with self._region_lock:
            regions = list(self._live_regions.values())
        for region in regions:
            region.notify_nowait()

    def worker_loop(self, w: int) -> None:
        core = self.core
        emit = self.recorder.emit
        idle = False   # park/wake events on transitions only (no flood)
        while not self.drained and not core.aborted:
            progressed = self.schedule_once(w)
            if progressed:
                if idle:
                    idle = False
                    emit(w, EV_WAKE)
                continue
            if not idle:
                idle = True
                emit(w, EV_PARK)
            with self._work_available:
                if self.drained or core.aborted:
                    return
                self._work_available.wait(timeout=self.steal_backoff * 50)
            if not self.drained and not core.aborted:
                self._check_no_progress()

    def _active_workers(self) -> int:
        """Workers that can still make progress on their own: executing a
        unit whose stack top is NOT blocked in a plain-body recv/wait."""
        return sum(1 for w in range(self.n_workers)
                   if self._depth[w] > 0 and not self._stalled[w])

    def _check_no_progress(self) -> None:
        """Suspension deadlock: nothing queued, no worker executing freely
        (each is idle or stalled at a plain-body recv/wait), yet tasks
        remain — every wakeup would have to come from work that no longer
        exists.  Confirmed across a poll window against both wakeup epochs
        (frame resumes and raw channel/event activity), so a sender racing
        the window is never mistaken for quiescence.  The contract this
        enforces: wakeups come from the run's own work — a feeder outside
        the graph that stays silent past the window is indistinguishable
        from deadlock and aborts the run.  Workers hard-blocked at barriers
        count as active here; the Fig.-1 detector
        (:meth:`ExecutorCore.check_deadlock`) owns that state."""
        core = self.core
        if (self.drained or core.aborted or self.pending_units() > 0
                or self._active_workers() > 0):
            return
        suspended, stalled = core.suspended_frames, sum(self._stalled)
        if suspended <= 0 and stalled == 0:
            return
        self.recorder.emit(core.worker_id(default=-1), EV_DEADLOCK_POLL)
        resume_epoch, act_epoch = core.resume_epoch, activity_epoch()
        time.sleep(core.block_poll)
        if (not self.drained and not core.aborted
                and self.pending_units() == 0 and self._active_workers() == 0
                and (core.suspended_frames > 0 or sum(self._stalled) > 0)
                and core.resume_epoch == resume_epoch
                and activity_epoch() == act_epoch):
            with self._suspend_lock:
                waits = [f"{f.task.name}<-{f.request.describe()}"
                         for f in self._suspended.values()
                         if f.request is not None][:6]
            core.frame_deadlock(
                f"suspension deadlock: {core.suspended_frames} frame(s) "
                f"suspended ({', '.join(waits)}), {sum(self._stalled)} "
                "worker(s) blocked in task-body recv/wait, and no runnable "
                "work left to satisfy them")

    # ------------------------------------------------------------------
    # queues
    def _push_local(self, w: int, task: Task) -> None:
        with self._local_locks[w]:
            self._locals[w].append(task)

    def _pop_local(self, w: int) -> Optional[Task]:
        with self._local_locks[w]:
            dq = self._locals[w]
            if not dq:
                return None
            # priority-aware LIFO pop (bounded scan, paper's priority clause)
            best_i, best_p = len(dq) - 1, dq[-1].priority
            for i in range(len(dq) - 1, max(-1, len(dq) - 9), -1):
                if dq[i].priority > best_p:
                    best_i, best_p = i, dq[i].priority
            t = dq[best_i]
            del dq[best_i]
            return t

    def _steal_local(self, victim: int) -> Optional[Task]:
        with self._local_locks[victim]:
            dq = self._locals[victim]
            if not dq:
                return None
            if not self.arbiter.active:
                return dq.popleft()
            # conflict-aware: don't burn the steal on a task whose resources
            # are currently held — it would only bounce into the arbiter's
            # wait list (bounded FIFO-end scan, mirrors the priority pop)
            for i in range(min(len(dq), 8)):
                if not self.arbiter.would_defer(dq[i].tid):
                    t = dq[i]
                    del dq[i]
                    return t
            return None

    def _pop_resume(self, victim: int) -> Optional[TaskFrame]:
        with self._resume_locks[victim]:
            dq = self._resume_deqs[victim]
            return dq.popleft() if dq else None

    def _pop_gang(self, thief: int, victim: int) -> Optional[_GangULT]:
        ctx = self._contexts[thief]
        cur_gang, cur_nest = (ctx[-1] if ctx else (-1, 0))
        with self._gang_locks[victim]:
            dq = self._gang_deqs[victim]
            if not dq:
                return None
            head = dq[0]
            if is_eligible_to_sched(head.gang_id, head.nest_level, cur_gang, cur_nest):
                return dq.popleft()
            return None

    def _notify_work(self) -> None:
        with self._work_available:
            self._work_available.notify_all()

    # ------------------------------------------------------------------
    # scheduling
    def schedule_once(self, w: int) -> bool:
        """One scheduling point: gang deque > resumed frames > local deque >
        steal.  Returns True if a unit of work was executed."""
        if self.core.aborted:
            return False
        ult = self._pop_gang(w, w)
        if ult is not None:
            self._run_gang_ult(w, ult)
            return True
        frame = self._pop_resume(w)
        if frame is not None:
            self._run_frame_segment(w, frame)
            return True
        task = self._pop_local(w)
        if task is not None:
            self._run_task(w, task)
            return True
        # work stealing (Algorithm 2 policy)
        pol = self._policies[w]
        victim = pol.select()
        got: Any = None
        if victim != w:
            self.run_stats["steal_attempts"] += 1
            self.recorder.emit(w, EV_STEAL_ATTEMPT, "", victim)
            got = self._pop_gang(w, victim)
            if got is None:
                got = self._pop_resume(victim)
            if got is None:
                got = self._steal_local(victim)
        pol.record(victim, got is not None)
        if got is None:
            return False
        self.run_stats["steals"] += 1
        if self._recording:
            if isinstance(got, _GangULT):
                entry = (got.region.spawn_tid, got.thread_num) \
                    if got.region.spawn_task is not None else None
            elif isinstance(got, TaskFrame):
                entry = FrameResume(got.task.tid, got.resumes + 1)
            else:
                entry = got.tid
            if entry is not None:
                self._rec_steals[w].append((victim, entry))
        if isinstance(got, _GangULT):
            self.recorder.emit(w, EV_STEAL_HIT, "gang", victim)
            self._run_gang_ult(w, got)
        elif isinstance(got, TaskFrame):
            self.recorder.emit(w, EV_STEAL_HIT, "frame", victim)
            self._run_frame_segment(w, got)
        else:
            self.recorder.emit(w, EV_STEAL_HIT, "task", victim)
            self._run_task(w, got)
        return True

    # ------------------------------------------------------------------
    # task execution
    def _begin_unit(self, w: int) -> None:
        self._depth[w] += 1       # own slot only; no lock needed

    def _end_unit(self, w: int) -> None:
        self._depth[w] -= 1

    def _run_task(self, w: int, task: Task) -> None:
        arbiter = self.arbiter
        if arbiter.active and arbiter.needs(task.tid):
            if arbiter.holds(task.tid):
                pass        # pre-granted by a releaser's FIFO scan
            elif arbiter.try_acquire(task.tid):
                self.run_stats["resource_acquires"] += 1
                self.recorder.emit_resource(w, EV_RESOURCE_ACQUIRE, task,
                                            len(arbiter.needs(task.tid)))
            else:
                # contended: the task now sits on the arbiter's FIFO wait
                # list (soft-blocked, like a suspended frame — the worker
                # moves on); release() re-queues it when granted
                self.run_stats["resource_waits"] += 1
                self.recorder.emit_resource(w, EV_RESOURCE_WAIT, task)
                self.core.note_frame_suspended()
                return
        self.recorder.emit_task_start(w, task)
        if self._recording:
            # per-worker list, appended only by worker w: start order, no lock
            self._rec_entries[w].append(task.tid)
            if task.kind == "comm":
                with self._rec_comm_lock:
                    self._rec_comms.append(task.tid)
        ctx = TaskContext(self._graph, task, self._results, runtime=self)
        ctx.worker_id = w  # type: ignore[attr-defined]
        self._begin_unit(w)
        try:
            try:
                result = task.fn(ctx) if task.fn is not None else None
            except BaseException as e:  # noqa: BLE001 - propagate to run()
                self.core.fail(e)
                return
            if isinstance(result, GeneratorType):
                # generator body => suspendable frame (segment 0 runs now)
                ctx._in_frame = True
                frame = TaskFrame(task, ctx, result)
                frame.last_worker = w
                self._advance_frame(w, frame)
                return
        finally:
            self._end_unit(w)
        self.recorder.emit(w, EV_TASK_END, "", task.tid)
        with self._results_lock:
            self._results[task.tid] = result
        self._complete(w, task)

    # ------------------------------------------------------------------
    # suspendable frames
    def _run_frame_segment(self, w: int, frame: TaskFrame) -> None:
        """Execute one resume segment of a frame popped off a resume deque
        (possibly stolen — ``w`` need not be ``frame.last_worker``)."""
        frame.resumes += 1
        self.recorder.emit_frame_resume(w, frame)
        if self._recording:
            self._rec_entries[w].append(FrameResume(frame.task.tid, frame.resumes))
        frame.ctx.worker_id = w  # type: ignore[attr-defined]
        frame.last_worker = w
        self._begin_unit(w)
        try:
            self._advance_frame(w, frame)
        finally:
            self._end_unit(w)

    def _advance_frame(self, w: int, frame: TaskFrame) -> None:
        """Drive the generator until it completes or must park.  Without
        recording, immediately satisfiable requests (non-empty channel, set
        event) are consumed inline; with recording on, every request parks
        so the resume segment is observable as a run-list entry."""
        core = self.core
        value = frame.resume_value
        frame.resume_value = None
        while True:
            try:
                status, payload = frame.step(value)
            except BaseException as e:  # noqa: BLE001 - propagate to run()
                core.fail(e)
                return
            if status == "done":
                self.recorder.emit(w, EV_TASK_END, "", frame.task.tid)
                with self._results_lock:
                    self._results[frame.task.tid] = payload
                self._complete(w, frame.task)
                return
            request = payload
            if not self._recording:
                ok, value = request.try_immediate()
                if ok:
                    continue
            self._park_frame(w, frame, request)
            return

    def _park_frame(self, w: int, frame: TaskFrame, request) -> None:
        core = self.core
        frame.last_worker = w

        def waker(value=None, *, _frame=frame):
            self._resume_frame(_frame, value)

        frame.request = request
        frame.waker = waker
        with self._suspend_lock:
            self._suspended[frame.task.tid] = frame
        note_parked(frame)
        core.note_frame_suspended()
        self.run_stats["frame_suspends"] += 1
        self.recorder.emit_frame_suspend(w, frame, request)
        status, value = request.park(waker)
        if status == "ready":
            # the primitive was already satisfied (or this is a plain
            # yield): the frame is immediately resumable, via the queue so
            # other work interleaves — and so recording sees the segment
            waker(value)
        elif core.aborted:
            # the run died while we parked; nobody will drain us later
            self._discard_parked(frame)

    def _resume_frame(self, frame: TaskFrame, value: Any) -> None:
        """Waker target: move a parked frame onto the resume deque of its
        locality worker.  Idempotent against a racing cancel."""
        with self._suspend_lock:
            if self._suspended.pop(frame.task.tid, None) is None:
                return
        note_unparked(frame)
        if self._recording and isinstance(frame.request, WaitAnyRequest):
            # the resume value of a multi-wait is (winner index, payload);
            # record the winner so replay pins the same choice.  (tid, seg)
            # keys are unique, so racing wakers never collide.
            self._rec_wait_choices[(frame.task.tid, frame.resumes + 1)] = \
                int(value[0])
        frame.resume_value = value
        frame.request = None
        frame.waker = None
        self.core.note_frame_resumed()
        # the waker may be any thread (a worker mid-send or an external
        # caller) — worker -1 routes to the recorder's external ring
        self.recorder.emit(self.core.worker_id(default=-1), EV_FRAME_WAKE,
                           "", frame.task.tid, frame.resumes + 1)
        target = frame.last_worker
        with self._resume_locks[target]:
            self._resume_deqs[target].append(frame)
        self._notify_work()

    def _discard_parked(self, frame: TaskFrame) -> None:
        with self._suspend_lock:
            if self._suspended.pop(frame.task.tid, None) is None:
                return
        note_unparked(frame)
        if frame.request is not None:
            frame.request.cancel(frame.waker)
        self.core.note_frame_resumed()   # keep the run's suspend count balanced
        frame.close()

    def drain_frames(self) -> None:
        with self._suspend_lock:
            frames = list(self._suspended.values())
        for frame in frames:
            self._discard_parked(frame)
        # resource grants die with the run: drop every holder and rebalance
        # the suspension accounting of tasks still deferred on the arbiter
        # (the release-on-abort contract the checkpoint writers rely on)
        for _tid in self.arbiter.abort():
            self.core.note_frame_resumed()

    def _complete(self, w: int, task: Task) -> None:
        arbiter = self.arbiter
        if arbiter.active and arbiter.holds(task.tid):
            n_res = len(arbiter.needs(task.tid))
            granted = arbiter.release(task.tid)
            self.run_stats["resource_releases"] += 1
            self.recorder.emit_resource(w, EV_RESOURCE_RELEASE, task, n_res)
            for tid in granted:
                # granted at release time (FIFO-fair): hand the task back to
                # the releasing worker's queue, already holding its grants
                t = self._graph.tasks[tid]
                self.run_stats["resource_acquires"] += 1
                self.recorder.emit_resource(w, EV_RESOURCE_ACQUIRE, t,
                                            len(arbiter.needs(tid)))
                self.core.note_frame_resumed()
                self._push_local(w, t)
            if granted:
                self._notify_work()
        newly_ready: List[Task] = []
        with self._indeg_lock:
            for s in self._graph.successors(task):
                self._indeg[s.tid] -= 1
                if self._indeg[s.tid] == 0:
                    newly_ready.append(s)
        for s in newly_ready:
            self._push_local(w, s)
        if newly_ready:
            self._notify_work()
        with self._remaining_lock:
            self._remaining -= 1
            done = self._remaining <= 0
        if done:
            self.core.signal_done()
            # kick idle workers out of their backoff naps so the core is
            # immediately quiescent for the next run
            self._notify_work()

    # ------------------------------------------------------------------
    # parallel regions (TaskContext.parallel delegates here)
    def parallel(
        self,
        n_threads: int,
        body: Callable[[int, GangRegion], Any],
        *,
        gang: Optional[bool] = None,
        spawn_ctx: Optional[TaskContext] = None,
    ) -> List[Any]:
        """Fork a parallel region of ``n_threads`` ULTs running
        ``body(thread_num, region)``; join and return per-thread results.
        ``region.barrier()`` is the blocking in-region barrier.

        Gang regions (default) are scheduled per Algorithm 1.  Non-gang
        regions push all ULTs to the calling worker's queue — combined with
        blocking barriers this reproduces the Fig. 1 deadlock, which the
        core detects."""
        core = self.core
        w = core.worker_id()
        use_gang = self.gang_default if gang is None else gang
        if use_gang and n_threads > self.n_workers:
            # Blocking synchronization requires every gang member on a
            # distinct kernel thread (no ULT stack switching in Python) —
            # same constraint OpenMP has for its thread teams.
            raise ValueError(
                f"gang region requests {n_threads} ULTs but only "
                f"{self.n_workers} workers exist; blocking barriers would deadlock")
        ctx_stack = self._contexts[w]
        nest_level = (ctx_stack[-1][1] if ctx_stack else 0) + 1

        spawn_task = spawn_ctx.task if spawn_ctx is not None else None
        with self._fork_lock:   # the paper's serialized fork phase
            gang_id = self.gang_state.next_gang_id() if use_gang else -1
            region = GangRegion(
                core, n_threads, gang_id=gang_id, nest_level=nest_level,
                rid=next(self._region_ids), spawn_task=spawn_task, body=body)
            if self._recording and spawn_task is not None:
                # fork lock => globally ordered by gang id (issue order)
                self._rec_forks.append((spawn_task.tid, gang_id, n_threads))
            self.recorder.emit(w, EV_GANG_RESERVE, "", region.rid, n_threads)
            if use_gang:
                self.run_stats["gang_regions"] += 1
                reserved = self.gang_state.get_workers(w, n_threads)
                self.gang_state.account_gang(
                    [reserved[i % len(reserved)] for i in range(n_threads)])
                for i in range(n_threads):
                    target = reserved[i % len(reserved)]
                    with self._gang_locks[target]:
                        self._gang_deqs[target].append(_GangULT(region, i))
            else:
                for i in range(n_threads):
                    with self._gang_locks[w]:
                        self._gang_deqs[w].append(_GangULT(region, i))
        with self._region_lock:
            self._live_regions[region.rid] = region
        self._notify_work()

        # join: the spawning worker helps out at this scheduling point —
        # paper: gang ULTs at a join barrier steal (eligible) work.
        try:
            while not region.finished:
                if core.aborted:
                    raise DeadlockError(core.abort_reason())
                progressed = self.schedule_once(w)
                if not progressed and not region.finished:
                    # join-waiters retry stealing, so they are NOT counted as
                    # hard-blocked (only blocking barriers are) — but they do
                    # poll the detector for barrier deadlocks elsewhere.
                    with region.cv:
                        if not region.finished:
                            if not region.cv.wait(timeout=core.block_poll):
                                core.check_deadlock()
        finally:
            with self._region_lock:
                self._live_regions.pop(region.rid, None)
        return list(region.results)

    # ------------------------------------------------------------------
    # plain-body blocking communication (work-conserving kernel-thread wait)
    def ctx_recv(self, channel: Channel, ctx: TaskContext) -> Any:
        return self._blocking_wait(channel.try_recv, "recv", channel.uid)

    def ctx_wait(self, event: TaskEvent, ctx: TaskContext) -> None:
        self._blocking_wait(
            lambda: ((True, None) if event.is_set() else (False, None)),
            "wait", event.uid)

    def ctx_send(self, channel: Channel, value: Any, ctx: TaskContext) -> None:
        """Plain-body backpressured send: block work-conservingly until the
        bounded channel has a slot (unbounded channels succeed at once)."""
        self._blocking_wait(
            lambda: ((True, None) if channel.try_send(value)
                     else (False, None)),
            "send", channel.uid)

    def ctx_wait_any(self, request: WaitAnyRequest, ctx: TaskContext) -> Any:
        """Plain-body select: poll the sources work-conservingly; returns
        ``(index, value)`` of the first satisfied one."""
        return self._blocking_wait(request.try_immediate, "wait_any")

    def ctx_yield(self, ctx: TaskContext) -> None:
        """Plain-body cooperative scheduling point: serve one unit inline."""
        self.schedule_once(self.core.worker_id())

    def _blocking_wait(self, poll: Callable[[], Tuple[bool, Any]],
                       what: str = "", uid: int = -1) -> Any:
        """Block a plain (non-generator) body until ``poll`` succeeds.  The
        worker is NOT hard-blocked: it keeps serving other work at this
        scheduling point (Python cannot switch ULT stacks, so this is the
        strongest preemption a plain body can get — generators suspend for
        real).  While nothing is schedulable the worker is flagged stalled
        and runs the no-progress detector: a wait no remaining work can
        satisfy raises DeadlockError instead of hanging."""
        core = self.core
        w = core.worker_id()
        ok, value = poll()
        if ok:    # satisfied immediately: no block window, no events
            return value
        emit = self.recorder.emit
        emit(w, EV_BLOCK, what, uid)
        try:
            while True:
                ok, value = poll()
                if ok:
                    return value
                if core.aborted:
                    raise DeadlockError(core.abort_reason())
                if self.schedule_once(w):
                    continue
                self._stalled[w] = True
                try:
                    with self._work_available:
                        self._work_available.wait(
                            timeout=self.steal_backoff * 50)
                    ok, value = poll()
                    if ok:
                        return value
                    self._check_no_progress()
                finally:
                    self._stalled[w] = False
        finally:
            emit(w, EV_UNBLOCK, "", uid)

    def _run_gang_ult(self, w: int, ult: _GangULT) -> None:
        region = ult.region
        if self._recording and region.spawn_task is not None:
            self._rec_entries[w].append((region.spawn_tid, ult.thread_num))
        self._contexts[w].append((region.gang_id, region.nest_level))
        self.recorder.emit(w, EV_GANG_ENTER, "", region.rid, ult.thread_num)
        try:
            result = region.body(ult.thread_num, region)
        except BaseException as e:  # noqa: BLE001
            self.core.fail(e)
            return
        finally:
            self.recorder.emit(w, EV_GANG_EXIT, "", region.rid,
                               ult.thread_num)
            self._contexts[w].pop()
            if region.gang_id >= 0:
                with self._fork_lock:
                    self.gang_state.release_gang_thread(w)
        region.thread_done(ult.thread_num, result)

    # ------------------------------------------------------------------
    # flight-recorder assembly: its consumer (obs/trace.py) is not ported
    def take_trace(self):
        """Assemble the last run's events into a runtime trace."""
        from ..api.session import not_ported
        raise not_ported("trace")

    # ------------------------------------------------------------------
    # recording assembly (record-and-replay, repro_torch.replay)
    def build_recording(self, graph: TaskGraph):
        """Assemble a replay Recording from the instrumentation buffers."""
        from ..replay.graph_key import graph_key
        from ..replay.recording import GangPlacement, Recording

        placements: Dict[int, GangPlacement] = {}
        for spawn_tid, gang_id, n_threads in self._rec_forks:
            if spawn_tid in placements:
                # recordings key regions by spawning task; two forks from one
                # task would be indistinguishable on replay — refuse loudly
                raise ValueError(
                    f"task {spawn_tid} forked more than one parallel region; "
                    "record-and-replay supports one region per task")
            placements[spawn_tid] = GangPlacement(
                spawn_tid, gang_id, [-1] * n_threads)
        for w, entries in enumerate(self._rec_entries):
            for e in entries:
                if isinstance(e, tuple) and e[0] in placements:
                    placements[e[0]].workers[e[1]] = w
        steals = [(w, victim, e)
                  for w, lst in enumerate(self._rec_steals)
                  for victim, e in lst]
        return Recording(
            digest=graph_key(graph).digest,
            graph_name=graph.name,
            n_workers=self.n_workers,
            policy=self.policy_name,
            worker_orders=[list(e) for e in self._rec_entries],
            gang_placements=placements,
            gang_issue_order=[f[0] for f in self._rec_forks],
            steals=steals,
            collective_order=list(self._rec_comms),
            wait_choices=dict(self._rec_wait_choices),
            resource_grants=self.arbiter.grant_log(),
            source="dynamic",
        )
