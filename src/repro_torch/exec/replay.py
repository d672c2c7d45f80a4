"""Replay dispatch: preallocated run lists + recorded gang placements.

The low-contention scheduling brain of the record-and-replay subsystem,
extracted from the old monolithic ``ReplayExecutor`` so it runs on the
shared :class:`~repro_torch.exec.core.ExecutorCore` substrate.  The dynamic
dispatch pays, per task: a queue push + pop under per-worker locks, a
global indegree-lock critical section, victim selection, and — for gang
regions — a fork-lock critical section running worker reservation.
:class:`ReplayDispatch` re-executes a graph of identical structure from a
:class:`~repro_torch.replay.recording.Recording` with none of those decisions:

* each worker walks its **preallocated run list** (the recorded start order),
* readiness is tracked by **per-task dependency counters** built on
  CPython-atomic ``list.append``/``len`` (no locks at all on the task hot
  path; task claims are atomic ``dict.setdefault`` races, first wins),
* results live in a preallocated list (index = tid; GIL-atomic writes),
* gang regions are forked straight onto their **recorded placement** in the
  recorded gang-id order — no ``GET_WORKERS`` scan, and the fork lock is
  held only to bump the issue cursor.

Deviation handling (cost drift / stale recordings): a worker whose next
recorded entry is not ready within ``stall_timeout`` falls back to *dynamic
stealing* — it scans for any ready-but-unclaimed task (or a published gang
ULT) and executes that instead, then re-checks its list.  Claims are
per-task, so a stolen task's recorded owner simply skips it.  Fallback never
steals a region-forking task whose recorded spawner is someone else: forks
must come from a worker free to join, preserving the gang invariants
(distinct workers per blocking region, monotonic issue order).

Deadlock freedom: run lists are recorded start orders, so dependency and
list-predecessor edges embed in one global time order (acyclic); the
earliest unfinished entry is always runnable by its owner, and the fallback
only adds work, never removes readiness.

Suspendable frames replay deterministically: a recorded run (instrumentation
forces a suspension at every ``yield``) stores each resume segment as a
:class:`~repro_torch.core.taskgraph.FrameResume` run-list entry.  On replay,
generator bodies *always* suspend at their yield points (even when the
channel already has data — the recorded segmentation is reproduced, not
re-decided); a frame becomes *resumable* when its channel send / event set
arrives, and the recorded owner executes segment ``seg`` at its recorded
list position, gated by a per-``(tid, seg)`` claim so fallback helpers
never run a segment twice.  Suspended frames are soft-blocked: their
workers keep walking their lists.

A :class:`ReplayDispatch` is *warm state*: the run lists, placements and
owner map are computed once per recording, and the serving pool keeps one
dispatch per shape while leasing worker time from a shared per-worker-count
core.
"""

from __future__ import annotations

import threading
import time
from types import GeneratorType
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Tuple

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
    EV_REPLAY_FALLBACK,
    EV_REPLAY_SKIP,
    EV_REPLAY_STALL,
    EV_RESOURCE_ACQUIRE,
    EV_RESOURCE_RELEASE,
    EV_RESOURCE_WAIT,
    EV_RUN_AHEAD,
    EV_TASK_END,
    EV_UNBLOCK,
    EV_WAKE,
)
from ..obs.recorder import NULL_RECORDER, FlightRecorder
from ..resources.arbiter import ResourceArbiter
from .core import DispatchStrategy, ExecutorCore, GangRegion

if TYPE_CHECKING:  # avoid a circular import at load time (exec <-> replay)
    from ..replay.recording import GangPlacement, Recording


class ReplayError(RuntimeError):
    """The recording cannot drive this graph (e.g. an unplaced gang region)."""


class ReplayDispatch(DispatchStrategy):
    """Run-list dispatch driven by a :class:`Recording`."""

    _RUN_AHEAD_WINDOW = 32

    def __init__(self, recording: "Recording", *, stall_timeout: float = 1e-3,
                 trace: bool = False):
        self.core: Optional[ExecutorCore] = None
        self.recording = recording
        self.n_workers = recording.n_workers
        self.stall_timeout = stall_timeout
        self.trace_enabled = trace
        self.recorder = (FlightRecorder(recording.n_workers) if trace
                         else NULL_RECORDER)

        n = self.n_workers
        self._orders = [list(o) for o in recording.worker_orders]
        self._placements: Dict[int, "GangPlacement"] = dict(recording.gang_placements)
        self._issue_order: List[int] = list(recording.gang_issue_order)
        self._issue_set = set(self._issue_order)
        # spawn_tid -> recorded owner worker of every entry, for wakeups
        self._owner: Dict[int, int] = recording.owner_of()
        # (tid, seg) -> recorded owner of each frame-resume entry
        self._resume_owner: Dict[Tuple[int, int], int] = {
            (e.tid, e.seg): w
            for w, order in enumerate(self._orders)
            for e in order if isinstance(e, FrameResume)}
        # (tid, seg) -> recorded wait_any winner index (selects replay as
        # the recorded deterministic choice)
        self._wait_choices: Dict[Tuple[int, int], int] = dict(
            getattr(recording, "wait_choices", {}) or {})

        self._worker_cvs = [threading.Condition() for _ in range(n)]
        self._waiting = [False] * n          # worker w is parked on its cv
        self._fork_lock = threading.Lock()
        self._fork_cv = threading.Condition(self._fork_lock)

        # per-run preallocated state (reset in begin_run)
        self._graph: Optional[TaskGraph] = None
        self._n_tasks = 0
        self._indeg: List[int] = []
        self._ready: List[bool] = []
        self._claims: Dict[int, int] = {}
        self._done: List[bool] = []
        self._dep_seen: List[list] = []
        self._completed: list = []
        self._results: List[Any] = []
        self._regions: Dict[int, GangRegion] = {}
        self._issue_cursor = 0
        # suspendable frames of the current run: tid -> live frame, plus the
        # parked subset (waiting on a channel/event) for abort draining
        self._frames: Dict[int, TaskFrame] = {}
        self._parked: Dict[int, TaskFrame] = {}
        self._park_lock = threading.Lock()
        # serializes the resumable test-and-clear so the recorded owner and
        # a fallback helper can never both take one wakeup
        self._frame_gate = threading.Lock()
        # no-progress detection (mirrors DynamicDispatch): per-worker unit
        # depth + "top of stack blocked in plain-body recv/wait" flags
        self._depth = [0] * n
        self._stalled = [False] * n

        # resource arbiter in *pinned* mode: the recorded grant order is
        # replayed bit-identically (a declaring task runs only when it is
        # head of every relevant recorded per-resource grant queue)
        self.arbiter = ResourceArbiter()

        self.stats: Dict[str, int] = {}
        self.issued_gang_ids: List[int] = []

    # ------------------------------------------------------------------
    # DispatchStrategy interface
    def begin_run(self, graph: TaskGraph) -> None:
        n = len(graph)
        self._graph = graph
        self._n_tasks = n
        # Lock-free bookkeeping, built on CPython-atomic container ops:
        # * claim      = dict.setdefault(tid, w) — first setter wins;
        # * dep count  = list.append + len vs indegree (append is atomic;
        #                over-observing "ready" is idempotent);
        # * completion = append to a global list, drained when len == n.
        self._indeg = graph.indegrees()
        self._ready = [c == 0 for c in self._indeg]
        self._claims = {}
        self._done = [False] * n
        self._dep_seen = [[] for _ in range(n)]
        self._completed = []
        self._results = [None] * n
        self._regions = {}
        self._issue_cursor = 0
        self.drain_frames()                  # cancel a prior aborted run's
        for frame in self._frames.values():  # parked frames; close woken-
            frame.close()                    # but-never-resumed ones (no-op
        self._frames = {}                    # for completed generators)
        self._waiting = [False] * self.n_workers
        self._depth = [0] * self.n_workers
        self._stalled = [False] * self.n_workers
        self.stats = {"fallback_steals": 0, "stalls": 0, "skips": 0,
                      "run_ahead": 0, "frame_suspends": 0,
                      "resource_acquires": 0, "resource_waits": 0,
                      "resource_releases": 0}
        self.issued_gang_ids = []
        # pre-validation recordings may lack a grant order; fall back to
        # dynamic arbitration then (still mutually exclusive, not pinned)
        grants = list(getattr(self.recording, "resource_grants", ()) or ())
        self.arbiter.begin(graph, pinned_order=grants or None)
        self.recorder.begin_run()

    @property
    def drained(self) -> bool:
        return len(self._completed) >= self._n_tasks

    def results(self) -> Dict[int, Any]:
        return {t.tid: self._results[t.tid] for t in self._graph.tasks}

    def pending_units(self) -> int:
        return self._n_tasks - len(self._completed)

    def wake_all(self) -> None:
        for cv in self._worker_cvs:
            with cv:
                cv.notify_all()
        with self._fork_cv:
            self._fork_cv.notify_all()
        # non-blocking: the caller may hold a region cv (a barrier waiter
        # runs the deadlock detector inside `with region.cv`)
        for region in list(self._regions.values()):
            region.notify_nowait()

    # ------------------------------------------------------------------
    # worker loop
    def worker_loop(self, w: int) -> None:
        core = self.core
        order = self._orders[w]
        cv = self._worker_cvs[w]
        emit = self.recorder.emit
        idx = 0
        stalled = False
        idle = False   # park/wake events on transitions only (no flood)
        while idx < len(order):
            if core.aborted:
                return
            entry = order[idx]
            if isinstance(entry, int):
                advanced = self._try_task(w, entry)
            elif isinstance(entry, FrameResume):
                advanced = self._try_resume(w, entry)
            else:
                advanced = self._try_gang(w, entry)
            if advanced:
                idx += 1
                stalled = False
                if idle:
                    idle = False
                    emit(w, EV_WAKE)
                continue
            # next recorded entry not ready: stay work-conserving without
            # parking — run a later ready entry of our *own* list (claims
            # and counters gate correctness; the list order is a schedule
            # hint, not a constraint)
            if self._run_ahead(w, order, idx + 1):
                if idle:
                    idle = False
                    emit(w, EV_WAKE)
                continue
            # nothing of ours is ready: wait one stall window, then start
            # stealing dynamically (cost drift / stale recording)
            if stalled:
                self.stats["stalls"] += 1
                emit(w, EV_REPLAY_STALL, "", idx)
                if self._fallback_once(w):
                    if idle:
                        idle = False
                        emit(w, EV_WAKE)
                    continue
            if not idle:
                idle = True
                emit(w, EV_PARK)
            # Dekker-style handoff with completers: set the waiting flag,
            # THEN re-check readiness.  A completer sets ready, THEN reads
            # the flag — under the GIL one of the two always observes the
            # other, so no wakeup is ever missed.
            self._waiting[w] = True
            try:
                with cv:
                    if not self._entry_ready(entry):
                        cv.wait(timeout=self.stall_timeout)
            finally:
                self._waiting[w] = False
            stalled = True
        # list exhausted: keep serving stalled regions/tasks until the run
        # drains (a stale recording may leave work only this worker can
        # help).  Wait a stall window *before* each scan so recorded owners
        # keep priority over idle helpers on the hot path.
        while not self.drained and not core.aborted:
            with cv:
                if self.drained:
                    break
                if not idle:
                    idle = True
                    emit(w, EV_PARK)
                self._waiting[w] = True
                cv.wait(timeout=self.stall_timeout)
                self._waiting[w] = False
            if not self.drained and not core.aborted:
                if self._fallback_once(w) and idle:
                    idle = False
                    emit(w, EV_WAKE)

    def _run_ahead(self, w: int, order, start: int) -> bool:
        """Execute one ready-but-unclaimed later entry of our own run list
        (bounded scan).  Region-forking tasks are skipped: forks must issue
        in recorded order, and issuing one early from here could wait on a
        fork that sits behind us in this very list."""
        end = min(len(order), start + self._RUN_AHEAD_WINDOW)
        for j in range(start, end):
            e = order[j]
            if not isinstance(e, int):
                continue
            if (self._ready[e] and e not in self._claims
                    and e not in self._placements
                    and self.arbiter.runnable_now(e)):
                if self._claims.setdefault(e, w) != w:
                    continue
                self.recorder.emit(w, EV_RUN_AHEAD, "", e)
                self._execute(w, self._graph.tasks[e])
                self.stats["run_ahead"] += 1
                return True
        return False

    def _entry_ready(self, entry) -> bool:
        """Cheap re-check under the worker cv (pairs with notify ordering:
        state is written before the cv is taken, so no wakeup is missed)."""
        if isinstance(entry, int):
            return ((self._ready[entry] and self.arbiter.runnable_now(entry))
                    or entry in self._claims)
        if isinstance(entry, FrameResume):
            if self._done[entry.tid] or (entry.tid, entry.seg) in self._claims:
                return True
            frame = self._frames.get(entry.tid)
            return (frame is not None and frame.resumable
                    and frame.resumes == entry.seg - 1)
        return entry[0] in self._regions or self._done[entry[0]]

    def _try_task(self, w: int, tid: int) -> bool:
        """Attempt the next recorded task.  True => advance the list."""
        if tid in self._claims:
            # executed (or in flight) elsewhere — a fallback thief claimed
            # it; safe to move on, whoever claimed it completes it
            if not self._done[tid]:
                self.stats["skips"] += 1
                self.recorder.emit(w, EV_REPLAY_SKIP, "", tid)
            return True
        if not self._ready[tid]:
            return False
        if not self.arbiter.runnable_now(tid):
            return False     # not this task's recorded grant turn yet
        if self._claims.setdefault(tid, w) != w:
            return True
        self._execute(w, self._graph.tasks[tid])
        return True

    def _try_resume(self, w: int, entry: FrameResume) -> bool:
        """Attempt the next recorded frame-resume segment.  True => advance
        the list (executed here, already executed elsewhere, or stale)."""
        tid, seg = entry.tid, entry.seg
        key = (tid, seg)
        if key in self._claims:
            if not self._done[tid]:
                self.stats["skips"] += 1     # a fallback helper took our slot
                self.recorder.emit(w, EV_REPLAY_SKIP, "", tid, seg)
            return True
        if self._done[tid]:
            return True                      # frame already ran to completion
        frame = self._frames.get(tid)
        if frame is None:
            return False                     # task not started yet
        if frame.resumes >= seg:
            return True                      # a fallback helper raced past us
        if not self._take_resumable(frame, seg):
            return False                     # wakeup not arrived yet
        self._claims.setdefault(key, w)
        self._resume_segment(w, frame)
        return True

    def _try_gang(self, w: int, entry: Tuple[int, int]) -> bool:
        spawn_tid, thread_num = entry
        region = self._regions.get(spawn_tid)
        if region is None:
            if self._done[spawn_tid]:
                # region already fully joined (e.g. spawner ran ULTs inline
                # after a fallback thief raced us) — nothing left to do
                return True
            return False
        if not region.claim(thread_num):
            return True
        self._run_ult(w, region, thread_num)
        return True

    def _fallback_once(self, w: int) -> bool:
        """Dynamic fallback: serve one gang ULT of a published region (they
        gate everyone behind a blocking barrier) or one ready-but-unclaimed
        task.  Never steals a region-forking task recorded for another
        worker.  Returns True if work was executed."""
        for region in list(self._regions.values()):
            if region.finished:
                continue
            i = region.claim_any()
            if i is not None:
                self.recorder.emit(w, EV_REPLAY_FALLBACK, "gang",
                                   region.spawn_tid, i)
                self._run_ult(w, region, i)
                self.stats["fallback_steals"] += 1
                return True
        # resumable frames gate their successors like barriers do — serve
        # them even off their recorded slot (per-segment claims keep each
        # segment single-shot; the recorded owner just skips it)
        for tid, frame in list(self._frames.items()):
            if self._done[tid] or not frame.resumable:
                continue
            seg = frame.resumes + 1
            if not self._take_resumable(frame, seg):
                continue
            self._claims.setdefault((tid, seg), w)
            self.recorder.emit(w, EV_REPLAY_FALLBACK, "frame", tid, seg)
            self._resume_segment(w, frame)
            self.stats["fallback_steals"] += 1
            return True
        for tid in range(self._n_tasks):
            if self._ready[tid] and tid not in self._claims:
                if not self.arbiter.runnable_now(tid):
                    continue     # held elsewhere or not its grant turn
                if tid in self._placements:
                    if self._owner.get(tid, w) != w:
                        continue
                    # even our own forking task may only go when it is next
                    # in recorded issue order — claiming it early would park
                    # us on the fork cursor behind a fork only we can run
                    cursor = self._issue_cursor
                    if (tid in self._issue_set
                            and (cursor >= len(self._issue_order)
                                 or self._issue_order[cursor] != tid)):
                        continue
                if self._claims.setdefault(tid, w) != w:
                    continue
                self.recorder.emit(w, EV_REPLAY_FALLBACK, "task", tid)
                self._execute(w, self._graph.tasks[tid])
                self.stats["fallback_steals"] += 1
                return True
        return False

    # ------------------------------------------------------------------
    # execution
    def _execute(self, w: int, task: Task) -> None:
        arbiter = self.arbiter
        if arbiter.active and arbiter.needs(task.tid):
            # Gated callers claim only after `runnable_now`, and a pinned
            # head's availability can only improve (competitors sit behind
            # it in the grant queues), so the first acquire succeeds; the
            # loop covers the unpinned degraded mode, where contention
            # defers us onto the FIFO until a release grants us in turn.
            if not arbiter.try_acquire(task.tid):
                self.stats["resource_waits"] += 1
                self.recorder.emit_resource(w, EV_RESOURCE_WAIT, task)
                while not arbiter.try_acquire(task.tid):
                    if self.core.aborted:
                        return
                    time.sleep(0)
            self.stats["resource_acquires"] += 1
            self.recorder.emit_resource(w, EV_RESOURCE_ACQUIRE, task,
                                        len(arbiter.needs(task.tid)))
        self.recorder.emit_task_start(w, task)
        ctx = TaskContext(self._graph, task, self._results, runtime=self)
        ctx.worker_id = w  # type: ignore[attr-defined]
        self._depth[w] += 1
        try:
            result = task.fn(ctx) if task.fn is not None else None
            if isinstance(result, GeneratorType):
                # generator body => suspendable frame.  Replay always
                # suspends at yield points (even with data available) so the
                # recorded segmentation — and the interleaving — is
                # reproduced.
                ctx._in_frame = True
                frame = TaskFrame(task, ctx, result)
                frame.last_worker = w
                self._frames[task.tid] = frame
                self._advance_frame(w, frame)
                return
        finally:
            self._depth[w] -= 1
        self.recorder.emit(w, EV_TASK_END, "", task.tid)
        self._results[task.tid] = result
        self._complete(w, task)

    # ------------------------------------------------------------------
    # suspendable frames
    def _take_resumable(self, frame: TaskFrame, seg: int) -> bool:
        """Atomically consume the frame's wakeup for segment ``seg`` (the
        recorded owner and fallback helpers race here; exactly one wins)."""
        with self._frame_gate:
            if not frame.resumable or frame.resumes != seg - 1:
                return False
            frame.resumable = False
            return True

    def _resume_segment(self, w: int, frame: TaskFrame) -> None:
        frame.resumes += 1
        self.recorder.emit_frame_resume(w, frame)
        frame.ctx.worker_id = w  # type: ignore[attr-defined]
        frame.last_worker = w
        self._depth[w] += 1
        try:
            self._advance_frame(w, frame)
        finally:
            self._depth[w] -= 1

    def _advance_frame(self, w: int, frame: TaskFrame) -> None:
        value = frame.resume_value
        frame.resume_value = None
        status, payload = frame.step(value)
        if status == "done":
            self.recorder.emit(w, EV_TASK_END, "", frame.task.tid)
            self._results[frame.task.tid] = payload
            self._complete(w, frame.task)
            return
        self._park_frame(w, frame, payload)

    def _park_frame(self, w: int, frame: TaskFrame, request) -> None:
        core = self.core
        tid = frame.task.tid
        if isinstance(request, WaitAnyRequest):
            # pin the recorded winner: the select resolves to the same
            # (index, value) choice as the recorded run
            choice = self._wait_choices.get((tid, frame.resumes + 1))
            if choice is not None and 0 <= choice < len(request.requests):
                request = request.pinned(choice)

        def waker(value=None, *, _frame=frame):
            self._wake_frame(_frame, value)

        frame.request = request
        frame.waker = waker
        with self._park_lock:
            self._parked[tid] = frame
        note_parked(frame)
        core.note_frame_suspended()
        self.stats["frame_suspends"] += 1
        self.recorder.emit_frame_suspend(w, frame, request)
        status, value = request.park(waker)
        if status == "ready":
            waker(value)
        elif core.aborted:
            self._discard_parked(frame)

    def _wake_frame(self, frame: TaskFrame, value: Any) -> None:
        """Waker target: mark the frame resumable and nudge the recorded
        owner of its next resume segment."""
        tid = frame.task.tid
        with self._park_lock:
            if self._parked.pop(tid, None) is None:
                return
        note_unparked(frame)
        frame.resume_value = value
        frame.request = None
        frame.waker = None
        with self._frame_gate:
            frame.resumable = True
        self.core.note_frame_resumed()
        # the waker may be any thread (a worker mid-send or an external
        # caller) — worker -1 routes to the recorder's external ring
        self.recorder.emit(self.core.worker_id(default=-1), EV_FRAME_WAKE,
                           "", tid, frame.resumes + 1)
        owner = self._resume_owner.get((tid, frame.resumes + 1))
        if owner == self.core.worker_id(default=-1):
            return     # waking ourselves (send landed while we parked): we
                       # are awake and will hit the resume entry on our walk
        targets = range(self.n_workers) if owner is None else (owner,)
        for t in targets:
            cv = self._worker_cvs[t]
            with cv:
                cv.notify_all()

    def _discard_parked(self, frame: TaskFrame) -> None:
        with self._park_lock:
            if self._parked.pop(frame.task.tid, None) is None:
                return
        note_unparked(frame)
        if frame.request is not None:
            frame.request.cancel(frame.waker)
        self.core.note_frame_resumed()
        frame.close()

    def drain_frames(self) -> None:
        with self._park_lock:
            frames = list(self._parked.values())
        for frame in frames:
            self._discard_parked(frame)
        # an aborted run must not leak grants into the next begin_run
        self.arbiter.abort()

    # ------------------------------------------------------------------
    # plain-body blocking communication (mirrors DynamicDispatch semantics:
    # the worker helps through the fallback path instead of idling)
    def ctx_recv(self, channel: Channel, ctx: TaskContext) -> Any:
        return self._blocking_wait(channel.try_recv, "recv", channel.uid)

    def ctx_wait(self, event: TaskEvent, ctx: TaskContext) -> None:
        self._blocking_wait(
            lambda: ((True, None) if event.is_set() else (False, None)),
            "wait", event.uid)

    def ctx_send(self, channel: Channel, value: Any, ctx: TaskContext) -> None:
        self._blocking_wait(
            lambda: ((True, None) if channel.try_send(value)
                     else (False, None)),
            "send", channel.uid)

    def ctx_wait_any(self, request: WaitAnyRequest, ctx: TaskContext) -> Any:
        return self._blocking_wait(request.try_immediate, "wait_any")

    def ctx_yield(self, ctx: TaskContext) -> None:
        self._fallback_once(self.core.worker_id())

    def _blocking_wait(self, poll, what: str = "", uid: int = -1) -> Any:
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
                if self._fallback_once(w):
                    continue
                self._stalled[w] = True
                try:
                    time.sleep(self.stall_timeout)
                    ok, value = poll()
                    if ok:
                        return value
                    self._check_no_progress()
                finally:
                    self._stalled[w] = False
        finally:
            emit(w, EV_UNBLOCK, "", uid)

    def _active_workers(self) -> int:
        return sum(1 for w in range(self.n_workers)
                   if self._depth[w] > 0 and not self._stalled[w])

    def _check_no_progress(self) -> None:
        """A plain-body recv/wait no remaining replay work can satisfy:
        nothing executing freely, no completion and no wakeup across a
        confirmation window (completed-count is the progress proxy — any
        runnable run-list entry gets executed by its owner or a fallback
        helper well within ``block_poll``)."""
        core = self.core
        if self.drained or core.aborted or self._active_workers() > 0:
            return
        self.recorder.emit(core.worker_id(default=-1), EV_DEADLOCK_POLL)
        before = (len(self._completed), core.resume_epoch, activity_epoch())
        time.sleep(core.block_poll)
        if (not self.drained and not core.aborted
                and self._active_workers() == 0
                and sum(self._stalled) > 0
                and (len(self._completed), core.resume_epoch,
                     activity_epoch()) == before):
            core.frame_deadlock(
                f"deadlock: {sum(self._stalled)} worker(s) blocked in "
                "task-body recv/wait during replay with no progress left "
                "in the run")

    # ------------------------------------------------------------------
    # flight-recorder assembly: its consumer (obs/trace.py) is not ported
    def take_trace(self):
        """Assemble the last run's events into a runtime trace."""
        from ..api.session import not_ported
        raise not_ported("trace")

    def _complete(self, w: int, task: Task) -> None:
        arbiter = self.arbiter
        if arbiter.active and arbiter.holds(task.tid):
            n_res = len(arbiter.needs(task.tid))
            arbiter.release(task.tid)
            self.stats["resource_releases"] += 1
            self.recorder.emit_resource(w, EV_RESOURCE_RELEASE, task, n_res)
            # nudge the recorded owner of each resource's next grantee
            # (release-then-read pairs with the waiter's set-flag-then-check)
            for nxt in arbiter.pinned_heads():
                owner = self._owner.get(nxt, -1)
                if 0 <= owner != w and self._waiting[owner]:
                    cv = self._worker_cvs[owner]
                    with cv:
                        cv.notify()
        self._done[task.tid] = True
        dep_seen = self._dep_seen
        indeg = self._indeg
        for s in self._graph.successors(task):
            stid = s.tid
            lst = dep_seen[stid]
            lst.append(None)                 # atomic; last appender sees full
            if len(lst) < indeg[stid]:
                continue
            self._ready[stid] = True
            owner = self._owner.get(stid, -1)
            # wake the recorded owner only if it is parked: completers set
            # ready THEN read the flag, waiters set the flag THEN re-check
            # readiness — one side always observes the other (GIL order)
            if 0 <= owner != w and self._waiting[owner]:
                cv = self._worker_cvs[owner]
                with cv:
                    cv.notify()
        self._completed.append(task.tid)     # atomic completion count
        if self.drained:
            self.core.signal_done()
            # kick parked helpers out of their stall windows so the core is
            # immediately idle for the next run() of the sweep
            for cv in self._worker_cvs:
                with cv:
                    cv.notify_all()

    def _run_ult(self, w: int, region: GangRegion, thread_num: int) -> None:
        # replay regions carry no rid; key gang spans by spawning task
        rid = region.rid if region.rid >= 0 else region.spawn_tid
        self.recorder.emit(w, EV_GANG_ENTER, "", rid, thread_num)
        self._depth[w] += 1
        try:
            result = region.body(thread_num, region)
        finally:
            self._depth[w] -= 1
            self.recorder.emit(w, EV_GANG_EXIT, "", rid, thread_num)
        region.thread_done(thread_num, result)

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
        """Fork/join a region on its recorded placement.  The recorded fork
        (gang-id) order is enforced: a fork waits until every earlier
        recorded fork has been issued."""
        del gang  # the recording already fixed the gang decision
        core = self.core
        spawn_recorded = (spawn_ctx is not None
                          and spawn_ctx.task.tid in self._placements)
        if n_threads == 1 and not spawn_recorded:
            # unrecorded single-ULT region: no barrier partner needed, run
            # inline (recorded ones go through the normal path so the fork
            # still issues in recorded gang-id order)
            region = GangRegion(core, 1, body=body)
            region.started[0] = True
            self._run_ult(core.worker_id(), region, 0)
            return list(region.results)
        if spawn_ctx is None:
            raise ReplayError("replayed regions need a spawning task context")
        if n_threads > self.n_workers:
            raise ReplayError(
                f"region requests {n_threads} ULTs but the replay pool has "
                f"{self.n_workers} workers; blocking barriers would deadlock")
        spawn_tid = spawn_ctx.task.tid
        w = core.worker_id()

        placement = self._placements.get(spawn_tid)
        region = GangRegion(
            core, n_threads,
            gang_id=placement.gang_id if placement else -1,
            spawn_tid=spawn_tid, body=body)
        if placement is not None and len(placement.workers) != n_threads:
            raise ReplayError(
                f"task {spawn_tid} forked {n_threads} ULTs but the recording "
                f"placed {len(placement.workers)}")

        # monotonic issue-order discipline: publish in recorded fork order
        in_issue_order = spawn_tid in self._issue_set
        with self._fork_cv:
            while (in_issue_order
                   and self._issue_cursor < len(self._issue_order)
                   and self._issue_order[self._issue_cursor] != spawn_tid):
                if core.aborted:
                    raise DeadlockError(core.abort_reason())
                self._fork_cv.wait(timeout=core.block_poll)
            if in_issue_order and self._issue_cursor < len(self._issue_order):
                self._issue_cursor += 1
            if spawn_tid in self._regions:
                raise ReplayError(
                    f"task {spawn_tid} forked a second parallel region; "
                    "recordings key regions by spawning task (one per task)")
            self.issued_gang_ids.append(region.gang_id)
            self._regions[spawn_tid] = region
            self.recorder.emit(w, EV_GANG_RESERVE, "", spawn_tid, n_threads)
            self._fork_cv.notify_all()

        # wake recorded members; unplaced regions (static seed) are served by
        # whichever workers stall, so wake everyone
        members = set(placement.workers) if placement is not None \
            else set(range(self.n_workers))
        for member in members:
            if member != w:
                cv = self._worker_cvs[member]
                with cv:
                    cv.notify_all()

        # join: run own recorded ULTs inline (our run-list entries for this
        # region sit *after* the spawning task — we are blocked here), then
        # help via fallback until the region completes
        if placement is not None:
            for i, member in enumerate(placement.workers):
                if member == w and region.claim(i):
                    self._run_ult(w, region, i)
        while not region.finished:
            if core.aborted:
                raise DeadlockError(core.abort_reason())
            i = region.claim_any() if placement is None else None
            if i is not None:
                self._run_ult(w, region, i)
                continue
            with region.cv:
                if not region.finished:
                    region.cv.wait(timeout=core.block_poll)
        return list(region.results)
