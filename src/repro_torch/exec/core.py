"""The shared executor core: one worker substrate for every scheduler.

Before this module existed the repo had grown *two* thread pools: the
dynamic :class:`~repro_torch.core.runtime.Runtime` and the replay
:class:`~repro_torch.replay.executor.ReplayExecutor` each owned worker threads,
a parallel-region implementation (``_Region`` vs ``_ReplayRegion``),
blocked-thread accounting and abort plumbing.  Following the
shared-substrate designs of low-contention tasking runtimes (Taskgraph,
nOS-V), this package extracts the common machinery once:

* :class:`ExecutorCore` — persistent worker threads with a generation-based
  park/wake protocol: between runs every worker parks on one condition
  variable; :meth:`ExecutorCore.run` installs a :class:`DispatchStrategy`,
  bumps the generation, and the workers execute ``dispatch.worker_loop(w)``
  until the run drains.  A core outlives any number of runs *and any number
  of dispatch strategies* — the same warm threads serve dynamic scheduling,
  replay, and the serving pool's leases.
* :class:`GangRegion` — the unified parallel region (the merge of the old
  ``_Region``/``_ReplayRegion``): a blocking in-region barrier wired into
  the core's blocked-thread accounting and deadlock detector, per-thread
  claim slots (used by replay and by dynamic fallback helpers), and
  completion bookkeeping.
* :class:`DispatchStrategy` — the pluggable scheduling brain.  Two
  implementations exist: :class:`~repro_torch.exec.dynamic.DynamicDispatch`
  (per-worker deques, Algorithm-2 victim selection, Algorithm-1 gang
  reservation) and :class:`~repro_torch.exec.replay.ReplayDispatch`
  (preallocated run lists, recorded gang placements, run-ahead and
  stall-triggered dynamic fallback).

Deadlock detection is centralized and oversubscription-safe: only workers
inside *blocking* barriers count as hard-blocked (join-waiters keep
scheduling and are excluded); when every worker of the core is hard-blocked
while dispatch-owned work is starved, :meth:`ExecutorCore.check_deadlock`
raises :class:`~repro_torch.core.simulator.DeadlockError` instead of hanging —
the paper's Fig. 1 state, detected identically under both strategies.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..core.simulator import DeadlockError
from ..core.taskgraph import TaskGraph
from ..core.tracing import EV_BARRIER_DONE, EV_BARRIER_WAIT, EV_DEADLOCK_POLL
from ..obs.recorder import NULL_RECORDER


class GangRegion:
    """A running parallel region (one gang), shared by every dispatch.

    Combines the dynamic runtime's region (blocking barrier + per-thread
    results) with the replay executor's (claim slots so recorded owners and
    fallback helpers can race for ULTs without running one twice).
    """

    __slots__ = ("rid", "gang_id", "nest_level", "n_threads", "core",
                 "spawn_task", "spawn_tid", "body", "lock", "cv",
                 "barrier_round", "arrived", "done", "started", "results")

    def __init__(
        self,
        core: "ExecutorCore",
        n_threads: int,
        *,
        gang_id: int = -1,
        nest_level: int = 0,
        rid: int = -1,
        spawn_task: Any = None,
        spawn_tid: int = -1,
        body: Optional[Callable[[int, "GangRegion"], Any]] = None,
    ):
        self.core = core
        self.n_threads = n_threads
        self.gang_id = gang_id
        self.nest_level = nest_level
        self.rid = rid
        self.spawn_task = spawn_task
        self.spawn_tid = spawn_task.tid if spawn_task is not None else spawn_tid
        self.body = body
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.barrier_round = 0
        self.arrived = 0
        self.done = 0
        self.started = [False] * n_threads
        self.results: List[Any] = [None] * n_threads

    # -- the in-region blocking barrier (paper: blocking sync inside tasks) -
    def barrier(self) -> None:
        """Blocking barrier across the region's ULTs.  The waiting kernel
        thread is accounted as hard-blocked and polls the core's deadlock
        detector — the Fig. 1 state raises instead of hanging."""
        core = self.core
        with self.cv:
            my_round = self.barrier_round
            self.arrived += 1
            if self.arrived == self.n_threads:
                self.arrived = 0
                self.barrier_round += 1
                self.cv.notify_all()
                return
            core.enter_blocked()
            w = core.worker_id(default=-1)
            core.recorder.emit(w, EV_BARRIER_WAIT, "", self.rid)
            try:
                while self.barrier_round == my_round:
                    if core.aborted:
                        raise DeadlockError(core.abort_reason())
                    if not self.cv.wait(timeout=core.block_poll):
                        core.check_deadlock()
            finally:
                core.recorder.emit(w, EV_BARRIER_DONE, "", self.rid)
                core.exit_blocked()

    # -- claim slots (replay owners / dynamic+replay fallback helpers) ------
    def claim(self, thread_num: int) -> bool:
        with self.lock:
            if self.started[thread_num]:
                return False
            self.started[thread_num] = True
            return True

    def claim_any(self) -> Optional[int]:
        with self.lock:
            for i, s in enumerate(self.started):
                if not s:
                    self.started[i] = True
                    return i
            return None

    def thread_done(self, thread_num: int, result: Any) -> bool:
        with self.cv:
            self.results[thread_num] = result
            self.done += 1
            finished = self.done == self.n_threads
            if finished:
                self.cv.notify_all()
            return finished

    @property
    def finished(self) -> bool:
        return self.done == self.n_threads

    def notify_nowait(self) -> None:
        """Best-effort wakeup of the region's waiters.  Non-blocking on the
        region lock: abort paths (``wake_all``) may run on a thread that
        already holds this very cv (a barrier waiter polls the deadlock
        detector while inside ``with self.cv``) — a lock holder is awake by
        definition, and every waiter re-polls on ``block_poll`` timeouts, so
        skipping a held lock costs latency, never correctness."""
        if self.cv.acquire(blocking=False):
            try:
                self.cv.notify_all()
            finally:
                self.cv.release()


class _RunState:
    """Abort state scoped to ONE run.  A fresh object is installed per run,
    so a caller that drained its run can never observe the *next* run's
    failure (or lose its own timeout to the next run's reset) on a shared
    core — it holds a reference to its own run's state.

    ``suspended`` counts frames currently parked on a channel/event (soft-
    blocked: their workers are free, so they are *excluded* from the Fig.-1
    hard-block count); ``resume_epoch`` increments on every frame wakeup so
    the suspension-deadlock detector can confirm quiescence across its
    confirmation window."""

    __slots__ = ("failure", "deadlock", "suspended", "resume_epoch")

    def __init__(self) -> None:
        self.failure: Optional[BaseException] = None
        self.deadlock: Optional[str] = None
        self.suspended = 0
        self.resume_epoch = 0


class DispatchStrategy:
    """The pluggable scheduling brain an :class:`ExecutorCore` drives.

    A strategy owns all per-run scheduling state (queues or run lists,
    readiness bookkeeping, results) and the region fork/join logic; the
    core owns the threads, the run lifecycle, abort plumbing and deadlock
    accounting.  One strategy instance is bound to at most one core at a
    time, but may be re-run any number of times (the serving pool keeps a
    warm :class:`~repro_torch.exec.replay.ReplayDispatch` per shape and leases
    core time for each request).
    """

    core: "ExecutorCore" = None  # type: ignore[assignment]

    def bind(self, core: "ExecutorCore") -> None:
        if self.core is not None and self.core is not core:
            raise RuntimeError(
                "dispatch strategy is already bound to a different core")
        self.core = core

    # -- run lifecycle -----------------------------------------------------
    def begin_run(self, graph: TaskGraph) -> None:
        """Reset per-run state.  Called with the core quiescent (every
        worker parked) before the generation is bumped."""
        raise NotImplementedError

    def worker_loop(self, w: int) -> None:
        """Worker ``w``'s body for one run: schedule work until
        :attr:`drained` or ``core.aborted``.  Exceptions escaping here are
        recorded as the run's failure."""
        raise NotImplementedError

    @property
    def drained(self) -> bool:
        """True once every unit of the current run has completed."""
        raise NotImplementedError

    def results(self) -> Dict[int, Any]:
        """{tid: result} of the drained run."""
        raise NotImplementedError

    # -- parallel regions (TaskContext.parallel delegates here) -------------
    def parallel(self, n_threads: int, body, *, gang=None, spawn_ctx=None):
        raise NotImplementedError

    # -- diagnostics / abort ------------------------------------------------
    def pending_units(self) -> int:
        """Starved schedulable units, for deadlock messages."""
        return 0

    def wake_all(self) -> None:
        """Wake every waiter this strategy parked (called on abort)."""

    def drain_frames(self) -> None:
        """Cancel every parked :class:`~repro_torch.core.taskgraph.TaskFrame` of
        the current run (called by the core when a run aborts, and by
        ``begin_run`` before reuse) so no frame stays orphaned on a channel
        or event that outlives the run."""


class ExecutorCore:
    """Persistent worker threads + run lifecycle, shared by all schedulers.

    ``run(dispatch, graph)`` executes one graph under one strategy; between
    runs the workers stay parked and warm.  Calls serialize: a second
    ``run`` (from any thread) waits until the previous run's workers are
    idle, which is what makes a core shareable between a pool's shapes and
    between dynamic warmup runs and replays.
    """

    def __init__(
        self,
        n_workers: int,
        *,
        block_poll: float = 0.05,
        name: str = "exec-core",
    ):
        self.n_workers = n_workers
        self.block_poll = block_poll
        self.name = name

        self._threads: List[threading.Thread] = []
        self._started = False
        self._shutdown = False
        self._tls = threading.local()
        # flight recorder of the dispatch currently running on this core;
        # reset to the no-op singleton between runs so a shared registry
        # core never keeps a trace buffer alive past its session
        self.recorder = NULL_RECORDER

        # run lifecycle: workers park on _gen_cv between runs
        self._gen_cv = threading.Condition()
        self._generation = 0
        self._workers_idle = n_workers
        self._dispatch: Optional[DispatchStrategy] = None

        # abort state of the CURRENT run (a fresh _RunState per run; workers
        # of run G can only ever see G's state — run G+1 cannot install
        # until they are all idle)
        self._run_state = _RunState()
        self._done_cv = threading.Condition()

        # hard-blocked accounting (blocking barriers only)
        self._blocked_count = 0
        self._blocked_lock = threading.Lock()

    # ------------------------------------------------------------------
    # lifecycle
    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._shutdown = False
        for w in range(self.n_workers):
            th = threading.Thread(target=self._worker_main, args=(w,),
                                  daemon=True, name=f"{self.name}-{w}")
            self._threads.append(th)
            th.start()

    def shutdown(self) -> None:
        self._shutdown = True
        with self._gen_cv:
            self._gen_cv.notify_all()
        dispatch = self._dispatch
        if dispatch is not None:
            dispatch.wake_all()
        with self._done_cv:
            self._done_cv.notify_all()
        for th in self._threads:
            th.join(timeout=5.0)
        alive = any(th.is_alive() for th in self._threads)
        self._threads.clear()
        self._started = False
        if not alive:
            # a straggler stuck in a long task body must keep seeing the
            # shutdown flag so it exits instead of rejoining the pool
            self._shutdown = False

    def __enter__(self) -> "ExecutorCore":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # worker identity
    def worker_id(self, default: int = 0) -> int:
        return getattr(self._tls, "wid", default)

    # ------------------------------------------------------------------
    # abort plumbing
    @property
    def aborted(self) -> bool:
        run = self._run_state
        return (self._shutdown or run.failure is not None
                or run.deadlock is not None)

    def abort_reason(self) -> str:
        run = self._run_state
        if self._shutdown:
            return "executor core shut down"
        if run.deadlock is not None:
            return run.deadlock
        return f"run aborted: {run.failure!r}"

    def fail(self, exc: BaseException) -> None:
        """Record the run's first failure and wake every waiter."""
        run = self._run_state
        if run.failure is None:
            run.failure = exc
        dispatch = self._dispatch
        if dispatch is not None:
            dispatch.wake_all()
        self.signal_done()

    def signal_done(self) -> None:
        with self._done_cv:
            self._done_cv.notify_all()

    # ------------------------------------------------------------------
    # blocked accounting + deadlock detection (Fig. 1)
    def enter_blocked(self) -> None:
        with self._blocked_lock:
            self._blocked_count += 1

    def exit_blocked(self) -> None:
        with self._blocked_lock:
            self._blocked_count -= 1

    # -- suspended-frame accounting (soft-blocked: worker-free) ------------
    def note_frame_suspended(self) -> None:
        run = self._run_state
        with self._blocked_lock:
            run.suspended += 1

    def note_frame_resumed(self) -> None:
        run = self._run_state
        with self._blocked_lock:
            run.suspended -= 1
            run.resume_epoch += 1

    @property
    def suspended_frames(self) -> int:
        with self._blocked_lock:
            return self._run_state.suspended

    @property
    def resume_epoch(self) -> int:
        with self._blocked_lock:
            return self._run_state.resume_epoch

    def check_deadlock(self) -> None:
        """The Fig. 1 state: every worker is stuck inside a *blocking*
        barrier (kernel-thread semantics — cannot schedule anything) while
        the units that would satisfy those barriers sit starved with the
        dispatch.  Safe under oversubscription: join-waiters keep stealing
        and are never counted as hard-blocked; frames suspended on a
        channel/event are soft-blocked (their worker is free) and never
        count either — they appear in the message only as context."""
        self.recorder.emit(self.worker_id(default=-1), EV_DEADLOCK_POLL)
        if self.aborted:
            # the run is already tearing down: barrier waiters drain their
            # enter_blocked accounting on the way out, and a transiently
            # full blocked count must not masquerade as a fresh deadlock
            return
        with self._blocked_lock:
            blocked = self._blocked_count
            suspended = self._run_state.suspended
        if blocked < self.n_workers:
            return
        dispatch = self._dispatch
        starved = dispatch.pending_units() if dispatch is not None else 0
        msg = (f"deadlock: all {blocked} workers blocked at blocking "
               f"barriers; {starved} ULT(s)/task(s) starved"
               + (f"; {suspended} frame(s) suspended" if suspended else ""))
        self._run_state.deadlock = msg
        self.signal_done()
        if dispatch is not None:
            dispatch.wake_all()
        raise DeadlockError(msg)

    def frame_deadlock(self, msg: str) -> None:
        """Report a *suspension* deadlock (all remaining work is frames
        parked on channels/events that nothing left in the run can satisfy).
        Unlike :meth:`check_deadlock` the reporting worker is idle, not
        blocked — it records the state and lets every worker observe
        ``aborted``."""
        run = self._run_state
        if run.deadlock is None and run.failure is None:
            run.deadlock = msg
        self.signal_done()
        dispatch = self._dispatch
        if dispatch is not None:
            dispatch.wake_all()

    # ------------------------------------------------------------------
    # the worker loop
    def _worker_main(self, w: int) -> None:
        self._tls.wid = w
        my_gen = 0
        while True:
            with self._gen_cv:
                while self._generation == my_gen and not self._shutdown:
                    self._gen_cv.wait(timeout=0.5)
                if self._shutdown:
                    return
                my_gen = self._generation
                dispatch = self._dispatch
            try:
                dispatch.worker_loop(w)
            except BaseException as e:  # noqa: BLE001 - propagate to run()
                self.fail(e)
            with self._gen_cv:
                self._workers_idle += 1
                self._gen_cv.notify_all()

    # ------------------------------------------------------------------
    # run lifecycle
    def run(
        self,
        dispatch: DispatchStrategy,
        graph: TaskGraph,
        timeout: float = 300.0,
    ) -> Dict[int, Any]:
        """Execute ``graph`` under ``dispatch`` on the warm workers; returns
        ``{tid: result}``.  Raises :class:`DeadlockError` on the Fig. 1
        state, re-raises the first task failure, raises ``TimeoutError``
        past ``timeout``.  Concurrent callers serialize."""
        if not self._started:
            self.start()
        with self._gen_cv:
            while self._workers_idle < self.n_workers:
                if self._shutdown:
                    raise RuntimeError("executor core is shut down")
                self._gen_cv.wait(timeout=0.05)
            if self._shutdown:
                raise RuntimeError("executor core is shut down")
            run_state = self._run_state = _RunState()
            dispatch.bind(self)
            dispatch.begin_run(graph)
            self.recorder = getattr(dispatch, "recorder", NULL_RECORDER)
            self._dispatch = dispatch
            self._workers_idle = 0
            self._generation += 1
            self._gen_cv.notify_all()

        # from here on read abort state ONLY through run_state: on a shared
        # core the next run may install (and reset self._run_state) as soon
        # as this run's workers go idle
        deadline = time.monotonic() + timeout
        try:
            with self._done_cv:
                while not dispatch.drained:
                    if (self._shutdown or run_state.deadlock is not None
                            or run_state.failure is not None):
                        break
                    if not self._done_cv.wait(timeout=0.05):
                        if time.monotonic() > deadline:
                            run_state.failure = TimeoutError(
                                f"graph {graph.name!r} did not finish within "
                                f"{timeout}s")
                            break
            if self._shutdown and not dispatch.drained:
                dispatch.drain_frames()
                raise RuntimeError("executor core was shut down mid-run")
            if run_state.deadlock is not None:
                dispatch.drain_frames()
                raise DeadlockError(run_state.deadlock)
            if run_state.failure is not None:
                failure = run_state.failure
                dispatch.wake_all()
                dispatch.drain_frames()
                raise failure
            return dispatch.results()
        finally:
            self.recorder = NULL_RECORDER
