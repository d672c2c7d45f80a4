"""Multi-threaded work-stealing + gang-scheduling runtime (faithful repro).

Executes a :class:`~repro_torch.core.taskgraph.TaskGraph` whose tasks are real
Python/PyTorch callables on a pool of pinned worker threads.  Kernel
launches (ctypes foreign calls and PyTorch ops) release the GIL, so workers
overlap their launches; on a CUDA device a task body returns once its work
is *enqueued*, so ``run`` returns before the device has finished — callers
that time the device bracket the run with ``torch.cuda.synchronize()``.

Since the unified-executor refactor, :class:`Runtime` is a thin facade: the
worker substrate (persistent threads, park/wake, blocked-thread accounting,
deadlock detection) is :class:`~repro_torch.exec.core.ExecutorCore`, and the
scheduling logic (per-worker deques, Algorithm-2 victim selection,
Algorithm-1 gang reservation, record instrumentation) is
:class:`~repro_torch.exec.dynamic.DynamicDispatch`.  The replay executor and the
serving pool run different dispatch strategies on the *same* substrate —
one runtime, as the paper argues.  A ``Runtime`` is reusable: repeated
:meth:`run` calls execute on the same warm parked workers with no thread
respawn, and passing ``core=`` lets several facades share one thread set.

Faithfulness to the paper:

* per-worker work-stealing deques; ready tasks are pushed to the queue of
  the worker that resolved their last dependency (paper §2.1);
* Algorithm 2 victim selection (``history`` / ``random`` / ``hybrid``);
* Algorithm 1 gang scheduling: parallel regions spawned by tasks are
  gang-scheduled onto reserved workers under the fork lock with a monotonic
  gang id; gang ULTs are stealable subject to ``is_eligible_to_sched``;
* region barriers: gang regions may use *blocking* barriers safely (all
  members are guaranteed distinct workers); at the *join* barrier a gang ULT
  steals eligible work instead of idling (the paper's scheduling point);
* non-gang regions with blocking barriers reproduce the Fig. 1 deadlock —
  the core detects the all-workers-blocked state and raises
  :class:`DeadlockError` instead of hanging.

Python threads cannot switch ULT stacks, so *internal* barriers of a gang
region block the kernel thread (safe under gang reservation) instead of
being cooperative scheduling points — the one deviation from HClib,
documented in DESIGN.md §2.
"""

from __future__ import annotations

import threading
import warnings
from typing import Any, Callable, Dict, List, Optional

from ..exec.core import ExecutorCore, GangRegion
from ..exec.dynamic import DynamicDispatch
from .taskgraph import TaskContext, TaskGraph

__all__ = ["Runtime", "run_graph"]


class Runtime:
    """The integrated runtime (HClib-OMP analogue) — dynamic-dispatch facade
    over the shared :class:`~repro_torch.exec.core.ExecutorCore`.

    ``core=`` injects a shared substrate (e.g. the serving pool's
    per-worker-count core); the runtime then *leases* those warm workers and
    :meth:`shutdown` leaves them running for the next lessee.  Without it
    the runtime owns a private core, shut down with the facade.
    """

    def __init__(
        self,
        n_workers: int,
        *,
        policy: str = "hybrid",
        gang_default: bool = True,
        seed: int = 0,
        steal_backoff: float = 20e-6,
        block_poll: float = 0.05,
        trace: bool = False,
        core: Optional[ExecutorCore] = None,
    ):
        if trace:
            from ..api.session import not_ported
            raise not_ported("trace")
        if core is not None and core.n_workers != n_workers:
            raise ValueError(
                f"shared core has {core.n_workers} workers, runtime wants "
                f"{n_workers}")
        self.n_workers = n_workers
        self.policy_name = policy
        self.gang_default = gang_default
        self.seed = seed
        self.steal_backoff = steal_backoff
        self.block_poll = block_poll
        self.trace_enabled = trace

        self._core = core if core is not None else ExecutorCore(
            n_workers, block_poll=block_poll, name="repro-worker")
        self._owns_core = core is None
        self._dispatch = DynamicDispatch(
            n_workers, policy=policy, gang_default=gang_default, seed=seed,
            steal_backoff=steal_backoff, trace=trace)
        #: the :class:`~repro_torch.replay.Recording` of the most recent
        #: ``run(record=True)``
        self.last_recording = None

    # ------------------------------------------------------------------
    # lifecycle
    @property
    def core(self) -> ExecutorCore:
        return self._core

    @property
    def gang_state(self):
        return self._dispatch.gang_state

    @property
    def last_stats(self) -> Dict[str, int]:
        """Lightweight counters of the most recent run (steals, frame
        suspensions) — surfaced by :class:`repro_torch.api.RunReport`."""
        return dict(self._dispatch.run_stats)

    def start(self) -> None:
        self._core.start()

    def shutdown(self) -> None:
        if self._owns_core:
            self._core.shutdown()

    def __enter__(self) -> "Runtime":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # graph execution
    def run(self, graph: TaskGraph, timeout: float = 300.0, *,
            record: bool = False) -> Dict[int, Any]:
        """Execute the graph; returns {tid: result}.  Raises DeadlockError if
        the Fig. 1 state is reached, or re-raises the first task failure.
        Repeated calls reuse the same warm worker threads.

        With ``record=True`` the run is instrumented (per-worker execution
        order, steals, gang placements and fork order) and a
        :class:`repro_torch.replay.Recording` is left in
        ``self.last_recording`` for the replay executor / graph cache."""
        graph.validate()
        self._dispatch.set_recording(record)
        try:
            results = self._core.run(self._dispatch, graph, timeout=timeout)
            if record:
                self.last_recording = self._dispatch.build_recording(graph)
            return results
        finally:
            self._dispatch.set_recording(False)

    # ------------------------------------------------------------------
    # parallel regions (called from task bodies via ctx.parallel)
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
        Delegates to the dynamic dispatch (Algorithm 1)."""
        return self._dispatch.parallel(n_threads, body, gang=gang,
                                       spawn_ctx=spawn_ctx)


class _RunGraphShim:
    """The v1 convenience entry point, now a thin shim over the v2 session
    API (:mod:`repro_torch.api`).

    ``run_graph(graph, n)`` runs one dynamic execution on a short-lived
    :class:`~repro_torch.api.Session` lease.  The old mutually-exclusive mode
    kwargs map onto :class:`~repro_torch.api.Plan` decisions:

    * ``record=True``  -> ``Session.run(graph, record=True)``;
    * ``replay=rec``   -> a ``Plan(mode="replay", recording=rec)``;
    * ``cache=c``      -> ``Session(cache=c)`` (record on miss, replay on
      hit);
    * ``pool=p``       -> ``p.serve(...)`` (``record``/``replay``/
      ``cache``/``trace`` are the pool's own business and rejected when
      combined with it).

    ``trace=True`` raises ``NotImplementedError`` (ROADMAP Queue A item 5),
    as :class:`~repro_torch.api.Session` does.

    The v1 ``run_graph.last_recording`` module global is **gone from the
    library path**; this shim keeps a deprecation-warned, read-only,
    *thread-local* alias for old callers.  New code reads the recording off
    the :class:`~repro_torch.api.RunReport` a session returns.
    """

    def __init__(self) -> None:
        self._tls = threading.local()

    # -- the deprecated alias -------------------------------------------
    @property
    def last_recording(self):
        """Deprecated: the recording involved in this thread's most recent
        ``run_graph`` call.  Use ``Session.run(...).recording``."""
        warnings.warn(
            "run_graph.last_recording is deprecated; use the RunReport "
            "returned by repro_torch.Session.run (report.recording)",
            DeprecationWarning, stacklevel=2)
        return getattr(self._tls, "recording", None)

    def _note(self, recording: Any) -> None:
        self._tls.recording = recording

    # -- the call --------------------------------------------------------
    def __call__(
        self,
        graph: TaskGraph,
        n_workers: int,
        *,
        policy: str = "hybrid",
        gang_default: bool = True,
        seed: int = 0,
        trace: bool = False,
        timeout: float = 300.0,
        record: bool = False,
        replay: Any = None,
        cache: Any = None,
        pool: Any = None,
    ) -> Dict[int, Any]:
        from ..api.session import Plan, Session
        from .policies import resolve as resolve_policy

        resolve_policy(policy)            # typos fail here, with valid names
        if pool is not None:
            if record or replay is not None or cache is not None or trace:
                raise ValueError(
                    "run_graph(pool=...) owns recording/replay/caching "
                    "itself; record/replay/cache/trace cannot be combined "
                    "with a pool")
            out = pool.serve(graph, n_workers, policy=policy,
                             gang_default=gang_default, seed=seed,
                             timeout=timeout)
            # v1 callers also read pool.last_recording after the call
            pool.last_recording = out.recording
            self._note(out.recording)
            return out.results
        if replay is not None:
            if record or cache is not None:
                warnings.warn(
                    "run_graph(replay=...) ignores record/cache; use a "
                    "Session with a Plan instead", DeprecationWarning,
                    stacklevel=2)
            replay.validate_against(graph)     # v1 checked the digest here
            session = Session(replay.n_workers, scheduler="replay",
                              policy=policy, gang_default=gang_default,
                              seed=seed)
            try:
                plan = Plan(mode="replay", n_workers=replay.n_workers,
                            policy=policy, graph=graph, digest=replay.digest,
                            recording=replay,
                            reason="run_graph(replay=...) shim")
                report = session.run(plan=plan, timeout=timeout)
            finally:
                session.close()
            self._note(report.recording)
            return report.results
        session = Session(n_workers, scheduler="dynamic", policy=policy,
                          gang_default=gang_default, seed=seed, cache=cache,
                          trace=trace)
        try:
            report = session.run(graph, record=record or None,
                                 timeout=timeout)
        finally:
            session.close()
        self._note(report.recording)
        return report.results


#: v1 entry point (shim; see :class:`_RunGraphShim`).
run_graph = _RunGraphShim()
