"""Sessions, execution plans and run reports (API v2).

One object owns scheduler selection and worker leasing:
:class:`Session` replaces the v1 juggling of
:class:`~repro_torch.core.runtime.Runtime` /
:class:`~repro_torch.replay.executor.ReplayExecutor` /
:class:`~repro_torch.replay.pool.ReplayPool` facades and the mutually-exclusive
``run_graph(record=/replay=/cache=/pool=)`` kwargs:

* ``Session(workers=4, scheduler="dynamic" | "replay" | "pool",
  policy=...)`` — the scheduler is picked once, the victim policy is
  validated once (:func:`repro_torch.core.policies.resolve`), and the session
  *leases* its worker threads from the process-global
  :class:`~repro_torch.exec.registry.CoreRegistry` (one warm core per worker
  count per process; ``shared_cores=False`` opts into a private core);
* :meth:`Session.plan` turns "what will happen to this graph" into
  inspectable data — a :class:`Plan` saying **warm** (dynamic on warm
  workers), **record** (instrumented dynamic run), **replay** (run a
  recording; ``remapped_from`` set when it was re-keyed from another worker
  count) or **pool** (the serving pool decides per shape) and *why*;
* :meth:`Session.run` executes a graph (or a prepared plan) and returns a
  :class:`RunReport` — results, the recording (if any), scheduler
  statistics (steals / fallbacks / frame suspensions) and wall clock.
  Nothing is smuggled through module globals: the v1
  ``run_graph.last_recording`` escape hatch is dead on this path.

Scheduler semantics
-------------------

``dynamic``
    Every run is scheduled dynamically on the leased warm workers.  With a
    ``cache``, a run whose shape misses records and stores; later
    same-shaped runs replay (the v1 ``run_graph(cache=...)`` contract).
``replay``
    Replay-first: cache hits replay on a persistent per-shape executor;
    with ``allow_remap`` a recording at another worker count is re-keyed
    (:func:`~repro_torch.replay.remap.remap_recording`) instead of re-recorded;
    a true miss records this run.  Requires a ``cache`` (it is where
    recordings live).
``pool``
    Requests route through a session-owned
    :class:`~repro_torch.replay.pool.ReplayPool` (warmup → record → replay with
    adaptive re-recording), the steady-state serving path.
``compiled``
    Replay, minus the scheduler: a cache-hit recording is lowered once
    (:func:`repro_torch.compile.compile_recording`) into a fused serial
    program and every later same-shaped run executes on the
    single-threaded :class:`~repro_torch.compile.CompiledExecutor` — no
    dispatch, no GIL contention, bit-identical results.  On a CUDA device
    each fused segment of capturable kernels runs as one CUDA graph.  A
    true miss records this run and compiles the next; a compiled plan that
    stalls (stale shape) falls back to replay for that run.

``trace=True`` turns the flight recorder on: ``RunReport.trace`` is the
run's assembled :class:`~repro_torch.obs.trace.RuntimeTrace`
(``repro_torch.obs.write_trace`` exports it for Perfetto).  ``procs=`` and
:meth:`Session.submit` (worker processes) are not ported yet: they raise
``NotImplementedError`` naming ROADMAP Queue A item 6.

On a CUDA device ``RunReport.wall_s`` is host time until every task body
has *enqueued* its work; time the device by bracketing the run with
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional, Union

from ..core.policies import resolve as resolve_policy
from ..core.taskgraph import TaskGraph

__all__ = ["Plan", "PlanError", "RunReport", "Session"]

_SCHEDULERS = ("dynamic", "replay", "pool", "compiled")

#: reference options the port does not run yet, with the ROADMAP item that
#: ports each
_NOT_PORTED = {
    "procs": "ROADMAP Queue A item 6 (mp/)",
}


def not_ported(what: str) -> NotImplementedError:
    """The error raised for a reference feature the port lacks so far."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet; see {_NOT_PORTED[what]}")


class PlanError(RuntimeError):
    """A plan cannot be executed (wrong graph shape, closed session, ...)."""


@dataclasses.dataclass
class Plan:
    """An inspectable execution decision for one graph shape.

    ``mode`` is one of ``"warm"`` (dynamic scheduling on warm leased
    workers), ``"record"`` (dynamic with instrumentation; the recording is
    returned in the report and stored in the session cache), ``"replay"``
    (drive the attached ``recording``; ``remapped_from`` names the worker
    count it was re-keyed from, if any), ``"compiled"`` (lower the attached
    ``recording`` into a fused serial program and run it schedulerless —
    :mod:`repro_torch.compile`) or ``"pool"`` (the serving pool owns the
    per-shape lifecycle).  ``reason`` says why the session chose
    it.  Plans are data: print them, test against them, or pass one back to
    :meth:`Session.run` — including against a *different same-shaped graph*
    (an iterative sweep plans once and executes per iteration).
    """

    mode: str
    n_workers: int
    policy: str
    graph: TaskGraph
    digest: Optional[str] = None
    recording: Optional[Any] = None          # repro_torch.replay.Recording
    remapped_from: Optional[int] = None
    record: bool = False
    reason: str = ""
    #: precomputed structural GraphKey (``Session.run(key=...)``) — lets a
    #: steady-state serving loop skip the per-request hash; safety is not
    #: skipped (replay still enforces the 1:1 task cover, so a wrong key
    #: fails loudly)
    key: Optional[Any] = None                # repro_torch.replay.GraphKey

    def describe(self) -> str:
        extra = ""
        if self.mode == "replay" and self.remapped_from is not None:
            extra = f" (remapped {self.remapped_from}->{self.n_workers})"
        return (f"Plan[{self.mode}{extra}] graph={self.graph.name!r} "
                f"workers={self.n_workers} policy={self.policy}"
                + (f" — {self.reason}" if self.reason else ""))

    def __str__(self) -> str:
        return self.describe()


@dataclasses.dataclass
class RunReport:
    """Everything one execution produced, returned by :meth:`Session.run`.

    ``results`` maps tid -> result; prefer ``report[handle]`` /
    :meth:`result` with the :class:`~repro_torch.api.graph.TaskHandle` the graph
    builder returned.  ``recording`` is the run's
    :class:`~repro_torch.replay.Recording` when one was produced or driven
    (record/replay/pool modes) — the value v1 leaked through
    ``run_graph.last_recording``.  ``stats`` carries scheduler counters:
    dynamic runs report ``steals``/``frame_suspends``; replays report
    ``fallback_steals``/``stalls``/``skips``/``run_ahead``/
    ``frame_suspends``; pool runs add the pool entry's serving counters
    plus ``pool_mode`` and (for replay serves) a ``replay_stats`` snapshot
    explaining fallback-heavy rows.  ``trace`` is the run's assembled
    :class:`~repro_torch.obs.trace.RuntimeTrace` when the session was built
    with ``trace=True`` (None otherwise) — feed it to
    :func:`repro_torch.obs.write_trace` for a Perfetto timeline.
    """

    results: Dict[int, Any]
    plan: Plan
    recording: Optional[Any]
    wall_s: float
    scheduler: str
    n_workers: int
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace: Optional[Any] = None              # repro_torch.obs.trace.RuntimeTrace

    def result(self, ref: Any) -> Any:
        """Result of a task, by :class:`~repro_torch.api.graph.TaskHandle`,
        :class:`~repro_torch.core.taskgraph.Task`, or raw tid."""
        tid = getattr(ref, "tid", ref)
        return self.results[tid]

    def __getitem__(self, ref: Any) -> Any:
        return self.result(ref)

    def __contains__(self, ref: Any) -> bool:
        return getattr(ref, "tid", ref) in self.results

    def summary(self) -> str:
        rec = "yes" if self.recording is not None else "no"
        return (f"RunReport[{self.plan.mode}] {len(self.results)} tasks in "
                f"{self.wall_s * 1e3:.2f} ms on {self.n_workers} workers "
                f"({self.scheduler}); recording: {rec}; stats: {self.stats}")


class Session:
    """Owns scheduler selection, policy validation and worker leasing for
    any number of graph executions (see module docstring).

    Use as a context manager (or call :meth:`close`): the session releases
    its core lease — and shuts down its pool/executors — on exit.  Runs on
    one session serialize; use one session per concurrent stream.
    """

    def __init__(
        self,
        workers: int,
        *,
        scheduler: str = "dynamic",
        policy: str = "hybrid",
        gang_default: bool = True,
        seed: int = 0,
        cache: Optional[Any] = None,           # repro_torch.replay.GraphCache
        allow_remap: bool = True,
        record: bool = False,
        trace: bool = False,
        shared_cores: bool = True,
        stall_timeout: float = 1e-3,
        block_poll: float = 0.05,
        pool_kwargs: Optional[Dict[str, Any]] = None,
        procs: Optional[int] = None,
    ):
        if workers < 1:
            raise ValueError(f"a session needs >= 1 worker, got {workers}")
        if scheduler not in _SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {scheduler!r}; valid schedulers: "
                f"{', '.join(_SCHEDULERS)}")
        if procs is not None:
            raise not_ported("procs")
        resolve_policy(policy)       # typos fail HERE, with the valid names
        if scheduler in ("replay", "compiled") and cache is None:
            from ..replay.cache import GraphCache
            cache = GraphCache()     # recordings need a home; private one
        self.workers = workers
        self.scheduler = scheduler
        self.policy = policy
        self.gang_default = gang_default
        self.seed = seed
        self.cache = cache
        self.allow_remap = allow_remap
        self.record_default = record
        self.trace = trace
        self.shared_cores = shared_cores
        self.stall_timeout = stall_timeout
        self.block_poll = block_poll
        self.pool_kwargs = dict(pool_kwargs or {})

        self._lock = threading.RLock()
        self._closed = False
        self._core: Optional[Any] = None                 # ExecutorCore lease
        self._runtime: Optional[Any] = None              # dynamic facade
        self._executors: Dict[str, Any] = {}             # digest -> executor
        self._pool: Optional[Any] = None                 # ReplayPool
        self._compiled: Dict[str, Any] = {}              # digest -> CompiledExecutor

    # ------------------------------------------------------------------
    # lifecycle
    def close(self) -> None:
        """Release the core lease and stop session-owned executors.  Shared
        cores stay warm for other lessees; the last lessee's release stops
        the threads (which keeps the suite's thread-leak check honest)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            executors = list(self._executors.values())
            self._executors.clear()
            self._compiled.clear()   # threadless; nothing to shut down
            pool, self._pool = self._pool, None
            runtime, self._runtime = self._runtime, None
            core, self._core = self._core, None
        for ex in executors:
            ex.shutdown()
        if pool is not None:
            pool.shutdown()
        if runtime is not None:
            runtime.shutdown()
        if core is not None:
            if self.shared_cores:
                from ..exec.registry import release_shared_core
                release_shared_core(core)
            else:
                core.shutdown()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _require_open(self) -> None:
        if self._closed:
            raise PlanError("session is closed")

    # ------------------------------------------------------------------
    # leased substrate (lazy: a session that never runs leases nothing)
    def _leased_core(self):
        with self._lock:
            self._require_open()
            if self._core is None:
                if self.shared_cores:
                    from ..exec.registry import shared_core
                    self._core = shared_core(self.workers)
                else:
                    from ..exec.core import ExecutorCore
                    self._core = ExecutorCore(
                        self.workers, block_poll=self.block_poll,
                        name=f"session{self.workers}-worker")
                    self._core.start()
            return self._core

    def _dynamic_runtime(self):
        with self._lock:
            self._require_open()
            if self._runtime is None:
                from ..core.runtime import Runtime
                self._runtime = Runtime(
                    self.workers, policy=self.policy,
                    gang_default=self.gang_default, seed=self.seed,
                    trace=self.trace, core=self._leased_core())
            return self._runtime

    def _replay_executor(self, recording):
        """Persistent per-shape executor leasing the session core; rebuilt
        when the shape's recording changes (e.g. a re-record)."""
        from ..replay.executor import ReplayExecutor
        with self._lock:
            self._require_open()
            ex = self._executors.get(recording.digest)
            if ex is not None and ex.recording is not recording:
                ex.shutdown()
                ex = None
            if ex is None:
                ex = ReplayExecutor(
                    recording, stall_timeout=self.stall_timeout,
                    check_digest=False, trace=self.trace,
                    core=self._leased_core())
                ex.start()
                self._executors[recording.digest] = ex
            return ex

    def _serving_pool(self):
        with self._lock:
            self._require_open()
            if self._pool is None:
                from ..replay.pool import ReplayPool
                kwargs = dict(self.pool_kwargs)
                kwargs.setdefault("allow_remap", self.allow_remap)
                kwargs.setdefault("stall_timeout", self.stall_timeout)
                kwargs.setdefault("shared_cores", self.shared_cores)
                kwargs.setdefault("trace", self.trace)
                self._pool = ReplayPool(self.cache, **kwargs)
            return self._pool

    @property
    def pool(self):
        """The session's serving pool (``scheduler="pool"`` only) — exposed
        for ``describe()`` / ``register_builder``."""
        if self.scheduler != "pool":
            raise PlanError(
                f"session scheduler is {self.scheduler!r}; no pool exists")
        return self._serving_pool()

    def submit(self, graph: TaskGraph, **kwargs: Any):
        """Asynchronous submission lives in :mod:`repro_torch.mp`, which is
        not ported yet."""
        raise not_ported("procs")

    # ------------------------------------------------------------------
    # planning
    @staticmethod
    def _as_taskgraph(graph: Union[TaskGraph, Any]) -> TaskGraph:
        if isinstance(graph, TaskGraph):
            return graph
        raise TypeError(f"expected a TaskGraph/Graph, got {type(graph)!r}")

    def plan(self, graph: TaskGraph, *, record: Optional[bool] = None,
             key: Optional[Any] = None) -> Plan:
        """Decide — without executing — how :meth:`run` would serve
        ``graph``; returns the decision as an inspectable :class:`Plan`.
        Side-effect-free: nothing is recorded, stored or leased.  ``key``
        supplies the graph's structural :class:`~repro_torch.replay.GraphKey`
        when the caller already knows it (a serving loop rebuilding one
        shape) so planning skips the per-request hash."""
        self._require_open()
        tg = self._as_taskgraph(graph)
        base = dict(n_workers=self.workers, policy=self.policy, graph=tg,
                    key=key)
        if self.scheduler == "pool":
            return Plan(mode="pool", digest=getattr(key, "digest", None),
                        reason=(
                            "serving pool owns the shape lifecycle "
                            "(warmup -> record -> replay, adaptive "
                            "re-record)"), **base)
        if key is None:
            from ..replay.graph_key import graph_key
            key = graph_key(tg)
            base["key"] = key
        base["digest"] = key.digest
        want_record = self.record_default if record is None else record
        rec = (self.cache.lookup(key, self.workers, self.policy)
               if self.cache is not None else None)
        if rec is not None:
            if self.scheduler == "compiled":
                return Plan(mode="compiled", recording=rec,
                            reason="cache hit — lower the recording to a "
                                   "fused serial program", **base)
            return Plan(mode="replay", recording=rec,
                        reason="cache hit for this shape at this worker "
                               "count", **base)
        if self.scheduler == "compiled":
            if self.allow_remap and self.cache is not None:
                remapped, src = self._try_remap(key)
                if remapped is not None:
                    return Plan(
                        mode="compiled", recording=remapped,
                        remapped_from=src,
                        reason=f"cache held the shape at {src} workers; "
                               f"re-keyed and compiled for {self.workers}",
                        **base)
            return Plan(mode="record", record=True,
                        reason="no recording for this shape — record this "
                               "run, compile the next", **base)
        if self.scheduler == "replay":
            if self.allow_remap and self.cache is not None:
                remapped, src = self._try_remap(key)
                if remapped is not None:
                    return Plan(
                        mode="replay", recording=remapped, remapped_from=src,
                        reason=f"cache held the shape at {src} workers; "
                               f"re-keyed to {self.workers}", **base)
            return Plan(mode="record", record=True,
                        reason="no recording for this shape — record this "
                               "run, replay the next", **base)
        if self.cache is not None:
            return Plan(mode="record", record=True,
                        reason="cache miss — record so later same-shaped "
                               "runs replay", **base)
        if want_record:
            return Plan(mode="record", record=True,
                        reason="recording requested", **base)
        return Plan(mode="warm",
                    reason="dynamic scheduling on warm leased workers",
                    **base)

    def _try_remap(self, key):
        from ..replay.remap import (RemapError, nearest_worker_count,
                                    remap_recording)
        donors = self.cache.candidates(key, self.policy)
        donors.pop(self.workers, None)
        while donors:
            src = nearest_worker_count(list(donors), self.workers)
            try:
                return remap_recording(donors.pop(src), self.workers), src
            except RemapError:
                continue
        return None, None

    # ------------------------------------------------------------------
    # execution
    def run(
        self,
        graph: Optional[TaskGraph] = None,
        *,
        plan: Optional[Plan] = None,
        record: Optional[bool] = None,
        key: Optional[Any] = None,
        timeout: float = 300.0,
    ) -> RunReport:
        """Execute ``graph`` (planned now) or a prepared ``plan`` (against
        ``graph`` when given — a sweep plans once, runs per iteration);
        returns a :class:`RunReport`.  ``key`` forwards a precomputed
        :class:`~repro_torch.replay.GraphKey` to :meth:`plan` (and, for pool
        sessions, to the pool) so steady-state loops skip hashing."""
        if plan is None:
            if graph is None:
                raise TypeError("run() needs a graph or a plan")
            plan = self.plan(graph, record=record, key=key)
        tg = self._as_taskgraph(graph) if graph is not None else plan.graph
        with self._lock:
            self._require_open()
            t0 = time.perf_counter()
            if plan.mode == "pool":
                report = self._run_pool(plan, tg, timeout)
            elif plan.mode == "compiled":
                report = self._run_compiled(plan, tg, timeout)
            elif plan.mode == "replay":
                report = self._run_replay(plan, tg, timeout)
            elif plan.mode in ("warm", "record"):
                report = self._run_dynamic(plan, tg, timeout)
            else:
                raise PlanError(f"unknown plan mode {plan.mode!r}")
            report.wall_s = time.perf_counter() - t0
            return report

    def execute(self, plan: Plan, *, timeout: float = 300.0) -> RunReport:
        """Alias: run a prepared plan against its own graph."""
        return self.run(plan=plan, timeout=timeout)

    def _run_dynamic(self, plan: Plan, tg: TaskGraph,
                     timeout: float) -> RunReport:
        rt = self._dynamic_runtime()
        do_record = plan.mode == "record"
        results = rt.run(tg, timeout=timeout, record=do_record)
        recording = rt.last_recording if do_record else None
        if do_record and recording is not None and self.cache is not None:
            self.cache.store(recording)
        stats = dict(rt.last_stats)
        return RunReport(results=results, plan=plan, recording=recording,
                         wall_s=0.0, scheduler=self.scheduler,
                         n_workers=self.workers, stats=stats,
                         trace=rt.last_trace)

    def _run_replay(self, plan: Plan, tg: TaskGraph,
                    timeout: float) -> RunReport:
        recording = plan.recording
        if recording is None:
            raise PlanError("replay plan carries no recording")
        if tg is not plan.graph:
            # executing a prepared plan against a fresh same-shaped graph:
            # re-key THIS graph (the plan's digest covered the original)
            from ..replay.graph_key import graph_key
            if graph_key(tg).digest != recording.digest:
                raise PlanError(
                    f"plan's recording is for digest "
                    f"{recording.digest[:16]} but the graph hashes "
                    "differently")
        if plan.remapped_from is not None and self.cache is not None:
            # adopt the re-keyed recording so the next plan() is a pure hit
            self.cache.store(recording)
        ex = self._replay_executor(recording)
        results = ex.run(tg, timeout=timeout)
        return RunReport(results=results, plan=plan, recording=recording,
                         wall_s=0.0, scheduler=self.scheduler,
                         n_workers=self.workers, stats=dict(ex.stats),
                         trace=ex.last_trace)

    def _compiled_executor(self, tg: TaskGraph, recording):
        """Get-or-build the per-digest compiled executor (threadless — no
        core lease).  The lowering's
        :class:`~repro_torch.compile.CompiledPlanMeta` is persisted next to
        the recording in the session cache."""
        from ..compile import CompiledExecutor, compile_recording
        ex = self._compiled.get(recording.digest)
        if ex is not None and ex.plan.recording is not recording:
            ex = None                        # recording swapped (re-record)
        if ex is None:
            cplan = compile_recording(tg, recording)
            ex = CompiledExecutor(tg, cplan)
            self._compiled[recording.digest] = ex
            if self.cache is not None and hasattr(self.cache, "store_plan_meta"):
                self.cache.store_plan_meta(
                    recording.digest, recording.n_workers, self.policy,
                    cplan.meta.to_dict())
        return ex

    def _run_compiled(self, plan: Plan, tg: TaskGraph,
                      timeout: float) -> RunReport:
        from ..compile import CompiledRunError, CompileError
        recording = plan.recording
        if recording is None:
            raise PlanError("compiled plan carries no recording")
        if tg is not plan.graph:
            from ..replay.graph_key import graph_key
            if graph_key(tg).digest != recording.digest:
                raise PlanError(
                    f"plan's recording is for digest "
                    f"{recording.digest[:16]} but the graph hashes "
                    "differently")
        if plan.remapped_from is not None and self.cache is not None:
            self.cache.store(recording)
        try:
            ex = self._compiled_executor(tg, recording)
            results = ex.run(tg, check_digest=False)
            stats = dict(ex.stats)
        except (CompileError, CompiledRunError) as e:
            # stale/unlowerable plan: drop the executable and serve this
            # run on the replay path (dynamic is replay's own fallback).  A
            # CUDA capture or replay error is neither, and raises.
            self._compiled.pop(recording.digest, None)
            report = self._run_replay(plan, tg, timeout)
            report.stats["compiled_fallback"] = str(e)
            return report
        return RunReport(results=results, plan=plan, recording=recording,
                         wall_s=0.0, scheduler=self.scheduler,
                         n_workers=self.workers, stats=stats, trace=None)

    def map(self, builder, inputs, *, record: Optional[bool] = None,
            key: Optional[Any] = None, timeout: float = 300.0,
            procs: Optional[int] = None):
        """Run a sweep of same-shaped graphs through one plan: ``builder``
        maps each input to a graph; the first graph is planned once and the
        plan is reused for every later input (re-planned a single time when
        the first run records, so the rest of the sweep replays/compiles).
        Returns the per-input :class:`RunReport` list.  ``procs`` (sharding the
        sweep over worker processes) raises ``NotImplementedError``."""
        self._require_open()
        if procs is not None:
            raise not_ported("procs")
        reports = []
        plan: Optional[Plan] = None
        for x in inputs:
            g = self._as_taskgraph(builder(x))
            if plan is None:
                plan = self.plan(g, record=record, key=key)
                reports.append(self.run(graph=g, plan=plan, timeout=timeout))
                if plan.mode == "record":
                    plan = None    # re-plan once: the next call hits the cache
            else:
                reports.append(self.run(graph=g, plan=plan, timeout=timeout))
        return reports

    def _run_pool(self, plan: Plan, tg: TaskGraph,
                  timeout: float) -> RunReport:
        pool = self._serving_pool()
        outcome = pool.serve(
            tg, self.workers, policy=self.policy,
            gang_default=self.gang_default, seed=self.seed, timeout=timeout,
            key=plan.key)
        stats = dict(outcome.stats)
        stats["pool_mode"] = outcome.mode
        return RunReport(results=outcome.results, plan=plan,
                         recording=outcome.recording, wall_s=0.0,
                         scheduler=self.scheduler, n_workers=self.workers,
                         stats=stats, trace=getattr(outcome, "trace", None))
