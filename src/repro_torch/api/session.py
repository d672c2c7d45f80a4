"""Sessions, execution plans and run reports (API v2).

One object owns scheduler selection and worker leasing:

* ``Session(workers=4, scheduler="dynamic", policy=...)`` — the scheduler
  is picked once, the victim policy is validated once
  (:func:`repro_torch.core.policies.resolve`), and the session *leases* its
  worker threads from the process-global
  :class:`~repro_torch.exec.registry.CoreRegistry` (one warm core per
  worker count per process; ``shared_cores=False`` opts into a private
  core);
* :meth:`Session.plan` turns "what will happen to this graph" into
  inspectable data — a :class:`Plan`;
* :meth:`Session.run` executes a graph (or a prepared plan) and returns a
  :class:`RunReport` — results, scheduler statistics (steals / frame
  suspensions) and wall clock.

The port runs the ``dynamic`` scheduler only.  The reference package's
other modes reach modules that are not ported yet; each raises
``NotImplementedError`` naming the ROADMAP item that will port it:
``scheduler="replay" | "pool"``, ``record=True`` and ``cache=`` (record and
replay, Queue A item 3), ``scheduler="compiled"`` (Queue A item 4),
``trace=True`` (Queue A item 5), ``procs=`` and :meth:`Session.submit`
(Queue A item 6).

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

#: reference scheduler modes and options the port does not run yet, with
#: the ROADMAP item that ports each
_NOT_PORTED = {
    "replay": "ROADMAP Queue A item 3 (record and replay: replay/, exec/replay.py)",
    "pool": "ROADMAP Queue A item 3 (record and replay: replay/pool.py)",
    "record": "ROADMAP Queue A item 3 (record and replay: replay/recording.py)",
    "cache": "ROADMAP Queue A item 3 (record and replay: replay/cache.py)",
    "compiled": "ROADMAP Queue A item 4 (compile/)",
    "trace": "ROADMAP Queue A item 5 (obs/trace.py, obs/perfetto.py)",
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

    ``mode`` is ``"warm"`` (dynamic scheduling on warm leased workers), the
    only mode the port runs so far.  ``reason`` says why the session chose
    it.  Plans are data: print them, test against them, or pass one back to
    :meth:`Session.run` — including against a *different same-shaped
    graph* (an iterative sweep plans once and executes per iteration).
    """

    mode: str
    n_workers: int
    policy: str
    graph: TaskGraph
    digest: Optional[str] = None
    reason: str = ""
    #: precomputed structural GraphKey (``Session.run(key=...)``) — lets a
    #: loop rebuilding one shape skip the per-request hash
    key: Optional[Any] = None                # repro_torch.replay.GraphKey

    def describe(self) -> str:
        return (f"Plan[{self.mode}] graph={self.graph.name!r} "
                f"workers={self.n_workers} policy={self.policy}"
                + (f" — {self.reason}" if self.reason else ""))

    def __str__(self) -> str:
        return self.describe()


@dataclasses.dataclass
class RunReport:
    """Everything one execution produced, returned by :meth:`Session.run`.

    ``results`` maps tid -> result; prefer ``report[handle]`` /
    :meth:`result` with the :class:`~repro_torch.api.graph.TaskHandle` the
    graph builder returned.  ``stats`` carries the dynamic scheduler's
    counters (``steals``/``frame_suspends``/resource grants).
    """

    results: Dict[int, Any]
    plan: Plan
    wall_s: float
    scheduler: str
    n_workers: int
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)

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
        return (f"RunReport[{self.plan.mode}] {len(self.results)} tasks in "
                f"{self.wall_s * 1e3:.2f} ms on {self.n_workers} workers "
                f"({self.scheduler}); stats: {self.stats}")


class Session:
    """Owns scheduler selection, policy validation and worker leasing for
    any number of graph executions (see module docstring).

    Use as a context manager (or call :meth:`close`): the session releases
    its core lease on exit.  Runs on one session serialize; use one session
    per concurrent stream.
    """

    def __init__(
        self,
        workers: int,
        *,
        scheduler: str = "dynamic",
        policy: str = "hybrid",
        gang_default: bool = True,
        seed: int = 0,
        cache: Optional[Any] = None,
        record: bool = False,
        trace: bool = False,
        shared_cores: bool = True,
        block_poll: float = 0.05,
        procs: Optional[int] = None,
    ):
        if workers < 1:
            raise ValueError(f"a session needs >= 1 worker, got {workers}")
        if scheduler not in _SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {scheduler!r}; valid schedulers: "
                f"{', '.join(_SCHEDULERS)}")
        if scheduler != "dynamic":
            raise not_ported(scheduler)
        resolve_policy(policy)       # typos fail HERE, with the valid names
        for what, value in (("cache", cache), ("procs", procs)):
            if value is not None:
                raise not_ported(what)
        for what, flag in (("record", record), ("trace", trace)):
            if flag:
                raise not_ported(what)
        self.workers = workers
        self.scheduler = scheduler
        self.policy = policy
        self.gang_default = gang_default
        self.seed = seed
        self.shared_cores = shared_cores
        self.block_poll = block_poll

        self._lock = threading.RLock()
        self._closed = False
        self._core: Optional[Any] = None                 # ExecutorCore lease
        self._runtime: Optional[Any] = None              # dynamic facade

    # ------------------------------------------------------------------
    # lifecycle
    def close(self) -> None:
        """Release the core lease.  Shared cores stay warm for other
        lessees; the last lessee's release stops the threads (which keeps
        the suite's thread-leak check honest)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            runtime, self._runtime = self._runtime, None
            core, self._core = self._core, None
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
                    core=self._leased_core())
            return self._runtime

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
        ``key`` supplies the graph's structural
        :class:`~repro_torch.replay.GraphKey` when the caller already knows
        it, so planning skips the hash."""
        self._require_open()
        if record:
            raise not_ported("record")
        tg = self._as_taskgraph(graph)
        if key is None:
            from ..replay.graph_key import graph_key
            key = graph_key(tg)
        return Plan(mode="warm", n_workers=self.workers, policy=self.policy,
                    graph=tg, key=key, digest=key.digest,
                    reason="dynamic scheduling on warm leased workers")

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
        returns a :class:`RunReport`."""
        if plan is None:
            if graph is None:
                raise TypeError("run() needs a graph or a plan")
            plan = self.plan(graph, record=record, key=key)
        tg = self._as_taskgraph(graph) if graph is not None else plan.graph
        if plan.mode != "warm":
            raise PlanError(f"unknown plan mode {plan.mode!r}")
        with self._lock:
            self._require_open()
            t0 = time.perf_counter()
            rt = self._dynamic_runtime()
            results = rt.run(tg, timeout=timeout)
            return RunReport(results=results, plan=plan,
                             wall_s=time.perf_counter() - t0,
                             scheduler=self.scheduler, n_workers=self.workers,
                             stats=dict(rt.last_stats))

    def execute(self, plan: Plan, *, timeout: float = 300.0) -> RunReport:
        """Alias: run a prepared plan against its own graph."""
        return self.run(plan=plan, timeout=timeout)

    def map(self, builder, inputs, *, key: Optional[Any] = None,
            timeout: float = 300.0, procs: Optional[int] = None):
        """Run a sweep of same-shaped graphs through one plan: ``builder``
        maps each input to a graph; the first graph is planned once and the
        plan is reused for every later input.  Returns the per-input
        :class:`RunReport` list."""
        self._require_open()
        if procs is not None:
            raise not_ported("procs")
        reports = []
        plan: Optional[Plan] = None
        for x in inputs:
            g = self._as_taskgraph(builder(x))
            if plan is None:
                plan = self.plan(g, key=key)
            reports.append(self.run(graph=g, plan=plan, timeout=timeout))
        return reports
