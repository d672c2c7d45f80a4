"""Futures-based task-graph construction (API v2).

The v1 construction API is positional and stringly wired: ``TaskGraph.add``
returns a :class:`~repro_torch.core.taskgraph.Task`, dependencies are declared by
hand (``deps=[...]``), and results come back as a bare ``{tid: result}``
dict the caller indexes by remembered integer ids.  This module makes the
dataflow explicit:

* :meth:`Graph.add` returns a :class:`TaskHandle` — a *future* for the
  task's result;
* a handle can be passed **as an argument** to a downstream task (including
  inside nested tuples/lists/dicts); the dependency edge is inferred
  automatically and the handle is replaced by the producing task's actual
  result when the consumer runs;
* inferred dependencies compose with explicit ``deps=`` (side-effect
  ordering — tile stores, decode state — still wants explicit edges);
* ``handle.result(report)`` / ``report[handle]`` replaces tid-keyed dict
  indexing on the :class:`~repro_torch.api.session.RunReport`.

:class:`Graph` *is a* :class:`~repro_torch.core.taskgraph.TaskGraph`: every
consumer of the v1 type (``graph_key``, recordings, the executors, the
simulator) accepts it unchanged, and a ``Graph`` built with the same names/
kinds/costs/edges as a v1 ``TaskGraph`` has the identical structural digest
— recordings are interchangeable across the two construction styles.

Body calling convention
-----------------------

``Graph.add(fn, *args)`` calls ``fn`` with ``args`` resolved (handles
replaced by results).  If ``fn``'s first parameter is named ``ctx`` it
additionally receives the :class:`~repro_torch.core.taskgraph.TaskContext` in
front (``fn(ctx, *resolved)``) — which is also how generator bodies get at
the suspension APIs (``yield ctx.recv(...)`` / ``ctx.send`` /
``ctx.wait_any``).  A zero-arg ``fn`` whose first parameter is not ``ctx``
is called as ``fn()``.  v1-style bodies (single ``ctx`` parameter) pass
through unwrapped, byte-for-byte.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, List, Optional, Sequence

from ..core.taskgraph import ParallelSpec, Task, TaskContext, TaskGraph

__all__ = ["Graph", "TaskHandle"]


class TaskHandle:
    """A future for one task's result, returned by :meth:`Graph.add`.

    Pass it (possibly nested in tuples/lists/dicts) as an argument to a
    later :meth:`Graph.add` call to both declare the dependency and receive
    the producing task's result; read it out of a finished run with
    ``report[handle]`` or ``handle.result(report)``.
    """

    __slots__ = ("_graph", "_task")

    def __init__(self, graph: "Graph", task: Task):
        self._graph = graph
        self._task = task

    @property
    def task(self) -> Task:
        return self._task

    @property
    def tid(self) -> int:
        return self._task.tid

    @property
    def name(self) -> str:
        return self._task.name

    @property
    def graph(self) -> "Graph":
        return self._graph

    def result(self, report: Any) -> Any:
        """This task's result out of a :class:`~repro_torch.api.session.RunReport`
        (or any mapping-like report with a ``result``/``__getitem__``)."""
        if hasattr(report, "result"):
            return report.result(self)
        return report[self.tid]

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, TaskHandle):
            return NotImplemented
        return self._graph is other._graph and self.tid == other.tid

    def __hash__(self) -> int:
        return hash((id(self._graph), self._task.tid))

    def __repr__(self) -> str:
        return f"TaskHandle({self._task.name!r}, tid={self._task.tid})"


def _collect_handles(obj: Any, out: List[TaskHandle]) -> None:
    """Find every :class:`TaskHandle` in a nested argument structure, in
    deterministic (left-to-right, insertion-ordered) discovery order.

    Only tuples, lists and dict values are traversed.  Handles inside
    *sets* are rejected loudly (sets are unordered and results may be
    unhashable — there is no sound way to resolve them); handles buried
    in custom objects are invisible to inference — declare those edges
    with explicit ``deps=``."""
    if isinstance(obj, TaskHandle):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _collect_handles(v, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _collect_handles(v, out)
    elif isinstance(obj, (set, frozenset)):
        if any(isinstance(v, TaskHandle) for v in obj):
            raise TypeError(
                "TaskHandle inside a set cannot be resolved (unordered, "
                "and results may be unhashable) — pass a tuple/list, or "
                "declare the edge with deps=")


def _resolve(obj: Any, ctx: TaskContext) -> Any:
    """Replace handles with their results, preserving the nesting shape."""
    if isinstance(obj, TaskHandle):
        return ctx.result(obj.tid)
    if isinstance(obj, tuple):
        return tuple(_resolve(v, ctx) for v in obj)
    if isinstance(obj, list):
        return [_resolve(v, ctx) for v in obj]
    if isinstance(obj, dict):
        return {k: _resolve(v, ctx) for k, v in obj.items()}
    return obj


def _wants_ctx(fn: Callable[..., Any]) -> bool:
    """Does ``fn``'s first parameter ask for the TaskContext?  Unknowable
    signatures (builtins, some partials) default to the v1 convention."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return True
    first = next(iter(params), None)
    return first == "ctx"


class Graph(TaskGraph):
    """A :class:`~repro_torch.core.taskgraph.TaskGraph` whose :meth:`add` returns
    :class:`TaskHandle` futures and infers dependencies from handle
    arguments.  Drop-in everywhere a ``TaskGraph`` is accepted."""

    def add(  # type: ignore[override]
        self,
        fn: Optional[Callable[..., Any]] = None,
        *args: Any,
        deps: Sequence[Any] = (),
        name: Optional[str] = None,
        kind: str = "compute",
        cost: float = 1.0,
        priority: int = 0,
        parallel: Optional[ParallelSpec] = None,
        uses: Sequence[Any] = (),
        uses_shared: Sequence[Any] = (),
        **meta: Any,
    ) -> TaskHandle:
        """Add a task; returns its :class:`TaskHandle`.

        ``args`` are passed to ``fn`` at execution time with any contained
        handles resolved to the producing tasks' results; each such handle
        contributes an inferred dependency edge.  Handles are discovered
        through nested tuples/lists/dicts only — a handle hidden inside a
        custom object is NOT seen (declare that edge via ``deps=``), and a
        handle inside a set raises at build time.  ``deps`` accepts
        handles, :class:`~repro_torch.core.taskgraph.Task` objects or raw tids
        and is kept *in front of* the inferred edges (explicit ordering
        intent first).

        ``uses`` / ``uses_shared`` declare
        :class:`~repro_torch.resources.Resource` conflicts (exclusive / shared):
        tasks sharing a resource are mutually excluded at run time without
        any ordering edge between them.
        """
        inferred: List[TaskHandle] = []
        _collect_handles(args, inferred)
        for h in inferred:
            if h._graph is not self:
                raise ValueError(
                    f"argument handle {h!r} belongs to graph "
                    f"{h._graph.name!r}, not {self.name!r}")
        if fn is None and args:
            raise ValueError("dataflow arguments need a callable body")
        explicit = [self._dep_tid(d) for d in deps]
        dep_ids = list(dict.fromkeys(explicit + [h.tid for h in inferred]))
        task = TaskGraph.add(
            self, self._compile_body(fn, args), deps=dep_ids, name=name,
            kind=kind, cost=cost, priority=priority, parallel=parallel,
            uses=uses, uses_shared=uses_shared, **meta)
        return TaskHandle(self, task)

    def handle(self, task_or_tid: Any) -> TaskHandle:
        """Wrap an existing task (or tid) of this graph in a handle."""
        tid = self._dep_tid(task_or_tid)
        return TaskHandle(self, self.tasks[tid])

    @staticmethod
    def _dep_tid(d: Any) -> int:
        if isinstance(d, (TaskHandle, Task)):
            return d.tid
        return int(d)

    @staticmethod
    def _compile_body(
        fn: Optional[Callable[..., Any]], args: Sequence[Any],
    ) -> Optional[Callable[[TaskContext], Any]]:
        if fn is None:
            return None
        wants_ctx = _wants_ctx(fn)
        if not args:
            if wants_ctx:
                return fn           # v1 convention: untouched, zero overhead
            def body(ctx: TaskContext, _fn=fn) -> Any:
                return _fn()
            return body
        if wants_ctx:
            def body(ctx: TaskContext, _fn=fn, _args=tuple(args)) -> Any:
                return _fn(ctx, *_resolve(_args, ctx))
        else:
            def body(ctx: TaskContext, _fn=fn, _args=tuple(args)) -> Any:
                return _fn(*_resolve(_args, ctx))
        return body
