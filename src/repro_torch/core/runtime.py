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
        Repeated calls reuse the same warm worker threads.  ``record=True``
        needs record-and-replay, which is not ported yet."""
        if record:
            from ..api.session import not_ported
            raise not_ported("record")
        graph.validate()
        return self._core.run(self._dispatch, graph, timeout=timeout)

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


def run_graph(
    graph: TaskGraph,
    n_workers: int,
    *,
    policy: str = "hybrid",
    gang_default: bool = True,
    seed: int = 0,
    timeout: float = 300.0,
) -> Dict[int, Any]:
    """The v1 convenience entry point: one dynamic execution on a
    short-lived :class:`~repro_torch.api.Session` lease; returns
    ``{tid: result}``.  The reference's ``record=``/``replay=``/``cache=``/
    ``pool=``/``trace=`` keywords arrive with record-and-replay and tracing
    (see :mod:`repro_torch.api.session`)."""
    from ..api.session import Session

    with Session(n_workers, policy=policy, gang_default=gang_default,
                 seed=seed) as session:
        return session.run(graph, timeout=timeout).results
