"""Low-contention replay of a recorded task-graph execution.

Since the unified-executor refactor this module is a thin facade: the
scheduling logic (preallocated run lists, atomic claims and dep counters,
recorded gang placements with monotonic issue order, run-ahead,
stall-triggered dynamic fallback) lives in
:class:`~repro_torch.exec.replay.ReplayDispatch`, and the worker substrate
(persistent threads, park/wake, deadlock detection) is the shared
:class:`~repro_torch.exec.core.ExecutorCore` — the same substrate the dynamic
:class:`~repro_torch.core.runtime.Runtime` runs on.

One executor owns (or leases) a worker pool sized to the recording; call
:meth:`ReplayExecutor.run` once per graph instance (same structure, e.g.
each iteration of a factorization sweep).  With ``core=`` the executor
leases warm workers from a shared core (the serving pool keeps one core
per worker count and any number of per-shape executors on top of it);
without, it owns a private core.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..exec.core import ExecutorCore
from ..exec.replay import ReplayDispatch, ReplayError
from ..core.taskgraph import TaskGraph
from .recording import Recording

__all__ = ["ReplayError", "ReplayExecutor", "replay_graph"]


class ReplayExecutor:
    """Re-execute task graphs from a :class:`Recording`.

    Use as a context manager or call :meth:`shutdown`.  ``shutdown`` on an
    executor leasing a shared ``core`` releases the lease but leaves the
    core's threads warm for other lessees.
    """

    def __init__(
        self,
        recording: Recording,
        *,
        stall_timeout: float = 1e-3,
        block_poll: float = 0.05,
        check_digest: bool = True,
        trace: bool = False,
        core: Optional[ExecutorCore] = None,
    ):
        """``trace=True`` is the reference's flight-recorder trace, which
        the port does not assemble yet: it raises ``NotImplementedError``
        (ROADMAP Queue A item 5)."""
        if trace:
            from ..api.session import not_ported
            raise not_ported("trace")
        if core is not None and core.n_workers != recording.n_workers:
            raise ValueError(
                f"shared core has {core.n_workers} workers but the recording "
                f"was made at {recording.n_workers}")
        self.recording = recording
        self.n_workers = recording.n_workers
        self.stall_timeout = stall_timeout
        self.block_poll = block_poll
        self.check_digest = check_digest

        self._core = core if core is not None else ExecutorCore(
            recording.n_workers, block_poll=block_poll, name="replay-worker")
        self._owns_core = core is None
        self._dispatch = ReplayDispatch(recording, stall_timeout=stall_timeout)

    # ------------------------------------------------------------------
    # lifecycle
    @property
    def core(self) -> ExecutorCore:
        return self._core

    def start(self) -> None:
        self._core.start()

    def shutdown(self) -> None:
        if self._owns_core:
            self._core.shutdown()

    def __enter__(self) -> "ReplayExecutor":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # introspection (deviation stats drive the pool's adaptive re-recording)
    @property
    def stats(self) -> Dict[str, int]:
        return self._dispatch.stats

    @property
    def issued_gang_ids(self):
        return self._dispatch.issued_gang_ids

    # ------------------------------------------------------------------
    def run(self, graph: TaskGraph, timeout: float = 300.0) -> Dict[int, Any]:
        """Execute ``graph`` following the recording; returns {tid: result}."""
        self.recording.validate_against(graph, check_digest=self.check_digest)
        return self._core.run(self._dispatch, graph, timeout=timeout)


def replay_graph(
    graph: TaskGraph,
    recording: Recording,
    *,
    timeout: float = 300.0,
    stall_timeout: float = 1e-3,
    check_digest: bool = True,
) -> Dict[int, Any]:
    """Convenience: replay ``graph`` from ``recording`` on a fresh executor."""
    ex = ReplayExecutor(recording, stall_timeout=stall_timeout,
                        check_digest=check_digest)
    with ex:
        return ex.run(graph, timeout=timeout)
