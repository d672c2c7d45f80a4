"""Process-global registry of shared :class:`ExecutorCore` substrates.

Several :class:`~repro_torch.replay.pool.ReplayPool`\\ s (multi-tenant serving: one
pool per model / per tenant) used to spawn their own cores, so total worker
threads grew with the number of *pools* times worker counts.  The registry
caps that at one core per **worker count per process**: every pool (and any
other facade passing ``core=``) leases the same warm threads.

Leases are refcounted: :func:`shared_core` bumps the count and starts the
core lazily; :func:`release_shared_core` drops it and shuts the core's
threads down when the last lessee leaves — which is what keeps the test
suite's worker-thread leak check meaningful.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from .core import ExecutorCore


class CoreRegistry:
    """Refcounted map of ``worker count -> shared ExecutorCore``."""

    def __init__(self, *, name_prefix: str = "exec-core"):
        self._lock = threading.Lock()
        self._cores: Dict[int, ExecutorCore] = {}
        self._refs: Dict[int, int] = {}
        self._name_prefix = name_prefix

    def acquire(self, n_workers: int, *, block_poll: float = 0.05) -> ExecutorCore:
        """Lease the process-wide core for ``n_workers`` (created and
        started on first acquire)."""
        if n_workers < 1:
            raise ValueError(f"cannot share a core of {n_workers} workers")
        with self._lock:
            core = self._cores.get(n_workers)
            if core is None:
                core = ExecutorCore(
                    n_workers, block_poll=block_poll,
                    name=f"{self._name_prefix}{n_workers}")
                self._cores[n_workers] = core
                self._refs[n_workers] = 0
                core.start()
            self._refs[n_workers] += 1
            return core

    def release(self, core: ExecutorCore) -> None:
        """Drop one lease; the last release shuts the core down."""
        to_shutdown: Optional[ExecutorCore] = None
        with self._lock:
            for n, c in self._cores.items():
                if c is core:
                    self._refs[n] -= 1
                    if self._refs[n] <= 0:
                        to_shutdown = self._cores.pop(n)
                        self._refs.pop(n)
                    break
        if to_shutdown is not None:
            to_shutdown.shutdown()

    def refcounts(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._refs)

    def shutdown_all(self) -> None:
        """Force-stop every registered core regardless of refcounts.

        For process teardown paths where no lessee will ever release —
        a :mod:`repro_torch.mp` worker child exiting on parent death must not
        leave worker threads spinning while the interpreter finalizes.
        Leases handed out before this call become dead handles; the
        registry itself stays usable (a later acquire builds fresh cores).
        """
        with self._lock:
            cores = list(self._cores.values())
            self._cores.clear()
            self._refs.clear()
        for core in cores:
            core.shutdown()

    def __len__(self) -> int:
        with self._lock:
            return len(self._cores)


#: The process-global registry every ReplayPool leases from by default.
REGISTRY = CoreRegistry()


def shared_core(n_workers: int) -> ExecutorCore:
    """Lease the process-global shared core for ``n_workers`` workers.
    Pair every call with :func:`release_shared_core`."""
    return REGISTRY.acquire(n_workers)


def release_shared_core(core: ExecutorCore) -> None:
    """Release a lease taken via :func:`shared_core`."""
    REGISTRY.release(core)
