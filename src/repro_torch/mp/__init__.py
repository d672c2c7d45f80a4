"""Multi-process execution pool: processes for parallelism, recordings
for dispatch.

The in-process executors hit a single-interpreter ceiling: every dispatch
path contends on the GIL, so adding worker *threads* stops buying
parallelism (on the card every path is host-bound: the threads that
enqueue kernels wait on each other, not on the device).  This package shards
work across worker *processes* instead — each child hosts its own shared
:class:`~repro_torch.exec.core.ExecutorCore` + serving pool — while recordings
and compiled-plan metadata ship through the existing on-disk
:class:`~repro_torch.replay.cache.GraphCache`, so children replay warm without
paying their own recording runs.

Entry points:

* :class:`ProcessPool` / :class:`WorkerSpec` — the raw pool (spawn-safe
  request pipe, seq-matched :class:`RunFuture` results, daemon children
  that die with the parent);
* ``Session(procs=N)`` routes :meth:`~repro_torch.api.session.Session.map`
  through the pool and exposes :meth:`Session.process_pool`;
* ``ContinuousBatchingEngine(procs=N, fns_ref=...)`` shards serving
  requests by rid across child engines with bit-identical per-request
  streams;
* :func:`callable_ref` / :func:`resolve_ref` — the "code ships by import
  reference, never by pickle" contract.

On a CUDA device each child opens its own context on the same card.
Without MPS the contexts take turns on the device, so kernels of two
processes do not overlap: what the children add is host parallelism.
Data crosses the pipe as numpy arrays, never as torch tensors
(:func:`repro_torch.mp.tasks.portable`).
"""

from .futures import FutureTimeout, RunFuture, WorkerDied, WorkerError
from .pool import ProcessPool, WorkerSpec, callable_ref, resolve_ref

__all__ = [
    "FutureTimeout",
    "ProcessPool",
    "RunFuture",
    "WorkerDied",
    "WorkerError",
    "WorkerSpec",
    "callable_ref",
    "resolve_ref",
]
