"""Unified executor core: one worker substrate under every scheduler.

:class:`ExecutorCore` owns persistent worker threads (park/wake between
runs), unified :class:`GangRegion` parallel regions (blocking barriers with
centralized blocked-thread accounting and Fig.-1 deadlock detection), and a
pluggable :class:`DispatchStrategy`:

* :class:`DynamicDispatch` — per-worker work-stealing deques, Algorithm-2
  victim selection, Algorithm-1 gang reservation (+ record-and-replay
  instrumentation);
* :class:`ReplayDispatch` — preallocated run lists, recorded gang
  placements with monotonic issue order, run-ahead and stall-triggered
  dynamic fallback.

Both dispatches execute *suspendable task frames*: generator task bodies
yield ``ctx.recv``/``ctx.wait``/``ctx.yield_`` requests and are parked
without occupying their worker (soft-blocked — excluded from Fig.-1
hard-block accounting), then resumed on any worker.  Dynamic treats resumed
frames as locality-preferring stealable work; replay reproduces the
recorded resume segmentation (``FrameResume`` run-list entries).

:class:`CoreRegistry` / :func:`shared_core` add process-global core
sharing: one refcounted core per worker count serves every pool/facade in
the process, capping threads across tenants.

The public entry points remain the facades:
:class:`~repro_torch.core.runtime.Runtime` (dynamic),
:class:`~repro_torch.replay.executor.ReplayExecutor` (replay) and
:class:`~repro_torch.replay.pool.ReplayPool` (serving) — all three lease worker
time from this substrate.
"""

from .. import core as _core  # noqa: F401  (initialize repro_torch.core first:
# repro_torch.core.runtime imports repro_torch.exec.core, so letting the
# package cycle start HERE keeps ``import repro_torch.exec`` working as a
# first import)
from .core import DispatchStrategy, ExecutorCore, GangRegion
from .dynamic import DynamicDispatch
from .registry import REGISTRY, CoreRegistry, release_shared_core, shared_core
from .replay import ReplayDispatch, ReplayError

__all__ = [
    "CoreRegistry",
    "DispatchStrategy",
    "DynamicDispatch",
    "ExecutorCore",
    "GangRegion",
    "REGISTRY",
    "ReplayDispatch",
    "ReplayError",
    "release_shared_core",
    "shared_core",
]
