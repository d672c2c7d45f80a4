"""Unified executor core: one worker substrate under every scheduler.

:class:`ExecutorCore` owns persistent worker threads (park/wake between
runs), unified :class:`GangRegion` parallel regions (blocking barriers with
centralized blocked-thread accounting and Fig.-1 deadlock detection), and a
pluggable :class:`DispatchStrategy`.  The port carries
:class:`DynamicDispatch` (per-worker work-stealing deques, Algorithm-2
victim selection, Algorithm-1 gang reservation); the replay dispatch
arrives with record-and-replay.

:class:`CoreRegistry` / :func:`shared_core` add process-global core
sharing: one refcounted core per worker count serves every session in the
process.
"""

from .. import core as _core  # noqa: F401  (initialize repro_torch.core first:
# repro_torch.core.runtime imports repro_torch.exec.core, so letting the
# package cycle start HERE keeps ``import repro_torch.exec`` working as a
# first import)
from .core import DispatchStrategy, ExecutorCore, GangRegion
from .dynamic import DynamicDispatch
from .registry import REGISTRY, CoreRegistry, release_shared_core, shared_core

__all__ = [
    "CoreRegistry",
    "DispatchStrategy",
    "DynamicDispatch",
    "ExecutorCore",
    "GangRegion",
    "REGISTRY",
    "release_shared_core",
    "shared_core",
]
