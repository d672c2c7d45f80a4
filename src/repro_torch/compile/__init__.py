"""Compile stable recordings into fused execution plans.

A validated :class:`~repro_torch.replay.Recording` is a complete execution
plan; this package lowers one into a serial program of fused segments plus
inline opaque bodies, executed by a single-threaded driver with Python only
at segment boundaries — the record-once / re-execute-at-near-zero-overhead
endgame (Taskgraph, PAPERS.md) that reverses the GIL-bound multi-worker
dispatch collapse.  On a CUDA device each capturable segment runs as one
CUDA graph (:mod:`repro_torch.compile.capture`); on the CPU it runs its
composed callable.
"""

from .driver import CompiledExecutor, CompiledRunError
from .fuse import FuseSpec, FusedSegment, fuse_spec_of
from .plan import CompiledPlan, CompiledPlanMeta, CompileError, compile_recording

__all__ = [
    "CompiledExecutor",
    "CompiledRunError",
    "CompiledPlan",
    "CompiledPlanMeta",
    "CompileError",
    "FuseSpec",
    "FusedSegment",
    "compile_recording",
    "fuse_spec_of",
]
