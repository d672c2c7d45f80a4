"""Fused segments captured as CUDA graphs, bound to executor-owned storage.

The reference package wraps a fused segment in ``jax.jit``; on a CUDA
device the port captures the segment's kernel sequence once as a
``torch.cuda.CUDAGraph`` and replays it, so the segment's tens of kernel
launches cost one graph launch.  Four properties make that safe:

* **Nothing runs twice.**  Capture records work without running it, so the
  segment's first run captures and then replays at once; the tile updates
  are in place (``out=c``), and no eager warm-up call ever touches real
  tiles.  Library handles and workspaces are made before the first capture
  by throw-away calls on scratch tensors (:func:`prepare_thread`).
* **Storage the executor owns.**  A graph reads and writes fixed
  addresses, but every same-digest graph brings tiles of its own.  A
  :class:`DeviceBinding` owns one tensor per state key present at the
  start of a run: :meth:`DeviceBinding.bind` copies the run's tiles into
  them with one ``torch._foreach_copy_`` and rebinds the state's keys to
  them, and :meth:`DeviceBinding.release` copies the final values back
  into the run's own tiles and restores the keys.  Opaque bodies (the
  LU/QR panels) look tiles up in the same state, so they see the tensors
  the graphs do.  No value a run leaves behind aliases executor memory, so
  a factor stays intact when a later run replays the same graphs.
* **Inputs made between runs are staged.**  A segment input that is
  neither executor-owned nor written by an earlier captured segment (QR's
  ``("vt", k)`` reflectors, uploaded afresh by every panel) is copied into
  a buffer of the segment's own before each replay.
* **Each graph keeps its memory.**  Every graph captures into a memory
  pool of its own and holds every tensor it hands to the state, so no
  later capture is ever given memory that a graph writes, whatever order
  the graphs replay in.  Two segments of one structure therefore never
  share buffers.

Capture runs on a side stream with ``capture_error_mode="thread_local"``
(parked workers and the panels' gang threads may touch CUDA meanwhile);
replays, staging copies and opaque bodies run on the caller's current
stream, which keeps their order.  Kernel launches made while capturing are
tallied per graph and counted at every replay
(:func:`repro_torch.kernels.cuda_lib.capturing_launches`).  A capture or
replay error raises as it is: it is not a ``CompiledRunError``, so no
caller falls back from it to another scheduler.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set

import torch

from ..kernels import cuda_lib

__all__ = ["DeviceBinding", "SegmentGraph", "capture_stream",
           "prepare_thread"]

_streams: Dict[int, torch.cuda.Stream] = {}
_streams_lock = threading.Lock()
_prepared = threading.local()


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every capture on ``device`` uses (a graph cannot be
    captured on the default stream)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _streams_lock:
        stream = _streams.get(index)
        if stream is None:
            stream = _streams[index] = torch.cuda.Stream(device=index)
        return stream


def prepare_thread(stream: torch.cuda.Stream, device: torch.device) -> None:
    """Make this thread's cuBLAS and cuSOLVER handles, and the cuBLAS
    workspace of ``stream``, with throw-away calls on scratch tensors before
    the thread's first capture on ``stream``: creating them inside a
    capture is not allowed."""
    done = getattr(_prepared, "streams", None)
    if done is None:
        done = _prepared.streams = set()
    if stream.cuda_stream in done:
        return
    with torch.cuda.stream(stream):
        eye = torch.eye(2, dtype=torch.float64, device=device)
        torch.linalg.cholesky_ex(eye)
        torch.linalg.solve_triangular(eye, eye, upper=True, left=False)
    stream.synchronize()
    done.add(stream.cuda_stream)


def _leaves(value: Any, where: Any) -> List[torch.Tensor]:
    """The tensors of a state value: a tensor or a tuple of tensors."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _leaves(v, where)]
    raise TypeError(f"a captured segment reads and writes tensors only; "
                    f"state key {where!r} holds {type(value).__name__}")


def _clone(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return value.clone()
    if isinstance(value, (tuple, list)):
        return type(value)(_clone(v) for v in value)
    return value


class DeviceBinding:
    """The storage a compiled executor's captured graphs read and write.

    ``keys`` are the state keys the plan's capturable segments read or
    write.  Those present as CUDA tensors at the first run are *bound*: the
    binding owns one tensor for each, for as long as it lives, and every
    run goes through :meth:`bind` and :meth:`release`.  ``stable`` tensors
    keep their storage from run to run (the owned tensors and every tensor
    a captured graph hands to the state); captures read them in place."""

    def __init__(self, keys: Sequence[Any]):
        self.keys = tuple(keys)
        self._on_cuda: Optional[bool] = None
        self._bound: List[Any] = []
        self._owned: List[torch.Tensor] = []
        self._stable: Set[int] = set()
        self.device: Optional[torch.device] = None
        #: graphs captured so far, and the host seconds they took
        self.captured = 0
        self.capture_s = 0.0

    def bind(self, state) -> Optional[List[torch.Tensor]]:
        """Copy the run's tensors into the owned ones and rebind the state
        to them; returns the run's own tensors for :meth:`release`, or
        ``None`` when the state does not live on CUDA (nothing is
        captured then)."""
        if self._on_cuda is None:
            present = []
            for k in self.keys:
                try:
                    v = state[k]
                except KeyError:
                    continue
                if isinstance(v, torch.Tensor):
                    present.append((k, v))
            self._on_cuda = any(v.is_cuda for _, v in present)
            if not self._on_cuda:
                return None
            self._bound = [k for k, _ in present]
            self.device = present[0][1].device
            self._owned = [torch.empty_like(v) for _, v in present]
            self._stable.update(id(t) for t in self._owned)
        elif not self._on_cuda:
            return None
        mine = [state[k] for k in self._bound]
        torch._foreach_copy_(self._owned, mine)
        for k, t in zip(self._bound, self._owned):
            state[k] = t
        return mine

    def release(self, state, mine: List[torch.Tensor]) -> None:
        """Copy the final values into the run's own tensors and rebind the
        state to them, so the run keeps nothing of the executor's."""
        torch._foreach_copy_(mine, [state[k] for k in self._bound])
        for k, t in zip(self._bound, mine):
            state[k] = t

    def is_stable(self, t: torch.Tensor) -> bool:
        return id(t) in self._stable

    def mark_stable(self, tensors: Sequence[torch.Tensor]) -> None:
        self._stable.update(id(t) for t in tensors)


class SegmentGraph:
    """One fused segment captured as a CUDA graph (see the module notes).

    Made at the segment's first run on CUDA: the external inputs are read
    in place where they are stable, or staged into buffers of the graph's
    own; the kernel sequence is captured; its outputs become stable."""

    __slots__ = ("graph", "direct", "staged_keys", "static", "outs", "res",
                 "out_keys", "tids", "launches", "capture_s")

    def __init__(self, segment, state, binding: DeviceBinding):
        t0 = time.perf_counter()
        device = binding.device
        stream = capture_stream(device)
        prepare_thread(stream, device)
        inputs = []
        self.direct = []            # (key, value) read in place
        self.staged_keys = []
        self.static: List[torch.Tensor] = []
        for k in segment.ext_keys:
            v = state[k]
            leaves = _leaves(v, k)
            if all(binding.is_stable(t) for t in leaves):
                self.direct.append((k, v))
                inputs.append(v)
            else:
                s = _clone(v)
                self.staged_keys.append(k)
                self.static.extend(_leaves(s, k))
                inputs.append(s)
        self.out_keys = segment.out_keys
        self.tids = segment.tids
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream), \
                cuda_lib.capturing_launches() as tally:
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                outs, res = segment._run(*inputs)
            except BaseException:
                try:
                    self.graph.capture_end()
                except Exception:   # noqa: BLE001 - the first error is raised
                    pass
                raise
            self.graph.capture_end()
        self.outs = outs
        self.res = res
        self.launches = dict(tally)
        binding.mark_stable([t for k, v in zip(self.out_keys, outs)
                             for t in _leaves(v, k)])
        self.capture_s = time.perf_counter() - t0
        binding.captured += 1
        binding.capture_s += self.capture_s

    def replay(self, state, results: Dict[int, Any]) -> None:
        for k, v in self.direct:
            if state[k] is not v:
                raise RuntimeError(
                    f"state key {k!r} was rebound since its segment was "
                    "captured: the captured graph would read stale storage")
        if self.static:
            torch._foreach_copy_(
                self.static,
                [t for k in self.staged_keys for t in _leaves(state[k], k)])
        self.graph.replay()
        cuda_lib.add_launches(self.launches)
        for k, v in zip(self.out_keys, self.outs):
            state[k] = v
        for tid, rv in zip(self.tids, self.res):
            results[tid] = _clone(rv)
