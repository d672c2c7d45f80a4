"""The flight recorder: per-worker lock-free ring buffers of point events.

Design constraints (Taskgraph's low-contention argument — instrumentation
must be cheap enough to leave on):

* **one writer per ring** — worker ``w`` appends only to ``rings[w]``, so
  no lock is needed on the hot path: a ring append is one ``perf_counter``
  call, one tuple pack, one CPython-atomic list store and an int add.
  Events emitted from *non-worker* threads (a channel send from outside
  the pool, a background re-record) go to one extra "external" ring,
  guarded by a small lock (those paths are rare and never hot).
* **bounded memory** — each ring holds ``capacity`` events; older events
  are overwritten and counted as dropped (surfaced on the assembled
  :class:`~repro_torch.obs.trace.RuntimeTrace`).
* **near-zero cost when off** — executors hold :data:`NULL_RECORDER`, a
  module-level singleton whose ``emit`` does nothing.  The hot loops do
  ``self.recorder.emit(...)`` unconditionally: no branch, one attribute
  call.  The signature is positional and fixed (no ``*args``) so a no-op
  emit allocates nothing — tested in ``tests/test_obs.py``.

Recorders register in a ``WeakSet`` so the test suite can assert no trace
buffer outlives its session (``live_recorders``).
"""

from __future__ import annotations

import threading
import weakref
from time import perf_counter
from typing import List, Tuple

from ..core.tracing import EV_FRAME_RESUME, EV_FRAME_SUSPEND, EV_TASK_START

__all__ = ["FlightRecorder", "NullRecorder", "NULL_RECORDER",
           "live_recorders"]

#: raw record: (t, event kind, label, a, b) — worker id is the ring index
RawEvent = Tuple[float, str, str, int, int]

_live: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()


def live_recorders() -> List["FlightRecorder"]:
    """Every :class:`FlightRecorder` still referenced somewhere — the
    suite-level leak check asserts this drains when sessions close."""
    return list(_live)


class _Ring:
    """Fixed-capacity single-writer ring of raw events."""

    __slots__ = ("buf", "cap", "n")

    def __init__(self, capacity: int):
        self.cap = capacity
        self.buf: List[RawEvent] = [None] * capacity  # type: ignore[list-item]
        self.n = 0

    def append(self, item: RawEvent) -> None:
        self.buf[self.n % self.cap] = item
        self.n += 1

    def reset(self) -> None:
        self.n = 0

    @property
    def dropped(self) -> int:
        return max(0, self.n - self.cap)

    def snapshot(self) -> List[RawEvent]:
        """Events in emission order (oldest surviving first)."""
        n, cap, buf = self.n, self.cap, self.buf
        if n <= cap:
            return [e for e in buf[:n] if e is not None]
        head = n % cap
        return [e for e in buf[head:] + buf[:head] if e is not None]


class NullRecorder:
    """The off-switch: every method is a no-op.  ``emit`` keeps the exact
    positional signature of :meth:`FlightRecorder.emit` — fixed arity, no
    ``*args`` (packing a ``*args`` tuple would allocate per call).  The
    ``emit_*`` helpers exist so hot call sites pass raw objects instead of
    building label strings: with tracing off, a call allocates nothing."""

    __slots__ = ()
    enabled = False

    def emit(self, worker, kind, label="", a=-1, b=-1):
        return None

    def emit_task_start(self, worker, task):
        return None

    def emit_frame_resume(self, worker, frame):
        return None

    def emit_frame_suspend(self, worker, frame, request):
        return None

    def emit_resource(self, worker, kind, task, n_res=0):
        return None

    def begin_run(self):
        return None


#: module-level singleton installed on every executor while tracing is off
NULL_RECORDER = NullRecorder()


class FlightRecorder:
    """Per-worker event rings for one executor (dispatch strategy).

    ``emit(worker, kind, label, a, b)`` timestamps with ``perf_counter``
    and appends to ``worker``'s ring; ``worker=-1`` routes to the shared
    external ring (non-worker threads).  ``begin_run`` resets the rings so
    a snapshot only ever covers the current run.
    """

    __slots__ = ("n_workers", "rings", "_ext_lock", "__weakref__")

    enabled = True

    def __init__(self, n_workers: int, capacity: int = 1 << 15, *,
                 owned: bool = True):
        self.n_workers = n_workers
        # ring [-1] is the external ring: Python's negative indexing makes
        # `rings[worker]` correct for worker ids in [-1, n_workers)
        self.rings = [_Ring(capacity) for _ in range(n_workers + 1)]
        self._ext_lock = threading.Lock()
        if owned:               # the process's span recorder is no session's
            _live.add(self)

    def emit(self, worker, kind, label="", a=-1, b=-1):
        if worker >= 0:
            self.rings[worker].append((perf_counter(), kind, label, a, b))
        else:
            with self._ext_lock:
                self.rings[-1].append((perf_counter(), kind, label, a, b))

    def emit_at(self, t, kind, label, a, b):
        """An event on the external ring stamped by the caller, whose one
        clock read also feeds its own accounting
        (:mod:`repro_torch.obs.spans`)."""
        with self._ext_lock:
            self.rings[-1].append((t, kind, label, a, b))

    # -- hot-path helpers: label building lives HERE, not at call sites,
    # so a NullRecorder call allocates nothing ---------------------------
    def emit_task_start(self, worker, task):
        self.emit(worker, EV_TASK_START, task.kind + "|" + task.name,
                  task.tid, 0)

    def emit_frame_resume(self, worker, frame):
        task = frame.task
        self.emit(worker, EV_FRAME_RESUME, task.kind + "|" + task.name,
                  task.tid, frame.resumes)

    def emit_frame_suspend(self, worker, frame, request):
        uid = request.source_uid()
        label = request.describe()
        if uid >= 0:
            label = f"{label}@c{uid}"     # channel/event identity
        self.emit(worker, EV_FRAME_SUSPEND, label, frame.task.tid,
                  frame.resumes + 1)

    def emit_resource(self, worker, kind, task, n_res=0):
        """Resource acquire/wait/release for ``task`` (kind is one of the
        EV_RESOURCE_* constants; label building stays off the null path)."""
        self.emit(worker, kind, task.name, task.tid, n_res)

    def begin_run(self):
        for ring in self.rings:
            ring.reset()

    @property
    def dropped(self) -> int:
        return sum(r.dropped for r in self.rings)

    def snapshot(self) -> List[Tuple[int, float, str, str, int, int]]:
        """All events of the current run as ``(worker, t, kind, label, a,
        b)`` tuples, globally sorted by timestamp.  External-ring events
        come back with ``worker = -1``."""
        out: List[Tuple[int, float, str, str, int, int]] = []
        for w in range(self.n_workers):
            for (t, kind, label, a, b) in self.rings[w].snapshot():
                out.append((w, t, kind, label, a, b))
        for (t, kind, label, a, b) in self.rings[-1].snapshot():
            out.append((-1, t, kind, label, a, b))
        out.sort(key=lambda e: e[1])
        return out
