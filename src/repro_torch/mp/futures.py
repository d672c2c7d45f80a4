"""Futures and failure types for the multi-process execution pool.

A :class:`RunFuture` is the parent-side handle for one request shipped to a
worker process (or queued on the session's async submit thread): the
submitting thread gets it back immediately and the dispatcher resolves it
out of order when the child's response arrives.  Deliberately tiny — a
``threading.Event`` plus a result slot — because the pool's dispatcher
resolves futures from its own reader thread and never needs executor
machinery, and because :meth:`RunFuture.result` with a ``timeout`` is the
parent's thread-method watchdog over a child that wedged (the child cannot
be interrupted from here; the *wait* can).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

__all__ = ["FutureTimeout", "RunFuture", "WorkerDied", "WorkerError"]


class FutureTimeout(TimeoutError):
    """``RunFuture.result(timeout=...)`` expired before the worker replied."""


class WorkerDied(RuntimeError):
    """The worker process holding this request died before replying.

    Carries ``proc`` (the pool index of the dead worker) so callers can
    reroute the work — the serving engine re-serves the request in-process.
    """

    def __init__(self, proc: int, detail: str = ""):
        self.proc = proc
        super().__init__(
            f"worker process {proc} died{': ' + detail if detail else ''}")


class WorkerError(RuntimeError):
    """The task raised inside the worker process.

    ``kind`` is the remote exception's type name and ``remote_traceback``
    the formatted child-side traceback (exception *objects* do not cross
    the pipe — task bodies may raise anything, picklable or not).
    """

    def __init__(self, kind: str, message: str, remote_traceback: str = ""):
        self.kind = kind
        self.remote_traceback = remote_traceback
        super().__init__(f"{kind}: {message}")


class RunFuture:
    """One pending result, resolved exactly once by the dispatcher."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self._result: Any = None
        self._exception: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._callbacks: List[Callable[["RunFuture"], None]] = []

    # ------------------------------------------------------------------
    # producer side (dispatcher / submit worker)
    def set_result(self, value: Any) -> None:
        with self._lock:
            if self._event.is_set():
                return                      # first resolution wins
            self._result = value
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self)

    def set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._exception = exc
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self)

    # ------------------------------------------------------------------
    # consumer side
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until resolved; raises the worker's failure, or
        :class:`FutureTimeout` when ``timeout`` seconds pass first."""
        if not self._event.wait(timeout):
            raise FutureTimeout(
                f"no result within {timeout}s (worker busy, wedged, or "
                "starved — the request itself is still outstanding)")
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise FutureTimeout(f"no result within {timeout}s")
        return self._exception

    def add_done_callback(self, fn: Callable[["RunFuture"], None]) -> None:
        """Run ``fn(self)`` on resolution (immediately if already done);
        called from the resolving thread."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)
