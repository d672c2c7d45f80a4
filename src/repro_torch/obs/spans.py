"""Spans inside the program's top-level calls, on the flight recorder and
on the profiler's clock.

The compiled driver's runs (``repro.compiled.*``), the train step
(``repro.train.*``), flash attention's forward and backward
(``repro.flash.*``; each backward also counts its path,
``repro.flash.bwd_kernel`` or ``repro.flash.bwd_plain``), the MoE layer's
stages (``repro.moe.*``) and the serving engine's steps
(``repro.engine.*``) open spans here; every name starts with
``repro.``.

* **The switch.**  Spans are on while a torch profiler is active, and for
  a call made for a :class:`~repro_torch.api.session.Session` built with
  ``trace=True``.  A top-level call checks once (:func:`open_call`) and
  gets None when they are off: it then pays that check and nothing else.
  A top-level call made inside an open one (a compiled run inside an
  engine step) nests under it, and flash's calls follow the call they are
  made in (:func:`current`).
* **One recorder.**  Spans go to one process-level
  :class:`~repro_torch.obs.recorder.FlightRecorder`, on its external ring
  (flash's backward runs on autograd's device thread).  It is reset at
  the first call that sees a profiler running, and, while none runs, at
  every traced top-level call, so it holds one traced window.  Spans
  assume one caller thread at a time: a top-level call made on another
  thread while one is open nests under it.
* **The profiler's clock.**  While a profiler is active each span also
  enters ``torch.profiler.record_function(name)``, so it lands as a
  ``user_annotation`` in the same Chrome trace as the kernels it launched.
* **Device intervals.**  On CUDA a span records an event at its start
  and at its end, on the stream that was current when its top-level call
  opened (or the stream it names), and none in a call opened while that
  stream captured a graph.  One anchor a window (synchronise, record an
  event, read ``perf_counter``) places the events on the host's clock.
  Events are resolved only when :func:`span_trace` is read, and so are
  counters whose values are device tensors (:meth:`Spans.count_later`):
  the call that counts never waits for the device.

:func:`span_trace` assembles the window into a
:class:`~repro_torch.obs.trace.RuntimeTrace` whose ``spans`` hold one
:class:`~repro_torch.core.tracing.Event` a span, with its id, its parent,
its shared id and its device interval; ``write_trace`` exports it.
"""

from __future__ import annotations

import itertools
import sys
from time import perf_counter
from typing import Dict, List, Optional, Tuple

from ..core.tracing import EV_SPAN_BEGIN, EV_SPAN_COUNT, EV_SPAN_END
from .recorder import FlightRecorder
from .trace import RuntimeTrace, assemble

__all__ = ["Spans", "current", "open_call", "reset", "span_trace"]

#: events the window's ring holds (a span is two, a counter one)
CAPACITY = 1 << 17

_ids = itertools.count(1)
_profiler_enabled = None      # torch.autograd._profiler_enabled, once bound


def _profiling() -> bool:
    """Is a torch profiler active?  False until torch is imported."""
    global _profiler_enabled
    f = _profiler_enabled
    if f is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        f = _profiler_enabled = torch.autograd._profiler_enabled
    return f()


class _Window:
    """The traced window: the recorder, the stack of open span ids, the
    profiler marks and device events of the spans, and the anchor."""

    def __init__(self):
        self.rec = FlightRecorder(0, CAPACITY, owned=False)
        self.profiled = False                 # the window is a profiler's
        self.open: List[int] = []
        self.marks: Dict[int, object] = {}    # sid -> record_function
        self.dev: Dict[int, list] = {}        # sid -> [start, end] events
        self.pool: list = []                  # CUDA events to reuse
        self.anchor: Optional[Tuple[float, object]] = None
        self.later: list = []                 # (t, name, sid, tensor)

    def drop_open(self) -> None:
        """Forget the open spans, leaving the profiler's marks closed."""
        self.open.clear()
        for mark in reversed(list(self.marks.values())):
            mark.__exit__(None, None, None)
        self.marks.clear()

    def reset(self, profiled: bool) -> None:
        self.rec.begin_run()
        self.profiled = profiled
        self.drop_open()
        for pair in self.dev.values():
            self.pool.extend(e for e in pair if e is not None)
        self.dev.clear()
        self.later.clear()
        self.anchor = None


_window: Optional[_Window] = None
_top: Optional["Spans"] = None


def _stream_of(torch):
    """The current CUDA stream, or None off CUDA or while it captures a
    graph (no event may be recorded into a capture)."""
    if not (torch is not None and torch.cuda.is_available()
            and torch.cuda.is_initialized()):
        return None
    if torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_stream()


def _event(w: _Window, stream):
    """A timing CUDA event recorded on ``stream``."""
    ev = w.pool.pop() if w.pool else \
        sys.modules["torch"].cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


class Spans:
    """The spans of one top-level call.  :meth:`begin` and :meth:`end` a
    child (``t``, a clock read the caller also uses, makes one read feed
    both; the parent is the innermost open span), :meth:`span` one whose
    times are known already, :meth:`count` a counter of the call, and
    :meth:`close` the call's own span."""

    __slots__ = ("root", "_w", "_mirror", "_stream", "_outer")

    def __init__(self, w: _Window, mirror: bool, stream, outer: bool):
        self.root = -1
        self._w = w
        self._mirror = mirror
        self._stream = stream                 # on CUDA only
        self._outer = outer

    def begin(self, name: str, t: Optional[float] = None, *,
              mirror: bool = True, stream=None) -> int:
        """Open a child span; returns its id.  ``mirror=False`` keeps it
        out of the profiler's trace; ``stream`` (CUDA) takes its device
        events on another stream than the call's."""
        if t is None:
            t = perf_counter()
        w = self._w
        sid = next(_ids)
        parent = w.open[-1] if w.open else -1
        w.open.append(sid)
        if mirror and self._mirror:
            mark = sys.modules["torch"].autograd.profiler.record_function(
                name)
            mark.__enter__()
            w.marks[sid] = mark
        if self._stream is not None:
            w.dev[sid] = [_event(w, stream or self._stream), None]
        w.rec.emit_at(t, EV_SPAN_BEGIN, name, sid, parent)
        return sid

    def end(self, sid: int, t: Optional[float] = None, key: int = -1, *,
            stream=None) -> None:
        """Close span ``sid``; ``key`` is the id it shares with others (a
        request's rid), ``stream`` the one its start event went to."""
        if t is None:
            t = perf_counter()
        w = self._w
        if self._stream is not None:
            pair = w.dev.get(sid)
            if pair is not None:
                pair[1] = _event(w, stream or self._stream)
        mark = w.marks.pop(sid, None)
        if mark is not None:
            mark.__exit__(None, None, None)
        stack = w.open
        if stack and stack[-1] == sid:
            stack.pop()
        elif sid in stack:
            stack.remove(sid)
        w.rec.emit_at(t, EV_SPAN_END, "", sid, key)

    def span(self, name: str, t0: float, t1: float, key: int = -1) -> None:
        """A child span from ``t0`` to ``t1`` on the host alone (it began
        before it could be opened, as a request's wait in the queue)."""
        w = self._w
        sid = next(_ids)
        w.rec.emit_at(t0, EV_SPAN_BEGIN, name, sid,
                      w.open[-1] if w.open else -1)
        w.rec.emit_at(t1, EV_SPAN_END, "", sid, key)

    def count(self, name: str, value: int) -> None:
        """A counter of this call (summed over the window by name)."""
        self._w.rec.emit_at(perf_counter(), EV_SPAN_COUNT, name, self.root,
                            int(value))

    def count_later(self, name: str, value) -> None:
        """:meth:`count` of a 0-d integer tensor, kept as it is and read
        when the window is (:func:`span_trace`), so the counting call never
        waits for the device."""
        self._w.later.append((perf_counter(), name, self.root, value))

    def close(self, t: Optional[float] = None) -> None:
        """End the call's own span (and, at the top, any child an error
        left open)."""
        global _top
        self.end(self.root, t)
        if self._outer:
            self._w.drop_open()
            _top = None


def current() -> Optional[Spans]:
    """The open top-level call's spans, or None: the check of a call that
    follows the call it is made in."""
    return _top


def open_call(name: str, *, traced: bool = False,
              t: Optional[float] = None) -> Optional[Spans]:
    """The one check of a top-level call: its :class:`Spans`, its own span
    ``name`` open, when a profiler runs or ``traced`` (the session's
    ``trace=True``) asks; None otherwise."""
    global _window, _top
    top = _top
    if top is not None:
        sp = Spans(top._w, top._mirror, top._stream, outer=False)
        sp.root = sp.begin(name, t)
        return sp
    prof = _profiling()
    if not prof and not traced:
        w = _window
        if w is not None and w.profiled:
            w.profiled = False
        return None
    w = _window
    if w is None:
        w = _window = _Window()
    if not (prof and w.profiled):
        w.reset(prof)
    stream = _stream_of(sys.modules.get("torch"))
    if stream is not None and w.anchor is None:
        torch = sys.modules["torch"]
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        w.anchor = (perf_counter(), a)
    sp = Spans(w, prof, stream, outer=True)
    _top = sp
    sp.root = sp.begin(name, t)
    return sp


def reset() -> None:
    """Empty the window (the next traced call starts a new one)."""
    if _window is not None:
        _window.reset(False)


def _devices(w: _Window) -> Dict[int, Tuple[float, float]]:
    """Each span's device interval on the host's clock (synchronises)."""
    if w.anchor is None or not w.dev:
        return {}
    torch = sys.modules["torch"]
    torch.cuda.synchronize()
    t_a, a = w.anchor
    out = {}
    for sid, (e0, e1) in w.dev.items():
        if e0 is not None and e1 is not None:
            out[sid] = (t_a + a.elapsed_time(e0) * 1e-3,
                        t_a + a.elapsed_time(e1) * 1e-3)
    return out


def span_trace(root: Optional[int] = None) -> Optional[RuntimeTrace]:
    """The window's spans as a :class:`RuntimeTrace` (``spans``, the
    counters, and ``dropped``, the events the ring lost), or None when
    nothing was recorded.  ``root`` keeps one span and its descendants."""
    w = _window
    if w is None:
        return None
    for t, name, sid, value in w.later:
        w.rec.emit_at(t, EV_SPAN_COUNT, name, sid, int(value))
    w.later.clear()
    snap = w.rec.snapshot()
    if root is not None:
        parent = {e[4]: e[5] for e in snap if e[2] == EV_SPAN_BEGIN}
        keep = set()
        for sid in parent:
            s = sid
            while s > 0 and s != root:
                s = parent.get(s, -1)
            if s == root:
                keep.add(sid)
        snap = [e for e in snap if e[4] in keep]
    if not snap:
        return None
    return assemble(snap, 0, dropped=w.rec.dropped, devices=_devices(w))
