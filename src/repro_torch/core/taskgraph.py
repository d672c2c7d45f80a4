"""Task-graph representation.

A :class:`TaskGraph` is a DAG of :class:`Task` nodes.  Tasks carry

* an optional callable ``fn(ctx)`` executed by the runtime (``ctx`` is a
  :class:`TaskContext` giving access to predecessor results and to the
  runtime's parallel-region primitives),
* an analytical ``cost`` (seconds) used by the discrete-event simulator and
  the static list scheduler,
* a ``kind`` tag (``compute`` / ``comm`` / ``panel`` / ...) used by cost
  models and by the critical-path breakdown figures,
* an optional ``parallel`` spec describing a nested data-parallel region the
  task spawns (the gang-scheduling target of the paper).

Dependencies are explicit (OpenMP ``depend``-style, resolved by the runtime)
— the graph is static; readiness is dynamic.

Suspendable task frames
-----------------------

Task bodies may be written as *generators*; the runtime then compiles them
into resumable :class:`TaskFrame`\\ s (the paper's ULT-style suspension,
§III): yielding one of the :class:`TaskContext` communication requests —
``yield ctx.recv(channel)`` / ``yield ctx.wait(event)`` /
``yield ctx.yield_()`` — parks the frame on a waitlist *without occupying a
worker thread*, and a matching :meth:`Channel.send` / :meth:`TaskEvent.set`
makes it resumable on any worker.  Plain (non-generator) bodies may call the
same APIs; they block their kernel thread work-conservingly (the worker
keeps scheduling other tasks at the blocking point) since Python cannot
switch ULT stacks.  :class:`Channel` and :class:`TaskEvent` are the
communication primitives; :class:`FrameResume` is the run-list entry type
the record-and-replay subsystem uses to reproduce frame interleavings.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import weakref
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

from ..resources.handle import Resource


# ---------------------------------------------------------------------------
# communication primitives + suspendable frames
# ---------------------------------------------------------------------------

# Global activity epoch: bumped by every Channel.send / TaskEvent.set so the
# runtime's suspension-deadlock detectors can confirm "nothing changed" across
# their confirmation window even for sends that found no parked waiter (e.g. a
# send racing a plain-body ctx.recv poll loop).  This makes detection safe
# against senders racing the window — not against senders that stay silent
# past it: wakeups are expected to come from the run's own work.
_epoch_lock = threading.Lock()
_activity_epoch = 0

# Process-wide monotonic ids for communication primitives: names are user-
# chosen and may collide, so the flight recorder tags suspend/block events
# with the uid (``recv(chan)@c7``) to tell same-named channels apart.
_prim_uids = itertools.count()


def _bump_activity() -> None:
    global _activity_epoch
    with _epoch_lock:
        _activity_epoch += 1


def activity_epoch() -> int:
    with _epoch_lock:
        return _activity_epoch


class ChannelEmpty(Exception):
    """:meth:`Channel.recv_nowait` on an empty channel."""


class ChannelFull(Exception):
    """:meth:`Channel.send` on a full *bounded* channel.  Use
    :meth:`TaskContext.send` for backpressure: a frame body parks, a plain
    body blocks work-conservingly, until a receiver frees space."""


class Channel:
    """A multi-producer multi-consumer FIFO for task-internal communication.

    ``send`` on the default *unbounded* channel never blocks.  With
    ``capacity=N`` the channel is *bounded*: senders must pace themselves —
    ``ctx.send(ch, v)`` suspends a frame body (``yield ctx.send(ch, v)``)
    or blocks a plain body work-conservingly until a receiver frees a slot,
    and the raw :meth:`send` raises :class:`ChannelFull` instead of
    silently growing the buffer.

    Receiving goes through :meth:`TaskContext.recv`: a generator body
    suspends its frame until an item arrives (the worker keeps scheduling);
    a plain body blocks its kernel thread work-conservingly.  Delivery to
    parked frames happens under the channel lock, so a ``send`` racing a
    frame park can never be lost: either the parking side sees the item, or
    the sender sees the waiter.  On a bounded channel, a receive that frees
    a slot promotes the oldest parked *sender* (its value enters the buffer
    in park order); plain-body senders polling :meth:`try_send` may
    interleave with parked frame senders — FIFO fairness is per mechanism,
    not global.
    """

    __slots__ = ("name", "capacity", "uid", "_lock", "_items", "_waiters",
                 "_send_waiters")

    def __init__(self, name: str = "channel", capacity: Optional[int] = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"channel capacity must be >= 1, got {capacity}")
        self.name = name
        self.capacity = capacity
        self.uid = next(_prim_uids)
        self._lock = threading.Lock()
        self._items: Deque[Any] = deque()
        self._waiters: Deque[Callable[[Any], None]] = deque()
        # parked frame senders of a bounded channel: (waker, value) pairs
        self._send_waiters: Deque[Tuple[Callable[[Any], None], Any]] = deque()

    def send(self, value: Any) -> None:
        """Non-suspending send.  Bounded channels raise :class:`ChannelFull`
        when no slot (and no parked receiver) is available — backpressure
        needs the scheduler, so it lives in :meth:`TaskContext.send`."""
        if not self.try_send(value):
            raise ChannelFull(
                f"channel {self.name!r} is full (capacity {self.capacity}); "
                "use ctx.send(channel, value) so the sender can suspend")

    def try_send(self, value: Any) -> bool:
        """Attempt a send without waiting; False when the channel is full."""
        with self._lock:
            waiter = self._waiters.popleft() if self._waiters else None
            if waiter is None:
                if (self.capacity is not None
                        and len(self._items) >= self.capacity):
                    return False
                self._items.append(value)
        _bump_activity()
        if waiter is not None:
            waiter(value)
        return True

    def _pop_item(self) -> Any:
        """Take the head item and promote the oldest parked sender into the
        freed slot.  Caller holds ``_lock``; returns ``(value, promoted)``
        where ``promoted`` must be called outside the lock (or None)."""
        value = self._items.popleft()
        promoted = None
        if self._send_waiters:
            waker, pending = self._send_waiters.popleft()
            self._items.append(pending)
            promoted = waker
        return value, promoted

    def try_recv(self) -> Tuple[bool, Any]:
        with self._lock:
            if not self._items:
                return False, None
            value, promoted = self._pop_item()
        if self.capacity is not None:
            # blocked senders poll/confirm on the activity epoch: a consumed
            # slot is the progress they are waiting for
            _bump_activity()
        if promoted is not None:
            promoted(None)
        return True, value

    def recv_nowait(self) -> Any:
        ok, value = self.try_recv()
        if not ok:
            raise ChannelEmpty(f"channel {self.name!r} is empty")
        return value

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    # -- park/cancel protocol (used by the dispatch strategies) -------------
    def _park(self, waiter: Callable[[Any], None]) -> Tuple[str, Any]:
        """Atomically take an item or register ``waiter``.  Returns
        ``("ready", item)`` or ``("parked", None)``."""
        with self._lock:
            if self._items:
                value, promoted = self._pop_item()
            else:
                self._waiters.append(waiter)
                return "parked", None
        if self.capacity is not None:
            _bump_activity()
        if promoted is not None:
            promoted(None)
        return "ready", value

    def _cancel(self, waiter: Callable[[Any], None]) -> bool:
        """Remove a registered waiter; False if it already fired."""
        with self._lock:
            try:
                self._waiters.remove(waiter)
                return True
            except ValueError:
                return False

    def _park_send(self, waiter: Callable[[Any], None],
                   value: Any) -> Tuple[str, Any]:
        """Atomically deliver/enqueue ``value`` or register the sender
        ``waiter`` for the next freed slot (bounded channels)."""
        with self._lock:
            recv_waiter = self._waiters.popleft() if self._waiters else None
            if recv_waiter is None:
                if (self.capacity is not None
                        and len(self._items) >= self.capacity):
                    self._send_waiters.append((waiter, value))
                    return "parked", None
                self._items.append(value)
        _bump_activity()
        if recv_waiter is not None:
            recv_waiter(value)
        return "ready", None

    def _cancel_send(self, waiter: Callable[[Any], None]) -> bool:
        with self._lock:
            for i, (w, _) in enumerate(self._send_waiters):
                if w is waiter:
                    del self._send_waiters[i]
                    return True
            return False

    def _requeue(self, value: Any) -> None:
        """Hand back an item a losing multi-wait racer consumed.  Delivers
        to a parked receiver if one exists, else re-enters the buffer —
        *bypassing* the capacity check: the item was already admitted once,
        so bouncing it off a refilled bounded channel would drop it (or
        blow up in an unrelated sender's callback)."""
        with self._lock:
            waiter = self._waiters.popleft() if self._waiters else None
            if waiter is None:
                self._items.append(value)
        _bump_activity()
        if waiter is not None:
            waiter(value)


class TaskEvent:
    """A one-shot event tasks can :meth:`TaskContext.wait` on.

    ``set()`` is sticky; frames parked on the event become resumable, later
    waits return immediately.
    """

    __slots__ = ("name", "uid", "_lock", "_set", "_waiters")

    def __init__(self, name: str = "event"):
        self.name = name
        self.uid = next(_prim_uids)
        self._lock = threading.Lock()
        self._set = False
        self._waiters: Deque[Callable[[Any], None]] = deque()

    def is_set(self) -> bool:
        with self._lock:
            return self._set

    def set(self) -> None:
        with self._lock:
            if self._set:
                return
            self._set = True
            waiters = list(self._waiters)
            self._waiters.clear()
        _bump_activity()
        for waiter in waiters:
            waiter(None)

    def _park(self, waiter: Callable[[Any], None]) -> Tuple[str, Any]:
        with self._lock:
            if self._set:
                return "ready", None
            self._waiters.append(waiter)
            return "parked", None

    def _cancel(self, waiter: Callable[[Any], None]) -> bool:
        with self._lock:
            try:
                self._waiters.remove(waiter)
                return True
            except ValueError:
                return False


class FrameRequest:
    """What a suspended generator body is waiting for (yielded to the
    worker loop).  ``try_immediate`` is the eager fast path (consume inline
    without suspending); ``park`` registers a waker under the primitive's
    lock so no wakeup can be lost."""

    kind = "?"
    __slots__ = ()

    def try_immediate(self) -> Tuple[bool, Any]:
        return False, None

    def park(self, waiter: Callable[[Any], None]) -> Tuple[str, Any]:
        raise NotImplementedError

    def cancel(self, waiter: Callable[[Any], None]) -> bool:
        return False

    def describe(self) -> str:
        return self.kind

    def source_uid(self) -> int:
        """Uid of the primitive this request waits on (-1 when it has none
        or several) — the flight recorder's channel-identity tag."""
        return -1


class RecvRequest(FrameRequest):
    kind = "recv"
    __slots__ = ("channel",)

    def __init__(self, channel: Channel):
        self.channel = channel

    def try_immediate(self) -> Tuple[bool, Any]:
        return self.channel.try_recv()

    def park(self, waiter):
        return self.channel._park(waiter)

    def cancel(self, waiter):
        return self.channel._cancel(waiter)

    def describe(self) -> str:
        return f"recv({self.channel.name})"

    def source_uid(self) -> int:
        return self.channel.uid


class WaitRequest(FrameRequest):
    kind = "wait"
    __slots__ = ("event",)

    def __init__(self, event: TaskEvent):
        self.event = event

    def try_immediate(self) -> Tuple[bool, Any]:
        return (True, None) if self.event.is_set() else (False, None)

    def park(self, waiter):
        return self.event._park(waiter)

    def cancel(self, waiter):
        return self.event._cancel(waiter)

    def describe(self) -> str:
        return f"wait({self.event.name})"

    def source_uid(self) -> int:
        return self.event.uid


class SendRequest(FrameRequest):
    """A bounded-channel send: the *sender* suspends until a slot frees
    (the backpressure half of the paper's blocking communication)."""

    kind = "send"
    __slots__ = ("channel", "value")

    def __init__(self, channel: Channel, value: Any):
        self.channel = channel
        self.value = value

    def try_immediate(self) -> Tuple[bool, Any]:
        return (self.channel.try_send(self.value), None)

    def park(self, waiter):
        return self.channel._park_send(waiter, self.value)

    def cancel(self, waiter):
        return self.channel._cancel_send(waiter)

    def describe(self) -> str:
        return f"send({self.channel.name})"

    def source_uid(self) -> int:
        return self.channel.uid


class WaitAnyRequest(FrameRequest):
    """Select-style multi-wait: satisfied by whichever of its sub-requests
    (``recv`` on a channel / ``wait`` on an event) becomes ready first.

    The resume value is ``(index, value)``: the position of the winning
    source in the argument list plus that source's payload.  Exactly one
    source is consumed — a channel item claimed by a losing racer is
    re-queued, never dropped.  The winning index is instrumented by the
    recording dynamic dispatch and pinned on replay
    (:meth:`pinned`), so a replayed select is a deterministic choice.
    """

    kind = "wait_any"
    __slots__ = ("requests", "_lock", "_fired", "_children")

    def __init__(self, requests: Sequence[FrameRequest]):
        reqs = tuple(requests)
        if not reqs:
            raise ValueError("wait_any needs at least one channel/event")
        for r in reqs:
            if not isinstance(r, (RecvRequest, WaitRequest)):
                raise TypeError(
                    "wait_any sources must be channels or events "
                    f"(recv/wait), got {getattr(r, 'kind', r)!r}")
        self.requests = reqs
        self._lock = threading.Lock()
        self._fired = False
        # (index, child_waiter) pairs registered with the sub-requests
        self._children: List[Tuple[int, Callable[[Any], None]]] = []

    def try_immediate(self) -> Tuple[bool, Any]:
        for i, r in enumerate(self.requests):
            ok, v = r.try_immediate()
            if ok:
                return True, (i, v)
        return False, None

    def _claim(self) -> bool:
        with self._lock:
            if self._fired:
                return False
            self._fired = True
            return True

    def _cancel_children(self, except_waiter=None) -> None:
        for j, c in self._children:
            if c is not except_waiter:
                self.requests[j].cancel(c)

    def park(self, waiter: Callable[[Any], None]) -> Tuple[str, Any]:
        # children append incrementally so a child that fires mid-loop can
        # cancel every sibling parked so far; the post-loop sweep catches
        # any parked after the winner (cancel is a no-op on consumed ones)
        self._children = children = []
        for i, r in enumerate(self.requests):
            with self._lock:
                if self._fired:
                    break           # a parked child already won
            child = self._make_child(i, r, waiter)
            status, v = r.park(child)
            if status == "ready":
                if self._claim():
                    for j, c in children:
                        self.requests[j].cancel(c)
                    return "ready", (i, v)
                # a previously-parked child fired concurrently and owns the
                # delivery; this ready value must not drop
                if isinstance(r, RecvRequest):
                    r.channel._requeue(v)
                break
            children.append((i, child))
        with self._lock:
            fired = self._fired
        if fired:
            for j, c in children:
                self.requests[j].cancel(c)
            return "parked", None   # the winner child calls ``waiter``
        return "parked", None

    def _make_child(self, i: int, r: FrameRequest,
                    waiter: Callable[[Any], None]) -> Callable[[Any], None]:
        def child(value: Any = None, *, _i=i, _r=r) -> None:
            if not self._claim():
                # lost the race: hand a consumed channel item back (events
                # are sticky — nothing to return).  _requeue bypasses the
                # capacity check: a full bounded channel must not drop the
                # item or raise inside the producing sender's callback.
                if isinstance(_r, RecvRequest):
                    _r.channel._requeue(value)
                return
            self._cancel_children(except_waiter=child)
            waiter((_i, value))
        return child

    def cancel(self, waiter: Callable[[Any], None]) -> bool:
        if not self._claim():
            return False
        self._cancel_children()
        return True

    def pinned(self, index: int) -> "FrameRequest":
        """The replay form: wait only on the recorded winner, delivering the
        same ``(index, value)`` shape."""
        return _PinnedChoice(self.requests[index], index)

    def describe(self) -> str:
        return ("wait_any("
                + ", ".join(r.describe() for r in self.requests) + ")")


class _PinnedChoice(FrameRequest):
    """A :class:`WaitAnyRequest` whose winning index was recorded: replay
    parks only on that source, making the select deterministic."""

    kind = "wait_any"
    __slots__ = ("request", "index", "_wrapped")

    def __init__(self, request: FrameRequest, index: int):
        self.request = request
        self.index = index
        self._wrapped: Optional[Callable[[Any], None]] = None

    def try_immediate(self) -> Tuple[bool, Any]:
        ok, v = self.request.try_immediate()
        return (True, (self.index, v)) if ok else (False, None)

    def park(self, waiter):
        def wrapped(value: Any = None) -> None:
            waiter((self.index, value))
        self._wrapped = wrapped
        status, v = self.request.park(wrapped)
        if status == "ready":
            return "ready", (self.index, v)
        return status, None

    def cancel(self, waiter):
        if self._wrapped is None:
            return False
        return self.request.cancel(self._wrapped)

    def describe(self) -> str:
        return f"wait_any[{self.index}]({self.request.describe()})"

    def source_uid(self) -> int:
        return self.request.source_uid()


class YieldRequest(FrameRequest):
    """A cooperative yield: the frame goes to the back of the resume queue
    so the worker can schedule other work; it is immediately resumable."""

    kind = "yield"
    __slots__ = ()

    def park(self, waiter):
        return "ready", None


@dataclasses.dataclass(frozen=True)
class FrameResume:
    """A run-list entry: resume segment ``seg`` (1-based) of task ``tid``'s
    suspended frame.  Recorded by the dynamic dispatch, reproduced by
    replay (JSON-encoded as ``["r", tid, seg]``)."""

    tid: int
    seg: int


class TaskFrame:
    """A resumable execution of one task whose body is a generator.

    The worker loop drives the generator via :meth:`step`; each yielded
    :class:`FrameRequest` either completes inline (eager mode) or parks the
    frame.  ``resumes`` counts executed resume segments (segment 0 is the
    initial run), ``last_worker`` is the resume-locality hint, and
    ``resumable``/``resume_value`` carry the wakeup handshake.
    """

    __slots__ = ("task", "ctx", "gen", "resumes", "resume_value",
                 "last_worker", "resumable", "request", "waker",
                 "__weakref__")

    def __init__(self, task: "Task", ctx: "TaskContext", gen: Any):
        self.task = task
        self.ctx = ctx
        self.gen = gen
        self.resumes = 0
        self.resume_value: Any = None
        self.last_worker = 0
        self.resumable = False
        self.request: Optional[FrameRequest] = None
        self.waker: Optional[Callable[[Any], None]] = None

    def step(self, value: Any = None) -> Tuple[str, Any]:
        """Advance the generator once.  Returns ``("done", result)`` or
        ``("suspend", request)``."""
        try:
            req = self.gen.send(value)
        except StopIteration as stop:
            return "done", stop.value
        if not isinstance(req, FrameRequest):
            raise TypeError(
                f"task {self.task.name!r} yielded {req!r}; generator task "
                "bodies must yield ctx.recv(channel) / ctx.wait(event) / "
                "ctx.yield_()")
        return "suspend", req

    def close(self) -> None:
        self.gen.close()


# Every parked frame is registered here (and removed on wake/cancel) so the
# test suite can assert no frame is orphaned after aborts — the frame
# analogue of the worker-thread leak check.
_parked_frames: "weakref.WeakSet[TaskFrame]" = weakref.WeakSet()


def note_parked(frame: TaskFrame) -> None:
    _parked_frames.add(frame)


def note_unparked(frame: TaskFrame) -> None:
    _parked_frames.discard(frame)


def live_parked_frames() -> List[TaskFrame]:
    return list(_parked_frames)


@dataclasses.dataclass
class ParallelSpec:
    """A nested data-parallel region spawned by a task.

    ``n_threads`` ULTs run ``body(tid, ctx)``.  ``blocking`` marks regions
    whose internal synchronization is *blocking* (the paper's Fig. 1 hazard:
    a custom library barrier that does not yield to the scheduler).  ``gang``
    requests gang scheduling for this region (the paper's
    ``ompx_set_gang_sched`` scope); ``None`` defers to the runtime default.
    ``cost_per_thread`` is the per-ULT cost for the simulator; ``n_barriers``
    is how many internal barrier rounds the region performs.
    """

    n_threads: int
    body: Optional[Callable[[int, "TaskContext"], Any]] = None
    blocking: bool = True
    gang: Optional[bool] = None
    cost_per_thread: float = 0.0
    n_barriers: int = 1


@dataclasses.dataclass
class Task:
    tid: int
    name: str
    fn: Optional[Callable[["TaskContext"], Any]] = None
    deps: Tuple[int, ...] = ()
    kind: str = "compute"
    cost: float = 1.0
    priority: int = 0
    parallel: Optional[ParallelSpec] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # declarative conflicts (QuickSched): resources this task must hold for
    # its whole execution — exclusively (``uses``) or reader-shared
    # (``uses_shared``).  No ordering is implied; the arbiter picks one.
    uses: Tuple[Resource, ...] = ()
    uses_shared: Tuple[Resource, ...] = ()

    def __hash__(self) -> int:  # identity by tid within a graph
        return hash(self.tid)


class TaskContext:
    """Handed to task bodies at execution time.

    Provides predecessor results (``ctx[dep_task]`` / ``ctx.result(tid)``),
    the parallel-region primitives (``ctx.parallel`` / ``ctx.barrier``) used
    by gang-scheduled regions, and the suspension APIs (``ctx.recv`` /
    ``ctx.wait`` / ``ctx.yield_``).  In a generator body these return
    :class:`FrameRequest` objects that MUST be yielded (``value = yield
    ctx.recv(ch)``); in a plain body they block the worker
    work-conservingly.
    """

    _in_frame = False           # set by the frame driver for generator bodies

    def __init__(self, graph: "TaskGraph", task: Task, results: Dict[int, Any],
                 runtime: Any = None):
        self.graph = graph
        self.task = task
        self._results = results
        self.runtime = runtime

    def result(self, tid: int) -> Any:
        return self._results[tid]

    # -- suspension / communication (the paper's blocking extensions) -------
    def recv(self, channel: Channel) -> Any:
        """Receive from ``channel``.  Generator body: ``value = yield
        ctx.recv(ch)`` suspends the frame until an item arrives.  Plain
        body: blocks this worker (which keeps scheduling other work)."""
        if self._in_frame:
            return RecvRequest(channel)
        rt = self.runtime
        if rt is None or not hasattr(rt, "ctx_recv"):
            return channel.recv_nowait()        # serial context: no waiting
        return rt.ctx_recv(channel, self)

    def wait(self, event: TaskEvent) -> Any:
        """Wait for ``event``; same generator/plain split as :meth:`recv`."""
        if self._in_frame:
            return WaitRequest(event)
        rt = self.runtime
        if rt is None or not hasattr(rt, "ctx_wait"):
            if not event.is_set():
                raise RuntimeError(
                    f"wait on unset event {event.name!r} outside a runtime")
            return None
        return rt.ctx_wait(event, self)

    def send(self, channel: Channel, value: Any) -> Any:
        """Send with backpressure.  Generator body: ``yield ctx.send(ch,
        v)`` suspends the frame while a bounded channel is full.  Plain
        body: blocks this worker work-conservingly until a slot frees.
        Unbounded channels never wait (equivalent to ``channel.send``)."""
        if self._in_frame:
            return SendRequest(channel, value)
        rt = self.runtime
        if rt is None or not hasattr(rt, "ctx_send"):
            channel.send(value)             # serial context: no waiting
            return None
        return rt.ctx_send(channel, value, self)

    def wait_any(self, *sources: Any) -> Any:
        """Select-style multi-wait over channels and/or events: returns
        ``(index, value)`` for whichever source is satisfied first.
        Generator body: ``idx, v = yield ctx.wait_any(ch_a, ch_b, ev)``
        suspends until one fires.  Plain body: blocks work-conservingly.
        Recording captures the winning index; replay pins it, so the
        choice is deterministic."""
        request = WaitAnyRequest([self._as_request(s) for s in sources])
        if self._in_frame:
            return request
        rt = self.runtime
        if rt is None or not hasattr(rt, "ctx_wait_any"):
            ok, result = request.try_immediate()
            if not ok:
                raise RuntimeError(
                    "wait_any with no source ready outside a runtime")
            return result
        return rt.ctx_wait_any(request, self)

    @staticmethod
    def _as_request(source: Any) -> FrameRequest:
        if isinstance(source, Channel):
            return RecvRequest(source)
        if isinstance(source, TaskEvent):
            return WaitRequest(source)
        if isinstance(source, (RecvRequest, WaitRequest)):
            return source
        raise TypeError(
            f"wait_any sources must be Channel/TaskEvent, got {source!r}")

    def yield_(self) -> Any:
        """A cooperative scheduling point.  Generator body: ``yield
        ctx.yield_()`` parks the frame at the back of the resume queue.
        Plain body: the worker serves one unit of other work inline."""
        if self._in_frame:
            return YieldRequest()
        rt = self.runtime
        if rt is None or not hasattr(rt, "ctx_yield"):
            return None
        return rt.ctx_yield(self)

    def parallel(self, n_threads: int, body, *, gang=None):
        """Fork/join a nested parallel region (delegates to the runtime;
        gang-scheduled by default — the paper's `ompx_set_gang_sched`)."""
        if self.runtime is None:
            # degenerate serial execution (no runtime): run inline
            class _SerialRegion:
                def barrier(self_inner):
                    pass
            region = _SerialRegion()
            return [body(i, region) for i in range(n_threads)]
        return self.runtime.parallel(n_threads, body, gang=gang, spawn_ctx=self)

    def __getitem__(self, task_or_tid) -> Any:
        tid = task_or_tid.tid if isinstance(task_or_tid, Task) else task_or_tid
        return self._results[tid]

    def dep_results(self) -> List[Any]:
        return [self._results[d] for d in self.task.deps]


class TaskGraph:
    """A static DAG of tasks with dependency bookkeeping."""

    def __init__(self, name: str = "graph"):
        self.name = name
        self.tasks: List[Task] = []
        self._succ: Dict[int, List[int]] = {}
        # declared resources in first-use order; recordings and the flight
        # recorder refer to them by index in this list (the "rindex")
        self.resources: List[Resource] = []
        self._resource_index: Dict[int, int] = {}   # id(resource) -> rindex

    # -- construction -----------------------------------------------------
    def add(
        self,
        fn: Optional[Callable[[TaskContext], Any]] = None,
        *,
        deps: Sequence[Task] = (),
        name: Optional[str] = None,
        kind: str = "compute",
        cost: float = 1.0,
        priority: int = 0,
        parallel: Optional[ParallelSpec] = None,
        uses: Sequence[Resource] = (),
        uses_shared: Sequence[Resource] = (),
        **meta: Any,
    ) -> Task:
        tid = len(self.tasks)
        dep_ids = tuple(d.tid if isinstance(d, Task) else int(d) for d in deps)
        for d in dep_ids:
            if d >= tid or d < 0:
                raise ValueError(f"dependency {d} of task {tid} is not an existing task")
        for r in tuple(uses) + tuple(uses_shared):
            if not isinstance(r, Resource):
                raise TypeError(
                    f"uses/uses_shared entries must be Resource, got {r!r}")
            self.register_resource(r)
        t = Task(
            tid=tid,
            name=name or f"{kind}:{tid}",
            fn=fn,
            deps=dep_ids,
            kind=kind,
            cost=float(cost),
            priority=priority,
            parallel=parallel,
            meta=dict(meta),
            uses=tuple(uses),
            uses_shared=tuple(uses_shared),
        )
        self.tasks.append(t)
        self._succ[tid] = []
        for d in dep_ids:
            self._succ[d].append(tid)
        return t

    def register_resource(self, resource: Resource) -> int:
        """Intern ``resource`` into this graph's rindex space (idempotent;
        identity-keyed — two same-named handles are two resources)."""
        rindex = self._resource_index.get(id(resource))
        if rindex is None:
            rindex = len(self.resources)
            self._resource_index[id(resource)] = rindex
            self.resources.append(resource)
        return rindex

    def resource_index(self) -> Dict[int, int]:
        """id(resource) -> rindex for every declared resource."""
        return self._resource_index

    # -- queries ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.tasks)

    def __iter__(self):
        return iter(self.tasks)

    def successors(self, task_or_tid) -> List[Task]:
        tid = task_or_tid.tid if isinstance(task_or_tid, Task) else task_or_tid
        return [self.tasks[s] for s in self._succ[tid]]

    def indegrees(self) -> List[int]:
        return [len(t.deps) for t in self.tasks]

    def roots(self) -> List[Task]:
        return [t for t in self.tasks if not t.deps]

    def topological_order(self) -> List[Task]:
        """Kahn topological order; raises on cycles (construction forbids
        them, this is a safety net for hand-built graphs)."""
        indeg = self.indegrees()
        frontier = [t.tid for t in self.tasks if indeg[t.tid] == 0]
        order: List[int] = []
        while frontier:
            tid = frontier.pop()
            order.append(tid)
            for s in self._succ[tid]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    frontier.append(s)
        if len(order) != len(self.tasks):
            raise ValueError("task graph has a cycle")
        return [self.tasks[t] for t in order]

    def critical_path(self) -> Tuple[float, List[Task]]:
        """Longest path through the graph by task ``cost`` (a task spawning a
        parallel region contributes ``cost + cost_per_thread`` — the region
        runs to completion within the task from the graph's point of view).
        Returns ``(length_seconds, path_tasks)``."""
        order = self.topological_order()
        dist: Dict[int, float] = {}
        prev: Dict[int, Optional[int]] = {}
        for t in order:
            c = t.cost + (t.parallel.cost_per_thread if t.parallel else 0.0)
            best, arg = 0.0, None
            for d in t.deps:
                if dist[d] > best:
                    best, arg = dist[d], d
            dist[t.tid] = best + c
            prev[t.tid] = arg
        end = max(dist, key=lambda k: dist[k])
        path: List[Task] = []
        cur: Optional[int] = end
        while cur is not None:
            path.append(self.tasks[cur])
            cur = prev[cur]
        return dist[end], list(reversed(path))

    def total_work(self) -> float:
        return sum(
            t.cost + (t.parallel.n_threads * t.parallel.cost_per_thread if t.parallel else 0.0)
            for t in self.tasks
        )

    def validate(self) -> None:
        self.topological_order()

    def subgraph_kinds(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for t in self.tasks:
            out[t.kind] = out.get(t.kind, 0) + 1
        return out
