"""Continuous-batching decode engine.

The port of the reference's ``repro/serving/engine.py``, without the
multi-process front end (``procs=`` raises ``NotImplementedError``, ROADMAP
Queue A item 6).  One :class:`ContinuousBatchingEngine` turns a stream of
:class:`~repro_torch.serving.request.Request`\\ s into decode-step task
graphs executed by a caller-owned
:class:`~repro_torch.api.session.Session`:

* **admission queue** — a bounded :class:`~repro_torch.core.taskgraph.Channel`.
  :meth:`submit` refuses (:class:`AdmissionFull`) or blocks when the queue
  is full; the queue drains only as decode slots free up, so backpressure
  propagates to the client with no extra machinery.
* **per-step dynamic batch composition** — every step serves whatever is
  in flight *right now*: new arrivals join as slots free, finished
  requests leave immediately (early exit on EOS or token budget), nobody
  waits for a fixed batch to fill or drain.
* **per-batch-shape graphs, built off the hot path** — the step graph for
  ``k`` active lanes is built (and its structural
  :func:`~repro_torch.replay.graph_key` computed) exactly once, then reused:
  task bodies read the engine's current lane list, so the same graph
  object serves every step with ``k`` lanes.  The steady-state loop does
  no graph construction and no hashing — the precomputed key rides
  :meth:`Session.run(key=...) <repro_torch.api.session.Session.run>`.
* **warm replay under shape churn** — with ``scheduler="pool"`` each lane
  count is one :class:`~repro_torch.replay.ReplayPool` shape: the pool
  records a shape the first time the batch hits it and replays it every
  time the churn returns there, remapping recordings across worker counts
  (:func:`~repro_torch.replay.remap.remap_recording`) when the cache was
  filled by a replica with a different core count.

Each shard of work is one request's private ``decode -> sample`` chain;
the step's join is a channel-fed suspendable gather frame (samples stream
their token as soon as it is drawn).  Because every request decodes
against its own KV cache, its token stream is independent of batch
composition — continuous batching is *bit-identical* to serving each
request alone.  On the CUDA device that holds because every kernel on the
path reduces in a fixed order (no atomics) and each lane's work depends on
its own tensors only.

The engine clock is wall time by default; passing ``step_time`` switches
to a deterministic virtual clock (each decode step advances time by that
amount) so tests can assert batch compositions and latency numbers
exactly.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ..api.graph import Graph
from ..api.session import not_ported
from ..core.taskgraph import Channel
from .metrics import RequestRecord, ServingReport
from .request import Request, RequestState

DecodeFn = Callable[[Any, Any], Tuple[Any, Any]]   # (cache, tok) -> (cache, logits)
PrefillFn = Callable[[Any], Tuple[Any, Any]]       # prompt -> (cache, logits)
SampleFn = Callable[[Any], Any]                    # logits -> token

#: pool serve modes driven by a warm recording (the hit side of the
#: warm-replay hit rate; warmup/record/rerecord are dynamic serves).
#: ``compiled`` counts as warm: it is the promoted form of a warm replay.
_WARM_MODES = ("replay", "adopt", "remap", "compiled")


class AdmissionFull(RuntimeError):
    """The bounded admission queue refused a request (backpressure)."""


class _LaneFuseState:
    """Fuse-state adapter over the engine's live lane list: ``("cache", i)``
    / ``("tok", i)`` / ``("logits", i)`` resolve to lane ``i``'s in-flight
    :class:`~repro_torch.serving.request.RequestState` *at call time* — lanes
    shift between steps, so the adapter must read through ``_active``, not
    bind states at graph-build time."""

    __slots__ = ("engine",)

    def __init__(self, engine: "ContinuousBatchingEngine"):
        self.engine = engine

    def __getitem__(self, k):
        return getattr(self.engine._active[k[1]], k[0])

    def __setitem__(self, k, v):
        setattr(self.engine._active[k[1]], k[0], v)


class ContinuousBatchingEngine:
    """Request-level continuous batching over a ``Session`` (see module
    docstring).

    Parameters
    ----------
    session:
        Caller-owned :class:`~repro_torch.api.session.Session` executing
        the decode-step graphs.  ``scheduler="pool"`` gives warm replays
        per batch shape; ``"dynamic"`` is the scheduling baseline.  With
        ``max_batch=1`` the engine degrades to FCFS per-request serving —
        the baseline continuous batching is compared against.
    decode_fn / prefill_fn / sample_fn:
        ``decode_fn(cache, tok) -> (cache, logits)`` and
        ``prefill_fn(prompt) -> (cache, logits)`` close over model params;
        ``sample_fn(logits) -> token`` defaults to the LM greedy sampler.
    max_batch:
        Decode-slot count (max lanes per step graph).
    admission_capacity:
        Bounded admission-queue depth (default ``2 * max_batch``).
    step_time:
        None (default): wall-clock timestamps.  A float switches to the
        deterministic virtual clock: each decode step advances engine time
        by exactly this many seconds.
    procs / fns_ref:
        The reference's multi-process front end; ``procs`` raises
        ``NotImplementedError`` until ``mp/`` is ported (ROADMAP Queue A
        item 6).
    """

    def __init__(
        self,
        session: Any,
        decode_fn: DecodeFn,
        prefill_fn: PrefillFn,
        *,
        max_batch: int = 4,
        admission_capacity: Optional[int] = None,
        sample_fn: Optional[SampleFn] = None,
        step_time: Optional[float] = None,
        procs: Optional[int] = None,
        fns_ref: Any = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if procs is not None:
            raise not_ported("procs")
        capacity = (2 * max_batch if admission_capacity is None
                    else admission_capacity)
        if capacity < 1:
            raise ValueError(
                f"admission_capacity must be >= 1, got {capacity}")
        if sample_fn is None:
            from ..models.serving import greedy_sample
            sample_fn = greedy_sample
        self.session = session
        self.max_batch = max_batch
        self.step_time = step_time
        self._decode_fn = decode_fn
        self._prefill_fn = prefill_fn
        self._sample_fn = sample_fn
        self._admission = Channel("serve.admission", capacity=capacity)

        self._active: List[RequestState] = []
        self._records: Dict[int, RequestRecord] = {}
        self._done = 0
        self._graphs: Dict[int, Tuple[Graph, Any]] = {}   # k -> (graph, key)
        self._step_tokens: List[Any] = []
        self._steps = 0
        self._warm_steps = 0
        self._lane_steps = 0
        self._shape_counts: Dict[int, int] = {}
        self._vnow = 0.0
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------------
    # clock
    def _now(self) -> float:
        if self.step_time is not None:
            return self._vnow
        return time.perf_counter() - self._t0

    def _reset_clock(self) -> None:
        self._vnow = 0.0
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------------
    # admission (client side)
    @property
    def admission_capacity(self) -> int:
        return int(self._admission.capacity)

    def queue_depth(self) -> int:
        return len(self._admission)

    def in_flight(self) -> int:
        return len(self._active)

    def submit(self, request: Request, *, block: bool = False,
               timeout: Optional[float] = None) -> None:
        """Enqueue ``request`` for admission.  When the bounded queue is
        full: raise :class:`AdmissionFull` (default), or with ``block``
        wait for a decode step to drain a slot — up to ``timeout`` seconds
        (forever when None).  Thread-safe."""
        if request.rid in self._records:
            raise ValueError(f"duplicate request id {request.rid}")
        self._records[request.rid] = RequestRecord(
            rid=request.rid, arrival_s=request.arrival_s)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while not self._admission.try_send(request):
            if not block or (deadline is not None
                             and time.monotonic() >= deadline):
                del self._records[request.rid]
                raise AdmissionFull(
                    f"admission queue full ({self.admission_capacity} "
                    f"waiting, {len(self._active)}/{self.max_batch} lanes "
                    "busy); retry after a decode step frees a slot")
            time.sleep(5e-4)

    def try_submit(self, request: Request) -> bool:
        """Non-raising :meth:`submit`; False when the queue refused it."""
        try:
            self.submit(request)
            return True
        except AdmissionFull:
            return False

    # ------------------------------------------------------------------
    # per-shape step graphs (built once per lane count, off the hot path)
    def _graph_for(self, k: int) -> Tuple[Graph, Any]:
        cached = self._graphs.get(k)
        if cached is not None:
            return cached
        from ..compile.fuse import FuseSpec

        g = Graph(f"serve_step[{k}]")
        g.fuse_state = _LaneFuseState(self)
        tokens = Channel(f"serve.tokens[{k}]")
        for i in range(k):
            def _decode(i=i):
                st = self._active[i]
                st.cache, st.logits = self._decode_fn(st.cache, st.tok)
                return st.logits

            # fusible for a compiled plan: decode_fn is the pure step;
            # jit_safe=False so a compiled driver calls it exactly like the
            # dynamic body does
            dec = g.add(_decode, name=f"decode{i}", kind="compute", cost=1.0,
                        fuse=FuseSpec(self._decode_fn,
                                      (("cache", i), ("tok", i)),
                                      (("cache", i), ("logits", i)),
                                      result_key=("logits", i),
                                      jit_safe=False))

            def _sample(logits, i=i):
                st = self._active[i]
                st.tok = self._sample_fn(logits)
                tokens.send((i, st.tok))
                return st.tok

            g.add(_sample, dec, name=f"sample{i}", kind="compute", cost=0.1)

        def _gather(ctx):
            # suspendable frame: assemble lane tokens as they stream in,
            # never pinning a worker while the remaining lanes decode
            out: List[Any] = [None] * k
            for _ in range(k):
                i, tok = yield ctx.recv(tokens)
                out[i] = tok
            self._step_tokens = out
            return out

        g.add(_gather, name="gather", kind="comm", cost=0.05)
        from ..replay.graph_key import graph_key
        entry = (g, graph_key(g))
        self._graphs[k] = entry
        return entry

    def prime(self, up_to: Optional[int] = None) -> None:
        """Pre-build the step graphs (and their structural keys) for lane
        counts ``1..up_to`` (default ``max_batch``) so the serving loop
        never constructs or hashes a graph on the request path."""
        for k in range(1, (up_to or self.max_batch) + 1):
            self._graph_for(k)

    # ------------------------------------------------------------------
    # the decode loop
    def _admit(self, now: float) -> bool:
        """Fill free lanes from the admission queue; prefill each admitted
        request (its first token comes from the prefill logits).  Requests
        whose budget is 1 token (or whose first token is EOS) complete
        here without ever occupying a decode slot."""
        admitted = False
        while len(self._active) < self.max_batch:
            ok, req = self._admission.try_recv()
            if not ok:
                break
            admitted = True
            rec = self._records[req.rid]
            rec.admitted_s = now
            cache, logits = self._prefill_fn(req.prompt)
            st = RequestState(req, cache, self._sample_fn(logits))
            tid = st.note_token(st.tok)
            t_first = self._now()
            rec.first_token_s = t_first
            rec.tokens.append(tid)
            rec.token_times_s.append(t_first)
            if st.done():
                rec.done_s = t_first
                self._done += 1
            else:
                self._active.append(st)
        return admitted

    def step(self) -> bool:
        """Admit arrivals into free lanes, then run one decode step over
        the in-flight set.  Returns False when there was nothing to do."""
        admitted = self._admit(self._now())
        if not self._active:
            return admitted
        k = len(self._active)
        graph, key = self._graph_for(k)
        report = self.session.run(graph, key=key)
        if self.step_time is not None:
            self._vnow += self.step_time
        now = self._now()
        self._steps += 1
        self._lane_steps += k
        self._shape_counts[k] = self._shape_counts.get(k, 0) + 1
        if report.stats.get("pool_mode") in _WARM_MODES:
            self._warm_steps += 1
        still: List[RequestState] = []
        for i, st in enumerate(self._active):
            tid = st.note_token(self._step_tokens[i])
            rec = self._records[st.rid]
            rec.tokens.append(tid)
            rec.token_times_s.append(now)
            if st.done():
                rec.done_s = now
                self._done += 1
            else:
                still.append(st)
        self._active = still
        return True

    # ------------------------------------------------------------------
    # workload driving
    def run(self, requests: Any, *, timeout: float = 600.0) -> ServingReport:
        """Drive a whole request stream to completion: submit each request
        when its ``arrival_s`` comes due (arrivals that hit a full
        admission queue wait — their queue delay is the backpressure
        showing up in TTFT), step the decode loop until every request has
        finished, and return the :class:`ServingReport`."""
        pending: Deque[Request] = deque(
            sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        self._reset_clock()
        t_limit = time.monotonic() + timeout
        while pending or len(self._admission) or self._active:
            if time.monotonic() > t_limit:
                raise TimeoutError(
                    f"serving loop exceeded {timeout}s with "
                    f"{len(pending)} pending / {self.in_flight()} in flight")
            now = self._now()
            while pending and pending[0].arrival_s <= now:
                if not self.try_submit(pending[0]):
                    break                      # queue full: backpressure
                pending.popleft()
            worked = self.step()
            if not worked and pending and not len(self._admission):
                # idle gap before the next arrival: jump (virtual clock)
                # or nap (wall clock) instead of spinning
                nxt = pending[0].arrival_s
                if self.step_time is not None:
                    self._vnow = max(self._vnow, nxt)
                else:
                    gap = nxt - self._now()
                    if gap > 0:
                        time.sleep(min(gap, 2e-3))
        return self.report()

    # ------------------------------------------------------------------
    def report(self) -> ServingReport:
        """Snapshot of everything served so far (complete requests only
        appear with their final token streams)."""
        if self._done != len(self._records):
            stranded = [rid for rid, rec in self._records.items()
                        if not rec.done_s]
            raise RuntimeError(
                f"{len(stranded)} request(s) still in flight: "
                f"{stranded[:8]}")
        return ServingReport(
            records=dict(self._records),
            steps=self._steps,
            warm_steps=self._warm_steps,
            lane_steps=self._lane_steps,
            max_batch=self.max_batch,
            wall_s=time.perf_counter() - self._t0,
            shape_counts=dict(self._shape_counts),
        )
