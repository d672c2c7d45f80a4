"""Continuous-batching decode engine.

The port of the reference's ``repro/serving/engine.py``.  One
:class:`ContinuousBatchingEngine` turns a stream of
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
exactly.  A request's arrival is its open-loop due time when it has one
(``Request.arrival_s``; :meth:`run` keeps it, so lateness in releasing it
counts), else the time it was submitted; it is admitted right before its
own prefill, so ``queue_wait_s`` is submit to prefill start.

A step under a torch profiler, or on a session built with ``trace=True``,
records its spans (:mod:`repro_torch.obs.spans`): ``repro.engine.step``,
and inside it, for each request it admits, ``repro.engine.admit`` (the
admission's bookkeeping), ``repro.engine.queue`` (arrival to the start of
its own prefill, wall clock only), ``repro.engine.prefill`` and
``repro.engine.sample`` (each with its device interval on CUDA), all
carrying the rid as their shared id, then ``repro.engine.decode`` around
the lane-step run, and the counter ``repro.engine.admitted``.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ..api.graph import Graph
from ..core.taskgraph import Channel
from ..obs import spans
from .metrics import RequestRecord, ServingReport
from .request import Request, RequestState

DecodeFn = Callable[[Any, Any], Tuple[Any, Any]]   # (cache, tok) -> (cache, logits)
PrefillFn = Callable[[Any], Tuple[Any, Any]]       # prompt -> (cache, logits)
SampleFn = Callable[[Any], Any]                    # logits -> token

#: pool serve modes driven by a warm recording (the hit side of the
#: warm-replay hit rate; warmup/record/rerecord are dynamic serves).
#: ``compiled`` counts as warm: it is the promoted form of a warm replay.
_WARM_MODES = ("replay", "adopt", "remap", "compiled")

_STEP, _ADMIT, _QUEUE = ("repro.engine.step", "repro.engine.admit",
                         "repro.engine.queue")
_PREFILL, _SAMPLE, _DECODE = ("repro.engine.prefill", "repro.engine.sample",
                              "repro.engine.decode")


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
        ``procs=N`` shards :meth:`run` across ``N`` worker *processes*
        (the session's :class:`~repro_torch.mp.ProcessPool`): requests
        route by ``rid % N`` to child-local engines, each with its own
        interpreter — no GIL sharing — and per-request streams stay
        bit-identical because every request decodes against its own KV
        cache regardless of which child batches it.  ``fns_ref`` is then
        required: a module-level factory reference (``"module:qualname"``
        or ``(ref, kwargs)``) returning ``(decode_fn, prefill_fn[,
        sample_fn])`` — code ships by import, never by pickle; each child
        builds its own model (on a CUDA device: its own copy on the card).
        A child that dies mid-stream has its remaining requests served by
        a fresh in-process engine (same fns), so no request is ever
        dropped; ``mp_stats`` says whether that happened.
    """

    #: process-wide unique serve-stream ids (several engines may share one
    #: session's pool)
    _mp_stream_ids = itertools.count(1)

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
            if procs < 1:
                raise ValueError(f"procs must be >= 1 (or None), got {procs}")
            if fns_ref is None:
                raise ValueError(
                    "procs=N needs fns_ref: child processes rebuild the "
                    "engine fns from a module-level factory reference "
                    "(callables do not cross a spawn boundary)")
        capacity = (2 * max_batch if admission_capacity is None
                    else admission_capacity)
        if capacity < 1:
            raise ValueError(
                f"admission_capacity must be >= 1, got {capacity}")
        if sample_fn is None:
            from ..models.serving import greedy_sample
            sample_fn = greedy_sample
        self.session = session
        self._traced = bool(getattr(session, "trace", False))
        self.max_batch = max_batch
        self.step_time = step_time
        self.procs = procs
        self.fns_ref = fns_ref
        #: per-proc summaries / fallback accounting of the last mp run
        self.mp_stats: Optional[Dict[str, Any]] = None
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
        self._trace: Optional[Any] = None
        self._trace_k = 0
        self._vnow = 0.0
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------------
    # clock
    def _now(self) -> float:
        if self.step_time is not None:
            return self._vnow
        return time.perf_counter() - self._t0

    def _at(self, t: float) -> float:
        """Engine time of the ``perf_counter`` reading ``t``."""
        if self.step_time is not None:
            return self._vnow
        return t - self._t0

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
        """Enqueue ``request`` for admission; it arrives at its
        ``arrival_s``, or now when that is None.  When the bounded queue
        is full: raise :class:`AdmissionFull` (default), or with ``block``
        wait for a decode step to drain a slot — up to ``timeout`` seconds
        (forever when None).  Thread-safe."""
        arrival = request.arrival_s
        self._enqueue(request, self._now() if arrival is None else arrival,
                      block, timeout)

    def _enqueue(self, request: Request, arrival: float, block: bool,
                 timeout: Optional[float]) -> None:
        if request.rid in self._records:
            raise ValueError(f"duplicate request id {request.rid}")
        self._records[request.rid] = RequestRecord(
            rid=request.rid, arrival_s=arrival)
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
    def _admit(self, sp: Optional[spans.Spans]) -> int:
        """Fill free lanes from the admission queue; prefill each admitted
        request (its first token comes from the prefill logits), stamping
        its admission right before its own prefill.  Requests whose budget
        is 1 token (or whose first token is EOS) complete here without
        ever occupying a decode slot.  Returns how many were admitted."""
        admitted = 0
        while len(self._active) < self.max_batch:
            if sp is not None:
                t_admit = time.perf_counter()
            ok, req = self._admission.try_recv()
            if not ok:
                break
            admitted += 1
            rid = req.rid
            rec = self._records[rid]
            t = time.perf_counter()
            rec.admitted_s = self._at(t)
            if sp is not None:
                sp.span(_ADMIT, t_admit, t, key=rid)
                if self.step_time is None:
                    sp.span(_QUEUE, rec.arrival_s + self._t0, t, key=rid)
                sid = sp.begin(_PREFILL, t)
            cache, logits = self._prefill_fn(req.prompt)
            if sp is not None:
                sp.end(sid, key=rid)
                sid = sp.begin(_SAMPLE)
            st = RequestState(req, cache, self._sample_fn(logits))
            tid = st.note_token(st.tok)
            t = time.perf_counter()
            if sp is not None:
                sp.end(sid, t, key=rid)
            t_first = self._at(t)
            rec.first_token_s = t_first
            rec.tokens.append(tid)
            rec.token_times_s.append(t_first)
            if st.done():
                rec.done_s = t_first
                self._done += 1
            else:
                self._active.append(st)
        if sp is not None:
            sp.count("repro.engine.admitted", admitted)
        return admitted

    def step(self) -> bool:
        """Admit arrivals into free lanes, then run one decode step over
        the in-flight set.  Returns False when there was nothing to do."""
        sp = spans.open_call(_STEP, traced=self._traced)
        if sp is None:
            return self._step(None)
        try:
            return self._step(sp)
        finally:
            sp.close()

    def _step(self, sp: Optional[spans.Spans]) -> bool:
        admitted = self._admit(sp)
        if not self._active:
            return admitted > 0
        k = len(self._active)
        graph, key = self._graph_for(k)
        if sp is not None:
            sid = sp.begin(_DECODE)
        report = self.session.run(graph, key=key)
        if sp is not None:
            sp.end(sid)
        if self.step_time is not None:
            self._vnow += self.step_time
        now = self._now()
        self._steps += 1
        self._lane_steps += k
        self._shape_counts[k] = self._shape_counts.get(k, 0) + 1
        if report.stats.get("pool_mode") in _WARM_MODES:
            self._warm_steps += 1
        if report.trace is not None and k >= self._trace_k:
            # keep the most heavily loaded step's trace: the steady-state
            # window a trace export wants
            self._trace, self._trace_k = report.trace, k
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
        if self.procs is not None:
            return self._run_mp(requests, timeout=timeout)
        pending: Deque[Tuple[float, Request]] = deque(sorted(
            ((r.arrival_s or 0.0, r) for r in requests),
            key=lambda dr: (dr[0], dr[1].rid)))
        self._reset_clock()
        t_limit = time.monotonic() + timeout
        while pending or len(self._admission) or self._active:
            if time.monotonic() > t_limit:
                raise TimeoutError(
                    f"serving loop exceeded {timeout}s with "
                    f"{len(pending)} pending / {self.in_flight()} in flight")
            now = self._now()
            while pending and pending[0][0] <= now:
                try:
                    # arrives when due: a late release still counts
                    self._enqueue(pending[0][1], pending[0][0], False, None)
                except AdmissionFull:
                    break                      # queue full: backpressure
                pending.popleft()
            worked = self.step()
            if not worked and pending and not len(self._admission):
                # idle gap before the next arrival: jump (virtual clock)
                # or nap (wall clock) instead of spinning
                nxt = pending[0][0]
                if self.step_time is not None:
                    self._vnow = max(self._vnow, nxt)
                else:
                    gap = nxt - self._now()
                    if gap > 0:
                        time.sleep(min(gap, 2e-3))
        return self.report()

    # ------------------------------------------------------------------
    # sharded multi-process serving
    def _run_mp(self, requests: Any, *, timeout: float) -> ServingReport:
        """Drive the stream across the session's process pool.

        Requests shard by ``rid % procs`` into per-child serve streams;
        the parent releases each request when its ``arrival_s`` comes due
        (parent **wall** clock — children may run a virtual clock for
        deterministic latency numbers, but admission ordering is real
        time), throttled to a per-child outstanding cap of
        ``admission_capacity + max_batch`` on top of the child's own
        bounded queue.  A child-side :class:`AdmissionFull` crosses the
        pipe as a failed future and the request is retried; a dead child
        moves its unfinished shard to an in-process fallback engine.  The
        merged report carries every request's record plus the summed child
        step counters."""
        from ..mp.futures import WorkerDied, WorkerError

        pool = self.session.process_pool(self.procs)
        n = pool.n_procs
        sid = next(self._mp_stream_ids)
        open_futs = pool.broadcast("serve_open", {
            "stream": sid,
            "fns_ref": self.fns_ref,
            "engine": {"max_batch": self.max_batch,
                       "admission_capacity": self.admission_capacity,
                       "step_time": self.step_time},
        })
        live = set()
        for p, fut in enumerate(open_futs):
            try:
                fut.result(timeout=60.0)
                live.add(p)
            except (WorkerDied, WorkerError):
                pass
        if not live:
            raise RuntimeError(
                f"no live worker process accepted serve stream {sid}")

        shards: Dict[int, Deque[Request]] = {p: deque() for p in range(n)}
        for req in sorted(requests, key=lambda r: (r.arrival_s or 0.0, r.rid)):
            shards[req.rid % n].append(req)
        retries: Dict[int, Deque[Request]] = {p: deque() for p in range(n)}
        outstanding: Dict[int, int] = {p: 0 for p in range(n)}
        peak: Dict[int, int] = {p: 0 for p in range(n)}
        cap = self.admission_capacity + self.max_batch
        in_flight: List[Tuple[Any, int, Request]] = []
        records: Dict[int, RequestRecord] = {}
        fallback: List[Request] = []
        dead: List[int] = []

        def _bury(p: int) -> None:
            """Move everything worker ``p`` still owes to the fallback.
            Records the death even when ``p`` never went live (a worker
            killed while its serve_open was still in flight)."""
            live.discard(p)
            if p not in dead:
                dead.append(p)
            fallback.extend(retries[p])
            retries[p].clear()
            fallback.extend(shards[p])
            shards[p].clear()

        for p in range(n):
            if p not in live:
                _bury(p)

        t0 = time.perf_counter()
        t_limit = time.monotonic() + timeout
        while any(shards.values()) or any(retries.values()) or in_flight:
            if time.monotonic() > t_limit:
                raise TimeoutError(
                    f"mp serving loop exceeded {timeout}s with "
                    f"{len(in_flight)} submits outstanding")
            now = time.perf_counter() - t0
            progressed = False
            for p in list(live):
                queue = retries[p] if retries[p] else shards[p]
                while (queue and outstanding[p] < cap
                       and (queue is retries[p]
                            or (queue[0].arrival_s or 0.0) <= now)):
                    req = queue.popleft()
                    fut = pool.request(
                        p, "serve_submit", {"stream": sid, "request": req})
                    in_flight.append((fut, p, req))
                    outstanding[p] += 1
                    peak[p] = max(peak[p], outstanding[p])
                    progressed = True
                    queue = retries[p] if retries[p] else shards[p]
            still: List[Tuple[Any, int, Request]] = []
            for fut, p, req in in_flight:
                if not fut.done():
                    still.append((fut, p, req))
                    continue
                outstanding[p] -= 1
                progressed = True
                try:
                    rec = fut.result(timeout=0)
                except WorkerError as e:
                    if e.kind == "AdmissionFull":
                        retries[p].append(req)   # backpressure: resubmit
                    else:
                        _bury(p)
                        fallback.append(req)
                except WorkerDied:
                    _bury(p)
                    fallback.append(req)
                else:
                    records[rec.rid] = rec
            in_flight = still
            if not progressed:
                time.sleep(1e-3)

        summaries: List[Dict[str, Any]] = []
        for p in sorted(live):
            try:
                summaries.append(pool.request(
                    p, "serve_close", {"stream": sid}).result(timeout=60.0))
            except (WorkerDied, WorkerError):
                dead.append(p)

        steps = sum(s["steps"] for s in summaries)
        warm_steps = sum(s["warm_steps"] for s in summaries)
        lane_steps = sum(s["lane_steps"] for s in summaries)
        shape_counts: Dict[int, int] = {}
        for s in summaries:
            for k, c in s["shape_counts"].items():
                shape_counts[k] = shape_counts.get(k, 0) + c
        if fallback:
            # a dead child's stranded requests are re-served in-process:
            # per-request KV caches make the token streams identical to
            # what the child would have produced
            rescue = ContinuousBatchingEngine(
                self.session, self._decode_fn, self._prefill_fn,
                sample_fn=self._sample_fn, max_batch=self.max_batch,
                admission_capacity=self.admission_capacity,
                step_time=self.step_time)
            report = rescue.run(fallback, timeout=timeout)
            records.update(report.records)
            steps += report.steps
            warm_steps += report.warm_steps
            lane_steps += report.lane_steps
            for k, c in report.shape_counts.items():
                shape_counts[k] = shape_counts.get(k, 0) + c
        self.mp_stats = {
            "stream": sid,
            "per_proc": summaries,
            "dead": sorted(set(dead)),
            "fallback": len(fallback),
            "peak_outstanding": peak,
            "cap": cap,
        }
        return ServingReport(
            records=records,
            steps=steps,
            warm_steps=warm_steps,
            lane_steps=lane_steps,
            max_batch=self.max_batch,
            wall_s=time.perf_counter() - t0,
            shape_counts=shape_counts,
            trace=None,
        )

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
            trace=self._trace,
        )
