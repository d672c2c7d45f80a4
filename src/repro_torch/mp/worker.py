"""Child-process side of the :class:`~repro_torch.mp.pool.ProcessPool` protocol.

``worker_main`` is the spawn target: it sends the ready handshake, then
loops on ``conn.recv()`` dispatching ``(seq, op, payload)`` requests into
a :class:`WorkerContext` — a lazily built
:class:`~repro_torch.api.session.Session` (with its own shared
:class:`~repro_torch.exec.core.ExecutorCore` / :class:`~repro_torch.replay.ReplayPool`)
plus any serving streams the parent opened.  **Pipe EOF is the
parent-death sentinel**: the recv loop exits, the context tears the
session down and force-stops the shared-core registry, and the (daemonic)
process ends — children never outlive the parent.

Serving streams (``serve_open`` / ``serve_submit`` / ``serve_close``) run
a child-local :class:`~repro_torch.serving.engine.ContinuousBatchingEngine` on a
driver thread; a ``serve_submit`` is answered *when the request finishes*
(with its :class:`~repro_torch.serving.metrics.RequestRecord`), which is how
per-request completion crosses the pipe without any polling protocol on
top.  A submit that hits the child's bounded admission queue answers
immediately with an ``AdmissionFull`` error — backpressure propagates to
the parent as a failed future it can retry, on top of its own
outstanding-cap throttling.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from typing import Any, Dict, Optional, Tuple

from .pool import WorkerSpec, _split_fns_ref, resolve_ref
from .tasks import portable

__all__ = ["WorkerContext", "worker_main"]


class WorkerContext:
    """Per-process service state handed to every shipped callable."""

    def __init__(self, conn: Any, spec: WorkerSpec, index: int):
        self.conn = conn
        self.spec = spec
        self.index = index
        self.state: Any = None               # spec.init's return value
        self._send_lock = threading.Lock()
        self._session: Optional[Any] = None
        self._streams: Dict[int, _ServeStream] = {}

    # ------------------------------------------------------------------
    # replies (recv loop + serve driver threads both send)
    def reply(self, seq: int, status: str, payload: Any) -> None:
        """Answer ``seq``; every torch tensor in ``payload`` goes as a
        numpy copy (:func:`~repro_torch.mp.tasks.portable`), never as a
        tensor."""
        try:
            payload = portable(payload)
            with self._send_lock:
                self.conn.send((seq, status, payload))
        except (BrokenPipeError, OSError):
            pass                             # parent is gone; we exit soon
        except Exception as e:               # unpicklable payload
            self.reply_err(seq, TypeError(
                f"worker reply for seq {seq} is not picklable: {e!r}"))

    def reply_err(self, seq: int, exc: BaseException) -> None:
        payload = (type(exc).__name__, str(exc),
                   "".join(traceback.format_exception(
                       type(exc), exc, exc.__traceback__)))
        try:
            with self._send_lock:
                self.conn.send((seq, "err", payload))
        except (BrokenPipeError, OSError):
            pass

    # ------------------------------------------------------------------
    @property
    def session(self) -> Any:
        """The child's session, built on first use from the spec (the
        on-disk cache directory is the recording-shipment channel)."""
        if self._session is None:
            from ..api.session import Session
            from ..replay.cache import GraphCache

            spec = self.spec
            cache = (GraphCache(spec.cache_path)
                     if spec.cache_path else None)
            self._session = Session(
                spec.workers, scheduler=spec.scheduler, policy=spec.policy,
                gang_default=spec.gang_default, seed=spec.seed, cache=cache,
                allow_remap=spec.allow_remap, trace=spec.trace,
                shared_cores=spec.shared_cores,
                stall_timeout=spec.stall_timeout,
                block_poll=spec.block_poll,
                pool_kwargs=dict(spec.pool_kwargs))
            if spec.init is not None:
                self.state = resolve_ref(spec.init)(self)
        return self._session

    # ------------------------------------------------------------------
    def dispatch(self, seq: int, op: str, payload: Any) -> None:
        if op == "ping":
            self.reply(seq, "ok", payload)
        elif op == "call":
            ref, args, kwargs = payload
            fn = resolve_ref(ref)
            self.reply(seq, "ok", fn(self, *args, **(kwargs or {})))
        elif op == "serve_open":
            sid = int(payload["stream"])
            if sid in self._streams:
                raise ValueError(f"serve stream {sid} is already open")
            self._streams[sid] = _ServeStream(
                self, payload["fns_ref"], dict(payload.get("engine") or {}))
            self.reply(seq, "ok", None)
        elif op == "serve_submit":
            stream = self._streams[int(payload["stream"])]
            stream.submit(seq, payload["request"])   # answered at finish
        elif op == "serve_close":
            stream = self._streams.pop(int(payload["stream"]))
            stream.close(seq)                        # answered at drain
        else:
            raise ValueError(f"unknown worker op {op!r}")

    def teardown(self) -> None:
        for stream in list(self._streams.values()):
            stream.abort()
        self._streams.clear()
        if self._session is not None:
            try:
                self._session.close()
            except Exception:
                pass
            self._session = None
        # a worker process hosts exactly one tenant: force-stop whatever
        # shared cores are still registered so the interpreter exits with
        # no live worker threads (daemon or not, a clean exit beats a reap)
        try:
            from ..exec.registry import REGISTRY
            REGISTRY.shutdown_all()
        except Exception:
            pass


class _ServeStream:
    """One continuous-batching engine driven by pipe submits.

    The driver thread owns every engine mutation except
    :meth:`ContinuousBatchingEngine.submit` (documented thread-safe); the
    stream lock only guards the seq bookkeeping (`_pending`, the close
    seq).  Completion detection reuses the engine's own semantics — token
    budget reached or EOS drawn — instead of ``done_s``, which is a valid
    0.0 under the virtual clock.
    """

    def __init__(self, ctx: WorkerContext, fns_ref: Any,
                 engine_kwargs: Dict[str, Any]):
        from ..serving.engine import ContinuousBatchingEngine

        ref, factory_kwargs = _split_fns_ref(fns_ref)
        fns = resolve_ref(ref)(**factory_kwargs)
        decode_fn, prefill_fn, sample_fn = (tuple(fns) + (None,))[:3]
        self.ctx = ctx
        self.engine = ContinuousBatchingEngine(
            ctx.session, decode_fn, prefill_fn, sample_fn=sample_fn,
            **engine_kwargs)
        self._lock = threading.Lock()
        self._pending: Dict[int, Tuple[int, Any]] = {}   # rid -> (seq, req)
        self._close_seq: Optional[int] = None
        self._aborted = False
        self._wake = threading.Event()
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(
            target=self._drive, name=f"mp-serve-drive-{ctx.index}",
            daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    # recv-loop side
    def submit(self, seq: int, request: Any) -> None:
        # AdmissionFull propagates to the dispatcher, which answers the
        # seq with an err the parent can retry on
        self.engine.submit(request)
        with self._lock:
            self._pending[request.rid] = (seq, request)
        self._wake.set()

    def close(self, seq: int) -> None:
        with self._lock:
            self._close_seq = seq
        self._wake.set()

    def abort(self) -> None:
        self._aborted = True
        self._wake.set()
        self._thread.join(timeout=5.0)

    # ------------------------------------------------------------------
    @staticmethod
    def _finished(rec: Any, req: Any) -> bool:
        if len(rec.tokens) >= req.max_new_tokens:
            return True
        eos = req.eos_token
        return (eos is not None and bool(rec.tokens)
                and rec.tokens[-1] == eos)

    def _drive(self) -> None:
        engine = self.engine
        while not self._aborted:
            worked = engine.step()
            done = []
            with self._lock:
                for rid, (seq, req) in list(self._pending.items()):
                    rec = engine._records.get(rid)
                    if rec is not None and self._finished(rec, req):
                        done.append((seq, rec))
                        del self._pending[rid]
                idle = (not self._pending and not engine.in_flight()
                        and not engine.queue_depth())
                close_seq = self._close_seq if idle else None
            for seq, rec in done:
                self.ctx.reply(seq, "ok", rec)
            if close_seq is not None:
                self.ctx.reply(close_seq, "ok", self.summary())
                return
            if not worked and not done:
                self._wake.wait(1e-3)
                self._wake.clear()

    def summary(self) -> Dict[str, Any]:
        """The child-side counters the parent folds into its merged
        :class:`~repro_torch.serving.metrics.ServingReport` — including the
        pool's per-shape record/adopt counters, which is how "children
        replay warm without re-recording" becomes assertable."""
        e = self.engine
        pool_stats: Dict[str, Any] = {}
        records = rerecords = 0
        sess = self.ctx._session
        if (sess is not None and sess.scheduler == "pool"
                and sess._pool is not None):
            pool_stats = sess._pool.describe()
            for st in pool_stats.values():
                records += int(st.get("records", 0))
                rerecords += int(st.get("rerecords", 0))
        return {
            "pid": os.getpid(),
            "proc": self.ctx.index,
            "steps": e._steps,
            "warm_steps": e._warm_steps,
            "lane_steps": e._lane_steps,
            "shape_counts": dict(e._shape_counts),
            "completed": e._done,
            "records": records,
            "rerecords": rerecords,
            "pool": pool_stats,
            "wall_s": time.perf_counter() - self._t0,
        }


def worker_main(conn: Any, spec: WorkerSpec, index: int) -> None:
    """Spawn target: handshake, serve the pipe, die with the parent."""
    ctx = WorkerContext(conn, spec, index)
    ctx.reply(0, "ok", ("ready", os.getpid()))
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break                        # parent died: EOF sentinel
            seq, op, payload = msg
            if op == "shutdown":
                ctx.reply(seq, "ok", None)
                break
            try:
                ctx.dispatch(seq, op, payload)
            except BaseException as e:       # noqa: BLE001 - shipped back
                ctx.reply_err(seq, e)
    finally:
        ctx.teardown()
        try:
            conn.close()
        except OSError:
            pass
