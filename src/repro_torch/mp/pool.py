"""Spawn-safe worker-process pool with a pipe request protocol.

A :class:`ProcessPool` holds N spawned child processes, each hosting its
own :class:`~repro_torch.api.session.Session` (shared
:class:`~repro_torch.exec.core.ExecutorCore` + :class:`~repro_torch.replay.ReplayPool`)
built from a picklable :class:`WorkerSpec`.  Work crosses a per-child
duplex pipe as ``(seq, op, payload)`` tuples; a per-child reader thread
resolves the matching :class:`~repro_torch.mp.futures.RunFuture` when the
child's ``(seq, status, payload)`` response lands — responses may arrive
out of order (a serving stream answers a submit only when the request
*finishes*), which is the whole point of the seq-matched futures.

Code never crosses the pipe: callables ship as ``"module:qualname"``
references (:func:`callable_ref`) resolved by import inside the child, and
recordings/compiled-plan meta ship through the on-disk
:class:`~repro_torch.replay.cache.GraphCache` named by ``WorkerSpec.cache_path``
— the children adopt the parent's recordings from disk instead of paying
their own recording runs.

Death handling is symmetric:

* children are **daemonic** and treat pipe EOF as the parent-death
  sentinel (their recv loop exits, the worker tears its session down), so
  a dying parent never strands grandchildren;
* the parent's reader thread treats pipe EOF as child death: every
  outstanding future on that worker fails with
  :class:`~repro_torch.mp.futures.WorkerDied` (carrying the worker index), which
  is what lets the serving engine re-route a dead child's requests instead
  of hanging on them.

Children start by ``spawn``, never ``fork``: a parent that has initialised
CUDA, or runs executor threads, cannot fork safely.  Each child imports
the port afresh and opens its own CUDA context on first use; its kernel
wrappers load the libraries the parent built under ``build/kernels/``
(:mod:`~repro_torch.kernels.cuda_lib`), so a parent that builds them
before it spawns spares every child a compile.  Launch counts are per
process: read a child's by shipping a reader to it (:meth:`submit` with
``proc=``).
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
import multiprocessing
import pickle
import threading
from typing import Any, Dict, List, Optional, Tuple

from .futures import RunFuture, WorkerDied

__all__ = ["ProcessPool", "WorkerSpec", "callable_ref", "resolve_ref"]


# ----------------------------------------------------------------------
# shipping callables by reference
def callable_ref(fn: Any) -> str:
    """``fn`` -> ``"module:qualname"``, verified to round-trip.

    Only module-level callables can cross a spawn boundary (the child
    re-imports them); closures, lambdas and locals raise ``ValueError`` so
    callers can fail fast (or fall back) instead of shipping a ref the
    child cannot resolve.
    """
    if isinstance(fn, str):
        resolve_ref(fn)                     # validate early, parent-side
        return fn
    mod = getattr(fn, "__module__", None)
    qual = getattr(fn, "__qualname__", None)
    if not mod or not qual or "<" in qual:
        raise ValueError(
            f"{fn!r} is not shippable to a worker process: only "
            "module-level callables resolve across spawn "
            "(got module={mod!r}, qualname={qual!r})".format(
                fn=fn, mod=mod, qual=qual))
    ref = f"{mod}:{qual}"
    if resolve_ref(ref) is not fn:
        raise ValueError(
            f"{fn!r} does not round-trip through {ref!r} (decorated or "
            "shadowed?); workers would resolve a different object")
    return ref


def resolve_ref(ref: str) -> Any:
    """``"module:qualname"`` -> the callable (child-side import)."""
    mod_name, _, qual = ref.partition(":")
    if not mod_name or not qual:
        raise ValueError(f"malformed callable ref {ref!r} "
                         "(want 'module:qualname')")
    obj: Any = importlib.import_module(mod_name)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


# ----------------------------------------------------------------------
@dataclasses.dataclass
class WorkerSpec:
    """Everything a child needs to build its session — plain picklable
    data.  ``cache_path`` (a directory) is the recording-shipment channel:
    every child opens its own :class:`~repro_torch.replay.cache.GraphCache` over
    the same directory, so parent-seeded recordings are adopted via
    ``GraphCache.candidates`` + ``remap_recording`` with no child-side
    recording run.  ``init`` names a module-level ``fn(ctx)`` run once at
    session build time; its return value becomes ``ctx.state`` (model
    set-up, RNG seeding — anything every later task on that worker needs).
    """

    workers: int = 1
    scheduler: str = "dynamic"
    policy: str = "hybrid"
    gang_default: bool = True
    seed: int = 0
    cache_path: Optional[str] = None
    allow_remap: bool = True
    trace: bool = False
    shared_cores: bool = True
    stall_timeout: float = 1e-3
    block_poll: float = 0.05
    pool_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    init: Optional[str] = None               # "module:qualname" -> fn(ctx)

    @classmethod
    def from_session(cls, session: Any) -> "WorkerSpec":
        """Mirror a parent session's configuration into child processes
        — the scheduler too, ``"compiled"`` included (cache shipment rides
        the session cache's on-disk path, when it has one)."""
        return cls(
            workers=session.workers,
            scheduler=session.scheduler,
            policy=session.policy,
            gang_default=session.gang_default,
            seed=session.seed,
            cache_path=getattr(session.cache, "path", None),
            allow_remap=session.allow_remap,
            trace=False,     # traces are parent-side observability; child
                             # ring buffers would never be shipped back
            shared_cores=session.shared_cores,
            stall_timeout=session.stall_timeout,
            block_poll=session.block_poll,
            pool_kwargs=dict(session.pool_kwargs),
        )


class _Worker:
    """Parent-side handle for one child process."""

    __slots__ = ("index", "process", "conn", "send_lock", "pending",
                 "pending_lock", "alive", "reader", "ready")

    def __init__(self, index: int) -> None:
        self.index = index
        self.process: Any = None
        self.conn: Any = None
        self.send_lock = threading.Lock()
        self.pending: Dict[int, RunFuture] = {}
        self.pending_lock = threading.Lock()
        self.alive = False
        self.reader: Optional[threading.Thread] = None
        self.ready = RunFuture()


class ProcessPool:
    """N spawned worker processes behind seq-matched pipe futures.

    ``request(proc, op, payload)`` is the raw protocol primitive;
    ``submit(fn, *args)`` ships a module-level callable as a ``call`` op
    (round-robin across workers unless ``proc`` pins one).  Use as a
    context manager, or call :meth:`shutdown`.
    """

    #: seq 0 is reserved for the child's ready handshake
    _READY_SEQ = 0

    def __init__(self, procs: int, spec: Optional[WorkerSpec] = None, *,
                 name: str = "repro-mp", start_timeout: float = 120.0):
        if procs < 1:
            raise ValueError(f"a process pool needs >= 1 worker, got {procs}")
        self.spec = spec if spec is not None else WorkerSpec()
        self.n_procs = procs
        self.name = name
        self._ctx = multiprocessing.get_context("spawn")
        self._seq = itertools.count(self._READY_SEQ + 1)
        self._rr = itertools.count()
        self._closed = False
        self._workers: List[_Worker] = [self._spawn(i) for i in range(procs)]
        try:
            for w in self._workers:
                got = w.ready.result(timeout=start_timeout)
                if got[0] != "ready":
                    raise RuntimeError(
                        f"worker {w.index} sent {got!r} instead of the "
                        "ready handshake")
        except BaseException:
            self.shutdown()
            raise

    # ------------------------------------------------------------------
    # lifecycle
    def _spawn(self, index: int) -> _Worker:
        from .worker import worker_main

        w = _Worker(index)
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        w.conn = parent_conn
        w.pending[self._READY_SEQ] = w.ready
        # daemon: the OS reaps the child if the parent dies without a clean
        # shutdown; the child's own recv loop exits on pipe EOF first
        w.process = self._ctx.Process(
            target=worker_main, args=(child_conn, self.spec, index),
            name=f"{self.name}-{index}", daemon=True)
        w.alive = True
        w.process.start()
        child_conn.close()       # the child owns its end now; EOF works
        w.reader = threading.Thread(
            target=self._read_loop, args=(w,),
            name=f"mp-reader-{index}", daemon=True)
        w.reader.start()
        return w

    def _read_loop(self, w: _Worker) -> None:
        while True:
            try:
                # bounded poll instead of a bare recv: a read blocked in
                # the kernel pins the connection's file description open,
                # so a conn.close() from another thread (the simulated
                # parent-death path, or kill()) could never deliver EOF to
                # the child; polling re-checks the handle a few times a
                # second so a close takes effect promptly
                if not w.conn.poll(0.2):
                    continue
                seq, status, payload = w.conn.recv()
            except (EOFError, OSError):
                break
            except (pickle.UnpicklingError, AttributeError, ImportError,
                    IndexError):
                # a reply we cannot decode poisons only itself, not the
                # worker; there is no seq to resolve, so drop it
                continue
            with w.pending_lock:
                fut = w.pending.pop(seq, None)
            if fut is None:
                continue                     # cancelled/unknown seq
            if status == "ok":
                fut.set_result(payload)
            else:
                from .futures import WorkerError
                kind, msg, tb = payload
                fut.set_exception(WorkerError(kind, msg, tb))
        self._mark_dead(w, "pipe closed")

    def _mark_dead(self, w: _Worker, detail: str) -> None:
        w.alive = False
        with w.pending_lock:
            pending, w.pending = dict(w.pending), {}
        for fut in pending.values():
            fut.set_exception(WorkerDied(w.index, detail))

    def alive(self, proc: int) -> bool:
        w = self._workers[proc]
        return w.alive and w.process.is_alive()

    def kill(self, proc: int) -> None:
        """Hard-kill one worker (chaos/testing helper).  Outstanding
        futures on it fail with :class:`WorkerDied` via the reader's EOF."""
        w = self._workers[proc]
        if w.process.is_alive():
            w.process.terminate()
        w.process.join(timeout=5.0)
        try:
            w.conn.close()
        except OSError:
            pass

    def shutdown(self) -> None:
        """Orderly stop: ask every live child to exit, then escalate
        (terminate -> kill) so no child ever outlives the pool."""
        if self._closed:
            return
        self._closed = True
        for w in self._workers:
            if w.alive:
                try:
                    seq = next(self._seq)
                    with w.send_lock:
                        w.conn.send((seq, "shutdown", None))
                except (OSError, ValueError):
                    pass
        for w in self._workers:
            w.process.join(timeout=3.0)
            if w.process.is_alive():
                w.process.terminate()
                w.process.join(timeout=2.0)
            if w.process.is_alive():      # pragma: no cover - last resort
                w.process.kill()
                w.process.join(timeout=2.0)
            try:
                w.conn.close()
            except OSError:
                pass
            self._mark_dead(w, "pool shut down")
            if w.reader is not None:
                w.reader.join(timeout=2.0)
            # release the multiprocessing bookkeeping entry so the suite's
            # orphaned-child check (multiprocessing.active_children) stays
            # clean even right after a shutdown
            w.process.close()

    def __enter__(self) -> "ProcessPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------------------
    # the protocol primitive
    def request(self, proc: int, op: str, payload: Any = None) -> RunFuture:
        """Send one op to worker ``proc``; the returned future resolves
        when (and only when) the child answers its seq."""
        if self._closed:
            raise RuntimeError("ProcessPool is shut down")
        w = self._workers[proc]
        fut = RunFuture()
        if not w.alive:
            fut.set_exception(WorkerDied(proc, "worker is not running"))
            return fut
        seq = next(self._seq)
        with w.pending_lock:
            w.pending[seq] = fut
        try:
            with w.send_lock:
                w.conn.send((seq, op, payload))
        except (pickle.PicklingError, TypeError) as e:
            # unpicklable payload: this request fails, the worker lives
            with w.pending_lock:
                w.pending.pop(seq, None)
            fut.set_exception(e)
        except (BrokenPipeError, EOFError, OSError) as e:
            with w.pending_lock:
                w.pending.pop(seq, None)
            self._mark_dead(w, f"send failed: {e}")
            fut.set_exception(WorkerDied(proc, f"send failed: {e}"))
        return fut

    def broadcast(self, op: str, payload: Any = None) -> List[RunFuture]:
        return [self.request(p, op, payload) for p in range(self.n_procs)]

    # ------------------------------------------------------------------
    # conveniences over the protocol
    def ping(self, proc: int, token: Any = None,
             timeout: float = 30.0) -> Any:
        return self.request(proc, "ping", token).result(timeout=timeout)

    def submit(self, fn: Any, *args: Any, proc: Optional[int] = None,
               **kwargs: Any) -> RunFuture:
        """Ship ``fn(ctx, *args, **kwargs)`` to a worker (round-robin when
        ``proc`` is None).  ``fn`` must be a module-level callable (or an
        explicit ``"module:qualname"`` string); inside the child it
        receives the :class:`~repro_torch.mp.worker.WorkerContext` first."""
        ref = callable_ref(fn)
        if proc is None:
            proc = next(self._rr) % self.n_procs
        return self.request(proc, "call", (ref, args, kwargs))

    def map(self, fn: Any, values: Any, timeout: float = 300.0) -> List[Any]:
        """Round-robin ``fn`` over ``values``; blocks for all results (in
        input order)."""
        futs = [self.submit(fn, v) for v in values]
        return [f.result(timeout=timeout) for f in futs]

    def describe(self) -> Dict[str, Any]:
        return {
            "procs": self.n_procs,
            "alive": [self.alive(p) for p in range(self.n_procs)],
            "pids": [w.process.pid if w.process is not None else None
                     for w in self._workers],
            "spec": dataclasses.asdict(self.spec),
        }


def _split_fns_ref(fns_ref: Any) -> Tuple[str, Dict[str, Any]]:
    """Normalize an engine ``fns_ref`` — ``"mod:qual"`` or
    ``("mod:qual", kwargs)`` — to ``(ref, kwargs)``."""
    if isinstance(fns_ref, (tuple, list)):
        ref, kw = fns_ref
        return str(ref), dict(kw or {})
    return str(fns_ref), {}
