"""Single-threaded driver for compiled plans.

The dynamic executor loses throughput as workers grow because every task
pays GIL-bound Python dispatch (deque locks, park/wake, per-task context
churn); a compiled plan removes the scheduler entirely.  The driver walks
the serial program emitted by :func:`~repro_torch.compile.compile_recording`:
fused segments are one callable each, opaque bodies run inline, and parked
frames resume at their recorded positions with recorded ``wait_any``
winners pinned — Python survives only *between* segments.

The program order is the recording's merged order, which is one valid
dependency-consistent serialization; because every write is gated by graph
edges (and channel/event values flow through explicit requests), any
dependency-consistent serial order is value-deterministic, so compiled
results are bit-identical to the dynamic run that produced the recording.
When an entry is momentarily not runnable (a frame resume whose channel
fills later in the program), the driver deterministically skips ahead to
the first runnable entry and retries the blocked prefix after each step.

Nested gang regions run inline with *real* threads behind the region
barrier — panel bodies interleave phases across threads via
``region.barrier()`` with cross-thread reductions, so serializing thread
bodies would be wrong, not just slow.

On a CUDA device every ``jitted`` segment is captured as a CUDA graph at
its first run and replayed after that, against storage the executor owns
(:mod:`repro_torch.compile.capture`); each run copies its tiles in and its
results out in bulk.  Task bodies and replays only *enqueue* device work,
so ``stats["body_s"]`` and ``stats["wall_s"]`` are host seconds up to the
enqueue; time the device by bracketing :meth:`CompiledExecutor.run` with
``torch.cuda.synchronize()``.

A run under a torch profiler, or with ``trace=True``, records its spans
(:mod:`repro_torch.obs.spans`): ``repro.compiled.run``, and inside it
``repro.compiled.bind``, one span a program entry
(``repro.compiled.graph``, a captured segment's replay;
``repro.compiled.segment``, a fused segment run as it is;
``repro.compiled.task``, an opaque body or a frame's resume) and
``repro.compiled.release``, each with its device interval on CUDA; the
clock reads that time the bodies and binds for ``stats`` time the spans
too.

Limitation: suspension must use generator frames (``yield ctx.recv(...)``).
A *plain* body that blocks on an empty channel would deadlock a
single-threaded driver; the adapter raises :class:`CompiledRunError`
immediately instead.  Such an error may come after some segments ran, and
their effects on the graph's state stay (as in the reference package); a
caller that falls back re-runs those tasks on the changed state (ROADMAP
Queue C).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from types import GeneratorType
from typing import Any, Dict, List, Optional, Tuple

from ..core.taskgraph import (
    Channel,
    TaskContext,
    TaskEvent,
    TaskFrame,
    TaskGraph,
    WaitAnyRequest,
    YieldRequest,
)
from ..obs import spans
from ..replay.graph_key import graph_key
from ..resources.arbiter import grants_by_resource, task_needs
from .plan import CompiledPlan

__all__ = ["CompiledExecutor", "CompiledRunError"]

_RUN, _BIND, _RELEASE = ("repro.compiled.run", "repro.compiled.bind",
                         "repro.compiled.release")
_GRAPH, _SEGMENT, _TASK = ("repro.compiled.graph", "repro.compiled.segment",
                           "repro.compiled.task")


class CompiledRunError(RuntimeError):
    """Compiled execution cannot make progress (stale plan / plain-body
    blocking).  Callers fall back to replay or dynamic execution.  A CUDA
    capture or replay error is not one of these: it raises as it is."""


class _GangBarrierRegion:
    """Region handle for nested parallel bodies: a real ``threading.Barrier``
    so phase-interleaved panel protocols (shared scratch, thread-0
    reductions) stay correct."""

    __slots__ = ("_barrier", "n_threads")

    def __init__(self, n_threads: int):
        self.n_threads = n_threads
        self._barrier = threading.Barrier(n_threads)

    def barrier(self) -> None:
        self._barrier.wait()


class _SerialRuntimeAdapter:
    """The duck-typed runtime interface ``TaskContext`` probes, scoped to
    single-threaded compiled execution."""

    def parallel(self, n_threads: int, body, *, gang=None, spawn_ctx=None):
        if n_threads <= 1:
            region = _GangBarrierRegion(1)
            return [body(0, region)]
        region = _GangBarrierRegion(n_threads)
        results: List[Any] = [None] * n_threads
        errors: List[BaseException] = []

        def run(t: int) -> None:
            try:
                results[t] = body(t, region)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)
                region._barrier.abort()

        threads = [threading.Thread(target=run, args=(t,), daemon=True)
                   for t in range(1, n_threads)]
        for th in threads:
            th.start()
        run(0)
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        return results

    # plain-body suspension: a single-threaded driver cannot wait — satisfy
    # immediately or fail loudly (generator frames are the supported path)
    def ctx_recv(self, channel: Channel, ctx) -> Any:
        ok, value = channel.try_recv()
        if not ok:
            raise CompiledRunError(
                f"plain-body recv on empty channel in task "
                f"{ctx.task.name!r}: compiled plans require generator "
                "frames for suspension")
        return value

    def ctx_send(self, channel: Channel, value: Any, ctx) -> None:
        ok, _ = channel.try_send(value)
        if not ok:
            raise CompiledRunError(
                f"plain-body send on full channel in task {ctx.task.name!r}: "
                "compiled plans require generator frames for suspension")

    def ctx_wait(self, event: TaskEvent, ctx) -> None:
        if not event.is_set():
            raise CompiledRunError(
                f"plain-body wait on unset event in task {ctx.task.name!r}: "
                "compiled plans require generator frames for suspension")

    def ctx_wait_any(self, request: WaitAnyRequest, ctx) -> Any:
        ok, value = request.try_immediate()
        if not ok:
            raise CompiledRunError(
                f"plain-body wait_any with no ready source in task "
                f"{ctx.task.name!r}")
        return value

    def ctx_yield(self, ctx) -> None:
        return None


class CompiledExecutor:
    """Executes a :class:`~repro_torch.compile.CompiledPlan` against same-digest
    graphs.  ``stats`` after each run reports wall time, time spent inside
    task bodies / fused kernels, and the resulting
    ``dispatch_overhead_fraction`` — the number the compilation exists to
    crush.  On CUDA both times are host seconds up to the enqueue of the
    run's device work, and ``stats`` adds ``captured_graphs`` (segments
    holding a CUDA graph), ``graphs_captured_this_run``, ``capture_s``
    (this run's capture seconds) and ``bind_s`` (this run's bulk copies in
    and out).  ``last_trace`` is the spans of a traced run (a
    :class:`~repro_torch.obs.trace.RuntimeTrace`), None otherwise."""

    def __init__(self, graph: TaskGraph, plan: CompiledPlan):
        self.plan = plan
        self.graph = graph
        self.stats: Dict[str, Any] = {}
        self.last_trace = None
        self._adapter = _SerialRuntimeAdapter()
        # the state keys the capturable segments touch: bound to storage
        # of this executor's own when a run's state lives on CUDA
        keys: Dict[Any, None] = {}
        for entry in plan.program:
            if entry[0] == "fused" and entry[1].jitted:
                keys.update(dict.fromkeys(entry[1].ext_keys))
                keys.update(dict.fromkeys(entry[1].out_keys))
        self._binding = None
        if keys:
            from .capture import DeviceBinding
            self._binding = DeviceBinding(list(keys))

    # ------------------------------------------------------------------
    def run(self, graph: Optional[TaskGraph] = None, *,
            check_digest: bool = True, trace: bool = False
            ) -> Dict[int, Any]:
        tg = graph if graph is not None else self.graph
        if check_digest and tg is not self.graph:
            if graph_key(tg).digest != self.plan.recording.digest:
                raise CompiledRunError(
                    f"graph {tg.name!r} does not match compiled plan digest "
                    f"{self.plan.recording.digest[:16]}")
        state = getattr(tg, "fuse_state", None)
        if state is None and self.plan.meta.n_fused:
            raise CompiledRunError(
                f"graph {tg.name!r} has fused segments but no fuse_state")

        results: Dict[int, Any] = {}
        completed: set = set()
        frames: Dict[int, TaskFrame] = {}      # parked frames by tid
        wait_choices = self.plan.recording.wait_choices
        adapter = self._adapter
        tasks = tg.tasks
        body_s = 0.0
        skip_ahead = 0
        perf = time.perf_counter

        # resource grant discipline: skip-ahead may not reorder conflicting
        # tasks, so a declaring task runs only at the head of its derived
        # per-resource grant queues; each start appends to the grant log,
        # compared per resource against the recording after the run.
        needs_map = {t.tid: task_needs(tg, t.tid) for t in tasks
                     if getattr(t, "uses", ()) or getattr(t, "uses_shared", ())}
        rqueues = {r: deque(tids) for r, tids in grants_by_resource(
            tg, self.plan.recording.resource_grants).items()} if needs_map else {}
        grant_log: List[int] = []

        def grant_turn(tids) -> bool:
            for tid in tids:
                for r, _ in needs_map.get(tid, ()):
                    q = rqueues[r]
                    if q and q[0] != tid:
                        return False
            return True

        def log_grants(tids) -> None:
            for tid in tids:
                if tid in needs_map:
                    for r, _ in needs_map[tid]:
                        q = rqueues[r]
                        if q and q[0] == tid:
                            q.popleft()
                    grant_log.append(tid)

        remaining: List[Tuple[Any, ...]] = list(self.plan.program)
        t_start = perf()
        sp = spans.open_call(_RUN, traced=trace, t=t_start)
        self.last_trace = None
        # on CUDA the captured graphs run against the executor's storage:
        # the run's tensors are copied in here and back out at the end
        binding = self._binding
        mine = None
        graphs = 0
        try:
            if sp is not None:
                sid = sp.begin(_BIND, t_start)
            mine = binding.bind(state) if binding is not None else None
            if mine is None:
                binding = None
            else:
                captured0, capture_s0 = binding.captured, binding.capture_s
            t1 = perf()
            bind_s = t1 - t_start
            if sp is not None:
                sp.end(sid, t1)
            while remaining:
                ran_index = -1
                for i, entry in enumerate(remaining):
                    kind = entry[0]
                    if kind == "fused":
                        seg = entry[1]
                        if not seg.ext_deps.issubset(completed):
                            continue
                        if needs_map and not grant_turn(seg.tids):
                            continue
                        log_grants(seg.tids)
                        t0 = perf()
                        if sp is not None:
                            # no entry enters the profiler's trace: the 511
                            # of an n = 7,680 factorization would cost the
                            # card ~5 points of its busy share (PERF.md §6)
                            captured = binding is not None and seg.jitted
                            graphs += captured
                            sid = sp.begin(_GRAPH if captured else _SEGMENT,
                                           t0, mirror=False)
                        seg(state, results, binding)
                        t1 = perf()
                        completed.update(seg.tids)
                    elif kind == "task":
                        tid = entry[1]
                        task = tasks[tid]
                        if any(d not in completed for d in task.deps):
                            continue
                        if needs_map and not grant_turn((tid,)):
                            continue
                        log_grants((tid,))
                        t0 = perf()
                        if sp is not None:
                            sid = sp.begin(_TASK, t0, mirror=False)
                        done = self._start_task(tg, task, results, frames,
                                                adapter)
                        t1 = perf()
                        if done:
                            completed.add(tid)
                    else:  # ("resume", tid, seg)
                        tid, seg_no = entry[1], entry[2]
                        frame = frames.get(tid)
                        if frame is None or frame.resumes + 1 != seg_no:
                            continue
                        ok, value = self._poll(frame, tid, seg_no,
                                               wait_choices)
                        if not ok:
                            continue
                        frame.resumes += 1
                        t0 = perf()
                        if sp is not None:
                            sid = sp.begin(_TASK, t0, mirror=False)
                        done = self._advance(frame, value, results, frames)
                        t1 = perf()
                        if done:
                            completed.add(tid)
                    body_s += t1 - t0
                    if sp is not None:
                        sp.end(sid, t1)
                    ran_index = i
                    break
                if ran_index < 0:
                    stuck = [e[0:2] if e[0] != "fused" else ("fused", e[1].tids)
                             for e in remaining[:4]]
                    raise CompiledRunError(
                        f"compiled run stalled on {tg.name!r}: no runnable "
                        f"entry among {len(remaining)} remaining (head: "
                        f"{stuck!r})")
                skip_ahead += ran_index
                del remaining[ran_index]
        finally:
            if mine is not None:
                t0 = perf()
                if sp is not None:
                    sid = sp.begin(_RELEASE, t0)
                binding.release(state, mine)
                t1 = perf()
                bind_s += t1 - t0
                if sp is not None:
                    sp.end(sid, t1)
            t_end = perf()
            if sp is not None:
                sp.count("repro.compiled.entries",
                         len(self.plan.program) - len(remaining))
                sp.count("repro.compiled.graphs", graphs)
                sp.count("repro.compiled.skip_ahead", skip_ahead)
                sp.close(t_end)
                if trace:
                    self.last_trace = spans.span_trace(root=sp.root)
        wall_s = t_end - t_start

        if frames:
            raise CompiledRunError(
                f"compiled run left {len(frames)} frame(s) parked on "
                f"{tg.name!r}: {sorted(frames)!r}")
        if needs_map:
            want = grants_by_resource(tg, self.plan.recording.resource_grants)
            got = grants_by_resource(tg, grant_log)
            if got != want:
                raise CompiledRunError(
                    f"compiled run diverged from the recorded resource grant "
                    f"order on {tg.name!r}: got {got!r}, recorded {want!r}")
        self.stats = {
            "wall_s": wall_s,
            "body_s": body_s,
            "dispatch_overhead_fraction":
                max(0.0, 1.0 - body_s / wall_s) if wall_s > 0 else 0.0,
            "segments": self.plan.meta.n_segments,
            "fused_tasks": self.plan.meta.n_fused_tasks,
            "opaque_tasks": self.plan.meta.n_opaque,
            "resumes": self.plan.meta.n_resumes,
            "skip_ahead": skip_ahead,
            "resource_grants": len(grant_log),
        }
        if binding is not None:
            self.stats.update(
                captured_graphs=binding.captured,
                graphs_captured_this_run=binding.captured - captured0,
                capture_s=binding.capture_s - capture_s0,
                bind_s=bind_s)
        return results

    # ------------------------------------------------------------------
    def _start_task(self, tg: TaskGraph, task, results: Dict[int, Any],
                    frames: Dict[int, TaskFrame], adapter) -> bool:
        ctx = TaskContext(tg, task, results, runtime=adapter)
        ctx.worker_id = 0  # type: ignore[attr-defined]
        result = task.fn(ctx) if task.fn is not None else None
        if isinstance(result, GeneratorType):
            ctx._in_frame = True
            frame = TaskFrame(task, ctx, result)
            return self._advance(frame, None, results, frames)
        results[task.tid] = result
        return True

    def _advance(self, frame: TaskFrame, value: Any,
                 results: Dict[int, Any], frames: Dict[int, TaskFrame]) -> bool:
        """Step a frame until done or parked.  Mirrors the dynamic
        executor's recording-mode behaviour: EVERY request parks, so the
        program's resume entries align one-to-one."""
        while True:
            status, payload = frame.step(value)
            if status == "done":
                results[frame.task.tid] = payload
                frames.pop(frame.task.tid, None)
                return True
            frame.request = payload
            frames[frame.task.tid] = frame
            return False

    def _poll(self, frame: TaskFrame, tid: int, seg_no: int,
              wait_choices: Dict[Tuple[int, int], int]) -> Tuple[bool, Any]:
        """Is the parked frame's request satisfiable now?  Consuming probe:
        on success the popped value feeds the resume immediately."""
        request = frame.request
        if isinstance(request, YieldRequest):
            frame.request = None
            return True, None
        if isinstance(request, WaitAnyRequest):
            winner = wait_choices.get((tid, seg_no))
            if winner is not None:
                request = request.pinned(winner)
        ok, value = request.try_immediate()
        if ok:
            frame.request = None
        return ok, value
