"""Replay-serving pool: warm leased workers with adaptive re-recording.

A steady-state serving loop (``repro_torch.serving``: one decode-step graph
per request) re-executes the same graph *shape* indefinitely.  Running each
request through :func:`~repro_torch.core.runtime.run_graph` pays per-request
runtime construction — thread spawn, queue allocation — on top of dynamic
scheduling.  :class:`ReplayPool` keeps one warm
:class:`~repro_torch.exec.core.ExecutorCore` per **worker count** and, per
``(GraphKey digest, n_workers, policy)``, a prepared replay dispatch
(:class:`~repro_torch.replay.executor.ReplayExecutor` leasing the shared core).
Total threads are capped by the set of distinct worker counts — not by the
number of shapes — and every path (warmup, recording, replay) runs on the
same warm substrate:

* **first requests** for a shape run dynamically *on the shared core*:
  ``warmup_runs`` requests unrecorded (so first-call costs — kernel
  builds, cold caches — do not skew the recorded placement), then one recording run — or the pool adopts
  a recording already in the :class:`~repro_torch.replay.cache.GraphCache` (e.g.
  shipped from a profiling run) with no dynamic run at all;
* **worker-count remapping** — when the cache holds the shape only at a
  different worker count, the pool re-keys it via
  :func:`~repro_torch.replay.remap.remap_recording` instead of paying a fresh
  recording run;
* **adaptive re-recording** — after every replay the pool reads
  ``ReplayExecutor.stats``; when the drift rate ``(fallback_steals +
  skips) / n_entries`` stays above ``drift_threshold`` for
  ``drift_patience`` consecutive runs, the recording is declared stale.
  (Fallback steals and skips are *plan deviations* — work executed off its
  recorded slot.  Raw stall counts are deliberately excluded: a worker
  legitimately idles through many stall windows while a long task body it
  depends on runs to completion.)
  The next request then re-records: inline (that request runs dynamically
  with instrumentation on — it is served normally, its recording is the
  fresh one) or, when a side-effect-free graph *builder* was registered via
  :meth:`register_builder`, in a **background thread** that records the
  builder's twin graph on transient workers while requests keep replaying
  the stale recording.  Either way the new recording is hot-swapped into
  the ``GraphCache`` (:meth:`GraphCache.swap`) and the entry's executor is
  rebuilt;
* **latency-aware drift** — deviation-rate triggers miss recordings that
  are *consistently imbalanced* (zero steals, long stalls baked into the
  placement).  With ``latency_drift_factor`` set, the pool tracks an EWMA
  of per-run replay wall clock against an EWMA of the entry's dynamic runs
  (warmups, recordings, re-recordings); a replay EWMA above ``factor ×``
  the dynamic baseline for ``drift_patience`` consecutive runs also
  triggers re-recording — even at zero fallback steals;
* **multi-tenant cap** — ``max_shapes`` bounds the number of resident
  entries; inserting past the cap evicts the least-recently-used
  ``(GraphKey, workers, policy)`` entry, releasing its core lease (cheap:
  no threads die — the shared cores stay warm).  A request racing its own
  entry's eviction completes normally on a fresh lease.

The reference package's warm → compiled promotion (``compile_after``) and
flight-recorder traces (``trace=True``) reach modules the port does not
have yet; both raise ``NotImplementedError`` naming their ROADMAP item.

Thread safety: requests for the same shape serialize on the entry lock;
requests for different shapes at the same worker count serialize on the
shared core (one run at a time per core); different worker counts run
concurrently on their own cores.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from ..api.session import not_ported
from ..core.policies import resolve as resolve_policy
from ..core.taskgraph import TaskGraph
from ..exec.core import ExecutorCore
from ..exec.registry import release_shared_core, shared_core
from .cache import GraphCache, cache_key
from .executor import ReplayExecutor
from .graph_key import GraphKey, graph_key
from .recording import Recording, RecordingError
from .remap import RemapError, nearest_worker_count, remap_recording


@dataclasses.dataclass
class PoolRun:
    """One served request, structured: results, the recording that is (or
    just became) live for the shape, how the request was served (``mode``:
    ``warmup`` / ``record`` / ``adopt`` / ``remap`` / ``rerecord`` /
    ``replay``) and a snapshot of the entry's serving counters.  For
    replay serves ``stats["replay_stats"]`` carries the executor's raw
    deviation counters (``fallback_steals`` / ``stalls`` / ``skips`` /
    ``run_ahead``) so a slow row is explainable from the outcome alone.
    The session API wraps this into a
    :class:`~repro_torch.api.session.RunReport`; the legacy
    :meth:`ReplayPool.run` returns just ``results``."""

    results: Dict[int, Any]
    recording: Optional[Recording]
    mode: str
    stats: Dict[str, Any]


@dataclasses.dataclass
class PoolEntryStats:
    """Per-(shape, workers, policy) serving counters."""

    requests: int = 0
    replays: int = 0
    warmups: int = 0          # unrecorded dynamic runs before recording
    records: int = 0          # cold dynamic recording runs
    remaps: int = 0           # recordings adopted via worker-count remap
    rerecords: int = 0        # adaptive re-recording swaps
    drift: float = 0.0        # last observed plan-deviation rate
    drift_strikes: int = 0    # consecutive runs past the threshold
    replay_ms: float = 0.0    # EWMA of replay wall clock
    dynamic_ms: float = 0.0   # EWMA of dynamic-run wall clock (baseline)
    latency_strikes: int = 0  # consecutive replays past the latency factor
    clean_replays: int = 0    # consecutive deviation-free replays

    def as_dict(self) -> Dict[str, Any]:
        # hand-rolled: this runs on EVERY serve (the outcome snapshot), and
        # dataclasses.asdict is slower on that path
        return {
            "requests": self.requests,
            "replays": self.replays,
            "warmups": self.warmups,
            "records": self.records,
            "remaps": self.remaps,
            "rerecords": self.rerecords,
            "drift": self.drift,
            "drift_strikes": self.drift_strikes,
            "replay_ms": self.replay_ms,
            "dynamic_ms": self.dynamic_ms,
            "latency_strikes": self.latency_strikes,
            "clean_replays": self.clean_replays,
        }


class _PoolEntry:
    """One per-shape lease (executor + recording) + drift bookkeeping."""

    __slots__ = ("executor", "recording", "n_entries", "lock",
                 "stats", "needs_rerecord", "rerecord_inflight", "last_error")

    def __init__(self) -> None:
        self.executor: Optional[ReplayExecutor] = None
        self.recording: Optional[Recording] = None
        self.n_entries = 1
        self.lock = threading.Lock()
        self.stats = PoolEntryStats()
        self.needs_rerecord = False
        self.rerecord_inflight = False
        self.last_error: Optional[BaseException] = None


class ReplayPool:
    """Persistent replay-serving pool (see module docstring).

    Parameters
    ----------
    cache:
        Backing :class:`GraphCache` (fresh in-memory one by default).  Give
        it a ``path`` to adopt recordings shipped from other processes and
        to persist re-recordings.
    drift_threshold / drift_patience:
        A replay whose ``(fallback steals + skips) / entries`` rate exceeds
        ``drift_threshold`` counts one strike; ``drift_patience`` strikes in
        a row trigger re-recording.
    latency_drift_factor:
        When set, a replay wall-clock EWMA above ``factor ×`` the entry's
        dynamic-baseline EWMA counts a latency strike; ``drift_patience``
        strikes in a row trigger re-recording even at zero plan deviation.
        ``None`` (default) disables the latency trigger.
    latency_alpha:
        EWMA smoothing for the wall-clock trackers.
    allow_remap:
        On a cache miss for the exact worker count, remap the nearest
        recorded worker count instead of recording from scratch.
    warmup_runs:
        Dynamic *unrecorded* requests served before the recording run when
        no cached recording exists.  The first execution of a shape
        typically pays one-off costs (kernel builds, cold allocator) that
        would bake a skewed task placement into the recording; recording a
        warm run captures the steady-state schedule.  Adopted/remapped
        recordings skip warmup entirely.
    max_shapes:
        Cap on resident ``(GraphKey, workers, policy)`` entries; the
        least-recently-used entry past the cap is evicted and its core
        lease released.  ``None`` (default) keeps every shape.
    compile_after:
        The reference's warm → compiled promotion; anything but ``None``
        raises ``NotImplementedError`` (ROADMAP Queue A item 4).
    stall_timeout:
        Forwarded to each :class:`ReplayExecutor`.
    trace:
        The reference's traced serves; ``True`` raises
        ``NotImplementedError`` (ROADMAP Queue A item 5).
    shared_cores:
        Lease worker cores from the process-global
        :class:`~repro_torch.exec.registry.CoreRegistry` (default): several pools
        in one process share one core per worker count, so total threads
        are capped across tenants.  ``False`` gives this pool private
        cores (the pre-registry behavior — full isolation).
    """

    def __init__(
        self,
        cache: Optional[GraphCache] = None,
        *,
        drift_threshold: float = 0.25,
        drift_patience: int = 3,
        latency_drift_factor: Optional[float] = None,
        latency_alpha: float = 0.3,
        allow_remap: bool = True,
        warmup_runs: int = 1,
        compile_after: Optional[int] = None,
        max_shapes: Optional[int] = None,
        stall_timeout: float = 1e-3,
        trace: bool = False,
        shared_cores: bool = True,
    ):
        if max_shapes is not None and max_shapes < 1:
            raise ValueError("max_shapes must be >= 1 (or None for no cap)")
        if compile_after is not None:
            raise not_ported("compiled")
        if trace:
            raise not_ported("trace")
        self.cache = cache if cache is not None else GraphCache()
        self.drift_threshold = drift_threshold
        self.drift_patience = drift_patience
        self.latency_drift_factor = latency_drift_factor
        self.latency_alpha = latency_alpha
        self.allow_remap = allow_remap
        self.warmup_runs = warmup_runs
        self.max_shapes = max_shapes
        self.stall_timeout = stall_timeout
        self.shared_cores = shared_cores
        self.last_recording: Optional[Recording] = None
        self.evictions = 0

        self._entries: Dict[str, _PoolEntry] = {}   # insertion order = LRU
        self._cores: Dict[int, ExecutorCore] = {}   # one per worker count
        self._builders: Dict[str, Callable[[], TaskGraph]] = {}
        self._lock = threading.Lock()
        self._closed = False

    # ------------------------------------------------------------------
    # lifecycle
    def shutdown(self) -> None:
        """Release every lease and stop the shared cores.  Terminal: later
        :meth:`run` calls raise (a request racing shutdown either completes
        first — shutdown waits on its entry lock — or observes the closed
        flag before it can install an executor nobody could ever stop)."""
        with self._lock:
            self._closed = True
            entries = list(self._entries.values())
            self._entries.clear()
            cores = list(self._cores.values())
            self._cores.clear()
        for entry in entries:
            self._release_entry(entry)
        for core in cores:
            if self.shared_cores:
                release_shared_core(core)   # last lessee stops the threads
            else:
                core.shutdown()

    def _release_entry(self, entry: _PoolEntry) -> None:
        """Shut an evicted/closed entry's lease down cleanly: waits for any
        in-flight request (the entry lock) before dropping the executor."""
        with entry.lock:
            if entry.executor is not None:
                entry.executor.shutdown()
                entry.executor = None
            entry.needs_rerecord = False

    def __enter__(self) -> "ReplayPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # ------------------------------------------------------------------
    # shared worker substrate
    def _core_for(self, n_workers: int) -> ExecutorCore:
        """The warm core for this worker count (leased lazily).  Every shape
        at this count — and its warmup/recording dynamic runs — shares these
        threads; with ``shared_cores`` (default) the lease comes from the
        process-global registry, so other pools share them too."""
        with self._lock:
            if self._closed:
                raise RuntimeError("ReplayPool is shut down")
            core = self._cores.get(n_workers)
            if core is None:
                if self.shared_cores:
                    core = shared_core(n_workers)
                else:
                    core = ExecutorCore(
                        n_workers, name=f"pool{n_workers}-worker")
                    core.start()
                self._cores[n_workers] = core
            return core

    # ------------------------------------------------------------------
    # introspection
    def describe(self) -> Dict[str, Dict[str, Any]]:
        """{cache key: stats dict} for every shape the pool has served."""
        with self._lock:
            entries = dict(self._entries)
        return {ckey: e.stats.as_dict() for ckey, e in entries.items()}

    def register_builder(
        self,
        key: Union[TaskGraph, GraphKey, str],
        builder: Callable[[], TaskGraph],
    ) -> None:
        """Register a zero-arg factory producing a fresh, *side-effect-free*
        graph of this shape (e.g. a decode step over scratch state).  With a
        builder registered, adaptive re-recording runs in a background
        thread on the builder's twin graph instead of making a request pay
        the dynamic run."""
        digest = self._digest_of(key)
        with self._lock:
            self._builders[digest] = builder

    @staticmethod
    def _digest_of(key: Union[TaskGraph, GraphKey, str]) -> str:
        if isinstance(key, TaskGraph):
            return graph_key(key).digest
        return key.digest if isinstance(key, GraphKey) else str(key)

    # ------------------------------------------------------------------
    # serving
    def serve(
        self,
        graph: TaskGraph,
        n_workers: int,
        *,
        policy: str = "hybrid",
        gang_default: bool = True,
        seed: int = 0,
        timeout: float = 300.0,
        key: Optional[GraphKey] = None,
    ) -> PoolRun:
        """Serve one execution of ``graph``; returns a :class:`PoolRun`
        (results + recording + how the request was served) — no state is
        smuggled through pool attributes.

        ``gang_default`` / ``seed`` configure the dynamic dispatch used for
        warmup, recording, and re-recording runs (replays are driven purely
        by the recording).  They are not part of the entry key: one shape
        should be served under one scheduling configuration.

        ``key`` skips the per-request structural hash when the caller
        already knows it (e.g. a decode loop rebuilding one shape — see
        :func:`repro_torch.models.decode_graph_key`); the executor still enforces
        the 1:1 task cover, so a wrong key fails loudly, not silently."""
        resolve_policy(policy)
        if key is None:
            key = graph_key(graph)
        ckey = cache_key(key, n_workers, policy)
        evicted: List[_PoolEntry] = []
        with self._lock:
            if self._closed:
                raise RuntimeError("ReplayPool is shut down")
            entry = self._entries.pop(ckey, None)
            if entry is None:
                entry = _PoolEntry()
            self._entries[ckey] = entry          # (re)insert: most recent
            if self.max_shapes is not None:
                while len(self._entries) > self.max_shapes:
                    oldest = next(iter(self._entries))
                    evicted.append(self._entries.pop(oldest))
                    self.evictions += 1
            builder = self._builders.get(key.digest)
        for old in evicted:
            self._release_entry(old)

        rt_kwargs = {"policy": policy, "gang_default": gang_default,
                     "seed": seed}
        with entry.lock:
            if self._closed:
                raise RuntimeError("ReplayPool is shut down")
            entry.stats.requests += 1
            if entry.executor is None:
                results, mode, replayed = self._materialize(
                    entry, key, graph, n_workers, rt_kwargs, timeout)
                return self._outcome(entry, results, mode, replayed=replayed)
            if entry.needs_rerecord:
                if builder is None:
                    results = self._rerecord_inline(
                        entry, graph, n_workers, rt_kwargs, timeout)
                    return self._outcome(entry, results, "rerecord")
                if not entry.rerecord_inflight:
                    entry.rerecord_inflight = True
                    threading.Thread(
                        target=self._rerecord_background,
                        args=(entry, builder, n_workers, rt_kwargs, timeout),
                        daemon=True,
                        name=f"replay-pool-rerecord-{ckey[:12]}",
                    ).start()
            results = self._replay(entry, graph, timeout)
            return self._outcome(entry, results, "replay", replayed=True)

    @staticmethod
    def _outcome(entry: _PoolEntry, results: Dict[int, Any], mode: str, *,
                 replayed: bool = False) -> PoolRun:
        stats = entry.stats.as_dict()
        if replayed and entry.executor is not None:
            # raw deviation counters of THIS replay — a speedup<1 row is
            # explainable from the outcome alone (fallback steals, stalls,
            # skips), without cross-referencing pool.describe()
            stats["replay_stats"] = dict(entry.executor.stats)
        return PoolRun(results=results, recording=entry.recording,
                       mode=mode, stats=stats)

    def run(
        self,
        graph: TaskGraph,
        n_workers: int,
        *,
        policy: str = "hybrid",
        gang_default: bool = True,
        seed: int = 0,
        timeout: float = 300.0,
        key: Optional[GraphKey] = None,
    ) -> Dict[int, Any]:
        """Legacy entry point: serve and return the bare ``{tid: result}``
        dict.  ``self.last_recording`` is refreshed for old callers; new
        code should use :meth:`serve` (or a ``Session(scheduler="pool")``)
        and read the recording off the returned :class:`PoolRun`."""
        out = self.serve(graph, n_workers, policy=policy,
                         gang_default=gang_default, seed=seed,
                         timeout=timeout, key=key)
        self.last_recording = out.recording
        return out.results

    def _replay(self, entry: _PoolEntry, graph: TaskGraph,
                timeout: float) -> Dict[int, Any]:
        t0 = time.perf_counter()
        results = entry.executor.run(graph, timeout=timeout)
        elapsed = time.perf_counter() - t0
        entry.stats.replays += 1
        self._observe_drift(entry, elapsed)
        return results

    # ------------------------------------------------------------------
    # entry construction paths
    def _materialize(
        self,
        entry: _PoolEntry,
        key: GraphKey,
        graph: TaskGraph,
        n_workers: int,
        rt_kwargs: Dict[str, Any],
        timeout: float,
    ) -> Tuple[Dict[int, Any], str, bool]:
        """Cold path: adopt / remap / record, install the lease, serve.
        Returns ``(results, mode, replayed)`` — ``replayed`` says the
        serve itself was driven by the installed executor (adopt/remap),
        not a dynamic run."""
        policy = rt_kwargs["policy"]
        mode = "adopt"
        rec = self.cache.lookup(key, n_workers, policy)
        if rec is None and self.allow_remap:
            rec = self._remap_from_cache(entry, key, n_workers, policy)
            mode = "remap"
        if rec is not None:
            self._install(entry, rec)
            if (self.latency_drift_factor is not None
                    and entry.stats.dynamic_ms == 0.0):
                # adopted/remapped recordings arrive with no dynamic runs:
                # without a baseline the latency trigger could never fire —
                # precisely for the shipped recordings most likely to be
                # imbalanced.  One dynamic probe seeds the EWMA.
                entry.stats.warmups += 1
                results, _, elapsed = self._run_dynamic(
                    graph, n_workers, rt_kwargs, timeout, record=False)
                self._note_dynamic(entry, elapsed)
                return results, mode, False
            return self._replay(entry, graph, timeout), mode, True
        if entry.stats.warmups < self.warmup_runs:
            # serve cold requests dynamically without recording: the first
            # executions pay one-off costs (kernel builds) whose skew would
            # otherwise be baked into the recorded placement
            entry.stats.warmups += 1
            results, _, elapsed = self._run_dynamic(
                graph, n_workers, rt_kwargs, timeout, record=False)
            self._note_dynamic(entry, elapsed)
            return results, "warmup", False
        results, recording, elapsed = self._run_dynamic(
            graph, n_workers, rt_kwargs, timeout, record=True)
        entry.stats.records += 1
        self._note_dynamic(entry, elapsed)
        self.cache.store(recording)
        self._install(entry, recording)
        return results, "record", False

    def _remap_from_cache(
        self,
        entry: _PoolEntry,
        key: GraphKey,
        n_workers: int,
        policy: str,
    ) -> Optional[Recording]:
        donors = self.cache.candidates(key, policy)
        donors.pop(n_workers, None)          # exact hits were already tried
        while donors:
            src = nearest_worker_count(list(donors), n_workers)
            try:
                rec = remap_recording(donors.pop(src), n_workers)
            except RemapError:
                continue                     # e.g. a gang too wide — next donor
            self.cache.store(rec)
            entry.stats.remaps += 1
            return rec
        return None

    def _run_dynamic(
        self,
        graph: TaskGraph,
        n_workers: int,
        rt_kwargs: Dict[str, Any],
        timeout: float,
        *,
        record: bool,
        transient: bool = False,
    ) -> Tuple[Dict[int, Any], Optional[Recording], float]:
        """One dynamic run on the shared warm core (or on transient private
        threads when ``transient`` — the background re-record path, which
        must not occupy the serving core)."""
        from ..core.runtime import Runtime

        core = None if transient else self._core_for(n_workers)
        rt = Runtime(n_workers, core=core, **rt_kwargs)
        with rt:
            t0 = time.perf_counter()
            results = rt.run(graph, timeout=timeout, record=record)
            elapsed = time.perf_counter() - t0
        return results, rt.last_recording, elapsed

    def _install(self, entry: _PoolEntry, recording: Recording) -> None:
        """(Re)build the entry's executor lease around ``recording``."""
        if entry.executor is not None:
            entry.executor.shutdown()
        entry.recording = recording
        entry.n_entries = max(
            1, sum(len(o) for o in recording.worker_orders))
        entry.executor = ReplayExecutor(
            recording, stall_timeout=self.stall_timeout, check_digest=False,
            core=self._core_for(recording.n_workers))
        entry.executor.start()
        entry.needs_rerecord = False
        entry.stats.drift_strikes = 0
        entry.stats.latency_strikes = 0
        entry.stats.clean_replays = 0

    # ------------------------------------------------------------------
    # adaptive re-recording (plan deviation + latency regression)
    def _ewma(self, old: float, sample_ms: float) -> float:
        if old <= 0.0:
            return sample_ms
        return old + self.latency_alpha * (sample_ms - old)

    def _note_dynamic(self, entry: _PoolEntry, elapsed_s: float) -> None:
        entry.stats.dynamic_ms = self._ewma(entry.stats.dynamic_ms,
                                            elapsed_s * 1e3)

    def _observe_drift(self, entry: _PoolEntry, elapsed_s: float) -> None:
        stats = entry.executor.stats
        st = entry.stats
        drift = (stats.get("fallback_steals", 0)
                 + stats.get("skips", 0)) / entry.n_entries
        st.drift = drift
        if drift > self.drift_threshold:
            st.drift_strikes += 1
        else:
            st.drift_strikes = 0
        # latency-aware drift: a consistently imbalanced recording can
        # replay deviation-free yet much slower than dynamic scheduling
        st.replay_ms = self._ewma(st.replay_ms, elapsed_s * 1e3)
        if (self.latency_drift_factor is not None and st.dynamic_ms > 0.0
                and st.replay_ms > st.dynamic_ms * self.latency_drift_factor):
            st.latency_strikes += 1
        else:
            st.latency_strikes = 0
        if (st.drift_strikes >= self.drift_patience
                or st.latency_strikes >= self.drift_patience):
            entry.needs_rerecord = True
        # a replay that earned no strike of either kind is "clean"
        if (st.drift_strikes == 0 and st.latency_strikes == 0
                and not entry.needs_rerecord):
            st.clean_replays += 1
        else:
            st.clean_replays = 0

    def _rerecord_inline(
        self,
        entry: _PoolEntry,
        graph: TaskGraph,
        n_workers: int,
        rt_kwargs: Dict[str, Any],
        timeout: float,
    ) -> Dict[int, Any]:
        """Serve this request dynamically with instrumentation on; its
        recording replaces the stale one (the request itself is the
        re-record — no double execution of side-effecting task bodies)."""
        rec = entry.recording
        if rec is not None and len(graph) != rec.n_tasks():
            # the replay path would catch a wrong-shaped graph at the 1:1
            # cover check; a drift-triggered re-record must not silently
            # adopt it instead (the precomputed-key safety contract)
            raise RecordingError(
                f"graph has {len(graph)} tasks but the entry's recording "
                f"covers {rec.n_tasks()}: wrong graph for this pool key")
        results, recording, elapsed = self._run_dynamic(
            graph, n_workers, rt_kwargs, timeout, record=True)
        entry.stats.rerecords += 1
        self._note_dynamic(entry, elapsed)
        self.cache.swap(recording)
        self._install(entry, recording)
        return results

    def _rerecord_background(
        self,
        entry: _PoolEntry,
        builder: Callable[[], TaskGraph],
        n_workers: int,
        rt_kwargs: Dict[str, Any],
        timeout: float,
    ) -> None:
        """Record the builder's twin graph off the request path — on
        transient threads, so the serving core stays free for replays —
        then hot-swap recording + executor under the entry lock."""
        try:
            twin = builder()
            _, recording, elapsed = self._run_dynamic(
                twin, n_workers, rt_kwargs, timeout, record=True,
                transient=True)
            with entry.lock:
                with self._lock:
                    live = any(e is entry for e in self._entries.values())
                if not live:
                    # the pool was shut down (or the entry evicted) while we
                    # recorded: installing would resurrect a lease nobody
                    # can reach — drop the recording
                    return
                entry.stats.rerecords += 1
                self._note_dynamic(entry, elapsed)
                self.cache.swap(recording)
                self._install(entry, recording)
        except BaseException as e:  # noqa: BLE001 - surfaced via last_error
            entry.last_error = e
            with entry.lock:
                entry.needs_rerecord = False   # do not spin on a broken twin
        finally:
            entry.rerecord_inflight = False
