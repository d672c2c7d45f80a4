"""Recording cache keyed on graph structure.

A :class:`GraphCache` maps ``(GraphKey digest, n_workers, policy)`` to a
:class:`~repro_torch.replay.recording.Recording`.  The key is purely structural
(see :mod:`~repro_torch.replay.graph_key`), so each iteration of a sweep that
rebuilds the same-shaped graph over fresh data hits the cache after the
first (recording) iteration.

With ``path`` set, recordings persist as one JSON file per cache key under
that directory and survive the process — a second sweep skips the recording
iteration entirely.  A truncated or corrupt cache file is *ignored* (and
quarantined as ``<file>.corrupt``), never fatal: the caller simply misses
and re-records, overwriting the bad entry.

:meth:`GraphCache.swap` atomically replaces an entry (returning the old
recording) — the hot-swap primitive the replay pool uses for adaptive
re-recording — and :meth:`GraphCache.candidates` enumerates every worker
count a digest has been recorded at, which is what worker-count remapping
(:mod:`~repro_torch.replay.remap`) feeds on.

Compiled-plan metadata (the reference package's ``CompiledPlanMeta``
dicts; the port's compiled plans are ROADMAP Queue A item 4) rides alongside recordings under the same cache key as ``<ckey>.plan.json``
(:meth:`store_plan_meta` / :meth:`lookup_plan_meta`): the lowering's shape
— segment counts, fusion coverage, boundary reasons — survives the process
while the executable itself stays memory-only.  Swapping or invalidating a
recording drops its plan metadata too (a new recording means a stale
lowering).

Cross-process safety: the cache directory is a shipment channel between
processes — worker processes, or the reference package and the port, which
read and write one JSON format — so several *processes* write it
concurrently.  Every disk write
goes to a per-writer unique temp file (pid + counter — two writers can
never interleave bytes in one temp path) followed by an atomic
``os.replace``, under an advisory ``fcntl`` lock on ``<file>.lock`` that
serializes writer pairs (and the unlink paths).  Readers never lock:
rename atomicity guarantees they see a complete old or complete new file,
and anything torn by a crashed writer is quarantined as usual.  Note the
*in-memory* layer is per-instance: a long-lived ``GraphCache`` does not
see another process's swap/invalidate until the key misses in memory —
cross-process consumers (pool worker children) open their own instance
per adoption, which reads through to disk.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import threading
from typing import Dict, Iterator, List, Optional, Union

try:                                     # POSIX advisory locks; the cache
    import fcntl                         # degrades to rename-only atomicity
except ImportError:                      # on platforms without fcntl
    fcntl = None                         # type: ignore[assignment]

from ..core.taskgraph import TaskGraph
from .graph_key import GraphKey, graph_key
from .recording import Recording


def cache_key(key: Union[GraphKey, str], n_workers: int, policy: str) -> str:
    digest = key.digest if isinstance(key, GraphKey) else str(key)
    return f"{digest[:32]}_w{n_workers}_{policy}"


_CKEY_RE = re.compile(r"^(?P<digest>[0-9a-f]{32})_w(?P<workers>\d+)_(?P<policy>.+)$")

#: per-process unique temp-file suffixes: concurrent writers (threads in
#: one process, or several processes via the pid component) never share a
#: temp path, so a torn interleaved write is structurally impossible
_TMP_COUNTER = itertools.count()


@contextlib.contextmanager
def _file_lock(target: str) -> Iterator[None]:
    """Advisory exclusive lock on ``target + ".lock"`` (no-op without
    fcntl).  The lock file deliberately does not end in ``.json`` so the
    :meth:`GraphCache.candidates` directory scan never sees it."""
    if fcntl is None:
        yield
        return
    fd = os.open(target + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)


def _atomic_write_json(target: str, payload: dict) -> None:
    """Write ``payload`` to ``target`` so that no reader — same process or
    another — can ever observe torn JSON: unique temp file, fsync-free
    atomic rename, advisory lock across the pair."""
    tmp = f"{target}.{os.getpid()}.{next(_TMP_COUNTER)}.tmp"
    with _file_lock(target):
        try:
            with open(tmp, "w") as fh:
                json.dump(payload, fh)
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):      # failed mid-write: never leak tmps
                try:
                    os.remove(tmp)
                except OSError:
                    pass


class GraphCache:
    """In-memory (and optionally on-disk) recording store."""

    def __init__(self, path: Optional[Union[str, os.PathLike]] = None):
        self.path = os.fspath(path) if path is not None else None
        self._mem: Dict[str, Recording] = {}
        self._plan_meta: Dict[str, dict] = {}
        self._lock = threading.Lock()
        if self.path is not None:
            os.makedirs(self.path, exist_ok=True)

    # ------------------------------------------------------------------
    def _file_for(self, ckey: str) -> Optional[str]:
        if self.path is None:
            return None
        return os.path.join(self.path, f"{ckey}.json")

    def _load_file(self, f: str) -> Optional[Recording]:
        """Parse one on-disk recording; quarantine and miss on corruption."""
        try:
            with open(f) as fh:
                return Recording.from_dict(json.load(fh))
        except FileNotFoundError:
            return None
        except (OSError, ValueError, KeyError, TypeError):
            # truncated write, corrupt JSON, or a schema from another era:
            # move it aside (best effort) so we stop re-parsing it, and let
            # the caller re-record over the key
            try:
                os.replace(f, f + ".corrupt")
            except OSError:
                pass
            return None

    def lookup(
        self,
        graph_or_key: Union[TaskGraph, GraphKey, str],
        n_workers: int,
        policy: str = "hybrid",
    ) -> Optional[Recording]:
        """Return the cached recording for this shape/config, or None."""
        key = (graph_key(graph_or_key) if isinstance(graph_or_key, TaskGraph)
               else graph_or_key)
        ckey = cache_key(key, n_workers, policy)
        with self._lock:
            rec = self._mem.get(ckey)
        if rec is not None:
            return rec
        f = self._file_for(ckey)
        if f is not None and os.path.exists(f):
            rec = self._load_file(f)
            if rec is not None:
                with self._lock:
                    self._mem[ckey] = rec
            return rec
        return None

    def _write(self, ckey: str, recording: Recording) -> None:
        f = self._file_for(ckey)
        if f is not None:
            _atomic_write_json(f, recording.to_dict())

    def store(self, recording: Recording) -> str:
        """Cache ``recording`` (and persist it when on-disk).  Returns the
        cache key."""
        ckey = cache_key(recording.digest, recording.n_workers, recording.policy)
        with self._lock:
            self._mem[ckey] = recording
        self._write(ckey, recording)
        return ckey

    # ------------------------------------------------------------------
    # compiled-plan metadata (rides the recording's cache key)
    def _plan_file_for(self, ckey: str) -> Optional[str]:
        if self.path is None:
            return None
        return os.path.join(self.path, f"{ckey}.plan.json")

    def store_plan_meta(self, key: Union[GraphKey, str], n_workers: int,
                        policy: str, meta: dict) -> str:
        """Persist a compiled plan's descriptive metadata next to the
        recording it was lowered from.  Returns the cache key."""
        ckey = cache_key(key, n_workers, policy)
        with self._lock:
            self._plan_meta[ckey] = dict(meta)
        f = self._plan_file_for(ckey)
        if f is not None:
            _atomic_write_json(f, meta)
        return ckey

    def lookup_plan_meta(self, key: Union[GraphKey, str], n_workers: int,
                         policy: str = "hybrid") -> Optional[dict]:
        """The stored compiled-plan metadata for this shape/config, or
        None (corrupt files miss, like recordings)."""
        ckey = cache_key(key, n_workers, policy)
        with self._lock:
            meta = self._plan_meta.get(ckey)
        if meta is not None:
            return dict(meta)
        f = self._plan_file_for(ckey)
        if f is not None and os.path.exists(f):
            try:
                with open(f) as fh:
                    meta = json.load(fh)
            except (OSError, ValueError):
                return None
            with self._lock:
                self._plan_meta[ckey] = dict(meta)
            return meta
        return None

    def _drop_plan_meta(self, ckey: str) -> None:
        with self._lock:
            self._plan_meta.pop(ckey, None)
        f = self._plan_file_for(ckey)
        if f is not None and os.path.exists(f):
            try:
                with _file_lock(f):
                    os.remove(f)
            except OSError:
                pass

    def swap(self, recording: Recording) -> Optional[Recording]:
        """Hot-swap ``recording`` over whatever the cache held for its key
        and return the replaced recording (None when the slot was empty).
        The in-memory exchange is atomic — concurrent swappers see each
        other's recordings as ``old``, never the same one twice.  On-disk,
        last writer wins (each write is an atomic file replace)."""
        # populate _mem from disk first so a disk-only entry surfaces as old
        self.lookup(recording.digest, recording.n_workers, recording.policy)
        ckey = cache_key(recording.digest, recording.n_workers, recording.policy)
        with self._lock:
            old = self._mem.get(ckey)
            self._mem[ckey] = recording
        self._write(ckey, recording)
        self._drop_plan_meta(ckey)   # a new recording stales any lowering
        return old

    def invalidate(
        self,
        key: Union[GraphKey, str],
        n_workers: int,
        policy: str = "hybrid",
    ) -> bool:
        """Drop an entry from memory and disk.  Returns True if anything
        was removed."""
        ckey = cache_key(key, n_workers, policy)
        with self._lock:
            dropped = self._mem.pop(ckey, None) is not None
        f = self._file_for(ckey)
        if f is not None and os.path.exists(f):
            try:
                with _file_lock(f):
                    os.remove(f)
                dropped = True
            except OSError:
                pass
        self._drop_plan_meta(ckey)
        return dropped

    def candidates(
        self,
        key: Union[GraphKey, str],
        policy: str = "hybrid",
    ) -> Dict[int, Recording]:
        """All recordings of this digest+policy, keyed by worker count —
        the feedstock for worker-count remapping when the exact count
        misses."""
        digest = (key.digest if isinstance(key, GraphKey) else str(key))[:32]
        out: Dict[int, Recording] = {}
        if self.path is not None and os.path.isdir(self.path):
            for fname in os.listdir(self.path):
                if not fname.endswith(".json"):
                    continue
                m = _CKEY_RE.match(fname[:-len(".json")])
                if not m or m.group("digest") != digest or m.group("policy") != policy:
                    continue
                rec = self.lookup(digest, int(m.group("workers")), policy)
                if rec is not None:
                    out[rec.n_workers] = rec
        with self._lock:
            mem = list(self._mem.items())
        for ckey, rec in mem:
            m = _CKEY_RE.match(ckey)
            if m and m.group("digest") == digest and m.group("policy") == policy:
                out[rec.n_workers] = rec
        return out

    def keys(self) -> List[str]:
        with self._lock:
            return sorted(self._mem)

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
            self._plan_meta.clear()
