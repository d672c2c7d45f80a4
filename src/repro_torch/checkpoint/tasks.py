"""Concurrent checkpoint-writer tasks guarded by a declarative resource.

The port's own copy of the reference's ``repro/checkpoint/tasks.py``
(which imports no JAX), over the port's :mod:`repro_torch.resources` and
:class:`~repro_torch.api.graph.Graph`.

The training-loop consumer of :mod:`repro_torch.resources`: N
shard-writer tasks share one checkpoint *file* resource with **no
ordering edges** between them.  Each writer serializes its shard (the
unguarded compute) and then appends it to the sink while holding the
file; the arbiter grants the file in whatever order the shards finish, so
serialization overlaps across workers while the writes themselves stay
mutually exclusive.  Edges would
also pin the write *order* and forbid the overlap — the resource pins
neither (the paper's conflicts-without-dependencies case).

:class:`CheckpointSink` enforces the invariant at the data layer: a second
``begin_shard`` while a write is open raises :class:`TornWriteError`, and
a crash mid-write leaves the sink torn (``complete`` is False) — the
executor surfaces that as an aborted run whose grants the arbiter provably
dropped (``drain_frames`` → ``ResourceArbiter.abort``; asserted in
``tests/test_torch_checkpoint.py``).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..resources import Resource

__all__ = ["CheckpointSink", "TornWriteError", "checkpoint_resource",
           "add_checkpoint_tasks"]


class TornWriteError(RuntimeError):
    """Two writers interleaved inside the sink — the invariant the file
    resource exists to rule out (only reachable if arbitration is off or
    broken, or a writer crashed and left its write open)."""


class CheckpointSink:
    """An append-only sharded checkpoint with torn-write detection.

    ``begin_shard`` / ``commit_shard`` bracket one shard's write; a second
    ``begin_shard`` while one is open raises :class:`TornWriteError`.  The
    checkpoint is ``complete`` once every expected shard committed and no
    write is open.  With a ``path`` the committed shards are also persisted
    as one JSON file per shard plus a manifest on ``finalize`` (dependency-
    free — the array checkpointer is
    :class:`~repro_torch.checkpoint.Checkpointer`).
    """

    def __init__(self, n_shards: int, path: Optional[str] = None):
        self.n_shards = n_shards
        self.path = path
        self.shards: Dict[int, Any] = {}
        self.write_log: List[int] = []       # commit order (grant order)
        self._open: Optional[int] = None
        self._lock = threading.Lock()
        if path is not None:
            os.makedirs(path, exist_ok=True)

    # -- the guarded critical section ----------------------------------
    def begin_shard(self, shard: int) -> None:
        with self._lock:
            if self._open is not None:
                raise TornWriteError(
                    f"shard {shard} opened while shard {self._open} is "
                    "mid-write: concurrent checkpoint writers")
            self._open = shard

    def commit_shard(self, shard: int, payload: Any) -> None:
        with self._lock:
            if self._open != shard:
                raise TornWriteError(
                    f"commit of shard {shard} but shard {self._open!r} is "
                    "open")
            self.shards[shard] = payload
            self.write_log.append(shard)
            self._open = None
        if self.path is not None:
            with open(os.path.join(self.path, f"shard_{shard:05d}.json"),
                      "w") as f:
                json.dump({"shard": shard, "payload": payload}, f)

    # -- state ----------------------------------------------------------
    @property
    def torn(self) -> bool:
        """A write was begun and never committed (crash mid-write)."""
        return self._open is not None

    @property
    def complete(self) -> bool:
        return not self.torn and len(self.shards) == self.n_shards

    def finalize(self) -> Optional[str]:
        """Write the manifest (requires ``complete``); returns its path."""
        if not self.complete:
            raise TornWriteError(
                f"checkpoint incomplete: {sorted(self.shards)} of "
                f"{self.n_shards} shards, torn={self.torn}")
        if self.path is None:
            return None
        manifest = os.path.join(self.path, "manifest.json")
        with open(manifest, "w") as f:
            json.dump({"n_shards": self.n_shards,
                       "write_log": self.write_log}, f)
        return manifest


def checkpoint_resource(name: str = "checkpoint") -> Resource:
    """The exclusive file resource all writer tasks of one sink share."""
    return Resource(name)


def add_checkpoint_tasks(
    graph,
    sink: CheckpointSink,
    payloads: Sequence[Any],
    *,
    resource: Optional[Resource] = None,
    serialize: Optional[Callable[[int, Any], Any]] = None,
    deps: Sequence[Sequence[Any]] = (),
    crash_on: Optional[int] = None,
) -> List[Any]:
    """Add one writer task per payload shard to ``graph`` (a
    :class:`~repro_torch.api.graph.Graph`), all sharing ``resource`` exclusively
    and with no edges between them.  ``serialize(shard, payload)`` is the
    unguarded per-shard compute (identity by default); ``deps[s]`` are
    optional per-shard upstream edges (the train step that produced the
    shard).  ``crash_on`` makes that shard's writer raise *between*
    ``begin_shard`` and ``commit_shard`` — the torn-write/abort fixture.
    Returns the writer task handles."""
    resource = resource if resource is not None else checkpoint_resource()
    handles = []
    for s, payload in enumerate(payloads):
        def _write(ctx, s=s, payload=payload):
            data = serialize(s, payload) if serialize is not None else payload
            sink.begin_shard(s)
            if crash_on == s:
                raise RuntimeError(f"simulated crash mid-write of shard {s}")
            sink.commit_shard(s, data)
            return s

        shard_deps = deps[s] if s < len(deps) else ()
        handles.append(graph.add(_write, name=f"ckpt_write{s}",
                                 kind="comm", cost=0.2, deps=shard_deps,
                                 uses=[resource]))
    return handles
