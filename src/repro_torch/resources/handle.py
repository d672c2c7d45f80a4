"""The declarative resource handle.

A :class:`Resource` names a piece of shared state — a KV-cache page, an
optimizer shard, a checkpoint directory — that tasks may use without an
inherent order.  The handle itself carries no runtime state: holders,
wait queues and grant logs live in the per-run
:class:`~repro_torch.resources.arbiter.ResourceArbiter`, so one handle can be
declared across many graphs and many runs concurrently.
"""

from __future__ import annotations

import itertools

# process-wide monotonic uids (names are user-chosen and may collide; the
# flight recorder and arbiter diagnostics tag events with the uid)
_resource_uids = itertools.count()


class Resource:
    """A named, optionally counted resource tasks can declare via
    ``g.add(fn, uses=[res])`` (exclusive) or ``uses_shared=[res]``.

    ``capacity=N`` makes the resource a counting semaphore: up to ``N``
    exclusive holders at once (a page pool, a bounded writer slot set).
    Shared (reader) holders are unlimited among themselves but mutually
    exclusive with any exclusive holder, regardless of capacity.
    """

    __slots__ = ("name", "capacity", "uid", "__weakref__")

    def __init__(self, name: str = "resource", capacity: int = 1):
        if capacity < 1:
            raise ValueError(f"resource capacity must be >= 1, got {capacity}")
        self.name = name
        self.capacity = capacity
        self.uid = next(_resource_uids)

    def __repr__(self) -> str:
        cap = f", capacity={self.capacity}" if self.capacity != 1 else ""
        return f"Resource({self.name!r}{cap})@r{self.uid}"
