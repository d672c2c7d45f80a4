"""Worker-count remapping of recordings.

Recordings are JSON-serializable and the on-disk
:class:`~repro_torch.replay.cache.GraphCache` persists them, so a recording made
on a profiling run can be shipped to serving replicas — which rarely run
the same worker count.  :func:`remap_recording` re-keys a recording from
``rec.n_workers`` to any ``new_workers`` so the replay executor can use it
directly:

* **fold / expand** — old worker ``w`` maps to new worker ``w %
  new_workers`` (round-robin).  Folded lists are merged by original list
  position (a stable proxy for recorded start time), so each old worker's
  entries keep their relative order — the executor's invariant that a run
  list is *some* dependency-consistent start order degrades gracefully:
  cross-list inversions introduced by the fold are served by the executor's
  run-ahead window and dynamic fallback, never deadlock.
* **frame adjacency** — a suspended frame's
  :class:`~repro_torch.core.taskgraph.FrameResume` entries are routed to the list
  where the frame's *start* entry lands (its home list), and re-ordered
  start-first / segments-ascending, so one worker owns a frame's whole
  lifecycle after the remap.
* **expansion rebalancing** — expanding to *more* workers would leave the
  extra workers with empty run lists (fallback-only helpers that idle
  through stall windows before stealing).  Instead, each empty worker is
  seeded with the tail half of the currently longest run list's plain-task
  entries (gang entries stay pinned to their placement worker).  Relative
  order within the moved tail and within the donor's remainder is
  preserved, so both remain dependency-consistent start orders; per-task
  claims keep the split correct regardless of how costs shift.
* **gang co-placement** — a placement's workers are folded with the same
  rule, then repaired to stay *distinct* (blocking in-region barriers need
  every ULT on its own kernel thread): colliding threads are reassigned
  round-robin to the nearest free worker, and their run-list entries move
  with them.  A recording whose largest gang exceeds ``new_workers`` cannot
  be remapped (:class:`RemapError`) — replaying it would deadlock.

The remapped recording keeps the original digest (the *graph* is unchanged,
only the slot keying), so it drops into the same :class:`GraphCache` under
the new ``(digest, new_workers, policy)`` key.  Steal decisions are purely
diagnostic and stale after a remap; they are dropped.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..core.taskgraph import FrameResume
from .recording import Entry, GangPlacement, Recording, RecordingError


class RemapError(RecordingError):
    """The recording cannot be re-keyed to the requested worker count."""


def remap_recording(rec: Recording, new_workers: int) -> Recording:
    """Return a copy of ``rec`` re-keyed for ``new_workers`` workers."""
    old = rec.n_workers
    if new_workers < 1:
        raise RemapError(f"cannot remap to {new_workers} workers")
    if new_workers == old:
        return Recording.from_dict(rec.to_dict())
    for p in rec.gang_placements.values():
        if len(p.workers) > new_workers:
            raise RemapError(
                f"recording places a {len(p.workers)}-ULT gang (task "
                f"{p.spawn_tid}); {new_workers} workers cannot host its "
                "blocking barriers")

    # 1. gang placements: fold, then repair collisions so each blocking
    # region keeps distinct workers (reassign round-robin to the next free).
    placements: Dict[int, GangPlacement] = {}
    for tid, p in rec.gang_placements.items():
        used: set = set()
        workers: List[int] = []
        for w in p.workers:
            nw = w % new_workers
            while nw in used:
                nw = (nw + 1) % new_workers
            workers.append(nw)
            used.add(nw)
        placements[tid] = GangPlacement(p.spawn_tid, p.gang_id, workers)
    # every gang entry's target worker under the repaired placements
    gang_target: Dict[Tuple[int, int], int] = {
        (tid, i): w
        for tid, p in placements.items() for i, w in enumerate(p.workers)}

    # 2. run lists: route each entry to its new worker, then merge folded
    # lists stably by (original position, old worker) — original position is
    # the recorded start-order proxy, so intra-worker order is preserved and
    # cross-list interleaving approximates the recorded global order.
    # Frame-resume entries follow their frame's *home list* (wherever the
    # task's start entry lands): a frame recorded as stolen across workers
    # still keeps all of its segments adjacent to its start after the fold,
    # so the remapped owner both starts and resumes it.
    task_target: Dict[int, int] = {}
    for ow, order in enumerate(rec.worker_orders):
        for e in order:
            if isinstance(e, int):
                task_target[e] = ow % new_workers
    buckets: List[List[Tuple[int, int, Entry]]] = [[] for _ in range(new_workers)]
    for ow, order in enumerate(rec.worker_orders):
        for idx, e in enumerate(order):
            if isinstance(e, int):
                target = ow % new_workers
            elif isinstance(e, FrameResume):
                target = task_target.get(e.tid, ow % new_workers)
            else:
                target = gang_target.get((e[0], e[1]), ow % new_workers)
            buckets[target].append((idx, ow, e))
    orders = [[e for _, _, e in sorted(b, key=lambda t: (t[0], t[1]))]
              for b in buckets]
    for order in orders:
        _fix_frame_segment_order(order)
    if new_workers > old:
        _seed_expansion_workers(orders)

    return Recording(
        digest=rec.digest,
        graph_name=rec.graph_name,
        n_workers=new_workers,
        policy=rec.policy,
        worker_orders=orders,
        gang_placements=placements,
        gang_issue_order=list(rec.gang_issue_order),
        steals=[],
        collective_order=list(rec.collective_order),
        # wait_any winners are keyed by (tid, seg) and the resource-grant
        # order is a tid sequence — both slot-independent, so the recorded
        # deterministic choices survive the remap untouched
        wait_choices=dict(rec.wait_choices),
        resource_grants=list(rec.resource_grants),
        source=f"remap[{old}->{new_workers}]:{rec.source}",
    )


def _fix_frame_segment_order(order: List[Entry]) -> None:
    """Restore each task's frame entries to causal order in place: start
    entry first, then resume segments ascending.  A fold can interleave
    source lists such that a stolen frame's segment 2 (recorded on another
    worker, small list index) sorts before segment 1."""
    positions: Dict[int, List[int]] = {}
    for i, e in enumerate(order):
        if isinstance(e, FrameResume):
            positions.setdefault(e.tid, []).append(i)
        elif isinstance(e, int):
            positions.setdefault(e, []).append(i)
    for tid, pos in positions.items():
        if len(pos) < 2:
            continue
        entries = [order[i] for i in pos]
        entries.sort(key=lambda e: 0 if isinstance(e, int) else e.seg)
        for i, e in zip(pos, entries):
            order[i] = e


def _seed_expansion_workers(orders: List[List[Entry]]) -> None:
    """Seed each empty run list with the tail half of the longest list's
    plain-task entries (in place), pulling each moved task's frame-resume
    entries along so a frame's segments stay on its home list.  Gang
    entries never move — their worker is fixed by the (already repaired)
    placement; a donor with fewer than two movable entries leaves the
    target as a fallback-only helper."""
    for w, order in enumerate(orders):
        if order:
            continue
        donor = max(range(len(orders)),
                    key=lambda i: sum(1 for e in orders[i] if isinstance(e, int)))
        movable = [i for i, e in enumerate(orders[donor]) if isinstance(e, int)]
        if len(movable) < 2:
            continue
        tail = movable[len(movable) // 2:]
        moved_tids = {orders[donor][i] for i in tail}
        move_set = set(tail) | {
            i for i, e in enumerate(orders[donor])
            if isinstance(e, FrameResume) and e.tid in moved_tids}
        orders[w] = [orders[donor][i] for i in sorted(move_set)]
        orders[donor] = [e for i, e in enumerate(orders[donor])
                         if i not in move_set]
        _fix_frame_segment_order(orders[w])


def nearest_worker_count(available: List[int], wanted: int) -> int:
    """Pick the best source worker count to remap from: prefer the closest,
    break ties toward the larger recording (folding loses less order
    information than expanding gains)."""
    if not available:
        raise ValueError("no candidate recordings to remap from")
    return min(available, key=lambda w: (abs(w - wanted), -w))
