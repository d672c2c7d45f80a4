"""Conflict-aware resource arbitration (deadlock-free by construction).

The arbiter grants a task's *entire* declared resource set atomically at
dispatch time (all-or-nothing): a task never holds one resource while
waiting for another, so there is no hold-and-wait and conflict scheduling
alone can never deadlock — the classic QuickSched argument.  Contended
tasks are deferred on a single global FIFO wait list and re-granted
fairly on release: a waiter is overtaken only by tasks whose resource
sets are disjoint from every earlier waiter's, so no task starves.

Two modes share the holder accounting:

* **dynamic** — grants in arrival order, defers on contention, and logs
  the global grant order (the ``resource_grants`` section of a
  :class:`~repro_torch.replay.recording.Recording`);
* **pinned** (replay / compiled) — a recorded grant order is replayed:
  a task is grantable only when it is at the head of the recorded
  per-resource grant queue *and* capacity is free, which reproduces the
  recorded acquisition order bit-identically.  Per-resource queues are
  derived from one recorded total order, so they can never cross-block.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from .handle import Resource

#: a task's deduplicated declaration: ((rindex, shared), ...)
Needs = Tuple[Tuple[int, bool], ...]


def task_needs(graph, tid: int) -> Needs:
    """The (rindex, shared) pairs task ``tid`` declares, deduplicated
    (exclusive wins when a resource appears in both lists)."""
    task = graph.tasks[tid]
    index = graph.resource_index()
    out: Dict[int, bool] = {}
    for r in getattr(task, "uses_shared", ()):
        out[index[id(r)]] = True
    for r in getattr(task, "uses", ()):
        out[index[id(r)]] = False
    return tuple(sorted(out.items()))


def grants_by_resource(graph, grants: Sequence[int]) -> Dict[int, List[int]]:
    """Derive per-resource grant sequences from a global grant order —
    the determinism contract replay enforces and tests compare."""
    out: Dict[int, List[int]] = {i: [] for i in range(len(graph.resources))}
    for tid in grants:
        for rindex, _shared in task_needs(graph, tid):
            out[rindex].append(tid)
    return out


class ResourceArbiter:
    """Per-run grant state for one dispatch.  All methods are thread-safe
    under one internal lock (grants are rare relative to task dispatch:
    only resource-declaring tasks ever enter the arbiter)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.active = False          # any task of the current graph declares
        self._resources: List[Resource] = []
        self._needs: Dict[int, Needs] = {}
        self._excl: List[int] = []       # exclusive holders per rindex
        self._shared: List[int] = []     # shared holders per rindex
        self._caps: List[int] = []
        self._held: Dict[int, Needs] = {}
        self._waiting: List[int] = []    # global FIFO of deferred tids
        self._waiting_set: set = set()
        self._grants: List[int] = []     # global grant order (tids)
        # pinned (replay) mode: per-resource recorded grant queues
        self._pinned: Optional[Dict[int, Deque[int]]] = None

    # ------------------------------------------------------------------
    def begin(self, graph, pinned_order: Optional[Sequence[int]] = None) -> None:
        """Reset for one run of ``graph``.  ``pinned_order`` switches the
        arbiter to replay mode enforcing that recorded global grant order."""
        with self._lock:
            self._resources = list(getattr(graph, "resources", ()))
            n = len(self._resources)
            self._needs = {}
            if n:
                for t in graph.tasks:
                    if getattr(t, "uses", ()) or getattr(t, "uses_shared", ()):
                        self._needs[t.tid] = task_needs(graph, t.tid)
            self.active = bool(self._needs)
            self._excl = [0] * n
            self._shared = [0] * n
            self._caps = [r.capacity for r in self._resources]
            self._held = {}
            self._waiting = []
            self._waiting_set = set()
            self._grants = []
            if pinned_order is None:
                self._pinned = None
            else:
                pinned: Dict[int, Deque[int]] = {i: deque() for i in range(n)}
                for tid in pinned_order:
                    for rindex, _shared in self._needs.get(tid, ()):
                        pinned[rindex].append(tid)
                self._pinned = pinned

    # ------------------------------------------------------------------
    # queries (read-only; safe for steal-awareness checks)
    def needs(self, tid: int) -> Needs:
        return self._needs.get(tid, ())

    def holds(self, tid: int) -> bool:
        return tid in self._held

    def held_count(self) -> int:
        with self._lock:
            return len(self._held)

    def waiting_count(self) -> int:
        with self._lock:
            return len(self._waiting)

    def grant_log(self) -> List[int]:
        with self._lock:
            return list(self._grants)

    def grant_orders(self) -> Dict[int, List[int]]:
        """Per-resource grant sequences of the run so far (the order
        compared bit-for-bit across dynamic, replay and compiled runs)."""
        with self._lock:
            out: Dict[int, List[int]] = {
                i: [] for i in range(len(self._resources))}
            for tid in self._grants:
                for rindex, _shared in self._needs.get(tid, ()):
                    out[rindex].append(tid)
            return out

    def pinned_heads(self) -> List[int]:
        """Pinned mode: the next recorded grantee of each resource queue
        (deduplicated) — replay's post-release wakeup targets."""
        with self._lock:
            if self._pinned is None:
                return []
            heads: List[int] = []
            for q in self._pinned.values():
                if q and q[0] not in heads:
                    heads.append(q[0])
            return heads

    def would_defer(self, tid: int) -> bool:
        """True when acquiring now would defer ``tid`` — the conflict-aware
        steal check (racy by nature: a definitive answer is acquire time's,
        but a thief should not burn a steal on a likely-deferred task)."""
        needs = self._needs.get(tid)
        if needs is None or tid in self._held:
            return False
        with self._lock:
            return not self._grantable(tid, needs)

    def runnable_now(self, tid: int) -> bool:
        """Pinned-mode gating for replay run-ahead/fallback: can ``tid``
        be granted right now (or does it hold / declare nothing)?"""
        needs = self._needs.get(tid)
        if needs is None or tid in self._held:
            return True
        with self._lock:
            return self._grantable(tid, needs)

    # ------------------------------------------------------------------
    # grant / release
    def _grantable(self, tid: int, needs: Needs) -> bool:
        """Caller holds the lock.  Availability + (pinned) head-of-queue +
        (dynamic) FIFO fairness against earlier waiters."""
        for rindex, shared in needs:
            if self._pinned is not None:
                q = self._pinned[rindex]
                if not q or q[0] != tid:
                    return False
            if shared:
                if self._excl[rindex] > 0:
                    return False
            else:
                if (self._shared[rindex] > 0
                        or self._excl[rindex] >= self._caps[rindex]):
                    return False
        if self._pinned is None and self._waiting:
            # fairness: an arrival may not overtake an earlier waiter that
            # shares any of its resources (head-of-line FIFO per resource)
            mine = {rindex for rindex, _ in needs}
            for other in self._waiting:
                if other == tid:
                    break
                if any(rindex in mine
                       for rindex, _ in self._needs.get(other, ())):
                    return False
        return True

    def _grant(self, tid: int, needs: Needs) -> None:
        for rindex, shared in needs:
            if shared:
                self._shared[rindex] += 1
            else:
                self._excl[rindex] += 1
            if self._pinned is not None:
                self._pinned[rindex].popleft()
        self._held[tid] = needs
        self._grants.append(tid)

    def try_acquire(self, tid: int) -> bool:
        """Grant ``tid``'s full resource set atomically.  On contention:
        dynamic mode defers the task on the FIFO wait list (the caller
        must not run it — :meth:`release` hands it back when granted);
        pinned mode returns False with no side effects (replay's stall
        machinery retries).  Idempotent for already-granted tids."""
        needs = self._needs.get(tid)
        if needs is None:
            return True
        with self._lock:
            if tid in self._held:
                return True
            if self._grantable(tid, needs):
                self._grant(tid, needs)
                return True
            if self._pinned is None and tid not in self._waiting_set:
                self._waiting.append(tid)
                self._waiting_set.add(tid)
            return False

    def release(self, tid: int) -> List[int]:
        """Release ``tid``'s grants.  Dynamic mode scans the wait list in
        FIFO order, grants every now-grantable waiter (a blocked earlier
        waiter shadows later overlapping ones — fairness), and returns the
        newly granted tids for the dispatch to re-queue.  No-op for tasks
        that hold nothing."""
        with self._lock:
            needs = self._held.pop(tid, None)
            if needs is None:
                return []
            for rindex, shared in needs:
                if shared:
                    self._shared[rindex] -= 1
                else:
                    self._excl[rindex] -= 1
            if self._pinned is not None or not self._waiting:
                return []
            granted: List[int] = []
            shadow: set = set()
            still_waiting: List[int] = []
            for waiter in self._waiting:
                wneeds = self._needs[waiter]
                overlaps = any(r in shadow for r, _ in wneeds)
                if not overlaps and self._grantable_plain(wneeds):
                    self._grant(waiter, wneeds)
                    self._waiting_set.discard(waiter)
                    granted.append(waiter)
                else:
                    still_waiting.append(waiter)
                    shadow.update(r for r, _ in wneeds)
            self._waiting = still_waiting
            return granted

    def _grantable_plain(self, needs: Needs) -> bool:
        """Availability only (caller holds the lock; fairness is the
        release scan's shadow set)."""
        for rindex, shared in needs:
            if shared:
                if self._excl[rindex] > 0:
                    return False
            else:
                if (self._shared[rindex] > 0
                        or self._excl[rindex] >= self._caps[rindex]):
                    return False
        return True

    def abort(self) -> List[int]:
        """Drop every grant and waiter (run abort / reuse).  Returns the
        tids that were still deferred so the dispatch can rebalance its
        suspension accounting."""
        with self._lock:
            waiting = list(self._waiting)
            n = len(self._resources)
            self._excl = [0] * n
            self._shared = [0] * n
            self._held = {}
            self._waiting = []
            self._waiting_set = set()
            return waiting
