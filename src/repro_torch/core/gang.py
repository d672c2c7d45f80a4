"""Gang scheduling (paper Algorithm 1) — pure logic shared by the threaded
runtime and the discrete-event simulator.

A *gang* is the set of ULTs of one data-parallel region that must be able to
synchronize with blocking operations.  ``gang_sched`` assigns the region a
monotonically increasing ``gang_id`` (under the runtime's fork lock, so ids
are a global total order on region forks), reserves ``n_request`` workers
chosen close to the spawner and below average gang load, and pushes ULT *i*
onto reserved worker *i*'s ``gang_deq``.

Deadlock freedom comes from two properties implemented here:

* gang deques are FIFO and pushes are globally ordered by ``gang_id``
  (fork lock), so every worker drains gang ULTs in gang-id order — the
  incomplete gang with the smallest id always has all of its reserved
  workers reach its ULTs, so its (blocking) barrier is satisfied; induction
  does the rest;
* ``is_eligible_to_sched`` restricts which gang ULTs a worker may *steal*:
  a worker currently inside gang G at nest level L may only take ULTs from
  strictly deeper regions or from G itself — earlier/outer gangs take
  precedence and no cycle of workers mutually blocked on each other's
  barriers can form.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, List, Sequence


@dataclasses.dataclass
class ULT:
    """A user-level thread of a parallel region."""

    gang_id: int            # id of the region (monotonic); -1 => not a gang ULT
    nest_level: int         # nest level of the *spawning* worker
    region: Any             # the ParallelRegion this ULT belongs to
    thread_num: int         # omp_get_thread_num() within the region
    cost: float = 0.0       # simulator cost per barrier phase

    @property
    def name(self) -> str:
        return f"gang{self.gang_id}.t{self.thread_num}"


class GangState:
    """Global gang bookkeeping (the runtime holds one, protected by its fork
    lock; the simulator holds one, single-threaded)."""

    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self._next_gang_id = itertools.count()
        # paper: per-worker count of gang ULTs ever assigned minus completed;
        # used by get_workers' load balancing.
        self.worker_gang_load: List[int] = [0] * n_workers
        self.n_gang_threads = 0

    def next_gang_id(self) -> int:
        return next(self._next_gang_id)

    # -- Algorithm 1, GET_WORKERS ------------------------------------------
    def get_workers(self, cur_worker_id: int, n_request: int) -> List[int]:
        """Reserve ``n_request`` workers: start adjacent to the spawner
        (wrapping back by ``n_request/2`` near the top of the worker range so
        the reservation stays contiguous), skip workers whose gang load is
        above average.  Mirrors the paper's pseudo-code, with the guarantee
        of termination even when every worker is above-average loaded (second
        sweep ignores the load filter — the paper implicitly relies on loads
        draining; a bounded scan keeps the runtime lock-step finite)."""
        n = self.n_workers
        n_request = min(n_request, n)
        avg_load = self.n_gang_threads / n
        if cur_worker_id + n_request >= n:
            start = (cur_worker_id - n_request // 2) % n
        else:
            start = (cur_worker_id + 1) % n
        reserved: List[int] = []
        idx = start
        scanned = 0
        while len(reserved) < n_request and scanned < n:
            if self.worker_gang_load[idx] <= avg_load:
                reserved.append(idx)
            idx = (idx + 1) % n
            scanned += 1
        # fallback sweep: take least-loaded remaining workers
        if len(reserved) < n_request:
            remaining = sorted(
                (w for w in range(n) if w not in reserved),
                key=lambda w: (self.worker_gang_load[w], (w - start) % n),
            )
            reserved.extend(remaining[: n_request - len(reserved)])
        return reserved

    def account_gang(self, workers: Sequence[int]) -> None:
        for w in workers:
            self.worker_gang_load[w] += 1
        self.n_gang_threads += len(workers)

    def release_gang_thread(self, worker: int) -> None:
        self.worker_gang_load[worker] -= 1
        self.n_gang_threads -= 1


# -- Algorithm 1, IS_ELIGIBLE_TO_SCHED --------------------------------------
def is_eligible_to_sched(
    ult_gang_id: int,
    ult_nest_level: int,
    worker_cur_gang_id: int,
    worker_nest_level: int,
) -> bool:
    """May a worker (currently executing inside gang ``worker_cur_gang_id``
    at ``worker_nest_level``, or idle if ``worker_cur_gang_id < 0``) start or
    steal the given gang ULT?"""
    if worker_cur_gang_id < 0:
        return True
    if ult_nest_level > worker_nest_level:
        return True
    if ult_nest_level == worker_nest_level and ult_gang_id == worker_cur_gang_id:
        return True
    return False
