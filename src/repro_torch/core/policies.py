"""Victim-selection policies (paper Algorithm 2 and baselines).

The paper's hybrid policy keeps, per worker, a fixed-size circular *history
array* ``prev_victim_id`` and a cursor ``history_idx``:

* ``select_victim``: if the entry under the cursor holds a valid victim id,
  steal from it (history); otherwise pick a uniformly random victim.
* after a **successful** steal the entry is set to the victim and the cursor
  advances — the next attempt lands on a (typically empty ⇒ random) slot, so
  a success is followed by a random probe;
* after a **failed** steal the entry is invalidated and the cursor moves
  back — landing on the slot of the latest success, so failures retry the
  last productive victim.

The alternation is what creates communication/computation overlap across
sibling subtrees (paper Fig. 2) while the retreat-on-failure preserves
locality.  ``HistoryPolicy`` is the classical steal-from-last-success
baseline (what LLVM OMP effectively does); ``RandomPolicy`` is the pure
random baseline.  All policies are deterministic given their ``seed`` so the
simulator and the benchmarks are reproducible.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Type


class PolicyError(ValueError):
    """An unknown victim-policy name (carries the valid options)."""


class VictimPolicy:
    """Per-worker victim selection state machine."""

    name = "base"

    def __init__(self, worker_id: int, n_workers: int, seed: int = 0):
        self.worker_id = worker_id
        self.n_workers = n_workers
        self.rng = random.Random((seed << 20) ^ (worker_id * 0x9E3779B1))

    def _rand_victim(self) -> int:
        """Random victim excluding self (a worker never steals from itself)."""
        if self.n_workers <= 1:
            return self.worker_id
        v = self.rng.randrange(self.n_workers - 1)
        return v if v < self.worker_id else v + 1

    def select(self) -> int:
        raise NotImplementedError

    def record(self, victim: int, success: bool) -> None:
        raise NotImplementedError

    def observe(self, metrics: dict) -> None:
        """Cross-run feedback hook (flight-recorder data plumbing).

        After every traced run the dispatch feeds each worker's policy the
        assembled :meth:`repro_torch.obs.RuntimeTrace.metrics` dict — notably
        ``steal_by_victim`` (per-victim ``[attempts, hits]`` histograms)
        and ``resume_latency`` — so a stats-driven policy can adapt across
        a session's (or a :class:`~repro_torch.replay.pool.ReplayPool` entry's)
        lifetime.  The built-in paper policies ignore it; custom policies
        registered via :func:`register_policy` override this."""

    def clone_for(self, worker_id: int) -> "VictimPolicy":
        return type(self)(worker_id, self.n_workers, self._seed)


class RandomPolicy(VictimPolicy):
    name = "random"

    def __init__(self, worker_id: int, n_workers: int, seed: int = 0):
        super().__init__(worker_id, n_workers, seed)
        self._seed = seed

    def select(self) -> int:
        return self._rand_victim()

    def record(self, victim: int, success: bool) -> None:
        pass


class HistoryPolicy(VictimPolicy):
    """Classical history heuristic: keep stealing from the last successful
    victim until a steal from it fails, then probe randomly."""

    name = "history"

    def __init__(self, worker_id: int, n_workers: int, seed: int = 0):
        super().__init__(worker_id, n_workers, seed)
        self._seed = seed
        self.last_victim: int = -1

    def select(self) -> int:
        if self.last_victim >= 0:
            return self.last_victim
        return self._rand_victim()

    def record(self, victim: int, success: bool) -> None:
        self.last_victim = victim if success else -1


class HybridPolicy(VictimPolicy):
    """Paper Algorithm 2 — alternating history / random within a fixed
    circular window."""

    name = "hybrid"

    def __init__(self, worker_id: int, n_workers: int, seed: int = 0, window: int = 8):
        super().__init__(worker_id, n_workers, seed)
        self._seed = seed
        self.window = window
        self.prev_victim_id: List[int] = [-1] * window
        self.history_idx = 0

    def select(self) -> int:
        cur = self.prev_victim_id[self.history_idx % self.window]
        if cur >= 0:
            return cur
        return self._rand_victim()

    def record(self, victim: int, success: bool) -> None:
        cur_idx = self.history_idx % self.window
        if success:
            self.prev_victim_id[cur_idx] = victim
            self.history_idx = (self.history_idx + 1) % self.window
        else:
            self.prev_victim_id[cur_idx] = -1
            self.history_idx = (self.history_idx - 1) % self.window

    def clone_for(self, worker_id: int) -> "HybridPolicy":
        return HybridPolicy(worker_id, self.n_workers, self._seed, self.window)


class FrameAwarePolicy(HybridPolicy):
    """Stats-driven hybrid: the paper's alternating history/random machine,
    with the *random* probe replaced by a deterministic walk over victims
    ranked from flight-recorder feedback.

    :meth:`observe` (fed each traced run's
    :meth:`~repro_torch.obs.RuntimeTrace.metrics`) ranks the other workers by

    * ``frame_resumes_by_worker`` — a worker that executes many frame
      resume segments hosts suspended continuations: its queue refills as
      channels are fed, so it is a durable steal target even when a random
      probe of it once failed;
    * per-victim steal hit rate (``steal_by_victim``) as the tie-break.

    Until the first observation (or when the trace saw no resumes and no
    steals) it behaves exactly like :class:`HybridPolicy`.  The walk is
    round-robin over the ranked list, so successive probes spread over the
    productive victims instead of hammering one — and the policy stays
    deterministic given its seed and its observation history.
    """

    name = "frame_hybrid"

    def __init__(self, worker_id: int, n_workers: int, seed: int = 0,
                 window: int = 8):
        super().__init__(worker_id, n_workers, seed, window)
        self._pref: List[int] = []
        self._pref_idx = 0

    def observe(self, metrics: dict) -> None:
        resumes = metrics.get("frame_resumes_by_worker") or {}
        by_victim = metrics.get("steal_by_victim") or {}
        ranked: List[tuple] = []
        for v in range(self.n_workers):
            if v == self.worker_id:
                continue
            # trace metrics carry int keys; JSON round-trips stringify them
            res = int(resumes.get(v, resumes.get(str(v), 0)))
            att, hits = by_victim.get(v, by_victim.get(str(v), (0, 0)))
            rate = (hits / att) if att else 0.0
            if res > 0 or hits > 0:
                ranked.append((-res, -rate, v))
        self._pref = [v for _, _, v in sorted(ranked)]
        self._pref_idx = 0

    def _rand_victim(self) -> int:
        if self._pref:
            v = self._pref[self._pref_idx % len(self._pref)]
            self._pref_idx += 1
            return v
        return super()._rand_victim()

    def clone_for(self, worker_id: int) -> "FrameAwarePolicy":
        return FrameAwarePolicy(worker_id, self.n_workers, self._seed,
                                self.window)


#: The validated policy registry.  Every entry point that accepts a
#: ``policy: str`` (``Session``, ``run_graph``, ``Runtime``, ``ReplayPool``,
#: the simulator) resolves the name here, so a typo fails at the API
#: boundary with the list of valid names instead of deep in dispatch.
POLICIES: Dict[str, Type[VictimPolicy]] = {
    "random": RandomPolicy,
    "history": HistoryPolicy,
    "hybrid": HybridPolicy,
    "frame_hybrid": FrameAwarePolicy,
}


def available_policies() -> List[str]:
    """Sorted names of every registered victim policy."""
    return sorted(POLICIES)


def register_policy(
    name: str, cls: Optional[Type[VictimPolicy]] = None,
) -> Callable[[Type[VictimPolicy]], Type[VictimPolicy]]:
    """Register a :class:`VictimPolicy` subclass under ``name`` (usable as a
    decorator).  Registered policies become valid ``policy=`` arguments
    everywhere a built-in name is."""
    def _register(c: Type[VictimPolicy]) -> Type[VictimPolicy]:
        if not (isinstance(c, type) and issubclass(c, VictimPolicy)):
            raise TypeError(f"{c!r} is not a VictimPolicy subclass")
        POLICIES[name] = c
        return c
    return _register(cls) if cls is not None else _register


def resolve(name: str) -> Type[VictimPolicy]:
    """Resolve a policy name to its class, or raise :class:`PolicyError`
    naming the valid choices.  The single validation point the session API
    and the legacy entry points share."""
    try:
        return POLICIES[name]
    except (KeyError, TypeError):
        raise PolicyError(
            f"unknown victim policy {name!r}; valid policies: "
            f"{', '.join(available_policies())}") from None


#: Package-level alias (``repro_torch.core.resolve_policy``): ``resolve`` reads
#: naturally as ``policies.resolve`` at the module level.
resolve_policy = resolve


def make_policy(name: str, worker_id: int, n_workers: int, seed: int = 0) -> VictimPolicy:
    return resolve(name)(worker_id, n_workers, seed)
