"""Per-request lifecycle records and their roll-up.

The engine stamps each request's lifecycle (arrival, admission, first
token, every decode token, completion) into a :class:`RequestRecord`; a
:class:`ServingReport` aggregates the stream into the numbers the serving
bench reports: p50/p99 per-token latency, time-to-first-token percentiles,
sustained tok/s over the loaded span, mean batch occupancy and the pool's
warm-replay hit rate.  Timestamps are engine-clock seconds (wall clock, or
the deterministic virtual clock when the engine runs with ``step_time``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RequestRecord:
    """One request's observed lifecycle."""

    rid: int
    arrival_s: float
    admitted_s: float = 0.0       # left the admission queue (prefill start)
    first_token_s: float = 0.0    # prefill done, first token out
    done_s: float = 0.0
    tokens: List[int] = dataclasses.field(default_factory=list)
    token_times_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def ttft_s(self) -> float:
        """Time-to-first-token: arrival -> first generated token (includes
        any admission-queue wait — that is the point)."""
        return self.first_token_s - self.arrival_s

    @property
    def queue_wait_s(self) -> float:
        return self.admitted_s - self.arrival_s

    def token_latencies_s(self) -> List[float]:
        """Gaps between consecutive generated tokens (decode cadence)."""
        times = self.token_times_s
        return [times[i] - times[i - 1] for i in range(1, len(times))]


def _pct(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values), q)) if values else 0.0


@dataclasses.dataclass
class ServingReport:
    """Everything one engine drive produced.

    ``records`` maps rid -> :class:`RequestRecord` (completed requests
    only; the engine refuses to finish with requests stranded).  ``steps``
    counts decode-step graphs executed, ``warm_steps`` how many of them the
    pool served as warm replays (0 under a dynamic session),
    ``lane_steps`` the total lanes occupied across steps (occupancy =
    ``lane_steps / steps / max_batch``).  ``trace`` stays None in the port:
    the flight recorder's trace (``Session(trace=True)``) is not ported yet.
    """

    records: Dict[int, RequestRecord]
    steps: int
    warm_steps: int
    lane_steps: int
    max_batch: int
    wall_s: float
    shape_counts: Dict[int, int] = dataclasses.field(default_factory=dict)
    trace: Optional[Any] = None            # always None: tracing is not ported

    # ------------------------------------------------------------------
    @property
    def completed(self) -> int:
        return len(self.records)

    @property
    def total_tokens(self) -> int:
        return sum(len(r.tokens) for r in self.records.values())

    @property
    def warm_hit_rate(self) -> float:
        """Fraction of decode steps served as warm pool replays."""
        return self.warm_steps / self.steps if self.steps else 0.0

    @property
    def occupancy(self) -> float:
        """Mean fraction of batch slots occupied per decode step."""
        if not self.steps or not self.max_batch:
            return 0.0
        return self.lane_steps / (self.steps * self.max_batch)

    def token_latencies_s(self) -> List[float]:
        out: List[float] = []
        for rec in self.records.values():
            out.extend(rec.token_latencies_s())
        return out

    def sustained_tok_s(self) -> float:
        """Generated tokens per second over the loaded span (first arrival
        to last completion)."""
        recs = self.records.values()
        if not recs:
            return 0.0
        span = (max(r.done_s for r in recs)
                - min(r.arrival_s for r in recs))
        return self.total_tokens / span if span > 0 else 0.0

    def tokens_by_rid(self) -> Dict[int, List[int]]:
        """{rid: generated token ids} — the bit-identity comparison view."""
        return {rid: list(rec.tokens) for rid, rec in self.records.items()}

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        """The bench-row numbers, all in ms / tok/s / rates."""
        lats = self.token_latencies_s()
        ttfts = [r.ttft_s for r in self.records.values()]
        return {
            "completed": float(self.completed),
            "tokens": float(self.total_tokens),
            "steps": float(self.steps),
            "p50_tok_ms": round(_pct(lats, 50) * 1e3, 3),
            "p99_tok_ms": round(_pct(lats, 99) * 1e3, 3),
            "ttft_p50_ms": round(_pct(ttfts, 50) * 1e3, 3),
            "ttft_p99_ms": round(_pct(ttfts, 99) * 1e3, 3),
            "tok_s": round(self.sustained_tok_s(), 1),
            "warm_hit_rate": round(self.warm_hit_rate, 3),
            "occupancy": round(self.occupancy, 3),
        }

    def describe(self) -> str:
        s = self.summary()
        return (f"served {self.completed} requests / {self.total_tokens} "
                f"tokens in {self.steps} steps ({self.wall_s:.3f}s): "
                f"per-token p50 {s['p50_tok_ms']:.2f} ms "
                f"p99 {s['p99_tok_ms']:.2f} ms, "
                f"ttft p50 {s['ttft_p50_ms']:.2f} ms, "
                f"{s['tok_s']:.0f} tok/s sustained, "
                f"warm-replay hit rate {self.warm_hit_rate:.0%}, "
                f"occupancy {self.occupancy:.0%}")
