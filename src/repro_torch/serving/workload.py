"""Seeded streaming-traffic generators.

:class:`PoissonWorkload` models an open-loop request stream: exponential
inter-arrival times at a target ``rate`` (requests/s) and a ragged
per-request token budget.  Everything is drawn from one
``numpy.random.Generator`` seeded at construction, so two workloads built
with the same parameters produce *identical* requests — arrival times,
prompts and budgets — which is what makes the serving tests and benches
reproducible (and their token streams comparable bit-for-bit).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .request import Request

Span = Union[int, Tuple[int, int]]


def _as_span(value: Span, what: str) -> Tuple[int, int]:
    if isinstance(value, int):
        lo = hi = value
    else:
        lo, hi = value
    if lo < 1 or hi < lo:
        raise ValueError(f"{what} span must satisfy 1 <= lo <= hi, got {value}")
    return lo, hi


class PoissonWorkload:
    """A deterministic Poisson-arrival request stream.

    Parameters
    ----------
    rate:
        Mean arrival rate in requests/second (exponential inter-arrivals).
    n_requests:
        Stream length.
    seed:
        Seeds the generator; equal seeds give equal streams.
    prompt_len:
        Prompt length in tokens — an int, or an inclusive ``(lo, hi)`` span
        sampled per request.
    max_new_tokens:
        Per-request generation budget (incl. the prefill token) — int or
        inclusive span; the span is what drives batch-shape churn.
    vocab_size:
        Prompt token ids are drawn uniformly from ``[0, vocab_size)``.
    eos_token:
        Stamped onto every request (early exit when sampled); None disables.
    """

    def __init__(
        self,
        rate: float,
        n_requests: int,
        *,
        seed: int = 0,
        prompt_len: Span = 16,
        max_new_tokens: Span = (2, 8),
        vocab_size: int = 256,
        eos_token: Optional[int] = None,
    ):
        if rate <= 0.0:
            raise ValueError(f"arrival rate must be > 0, got {rate}")
        if n_requests < 1:
            raise ValueError(f"need >= 1 request, got {n_requests}")
        self.rate = float(rate)
        self.n_requests = int(n_requests)
        self.seed = int(seed)
        self.prompt_len = _as_span(prompt_len, "prompt_len")
        self.max_new_tokens = _as_span(max_new_tokens, "max_new_tokens")
        self.vocab_size = int(vocab_size)
        self.eos_token = eos_token
        rng = np.random.default_rng(self.seed)
        self.arrivals = np.cumsum(
            rng.exponential(1.0 / self.rate, self.n_requests))
        self._prompt_lens = rng.integers(
            self.prompt_len[0], self.prompt_len[1] + 1, self.n_requests)
        self._budgets = rng.integers(
            self.max_new_tokens[0], self.max_new_tokens[1] + 1,
            self.n_requests)
        self._prompts = [
            rng.integers(0, self.vocab_size, (1, int(n)), dtype=np.int32)
            for n in self._prompt_lens
        ]

    def requests(self) -> List[Request]:
        """The stream, in arrival order."""
        return [
            Request(rid=i, prompt=self._prompts[i],
                    max_new_tokens=int(self._budgets[i]),
                    arrival_s=float(self.arrivals[i]),
                    eos_token=self.eos_token)
            for i in range(self.n_requests)
        ]

    def total_budget(self) -> int:
        """Sum of per-request token budgets (upper bound on tokens served;
        exact when no request exits early on EOS)."""
        return int(self._budgets.sum())

    def describe(self) -> str:
        return (f"poisson(rate={self.rate}/s, n={self.n_requests}, "
                f"seed={self.seed}, prompt={self.prompt_len}, "
                f"budget={self.max_new_tokens})")


def constant_prompt_requests(
    arrivals: Sequence[float],
    budgets: Sequence[int],
    prompt: object,
    *,
    eos_token: Optional[int] = None,
) -> List[Request]:
    """Hand-built stream helper for tests: explicit arrival offsets and
    budgets, one shared prompt object."""
    if len(arrivals) != len(budgets):
        raise ValueError("arrivals and budgets must have equal length")
    return [
        Request(rid=i, prompt=prompt, max_new_tokens=int(b),
                arrival_s=float(a), eos_token=eos_token)
        for i, (a, b) in enumerate(zip(arrivals, budgets))
    ]
