"""Requests and their in-flight decode state.

A :class:`Request` is what a client submits: a prompt, a token budget, an
optional EOS token and the (workload-relative) arrival time.  A
:class:`RequestState` is the engine's in-flight view of one admitted
request: its private KV cache, current token, and generated-token history.
Each request decodes against *its own* cache, so the per-request token
stream is independent of how requests are batched together — the property
the bit-identical continuous-batching-vs-per-request tests lean on.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, List, Optional

import numpy as np


def token_id(tok: Any) -> int:
    """Collapse a sampled token (a tensor on any device or a numpy array of
    any 1-element shape, or a plain int) to a python int — the form stored
    in request records and compared against ``eos_token``.

    For a CUDA tensor this is ``.item()``: the host waits for the lane's
    step to finish on the device and copies one integer back.  That is the
    per-lane host synchronisation the reference makes too (its
    ``np.asarray`` materialises the token), and it is intended: the engine
    needs the id to decide on EOS and budgets, and the step timestamp taken
    right after it covers the real compute.

    The module does not import torch (no tensor exists before torch is
    imported), so a serving worker process whose model is not a torch
    model starts without it."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(tok, torch.Tensor):
        if tok.numel() != 1:
            raise ValueError(f"expected a single sampled token, got shape "
                             f"{tuple(tok.shape)}")
        return int(tok.item())
    arr = np.asarray(tok)
    if arr.size != 1:
        raise ValueError(f"expected a single sampled token, got shape {arr.shape}")
    return int(arr.reshape(()))


@dataclasses.dataclass
class Request:
    """One client request.

    ``prompt`` is whatever the engine's ``prefill_fn`` accepts (for the LM
    path: an int array of token ids shaped ``(1, prompt_len)``).
    ``max_new_tokens`` counts *all* generated tokens, including the one the
    prefill's logits yield — a budget of 1 completes at admission without
    ever occupying a decode slot.  ``arrival_s`` is the open-loop due time,
    an offset from the start of the workload; None (a request with no due
    time) arrives when it is submitted.  ``eos_token`` stops the request
    early when the sampler draws it.
    """

    rid: int
    prompt: Any
    max_new_tokens: int
    arrival_s: Optional[float] = None
    eos_token: Optional[int] = None

    def __post_init__(self) -> None:
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1, "
                f"got {self.max_new_tokens}")


class RequestState:
    """In-flight decode state of one admitted request (one batch *lane*).

    ``cache``/``tok``/``logits`` are read and written only by this
    request's decode/sample tasks inside a step graph; the engine mutates
    the rest between steps.
    """

    __slots__ = ("request", "cache", "tok", "logits", "tokens")

    def __init__(self, request: Request, cache: Any, tok: Any):
        self.request = request
        self.cache = cache
        self.tok = tok
        self.logits: Any = None
        self.tokens: List[int] = []      # generated token ids, prefill first

    @property
    def rid(self) -> int:
        return self.request.rid

    def note_token(self, tok: Any) -> int:
        """Record a sampled token; returns its id."""
        tid = token_id(tok)
        self.tokens.append(tid)
        return tid

    def done(self) -> bool:
        """Budget exhausted or EOS drawn — the lane frees this step."""
        if len(self.tokens) >= self.request.max_new_tokens:
            return True
        eos = self.request.eos_token
        return eos is not None and bool(self.tokens) and self.tokens[-1] == eos
