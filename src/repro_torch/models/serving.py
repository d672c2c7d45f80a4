"""Decode-step task graphs for the serving loop.

The port of the reference's ``repro/models/serving.py`` on PyTorch tensors
(``torch.argmax``, ``torch.cat``).  Tokens stay on the model's device: the
graph's tasks never read one back to the host.

``repro_torch.serving.serve_lm`` decodes token-by-token: every step applies the same
computation to every request in the batch.  This module expresses one decode
step as a :class:`~repro_torch.core.taskgraph.TaskGraph` — the batch is split into
*shards*, each shard gets a ``decode -> sample`` task chain, and a final
``gather`` task joins the step — so the step can run on the task-graph
runtime and, because every step builds the *same graph shape* (names, kinds,
costs, dependencies — the callables differ but
:func:`~repro_torch.replay.graph_key` ignores callables), the whole decode
loop replays from one recording (``Session(scheduler="pool")``).

State lives in a mutable :class:`DecodeState` (the serving analogue of the
tile stores the factorization graphs close over): each shard owns its KV
cache and current token, task bodies read/write their own shard, and the
dependency/channel edges order every access — replay is bit-identical to
dynamic execution regardless of interleaving.

The gather join is a *suspendable frame* over a
:class:`~repro_torch.core.taskgraph.Channel`: each shard's sample task ``send``\\ s
its token as soon as it is drawn, and the gather generator ``recv``\\ s them
one by one — overlapping the join's assembly with the remaining shards'
decode/sample instead of barriering on all of them (and never pinning a
worker while it waits; the frame suspends).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import torch

from ..api.graph import Graph
from ..compile.fuse import FuseSpec
from ..core.taskgraph import Channel, TaskGraph
from ..resources import Resource

# decode_fn(params, cache, tok) -> (new_cache, logits); sample_fn(logits) -> tok
DecodeFn = Callable[[Any, Any, Any], Any]
SampleFn = Callable[[Any], Any]


def greedy_sample(logits: Any) -> Any:
    """Argmax over the last position — the serve_lm default sampler.  The
    argmax runs over every column of the logits, the padded vocabulary
    included, as the reference's does."""
    return torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)


@dataclasses.dataclass
class DecodeShard:
    """One batch shard's mutable serving state."""

    cache: Any
    tok: Any
    logits: Any = None


class _DecodeFuseState:
    """Fuse-state adapter over a :class:`DecodeState`: ``("params",)``
    resolves to the shared parameters, ``("cache", s)`` / ``("tok", s)`` /
    ``("logits", s)`` to shard ``s``'s fields."""

    __slots__ = ("state",)

    def __init__(self, state: "DecodeState"):
        self.state = state

    def __getitem__(self, k):
        if k[0] == "params":
            return self.state.params
        return getattr(self.state.shards[k[1]], k[0])

    def __setitem__(self, k, v):
        if k[0] == "params":
            self.state.params = v
        else:
            setattr(self.state.shards[k[1]], k[0], v)


class DecodeState:
    """Sharded decode-loop state driven by the decode-step graph.

    ``shards[s]`` is read and written only by shard ``s``'s tasks;
    ``step_tokens`` / ``history`` are written only by the gather task.
    """

    def __init__(self, params: Any, shards: List[DecodeShard]):
        self.params = params
        self.shards = shards
        self.step_tokens: Any = None
        self.history: List[Any] = []

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def tokens(self) -> Any:
        """All sampled tokens so far, concatenated (batch, steps)."""
        return torch.cat(self.history, dim=1)


def kv_page_resources(n_shards: int) -> List[Resource]:
    """One exclusive KV-page :class:`~repro_torch.resources.Resource` per decode
    lane.  Resource identity in the graph digest is (name, capacity), so
    rebuilding per step — even with fresh handles — keeps the digest stable
    and the decode loop replayable."""
    return [Resource(f"kv_page{s}") for s in range(n_shards)]


def build_decode_graph(
    state: DecodeState,
    decode_fn: DecodeFn,
    sample_fn: Optional[SampleFn] = None,
    *,
    kv_pages: Optional[List[Resource]] = None,
    maintenance_fn: Optional[Callable[["DecodeState"], Any]] = None,
) -> TaskGraph:
    """One decode step over ``state``: per shard ``decode -> sample``, plus a
    ``gather`` frame receiving each shard's token over a
    :class:`~repro_torch.core.taskgraph.Channel` as it is sampled.
    Rebuilding per step yields an identical
    :func:`~repro_torch.replay.graph_key` digest.

    ``kv_pages`` (see :func:`kv_page_resources`) opts each lane's decode
    task into an exclusive per-lane KV-page resource; ``maintenance_fn``
    then adds a ``kv_maint`` task that takes *every* page exclusively with
    no ordering edges at all — the arbiter serializes it against the decode
    tasks wherever it lands, and the recorded grant order replays the same
    placement bit-identically.  Without ``kv_pages`` the graph (and its
    digest) is byte-identical to the resource-free form."""
    sample = sample_fn or greedy_sample
    if kv_pages is not None and len(kv_pages) != state.n_shards:
        raise ValueError(
            f"kv_pages has {len(kv_pages)} entries for {state.n_shards} "
            "shards")
    if maintenance_fn is not None and kv_pages is None:
        raise ValueError("maintenance_fn requires kv_pages")
    g = Graph(f"decode_step[{state.n_shards}]")
    g.fuse_state = _DecodeFuseState(state)
    tokens = Channel("decode.tokens")
    for s in range(state.n_shards):
        def _decode(s=s):
            sh = state.shards[s]
            sh.cache, sh.logits = decode_fn(state.params, sh.cache, sh.tok)
            return sh.logits

        # fusible: decode_fn is the pure kernel; the logits write feeds the
        # sample task's dataflow argument.  jit_safe=False — decode_fn is
        # caller-supplied and a compiled driver must call it exactly as the
        # dynamic body does, for bit-identity.
        dec = g.add(_decode, name=f"decode{s}", kind="compute", cost=1.0,
                    uses=[kv_pages[s]] if kv_pages is not None else (),
                    fuse=FuseSpec(decode_fn,
                                  (("params",), ("cache", s), ("tok", s)),
                                  (("cache", s), ("logits", s)),
                                  result_key=("logits", s), jit_safe=False))

        def _sample(logits, s=s):
            sh = state.shards[s]
            sh.tok = sample(logits)
            tokens.send((s, sh.tok))
            return sh.tok

        # dataflow: the decode handle is the sample's argument — the edge
        # is inferred, and the logits flow as a value instead of through
        # shard state (the cache/tok mutations still ride the shard)
        g.add(_sample, dec, name=f"sample{s}", kind="compute", cost=0.1)

    n_shards = state.n_shards

    def _gather(ctx):
        # suspendable frame: assemble tokens as they stream in, suspending
        # (worker-free) between arrivals instead of barriering on all shards
        toks: List[Any] = [None] * n_shards
        for _ in range(n_shards):
            s, tok = yield ctx.recv(tokens)
            toks[s] = tok
        state.step_tokens = torch.cat(toks, dim=0)
        state.history.append(state.step_tokens)
        return state.step_tokens

    g.add(_gather, name="gather", kind="comm", cost=0.05)

    if maintenance_fn is not None:
        def _maint(ctx):
            return maintenance_fn(state)

        # conflicts-but-no-edges: the page resources are the ONLY thing
        # keeping this compaction pass out of the decode tasks' way
        g.add(_maint, name="kv_maint", kind="compute", cost=0.2,
              uses=list(kv_pages))
    return g


def decode_graph_key(n_shards: int):
    """Structural key of the ``n_shards`` decode-step graph (for priming a
    cache / registering a pool builder without building real state)."""
    from ..replay.graph_key import graph_key

    skeleton = DecodeState(None, [DecodeShard(None, None)] * n_shards)
    return graph_key(build_decode_graph(skeleton, lambda p, c, t: (c, t)))


def shard_batch(batch: Dict[str, Any], n_shards: int) -> List[Dict[str, Any]]:
    """Split every batch array along axis 0 into ``n_shards`` equal parts."""
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent batch sizes: {sorted(sizes)}")
    (bsz,) = sizes
    if bsz % n_shards:
        raise ValueError(f"batch size {bsz} does not shard into {n_shards}")
    per = bsz // n_shards
    return [{k: v[s * per:(s + 1) * per] for k, v in batch.items()}
            for s in range(n_shards)]


def make_decode_state(
    params: Any,
    cfg: Any,
    batch: Dict[str, Any],
    *,
    n_shards: int,
    max_len: int,
    prefill_fn: Optional[Callable[[Any, Dict[str, Any]], Any]] = None,
    sample_fn: Optional[SampleFn] = None,
    device: Any = None,
) -> DecodeState:
    """Prefill each shard and seed its first decode token.  The prefill
    logits' greedy token is recorded as step 0 of ``history``.  The default
    ``prefill_fn`` is the port's :func:`~repro_torch.models.lm.prefill`.

    ``batch``'s arrays (tensors or numpy) are put on ``device``: the CUDA
    device by default, which raises when there is none; pass
    ``device="cpu"`` with a model made on the host."""
    from ..linalg.tiles import resolve_device
    from .lm import prefill

    dev = resolve_device(device)
    model_dev = getattr(params, "device", dev)
    if model_dev.type != dev.type:
        raise ValueError(f"the model is on {model_dev} but device={dev}")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    if prefill_fn is None:
        def prefill_fn(p, b):
            return prefill(p, cfg, b, None, max_len=max_len)
    sample = sample_fn or greedy_sample
    shards: List[DecodeShard] = []
    first: List[Any] = []
    for sub in shard_batch(batch, n_shards):
        cache, logits = prefill_fn(params, sub)
        tok = sample(logits)
        shards.append(DecodeShard(cache=cache, tok=tok, logits=logits))
        first.append(tok)
    state = DecodeState(params, shards)
    state.step_tokens = torch.cat(first, dim=0)
    state.history.append(state.step_tokens)
    return state
