"""Module-level helpers shipped to ``repro_torch.mp`` worker processes by
reference.

The port's counterpart of ``tests/mp_helpers.py``.  The tests directory
has no ``__init__.py``, so pytest puts it on ``sys.path`` and these helpers
import inside spawned children as the top-level module
``test_torch_mp_helpers`` — which is what :func:`repro_torch.mp.callable_ref`
derives.  It imports nothing but ``repro_torch``, numpy and torch, so a
child that resolves a helper never imports JAX or the reference package;
torch is imported inside the helpers that need it, so a child that only
pings starts in a fraction of a second.  Everything here must stay
module-level and picklable-by-reference: no closures, no fixtures.
"""

import os
import sys
import time

import numpy as np

import repro_torch

VOCAB = 13
PRIME = 10_007
#: the Cholesky sweep's matrix order and tile width
CHOL_N, CHOL_B = 128, 32


# ---------------------------------------------------------------------------
# toy hash-walk LM (tests/mp_helpers.py's): per-request integer caches, so
# token streams are independent of batch composition
def _logits(h):
    row = [0.0] * VOCAB
    row[h % VOCAB] = 1.0
    return row


def toy_prefill(prompt):
    h = (int(np.asarray(prompt).sum()) * 31 + 7) % PRIME
    return {"h": h}, _logits(h)


def toy_decode(cache, tok):
    h = (cache["h"] * 31 + int(tok) + 7) % PRIME
    return {"h": h}, _logits(h)


def toy_sample(logits):
    return int(np.argmax(np.asarray(logits)))


def make_toy_fns():
    """Engine-fns factory for ``fns_ref`` (child processes re-import it)."""
    return toy_decode, toy_prefill, toy_sample


def make_slow_toy_fns(delay=0.002):
    """Toy fns whose decode sleeps ``delay`` seconds — keeps a serving
    stream in flight long enough for chaos tests to kill a child mid-run."""
    def slow_decode(cache, tok):
        time.sleep(delay)
        return toy_decode(cache, tok)
    return slow_decode, toy_prefill, toy_sample


def per_request_reference(requests):
    """Each request decoded alone, straight through the toy model — the
    ground truth any batched/sharded serve must match bit-for-bit."""
    out = {}
    for req in requests:
        cache, logits = toy_prefill(req.prompt)
        tok = toy_sample(logits)
        toks = [tok]
        while len(toks) < req.max_new_tokens and tok != req.eos_token:
            cache, logits = toy_decode(cache, tok)
            tok = toy_sample(logits)
            toks.append(tok)
        out[req.rid] = toks
    return out


# ---------------------------------------------------------------------------
# graph builders (same shape for every input -> one cache key per sweep)
def build_chain(x):
    g = repro_torch.Graph("mp-chain")
    a = g.add(lambda: x, name="src")
    b = g.add(lambda v: v + 1, a, name="inc")
    g.add(lambda v: v * 2, b, name="dbl")
    return g


def chain_expected(x):
    return {x, x + 1, (x + 1) * 2}


def build_cholesky_on(value):
    """``(seed, n, b, device)`` -> the tiled Cholesky of
    ``random_spd(n, seed)`` on ``device``, plus one sink task whose result
    is the factor L (a torch tensor: in a worker process it crosses the
    pipe as numpy)."""
    from repro_torch.linalg import (build_cholesky_graph, cholesky_extract,
                                    random_spd, to_tiles)

    seed, n, b, device = value
    a = random_spd(n, seed, device=device)
    store = to_tiles(a, b, device=device)
    g = build_cholesky_graph(n // b, b, store=store)
    g.add(lambda ctx: cholesky_extract(store), name="factor", kind="compute",
          deps=[t for t in g if not g.successors(t)])
    return g


def build_cholesky(seed):
    """:func:`build_cholesky_on` at ``CHOL_N`` / ``CHOL_B`` on the CPU."""
    return build_cholesky_on((seed, CHOL_N, CHOL_B, "cpu"))


def factor_of(results):
    """The factor among a Cholesky run's results (every other task
    returns None)."""
    (L,) = [v for v in results.values() if v is not None]
    return L


# ---------------------------------------------------------------------------
# plain worker tasks (fn(ctx, *args) protocol)
def whoami(ctx):
    return {"pid": os.getpid(), "index": ctx.index}


def echo(ctx, value):
    return value


def add(ctx, a, b):
    return a + b


def boom(ctx, message):
    raise ValueError(message)


def hang(ctx, seconds):
    time.sleep(seconds)
    return "woke"


def init_marker(ctx):
    """WorkerSpec.init target: runs once at child-session build time."""
    return {"init_pid": os.getpid(), "index": ctx.index}


def init_one_thread(ctx):
    """WorkerSpec.init target for children that compute with torch: one
    intra-op thread each, so a few children do not oversubscribe the
    host."""
    import torch

    torch.set_num_threads(1)
    return {"threads": torch.get_num_threads()}


def get_state(ctx):
    ctx.session                       # force the lazy session (runs init)
    return ctx.state


def tensors(ctx):
    """A reply made of torch tensors — on the top level and nested; the
    worker must send numpy in their place."""
    import torch

    return {"f32": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": [torch.ones(2, dtype=torch.bfloat16),
                       (torch.tensor(7),)],
            "plain": 3}


def builder_payload(ctx, seed):
    """``run_builder`` on the Cholesky builder, returned as the child saw
    it, plus whether it held a tensor before it reached the pipe."""
    from repro_torch.mp.tasks import run_builder

    out = run_builder(ctx, "test_torch_mp_helpers:build_cholesky", seed)
    return {"payload": out, "tensor_in_child": holds_tensor(out)}


def holds_tensor(value):
    """Whether a torch tensor sits anywhere in ``value`` (dicts, lists,
    tuples); False when torch was never imported."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    if isinstance(value, torch.Tensor):
        return True
    if isinstance(value, dict):
        return any(holds_tensor(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(holds_tensor(v) for v in value)
    return False


def child_launch_counts(ctx, reset=False):
    """This process's kernel launch counts (counters are per process),
    zeroed afterwards when ``reset``."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    counts = launch_counts()
    if reset:
        reset_launch_counts()
    return counts


def kernels_against_plain(ctx):
    """On the card, in this worker process: each of the port's four
    kernels and its plain version on the same small inputs (the GEMM in
    float64, the others in float32), returned as numpy with the launches
    each call made — nothing else crosses the pipe."""
    import torch

    from repro_torch.kernels import launch_counts, ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.tile_matmul import tile_matmul
    from repro_torch.models.ssm import ssd_scan_inputs

    rng = np.random.default_rng(5)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal(shape)).to("cuda", dtype)

    a, b, c = (t(192, 192, dtype=torch.float64) for _ in range(3))
    q1, k1, v1 = t(1, 32, 112), t(1, 545, 32, 112), t(1, 545, 32, 112)
    q, k, v = t(1, 32, 512, 112), t(1, 32, 512, 112), t(1, 32, 512, 112)
    silu = torch.nn.functional.silu
    xdt, cs, Bm, Cm = ssd_scan_inputs(
        silu(t(1, 512, 16, 64)), torch.nn.functional.softplus(t(1, 512, 16)),
        -torch.ones(16, device="cuda"), silu(t(1, 512, 64)),
        silu(t(1, 512, 64)), chunk=128)
    cases = {
        "tile_matmul": (
            lambda: tile_matmul(a, b, c.clone(), alpha=-1.0, beta=1.0,
                                trans_b=True),
            lambda: ref.tile_matmul_ref(a, b, c, alpha=-1.0, beta=1.0,
                                        trans_b=True)),
        "decode_attention": (
            lambda: decode_attention(q1, k1, v1, 545),
            lambda: ref.decode_attention_ref(q1, k1, v1, 545)),
        "flash_attention": (
            lambda: flash_attention(q, k, v, causal=True),
            lambda: ref.flash_attention_ref(q, k, v, causal=True)),
        "ssd_scan": (lambda: ssd_scan(xdt, cs, Bm, Cm)[0],
                     lambda: ref.ssd_scan_ref(xdt, cs, Bm, Cm)[0]),
    }
    out = {"device": torch.cuda.get_device_name(0)}
    for name, (kernel, plain) in cases.items():
        before = launch_counts()[name]
        got = kernel()
        torch.cuda.synchronize()
        out[name] = {"kernel": got, "plain": plain(),
                     "launched": launch_counts()[name] - before}
    return out


def imported_jax_or_reference(ctx):
    """The modules of JAX or the reference package this child imported."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


# ---------------------------------------------------------------------------
# GraphCache cross-process helpers (each call opens a FRESH instance so it
# reads through to disk — the documented cross-process consumption pattern)
def seed_recording(ctx, path, workers=2):
    """Record one real graph into the cache at ``path``; returns its key
    coordinates for later cross-process lookups."""
    from repro_torch.replay import GraphCache
    cache = GraphCache(path)
    with repro_torch.Session(workers, scheduler="replay", cache=cache) as s:
        rep = s.run(build_chain(1))
    return {"digest": rep.plan.digest, "workers": workers,
            "policy": s.policy, "pid": os.getpid()}


def cache_hammer(ctx, path, iters, workers=2):
    """Hammer the on-disk cache with store/swap/plan-meta writes of the
    same key — run on two processes at once, this is a true writer race
    on one target file."""
    from repro_torch.replay import GraphCache
    cache = GraphCache(path)
    with repro_torch.Session(workers, scheduler="replay", cache=cache) as s:
        rep = s.run(build_chain(1))
    rec = rep.recording
    if rec is None:                   # this process adopted; read it back
        rec = cache.lookup(rep.plan.digest, workers, s.policy)
    for i in range(iters):
        cache.store(rec)
        cache.swap(rec)
        cache.store_plan_meta(rec.digest, rec.n_workers, rec.policy,
                              {"pid": os.getpid(), "iter": i})
    return {"pid": os.getpid(), "digest": rec.digest, "writes": 3 * iters}


def store_plan_meta(ctx, path, digest, workers, policy, meta):
    from repro_torch.replay import GraphCache
    return GraphCache(path).store_plan_meta(digest, workers, policy, meta)


def lookup_plan_meta(ctx, path, digest, workers, policy):
    from repro_torch.replay import GraphCache
    return GraphCache(path).lookup_plan_meta(digest, workers, policy)


def swap_same_recording(ctx, path, digest, workers, policy):
    """Re-swap the on-disk recording for this key (drops its plan meta on
    disk — the event a *second* process must observe)."""
    from repro_torch.replay import GraphCache
    cache = GraphCache(path)
    rec = cache.lookup(digest, workers, policy)
    if rec is None:
        raise LookupError("nothing to swap: seed the cache first")
    cache.swap(rec)
    return True
