"""Tiled right-looking Cholesky factorization as a SLATE-style task graph.

Structure per step ``k`` — mirroring SLATE's nesting (top-level tasks with
``omp depend`` at block-column granularity, each *creating child tasks* and
taskwait-ing on them):

* ``panel*[k]``   — parent task; children: ``potrf[k]`` then independent
                    ``trsm[i,k]`` ("panel factorization is done in a bunch of
                    independent tasks", §5.4); joined by ``panel.join[k]``,
* ``bcast[k]``    — blocking communication: ship the factored column,
* ``look*[k]``    — lookahead parent; children update block column ``k+1``,
* ``trail*[k]``   — trailing parent; children update columns ``k+2..``.

The victim-selection anomaly the paper fixes lives in this shape: a trailing
parent dumps its many children onto *one* worker's queue; history-based
thieves lock onto that queue and the panel's children (and the broadcast
behind them) serialize on whatever worker picked the panel up — delaying the
critical path.  Hybrid stealing spreads the panel children (paper Fig. 9/11).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..api.graph import Graph
from ..compile.fuse import FuseSpec
from ..core.taskgraph import TaskGraph
from .tiles import (CostModel, Device, TileStore, resolve_device, tile_gemm_sub,
                    tile_potrf, tile_trsm_right_lower_t)

# per-child task-creation overhead charged to parent tasks (OpenMP task
# creation is ~0.5-1us)
SPAWN_COST = 7e-7


def build_cholesky_graph(
    nb: int,
    b: int = 64,
    *,
    store: Optional[TileStore] = None,
    cost: Optional[CostModel] = None,
    ranks: int = 4,
    comm: bool = True,
) -> TaskGraph:
    """Build the tiled-Cholesky task graph.  If ``store`` is given, tasks
    carry numeric bodies factoring it in place (lower-triangular result);
    otherwise bodies are ``None`` (cost-model graphs for the simulator).

    Built through the v2 :class:`~repro_torch.api.Graph` (``add`` returns
    :class:`~repro_torch.api.TaskHandle` futures usable as ``deps=``); tile
    writes are ordered by the explicit edges, so the structure — and the
    replay-cache digest — is identical to the v1 construction."""
    cm = cost or CostModel()
    g = Graph(f"cholesky[{nb}x{nb},b={b}]")
    numeric = store is not None
    noop = (lambda ctx: None) if numeric else None
    if numeric:
        # fuse metadata: numeric bodies are pure tile kernels over the store,
        # declared so compiled plans can fuse runs of them into one jitted
        # segment (Task.meta is digest-neutral — recordings are unaffected)
        g.fuse_state = store

    def _fuse(kernel, reads, writes):
        return FuseSpec(kernel, tuple(reads), tuple(writes)) if numeric else None

    def potrf_body(k):
        def fn(ctx):
            store[(k, k)] = tile_potrf(store[(k, k)])
        return fn if numeric else None

    def trsm_body(i, k):
        def fn(ctx):
            store[(i, k)] = tile_trsm_right_lower_t(store[(i, k)], store[(k, k)])
        return fn if numeric else None

    def update_body(i, j, k):
        def fn(ctx):
            store[(i, j)] = tile_gemm_sub(store[(i, j)], store[(i, k)], store[(j, k)])
        return fn if numeric else None

    join_look = None     # join of lookahead[k-1] (column k final)
    join_trail = None    # join of trailing[k-1]

    for k in range(nb):
        # ---- panel family -------------------------------------------------
        n_children = nb - k
        pparent = g.add(noop, name=f"panel*[{k}]", kind="panel",
                        cost=SPAWN_COST * n_children, priority=3,
                        deps=[join_look] if join_look is not None else [], step=k)
        potrf = g.add(potrf_body(k), name=f"potrf[{k}]", kind="panel",
                      cost=cm.potrf(b), priority=3, deps=[pparent], step=k,
                      fuse=_fuse(tile_potrf, [(k, k)], [(k, k)]))
        trsms = [
            g.add(trsm_body(i, k), name=f"trsm[{i},{k}]", kind="panel",
                  cost=cm.trsm(b), priority=3, deps=[potrf], step=k,
                  fuse=_fuse(tile_trsm_right_lower_t, [(i, k), (k, k)], [(i, k)]))
            for i in range(k + 1, nb)
        ]
        pjoin = g.add(noop, name=f"panel.join[{k}]", kind="panel", cost=0.0,
                      priority=3, deps=trsms or [potrf], step=k)

        col_dep = pjoin
        if comm:
            col_dep = g.add(noop, name=f"bcast[{k}]", kind="comm",
                            cost=cm.bcast(nb - k, b, ranks), priority=3,
                            deps=[pjoin], step=k)

        base_deps = [col_dep] + ([join_trail] if join_trail is not None else [])

        # ---- lookahead family (column k+1) --------------------------------
        if k + 1 < nb:
            lparent = g.add(noop, name=f"look*[{k}]", kind="lookahead",
                            cost=SPAWN_COST * (nb - k - 1), priority=2,
                            deps=base_deps, step=k)
            lchildren = [
                g.add(update_body(i, k + 1, k), name=f"upd[{i},{k + 1},{k}]",
                      kind="lookahead",
                      cost=cm.syrk(b) if i == k + 1 else cm.gemm(b),
                      priority=2, deps=[lparent], step=k,
                      fuse=_fuse(tile_gemm_sub,
                                 [(i, k + 1), (i, k), (k + 1, k)], [(i, k + 1)]))
                for i in range(k + 1, nb)
            ]
            join_look = g.add(noop, name=f"look.join[{k}]", kind="lookahead",
                              cost=0.0, priority=2, deps=lchildren, step=k)
        else:
            join_look = None

        # ---- trailing family (columns k+2..) -------------------------------
        if k + 2 < nb:
            n_tr = sum(nb - j for j in range(k + 2, nb))
            tparent = g.add(noop, name=f"trail*[{k}]", kind="compute",
                            cost=SPAWN_COST * n_tr, priority=0,
                            deps=base_deps, step=k)
            tchildren = []
            for j in range(k + 2, nb):
                for i in range(j, nb):
                    tchildren.append(
                        g.add(update_body(i, j, k), name=f"upd[{i},{j},{k}]",
                              kind="compute",
                              cost=cm.syrk(b) if i == j else cm.gemm(b),
                              priority=0, deps=[tparent], step=k,
                              fuse=_fuse(tile_gemm_sub,
                                         [(i, j), (i, k), (j, k)], [(i, j)])))
            join_trail = g.add(noop, name=f"trail.join[{k}]", kind="compute",
                               cost=0.0, priority=0, deps=tchildren, step=k)
        else:
            join_trail = None
    return g


def cholesky_graph_key(
    nb: int,
    b: int = 64,
    *,
    cost: Optional[CostModel] = None,
    ranks: int = 4,
    comm: bool = True,
):
    """Structural replay-cache key for :func:`build_cholesky_graph`.

    Computed from a body-less cost-model build (no tile store needed): the
    key ignores callables, so it is identical to the key of a numeric build
    with the same shape parameters — an iterative sweep keys its
    :class:`~repro_torch.replay.GraphCache` lookups on this and hits the
    recording from step 1 on every later step."""
    from ..replay import graph_key
    return graph_key(build_cholesky_graph(nb, b, cost=cost, ranks=ranks, comm=comm))


def cholesky_extract(store: TileStore) -> torch.Tensor:
    """Assemble L (zeroing the strictly-upper tiles)."""
    return torch.tril(store.assemble())


def random_spd(n: int, seed: int = 0, dtype: torch.dtype = torch.float64, *,
               device: Device = None) -> torch.Tensor:
    """``M M^T + n I`` for a standard normal ``M`` drawn from
    ``numpy.random.default_rng(seed)`` (the reference package's matrix);
    the product is formed on ``device`` in float64."""
    device = resolve_device(device)
    m = torch.from_numpy(np.random.default_rng(seed).standard_normal((n, n)))
    m = m.to(device)
    a = m @ m.T + n * torch.eye(n, dtype=torch.float64, device=device)
    return a.to(dtype)
