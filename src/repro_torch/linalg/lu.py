"""Tiled LU factorization (no pivoting; callers supply diagonally-dominant
matrices) as a SLATE-style task graph with gang-scheduled panel regions.

Structure per step ``k`` (paper Fig. 5/6):

* ``panel[k]``  — ONE heavy task forking a nested parallel region
  (:func:`~repro_torch.linalg.panels.lu_panel_region`, two blocking barriers
  per column) — the region the paper gang-schedules,
* ``bcast[k]``  — send the factored panel to the other ranks (comm task),
* ``col[k+1,k]`` — the lookahead column update (critical path),
* ``trail*[k]`` — trailing parent creating one child per remaining column
  (``U_kj = L_kk^{-1} A_kj`` then ``A_ij -= L_ik U_kj``), joined for the next
  step's dependencies.

The panel region runs on the host in numpy, as the reference package's does
(SLATE on GPU nodes factors its panels on the host too): the panel task
copies its block column to the host once, forks the region, and copies the
factored column back into the same tiles.  The column updates stay on the
tiles' device, their ``A_ij -= L_ik U_kj`` on the hand-written GEMM.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..api.graph import Graph
from ..compile.fuse import FuseSpec
from ..core.taskgraph import ParallelSpec, TaskGraph
from .cholesky import SPAWN_COST
from .panels import lu_panel_region
from .tiles import (
    CostModel,
    Device,
    ShapeOnlyStore,
    TileStore,
    column_from_host,
    column_to_host,
    resolve_device,
    tile_gemm_nn_sub,
    tile_trsm_left_lower_unit,
)


def _lu_col_fused(lkk, akj, *pairs):
    """Fused column update: ``U_kj = L_kk^{-1} A_kj`` then ``A_ij -= L_ik
    U_kj`` for the interleaved ``(L_ik, A_ij)`` pairs (each ``A_ij``
    updated in place).  Module-level so compiled plans can key one callable
    per column shape."""
    ukj = tile_trsm_left_lower_unit(lkk, akj)
    outs = [ukj]
    for t in range(0, len(pairs), 2):
        outs.append(tile_gemm_nn_sub(pairs[t + 1], pairs[t], ukj))
    return outs[0] if len(outs) == 1 else tuple(outs)


def build_lu_graph(
    nb: int,
    b: int = 64,
    *,
    store: Optional[TileStore] = None,
    cost: Optional[CostModel] = None,
    ranks: int = 4,
    panel_threads: int = 4,
    gang_panels: Optional[bool] = None,
    comm: bool = True,
) -> TaskGraph:
    cm = cost or CostModel()
    g = Graph(f"lu[{nb}x{nb},b={b}]")
    numeric = store is not None
    noop = (lambda ctx: None) if numeric else None

    def panel_body_factory(k: int, n_threads: int):
        """Numeric panel task: gathers block column k to the host, forks the
        gang region, writes the factored tiles back."""
        def fn(ctx):
            tiles = [store[(i, k)] for i in range(k, store.nb)]
            panel = column_to_host(tiles)
            body = lu_panel_region(panel, store.b, n_threads)
            ctx.parallel(n_threads, body, gang=gang_panels)
            column_from_host(tiles, panel)
        return fn

    if numeric:
        g.fuse_state = store

    def col_body(j: int, k: int):
        def fn(ctx):
            store[(k, j)] = tile_trsm_left_lower_unit(store[(k, k)], store[(k, j)])
            for i in range(k + 1, store.nb):
                store[(i, j)] = tile_gemm_nn_sub(store[(i, j)], store[(i, k)], store[(k, j)])
        return fn if numeric else None

    def col_fuse(j: int, k: int):
        if not numeric:
            return None
        reads = [(k, k), (k, j)]
        writes = [(k, j)]
        for i in range(k + 1, nb):
            reads += [(i, k), (i, j)]
            writes.append((i, j))
        return FuseSpec(_lu_col_fused, tuple(reads), tuple(writes))

    def col_cost(k: int) -> float:
        return cm.trsm(b) + 2.0 * (nb - k - 1) * b ** 3 / cm.flop_rate

    join_look = None
    join_trail = None

    for k in range(nb):
        m_tiles = nb - k
        n_threads = max(1, min(panel_threads, m_tiles))
        pdeps = [join_look] if join_look is not None else []
        if numeric:
            p = g.add(panel_body_factory(k, n_threads), name=f"panel[{k}]",
                      kind="panel", cost=cm.panel_lu(m_tiles, b), priority=3,
                      deps=pdeps, step=k)
        else:
            p = g.add(None, name=f"panel[{k}]", kind="panel",
                      cost=0.05 * cm.panel_lu(m_tiles, b), priority=3, deps=pdeps,
                      parallel=ParallelSpec(
                          n_threads=n_threads,
                          cost_per_thread=cm.panel_lu(m_tiles, b) / n_threads,
                          n_barriers=2 * b, blocking=True),
                      step=k)

        col_dep = p
        if comm:
            col_dep = g.add(noop, name=f"bcast[{k}]", kind="comm",
                            cost=cm.bcast(m_tiles, b, ranks), priority=3,
                            deps=[p], step=k)
        base_deps = [col_dep] + ([join_trail] if join_trail is not None else [])

        # lookahead column (single task, critical path)
        if k + 1 < nb:
            join_look = g.add(col_body(k + 1, k), name=f"col[{k + 1},{k}]",
                              kind="lookahead", cost=col_cost(k), priority=2,
                              deps=base_deps, step=k, fuse=col_fuse(k + 1, k))
        else:
            join_look = None

        # trailing family
        if k + 2 < nb:
            tparent = g.add(noop, name=f"trail*[{k}]", kind="compute",
                            cost=SPAWN_COST * (nb - k - 2), priority=0,
                            deps=base_deps, step=k)
            tchildren = [
                g.add(col_body(j, k), name=f"col[{j},{k}]", kind="compute",
                      cost=col_cost(k), priority=0, deps=[tparent], step=k,
                      fuse=col_fuse(j, k))
                for j in range(k + 2, nb)
            ]
            join_trail = g.add(noop, name=f"trail.join[{k}]", kind="compute",
                               cost=0.0, priority=0, deps=tchildren, step=k)
        else:
            join_trail = None
    return g


def lu_graph_key(
    nb: int,
    b: int = 64,
    *,
    cost: Optional[CostModel] = None,
    ranks: int = 4,
    panel_threads: int = 4,
    comm: bool = True,
):
    """Structural replay-cache key for :func:`build_lu_graph`.  NOTE: numeric
    and cost-model LU builds differ structurally (the cost-model panel is a
    :class:`ParallelSpec` task, the numeric panel forks at run time), so
    record numeric sweeps against a numeric build's key — this helper exists
    for simulator/cost-model replay."""
    from ..replay import graph_key
    return graph_key(build_lu_graph(nb, b, cost=cost, ranks=ranks,
                                    panel_threads=panel_threads, comm=comm))


def lu_static_recording(
    nb: int,
    b: int = 64,
    *,
    n_workers: int,
    cost: Optional[CostModel] = None,
    ranks: int = 4,
    panel_threads: int = 4,
    comm: bool = True,
    policy: str = "hybrid",
    seed: int = 0,
):
    """Synthesize a replay :class:`~repro_torch.replay.Recording` for the
    **numeric** LU graph from the simulator: the cost-model twin (same
    structure, :class:`ParallelSpec` panels) is list-scheduled at
    ``n_workers``, its gang reservations become recorded placements (panel
    forks replay *placed*, not via dynamic fallback), and the recording is
    keyed to the numeric build's digest so numeric sweeps replay it
    directly."""
    from ..core.static_schedule import ListScheduler
    from ..replay.graph_key import graph_key
    from ..replay.recording import Recording

    kwargs = dict(cost=cost, ranks=ranks, panel_threads=panel_threads,
                  comm=comm)
    twin = build_lu_graph(nb, b, **kwargs)
    sched = ListScheduler(n_workers, policy=policy, seed=seed).schedule(twin)
    numeric_key = graph_key(
        build_lu_graph(nb, b, store=ShapeOnlyStore(nb, b), **kwargs))
    return Recording.from_static_schedule(sched, twin, key=numeric_key)


def lu_extract(store: TileStore):
    """Assemble (L_unit, U) from the packed in-place factorization."""
    a = store.assemble()
    l = torch.tril(a, -1) + torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    u = torch.triu(a)
    return l, u


def random_diagdom(n: int, seed: int = 0, dtype: torch.dtype = torch.float64,
                   *, device: Device = None) -> torch.Tensor:
    """A standard normal ``M`` drawn from ``numpy.random.default_rng(seed)``
    (the reference package's draw) plus ``diag(sum_j |M_ij| + 1)``, formed on
    ``device`` in float64: strictly diagonally dominant by rows, so LU
    without pivoting is stable."""
    device = resolve_device(device)
    m = torch.from_numpy(np.random.default_rng(seed).standard_normal((n, n)))
    m = m.to(device)
    m += torch.diag(m.abs().sum(dim=1) + 1.0)
    return m.to(dtype)
