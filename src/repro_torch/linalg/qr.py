"""Tiled Householder QR as a SLATE-style task graph with gang-scheduled
panel regions (communication-avoiding flavor: per-column reductions are the
only panel synchronization; no pivoting — paper §5.2: "the panel
factorization is the most critical task to the task graph of QR").

Structure per step ``k``: like LU — gang-scheduled ``panel[k]`` (4 blocking
barriers per column), ``bcast[k]`` shipping {V, T}, a lookahead column task
and a trailing parent/children/join family applying
``A_j <- (I - V T V^T)^T A_j``.

The panel region runs on the host in numpy, as in the reference package.
The panel task uploads the reflectors in the layouts the column update
needs — ``V``, and contiguous ``V^T`` and ``T^T``, all three free to form
in numpy — so the update ``A_j - V (T^T (V^T A_j))`` runs as three launches
of the hand-written GEMM, which takes contiguous operands and transposes
only its second one.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..api.graph import Graph
from ..compile.fuse import FuseSpec
from ..core.taskgraph import ParallelSpec, TaskGraph
from ..kernels.tile_matmul import tile_matmul
from .cholesky import SPAWN_COST
from .panels import qr_form_t, qr_panel_region
from .tiles import CostModel, ShapeOnlyStore, TileStore, column_to_host

#: tile_matmul launches of one column update ``A_j - V (T^T (V^T A_j))``
COL_UPDATE_LAUNCHES = 3


class _QrFuseState:
    """Fuse-state adapter: tile keys ``(i, j)`` resolve to the tile store,
    ``("vt", k)`` to the panel-reflector side store."""

    __slots__ = ("store",)

    def __init__(self, store: TileStore):
        self.store = store

    def __getitem__(self, k):
        if k[0] == "vt":
            return self.store.vt_store[k[1]]
        return self.store[k]

    def __setitem__(self, k, v):
        if k[0] == "vt":
            self.store.vt_store[k[1]] = v
        else:
            self.store[k] = v


def _qr_col_fused(vt, *tiles):
    """Trailing-column update ``A_j <- (I - V T V^T)^T A_j`` over the
    stacked tiles of block column ``j``, written back into the tiles in
    place: ``W = V^T A``, ``Y = T^T W`` and ``A -= V Y``, each one
    :data:`COL_UPDATE_LAUNCHES`-th of the update on the tile GEMM.
    Module-level so compiled plans can key one callable per column
    shape."""
    V, Vt, Tt = vt
    b = tiles[0].shape[0]
    a = torch.cat(tiles)
    w = tile_matmul(Vt, a)
    y = tile_matmul(Tt, w)
    tile_matmul(V, y, a, alpha=-1.0, beta=1.0, out=a)
    for i, t in enumerate(tiles):
        t.copy_(a[i * b:(i + 1) * b])
    return tiles[0] if len(tiles) == 1 else tuple(tiles)


def build_qr_graph(
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
    g = Graph(f"qr[{nb}x{nb},b={b}]")
    numeric = store is not None
    noop = (lambda ctx: None) if numeric else None
    # side store for the panel reflectors: k -> (V, V^T, T^T) on the tiles'
    # device, V (m x b)
    vt_store: Dict[int, tuple] = {}
    if store is not None:
        store.vt_store = vt_store  # exposed for validation

    def panel_body_factory(k: int, n_threads: int):
        def fn(ctx):
            tiles = [store[(i, k)] for i in range(k, store.nb)]
            panel = column_to_host(tiles)
            body, taus = qr_panel_region(panel, store.b, n_threads)
            ctx.parallel(n_threads, body, gang=gang_panels)
            T = qr_form_t(panel, taus)
            V = np.tril(panel, -1)[:, :store.b] + np.eye(panel.shape[0], store.b)
            # one upload: R (the top tile's upper triangle), V, V^T, T^T
            m, b = V.shape
            host = np.concatenate([np.triu(panel[:b]).ravel(), V.ravel(),
                                   V.T.ravel(), T.T.ravel()])
            dev = torch.from_numpy(host).to(device=tiles[0].device,
                                            dtype=tiles[0].dtype)
            parts = torch.split(dev, [b * b, m * b, m * b, b * b])
            vt_store[k] = (parts[1].view(m, b), parts[2].view(b, m),
                           parts[3].view(b, b))
            # write back: R on/above the diagonal of the top tile, zeros below
            tiles[0].copy_(parts[0].view(b, b))
            for t in tiles[1:]:
                t.zero_()
        return fn

    if numeric:
        g.fuse_state = _QrFuseState(store)

    def col_body(j: int, k: int):
        def fn(ctx):
            _qr_col_fused(vt_store[k],
                          *[store[(i, j)] for i in range(k, store.nb)])
        return fn if numeric else None

    def col_fuse(j: int, k: int):
        if not numeric:
            return None
        keys = [(i, j) for i in range(k, nb)]
        return FuseSpec(_qr_col_fused, (("vt", k),) + tuple(keys), tuple(keys))

    def col_cost(k: int) -> float:
        return 4.0 * (nb - k) * b ** 3 / cm.flop_rate

    join_look = None
    join_trail = None

    for k in range(nb):
        m_tiles = nb - k
        n_threads = max(1, min(panel_threads, m_tiles))
        pdeps = [join_look] if join_look is not None else []
        if numeric:
            p = g.add(panel_body_factory(k, n_threads), name=f"panel[{k}]",
                      kind="panel", cost=cm.panel_qr(m_tiles, b), priority=3,
                      deps=pdeps, step=k)
        else:
            p = g.add(None, name=f"panel[{k}]", kind="panel",
                      cost=0.05 * cm.panel_qr(m_tiles, b), priority=3, deps=pdeps,
                      parallel=ParallelSpec(
                          n_threads=n_threads,
                          cost_per_thread=cm.panel_qr(m_tiles, b) / n_threads,
                          n_barriers=4 * b, blocking=True),
                      step=k)

        col_dep = p
        if comm:
            col_dep = g.add(noop, name=f"bcast[{k}]", kind="comm",
                            cost=cm.bcast(m_tiles + 1, b, ranks), priority=3,
                            deps=[p], step=k)
        base_deps = [col_dep] + ([join_trail] if join_trail is not None else [])

        if k + 1 < nb:
            join_look = g.add(col_body(k + 1, k), name=f"col[{k + 1},{k}]",
                              kind="lookahead", cost=col_cost(k), priority=2,
                              deps=base_deps, step=k, fuse=col_fuse(k + 1, k))
        else:
            join_look = None

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


def qr_graph_key(
    nb: int,
    b: int = 64,
    *,
    cost: Optional[CostModel] = None,
    ranks: int = 4,
    panel_threads: int = 4,
    comm: bool = True,
):
    """Structural replay-cache key for :func:`build_qr_graph` (cost-model
    shape; see the note on :func:`repro_torch.linalg.lu.lu_graph_key` about
    numeric-vs-cost-model panel structure)."""
    from ..replay import graph_key
    return graph_key(build_qr_graph(nb, b, cost=cost, ranks=ranks,
                                    panel_threads=panel_threads, comm=comm))


def qr_static_recording(
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
    """QR analogue of :func:`repro_torch.linalg.lu.lu_static_recording`:
    simulate the cost-model twin, carry its gang reservations into the
    recording as placements, key it to the numeric build's digest."""
    from ..core.static_schedule import ListScheduler
    from ..replay.graph_key import graph_key
    from ..replay.recording import Recording

    kwargs = dict(cost=cost, ranks=ranks, panel_threads=panel_threads,
                  comm=comm)
    twin = build_qr_graph(nb, b, **kwargs)
    sched = ListScheduler(n_workers, policy=policy, seed=seed).schedule(twin)
    numeric_key = graph_key(
        build_qr_graph(nb, b, store=ShapeOnlyStore(nb, b), **kwargs))
    return Recording.from_static_schedule(sched, twin, key=numeric_key)


def qr_extract_r(store: TileStore) -> torch.Tensor:
    return torch.triu(store.assemble())


def qr_reconstruct(store: TileStore) -> torch.Tensor:
    """Apply the stored panel transforms to R to reconstruct A = Q R on the
    store's device: A = H_0 H_1 ... H_{nb-1} R with H_k = I - V_k T_k V_k^T
    acting on the trailing rows."""
    n = store.nb * store.b
    a = qr_extract_r(store)
    for k in reversed(range(store.nb)):
        V, Vt, Tt = store.vt_store[k]
        rows = slice(k * store.b, n)
        blk = a[rows]
        a[rows] = blk - V @ (Tt.mT @ (Vt @ blk))
    return a
