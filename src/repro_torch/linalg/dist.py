"""Multi-rank (MPI-style) SLATE factorization task graphs.

The paper's experiments run SLATE with 2-4 MPI ranks per node, each with its
own OpenMP thread pool (10-20 threads).  Block columns are distributed
1-D block-cyclic: column ``j`` lives on rank ``j % R``.  Per step ``k``:

* the owner rank factors the panel (family / gang region) and *sends* the
  factored column (``bcast[k]`` comm task on the owner),
* every other rank has a blocking ``recv[k,r]`` comm task (the MPI Recv that
  dominates Idle time in paper Fig. 11d),
* each rank updates its local block columns (lookahead/trailing families).

Work stealing never crosses ranks; tasks are pinned via ``meta['rank']`` and
the simulator routes cross-rank readiness through the destination pool.

This is where the paper's headline Cholesky result reproduces: under
history-based stealing the owner's trailing flood starves the panel children
and the broadcast, and *every other rank* idles at its recv — hybrid victim
selection pulls the send earlier and collapses the idle time.
"""

from __future__ import annotations

from typing import Optional

from ..core.taskgraph import ParallelSpec, TaskGraph
from .cholesky import SPAWN_COST
from .tiles import CostModel


def build_dist_cholesky_graph(
    nb: int,
    b: int = 192,
    *,
    ranks: int = 4,
    cost: Optional[CostModel] = None,
) -> TaskGraph:
    cm = cost or CostModel()
    g = TaskGraph(f"dist-cholesky[{nb}x{nb},b={b},R={ranks}]")

    # per-rank joins of the previous step's families
    join_look = {r: None for r in range(ranks)}   # lookahead join (by owner of col k)
    join_trail = {r: None for r in range(ranks)}  # trailing join per rank

    def owner(j: int) -> int:
        return j % ranks

    for k in range(nb):
        ok = owner(k)
        # ---- panel family on the owner rank --------------------------------
        # depends ONLY on the lookahead that updated column k (SLATE: the
        # trailing family concurrently updates later columns — this is the
        # concurrency the victim policy governs)
        pdeps = [join_look[ok]] if join_look[ok] is not None else []
        pparent = g.add(None, name=f"panel*[{k}]", kind="panel",
                        cost=SPAWN_COST * (nb - k), priority=3, deps=pdeps,
                        rank=ok, step=k)
        potrf = g.add(None, name=f"potrf[{k}]", kind="panel", cost=cm.potrf(b),
                      priority=3, deps=[pparent], rank=ok, step=k)
        trsms = [
            g.add(None, name=f"trsm[{i},{k}]", kind="panel", cost=cm.trsm(b),
                  priority=3, deps=[potrf], rank=ok, step=k)
            for i in range(k + 1, nb)
        ]
        pjoin = g.add(None, name=f"panel.join[{k}]", kind="panel", cost=0.0,
                      priority=3, deps=trsms or [potrf], rank=ok, step=k)

        # ---- communication: owner sends, everyone else receives ------------
        send = g.add(None, name=f"bcast[{k}]", kind="comm",
                     cost=cm.bcast(nb - k, b, ranks), priority=3,
                     deps=[pjoin], rank=ok, step=k)
        recvs = {}
        for r in range(ranks):
            if r == ok:
                recvs[r] = send
            else:
                recvs[r] = g.add(None, name=f"recv[{k},{r}]", kind="comm",
                                 cost=cm.comm_latency + (nb - k) * cm.tile_bytes(b) / cm.comm_bw,
                                 priority=3, deps=[send], rank=r, step=k)

        # ---- update families per rank --------------------------------------
        new_join_look = {r: None for r in range(ranks)}
        new_join_trail = {r: None for r in range(ranks)}
        for r in range(ranks):
            # local columns this rank updates at step k
            look_cols = [j for j in range(k + 1, min(k + 2, nb)) if owner(j) == r]
            trail_cols = [j for j in range(k + 2, nb) if owner(j) == r]

            if look_cols:
                deps = [recvs[r]] + ([join_trail[r]] if join_trail[r] is not None else [])
                lparent = g.add(None, name=f"look*[{k},{r}]", kind="lookahead",
                                cost=SPAWN_COST * (nb - k - 1), priority=2,
                                deps=deps, rank=r, step=k)
                j = look_cols[0]
                lch = [
                    g.add(None, name=f"upd[{i},{j},{k}]", kind="lookahead",
                          cost=cm.syrk(b) if i == j else cm.gemm(b), priority=2,
                          deps=[lparent], rank=r, step=k)
                    for i in range(j, nb)
                ]
                new_join_look[r] = g.add(None, name=f"look.join[{k},{r}]",
                                         kind="lookahead", cost=0.0, priority=2,
                                         deps=lch, rank=r, step=k)
            if trail_cols:
                deps = [recvs[r]] + ([join_trail[r]] if join_trail[r] is not None else [])
                n_tr = sum(nb - j for j in trail_cols)
                tparent = g.add(None, name=f"trail*[{k},{r}]", kind="compute",
                                cost=SPAWN_COST * n_tr, priority=0, deps=deps,
                                rank=r, step=k)
                tch = []
                for j in trail_cols:
                    for i in range(j, nb):
                        tch.append(g.add(None, name=f"upd[{i},{j},{k}]",
                                         kind="compute",
                                         cost=cm.syrk(b) if i == j else cm.gemm(b),
                                         priority=0, deps=[tparent], rank=r, step=k))
                new_join_trail[r] = g.add(None, name=f"trail.join[{k},{r}]",
                                          kind="compute", cost=0.0, priority=0,
                                          deps=tch, rank=r, step=k)
        # next step's panel (on owner(k+1)) must wait for that rank's
        # lookahead join; other ranks' families chain through their joins
        join_look = new_join_look
        for r in range(ranks):
            if new_join_trail[r] is not None:
                join_trail[r] = new_join_trail[r]
            # if a rank had no trailing work this step, keep the old join
    return g


def _panel_task(g, name, kind, k, m_tiles, b, cm, n_threads, n_barriers,
                deps, rank, serial_frac=0.05):
    flops_cost = cm.panel_lu(m_tiles, b) if kind == "lu" else cm.panel_qr(m_tiles, b)
    return g.add(None, name=name, kind="panel", cost=serial_frac * flops_cost,
                 priority=3, deps=deps, rank=rank, step=k,
                 parallel=ParallelSpec(n_threads=n_threads,
                                       cost_per_thread=flops_cost / n_threads,
                                       n_barriers=n_barriers, blocking=True))


def build_dist_panel_graph(
    kernel: str,
    nb: int,
    b: int = 192,
    *,
    ranks: int = 4,
    panel_threads: int = 4,
    cost: Optional[CostModel] = None,
) -> TaskGraph:
    """Distributed LU/QR graph: gang-scheduled panel regions on the owner
    rank + column-level lookahead/trailing families per rank (paper §5.2)."""
    if kernel not in ("lu", "qr"):
        raise ValueError(kernel)
    cm = cost or CostModel()
    g = TaskGraph(f"dist-{kernel}[{nb}x{nb},b={b},R={ranks}]")
    join_look = {r: None for r in range(ranks)}
    join_trail = {r: None for r in range(ranks)}

    def owner(j: int) -> int:
        return j % ranks

    def col_cost(k: int) -> float:
        if kernel == "lu":
            return cm.trsm(b) + 2.0 * (nb - k - 1) * b ** 3 / cm.flop_rate
        return 4.0 * (nb - k) * b ** 3 / cm.flop_rate

    for k in range(nb):
        ok = owner(k)
        m_tiles = nb - k
        n_threads = max(1, min(panel_threads, m_tiles))
        n_barriers = 2 * b if kernel == "lu" else 4 * b
        pdeps = [join_look[ok]] if join_look[ok] is not None else []
        p = _panel_task(g, f"panel[{k}]", kernel, k, m_tiles, b, cm,
                        n_threads, n_barriers, pdeps, ok)

        send = g.add(None, name=f"bcast[{k}]", kind="comm",
                     cost=cm.bcast(m_tiles, b, ranks), priority=3, deps=[p],
                     rank=ok, step=k)
        recvs = {}
        for r in range(ranks):
            recvs[r] = send if r == ok else g.add(
                None, name=f"recv[{k},{r}]", kind="comm",
                cost=cm.comm_latency + m_tiles * cm.tile_bytes(b) / cm.comm_bw,
                priority=3, deps=[send], rank=r, step=k)

        new_join_look = {r: None for r in range(ranks)}
        for r in range(ranks):
            look_cols = [j for j in range(k + 1, min(k + 2, nb)) if owner(j) == r]
            trail_cols = [j for j in range(k + 2, nb) if owner(j) == r]
            if look_cols:
                deps = [recvs[r]] + ([join_trail[r]] if join_trail[r] is not None else [])
                new_join_look[r] = g.add(None, name=f"col[{look_cols[0]},{k}]",
                                         kind="lookahead", cost=col_cost(k),
                                         priority=2, deps=deps, rank=r, step=k)
            if trail_cols:
                deps = [recvs[r]] + ([join_trail[r]] if join_trail[r] is not None else [])
                tparent = g.add(None, name=f"trail*[{k},{r}]", kind="compute",
                                cost=SPAWN_COST * len(trail_cols), priority=0,
                                deps=deps, rank=r, step=k)
                tch = [g.add(None, name=f"col[{j},{k}]", kind="compute",
                             cost=col_cost(k), priority=0, deps=[tparent],
                             rank=r, step=k)
                       for j in trail_cols]
                join_trail[r] = g.add(None, name=f"trail.join[{k},{r}]",
                                      kind="compute", cost=0.0, priority=0,
                                      deps=tch, rank=r, step=k)
        join_look = new_join_look
    return g
