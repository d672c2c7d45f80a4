"""Closed-loop factorizations through the program's compiled scheduler.

One caller factors matrices back to back: each factorization loads a
matrix of the pool into the graph's tiles, runs the graph on
``Session(workers, scheduler="compiled")`` with the plan made once in
set-up (the program's path for a sweep of one shape: the graph is built,
recorded, lowered and captured once), and assembles L.  The rate is
``n^3 / 3`` for every factorization completed in the window over the
window's seconds.  Set-up forms the pool, builds the graph, records it
under the dynamic scheduler, captures it and replays it.  After the
window, L of a sample of the window's factorizations, drawn from the
seed, is held against ``torch.linalg.cholesky`` of the same matrix.
"""

from __future__ import annotations

import time

import torch

from portbench import generate
from portbench.harness import annotate, profile, sync
from portbench.reference import cholesky as reference

def _loader(store, nb: int, b: int):
    keys = [(i, j) for i in range(nb) for j in range(nb)]

    def load(a: torch.Tensor) -> None:
        """The user's matrix into the graph's tiles, in place: one
        reordering copy and one batched tile copy."""
        tiles = a.view(nb, b, nb, b).permute(0, 2, 1, 3).contiguous()
        torch._foreach_copy_([store[k] for k in keys],
                             list(tiles.view(nb * nb, b, b)))
    return load


def run(r) -> None:
    from repro_torch import Session
    from repro_torch.linalg import (build_cholesky_graph, cholesky_extract,
                                    to_tiles)

    cfg, tr, rec, dev = r.config, r.traffic, r.rec, r.device
    n, b = int(cfg["n"]), int(cfg["tile"])
    nb = n // b
    dtype = getattr(torch, cfg["dtype"])
    pool = generate.spd_pool(n, int(tr["pool"]), r.seed, dtype, dev)
    store = to_tiles(pool[0], b, device=dev)
    graph = build_cholesky_graph(nb, b, store=store)
    load = _loader(store, nb, b)
    session = Session(int(cfg["workers"]), scheduler=cfg["scheduler"],
                      policy=cfg["policy"])
    try:
        # record under the dynamic scheduler, then capture, then replay
        sync(dev)
        t0 = time.perf_counter()
        rep = session.run(graph)
        sync(dev)
        rec.facts["record_s"] = time.perf_counter() - t0
        rec.facts["record_mode"] = rep.plan.mode
        for k in range(1 + int(tr["warm_replays"])):
            load(pool[(k + 1) % len(pool)])
            session.run(graph)
        plan = session.plan(graph)
        rec.facts["plan_mode"] = plan.mode

        rng = generate.host_rng(r.seed, 5)
        keep = int(tr["sample"])
        kept = []                         # (pool index, L), a reservoir
        fallbacks = 0
        i = 0
        t0 = r.window_opens()
        while time.perf_counter() - t0 < r.seconds:
            j = i % len(pool)
            load(pool[j])
            rep = session.run(graph, plan=plan)
            L = cholesky_extract(store)
            st = rep.stats
            fallbacks += "compiled_fallback" in st or rep.plan.mode != \
                "compiled"
            rec.count("bind_s", st.get("bind_s", 0.0))
            rec.count("dispatch_overhead_fraction",
                      st["dispatch_overhead_fraction"])
            if len(kept) < keep:
                kept.append((j, L))
            else:
                slot = int(rng.integers(0, i + 1))
                if slot < keep:
                    kept[slot] = (j, L)
            del L
            i += 1
        t1 = r.window_closes()
        window = t1 - t0
        r.attempted = i
        r.e2e["factor_gflops"] = i * n ** 3 / 3.0 / window / 1e9
        rec.facts.update(n=n, tile=b, factorizations=i, window_s=window)

        if r.trace:
            k_traced = int(tr["traced"])

            def body():
                for k in range(k_traced):
                    with annotate("factor"):
                        load(pool[k % len(pool)])
                        session.run(graph, plan=plan)
                        cholesky_extract(store)
            rec.trace = profile(rec, body)
            rec.facts["traced_factorizations"] = k_traced
    finally:
        session.close()

    # the reference: every sampled factor against torch.linalg.cholesky
    del store, graph
    worst = 0.0
    for j, L in kept:
        worst = max(worst, reference.factor_error(L, pool[j]))
    r.failed = 0
    r.check("fallbacks", fallbacks)
    r.check("factor_err", worst)
