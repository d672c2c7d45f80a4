"""Multithreaded panel factorizations — the nested data-parallel regions the
paper gang-schedules (SLATE §5.2: "the panel factorization is parallelized in
a nested-parallel region ... synchronized at the end of each step using a
custom barrier operation in the library").

Each panel body runs as a gang ULT: ``body(thread_num, region)`` over a
shared numpy buffer, with ``region.barrier()`` as the blocking in-region
synchronization.  Threads own block-rows round-robin (the paper: "each
thread is persistently assigned tiles in a round-robin manner").
"""

from __future__ import annotations

from typing import List

import numpy as np


def _row_ranges(m: int, b: int, n_threads: int, tid: int, lead: int = 0) -> List[slice]:
    """Row slices (as slices into the panel) owned by ``tid``: block-rows of
    height ``b`` assigned round-robin, skipping the first ``lead`` rows where
    requested by the caller."""
    out = []
    n_blocks = (m + b - 1) // b
    for blk in range(tid, n_blocks, n_threads):
        r0, r1 = blk * b, min((blk + 1) * b, m)
        out.append(slice(r0, r1))
    return out


def lu_panel_region(panel: np.ndarray, b: int, n_threads: int):
    """Return ``body(tid, region)`` factoring ``panel`` (m x w) in place into
    unit-lower L (below diagonal) and U (on/above), *without pivoting*
    (callers guarantee diagonal dominance).  Right-looking, two blocking
    barriers per column — the paper's custom-barrier pattern."""
    m, w = panel.shape

    def body(tid: int, region) -> None:
        my_rows = _row_ranges(m, b, n_threads, tid)
        for j in range(w):
            # 1) scale column j below the diagonal (own rows only)
            pjj = panel[j, j]
            for sl in my_rows:
                lo = max(sl.start, j + 1)
                if lo < sl.stop:
                    panel[lo:sl.stop, j] /= pjj
            region.barrier()
            # 2) rank-1 update of the trailing columns (own rows only)
            if j + 1 < w:
                prow = panel[j, j + 1:]
                for sl in my_rows:
                    lo = max(sl.start, j + 1)
                    if lo < sl.stop:
                        panel[lo:sl.stop, j + 1:] -= np.outer(panel[lo:sl.stop, j], prow)
            region.barrier()

    return body


def qr_panel_region(panel: np.ndarray, b: int, n_threads: int):
    """Return ``(body, taus)``: Householder panel factorization of ``panel``
    (m x w) in place — V (unit lower) below the diagonal, R on/above — with
    per-column reductions synchronized by blocking barriers (4 per column).
    ``taus[j]`` filled with the Householder scalars."""
    m, w = panel.shape
    taus = np.zeros(w)
    # shared scratch: per-thread partial reductions
    norm_part = np.zeros(n_threads)
    w_part = np.zeros((n_threads, w))
    w_red = np.zeros(w)

    def body(tid: int, region) -> None:
        my_rows = _row_ranges(m, b, n_threads, tid)
        for j in range(w):
            # (a) partial squared norms of column j below row j
            s = 0.0
            for sl in my_rows:
                lo = max(sl.start, j + 1)
                if lo < sl.stop:
                    seg = panel[lo:sl.stop, j]
                    s += float(seg @ seg)
            norm_part[tid] = s
            region.barrier()
            # (b) thread 0 forms the reflector: v=[1, x/(alpha-beta)], tau
            if tid == 0:
                alpha = panel[j, j]
                sigma = float(norm_part.sum())
                if sigma == 0.0:
                    taus[j] = 0.0
                else:
                    beta = -np.sign(alpha if alpha != 0 else 1.0) * np.sqrt(alpha * alpha + sigma)
                    taus[j] = (beta - alpha) / beta
                    panel[j, j] = beta
                    norm_part[0] = alpha - beta   # broadcast the scale factor
            region.barrier()
            if taus[j] != 0.0:
                scale = norm_part[0]
                # (c) scale own rows of v; partial w = v^T A for trailing cols
                for sl in my_rows:
                    lo = max(sl.start, j + 1)
                    if lo < sl.stop:
                        panel[lo:sl.stop, j] /= scale
                part = np.zeros(w - j - 1) if j + 1 < w else np.zeros(0)
                for sl in my_rows:
                    lo = max(sl.start, j + 1)
                    if lo < sl.stop and j + 1 < w:
                        part += panel[lo:sl.stop, j] @ panel[lo:sl.stop, j + 1:]
                if j + 1 < w:
                    # v[0] = 1 contribution comes from row j (owned by its block owner)
                    if any(sl.start <= j < sl.stop for sl in my_rows):
                        part += panel[j, j + 1:]
                    w_part[tid, j + 1:] = part
                region.barrier()
                # (d) thread 0 reduces w
                if tid == 0 and j + 1 < w:
                    w_red[j + 1:] = taus[j] * w_part[:, j + 1:].sum(axis=0)
                region.barrier()
                # (e) apply rank-1 update to own rows (row j handled by owner)
                if j + 1 < w:
                    for sl in my_rows:
                        if sl.start <= j < sl.stop:
                            panel[j, j + 1:] -= w_red[j + 1:]
                        lo = max(sl.start, j + 1)
                        if lo < sl.stop:
                            panel[lo:sl.stop, j + 1:] -= np.outer(
                                panel[lo:sl.stop, j], w_red[j + 1:])
            else:
                region.barrier()
                region.barrier()
            region.barrier()

    return body, taus


def qr_form_t(panel: np.ndarray, taus: np.ndarray) -> np.ndarray:
    """Build the compact-WY T factor (upper triangular, w x w) from V (unit
    lower in ``panel``) and ``taus``: H_0 H_1 ... = I - V T V^T."""
    m, w = panel.shape
    V = np.tril(panel, -1)[:, :w] + np.eye(m, w)
    T = np.zeros((w, w))
    for j in range(w):
        if taus[j] == 0.0:
            continue
        T[j, j] = taus[j]
        if j > 0:
            T[:j, j] = -taus[j] * (T[:j, :j] @ (V[:, :j].T @ V[:, j]))
    return T
