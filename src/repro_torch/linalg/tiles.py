"""Tiled-matrix utilities, the analytical cost model and the tile kernels of
the SLATE-style factorization task graphs, on PyTorch tensors.

Tiles live on one device: the CUDA device unless the caller asks for the
CPU (``device="cpu"``).  The trailing-update GEMMs go through the
hand-written kernel (:mod:`repro_torch.kernels.tile_matmul`); ``potrf`` and
the two ``trsm`` forms were never TPU kernels and are ``torch.linalg``
calls.

Streams: every worker thread launches on the device's default stream (a
thread that never selects a stream gets it from
``torch.cuda.current_stream()``).  The device runs that work in enqueue
order, and the runtime dispatches a task only after every predecessor's
body has returned — that is, after the predecessor's work was enqueued —
so tile dependencies hold on the device with no events and no host
synchronisation.  Per-worker streams with event waits are later work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.tile_matmul import tile_matmul

Key = Tuple[int, int]
Device = Union[str, torch.device, None]


def resolve_device(device: Device) -> torch.device:
    """``None`` means the CUDA device, and raises when there is none: the
    port never moves to the CPU unless the caller says so."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass device='cpu' to run on the "
                "host")
        return torch.device("cuda")
    return torch.device(device)


class TileStore:
    """Shared tile storage mutated by task bodies.  Task-graph dependencies
    guarantee exclusive access ordering; dict item assignment is atomic.
    Every tile is a contiguous tensor with storage of its own."""

    def __init__(self, tiles: Dict[Key, torch.Tensor], nb: int, b: int):
        self.tiles = tiles
        self.nb = nb
        self.b = b

    def __getitem__(self, k: Key) -> torch.Tensor:
        return self.tiles[k]

    def __setitem__(self, k: Key, v: torch.Tensor) -> None:
        self.tiles[k] = v

    def assemble(self) -> torch.Tensor:
        return torch.cat([
            torch.cat([self.tiles[(i, j)] for j in range(self.nb)], dim=1)
            for i in range(self.nb)], dim=0)


class ShapeOnlyStore:
    """Stand-in for a :class:`TileStore` carrying only ``(nb, b)``.  Task
    bodies never run against it — it exists so the *numeric* variant of a
    factorization graph can be built purely for its structural
    :func:`~repro_torch.replay.graph_key` (numeric and cost-model builds
    differ structurally)."""

    def __init__(self, nb: int, b: int):
        self.nb = nb
        self.b = b


def _own_tile(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device`` that shares no storage."""
    return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)


def to_tiles(a: Union[torch.Tensor, np.ndarray], b: int, *,
             device: Device = None) -> TileStore:
    """Split the square matrix ``a`` into ``b x b`` tiles on ``device``."""
    device = resolve_device(device)
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    n = a.shape[0]
    if a.dim() != 2 or a.shape[0] != a.shape[1] or n % b != 0:
        raise ValueError(f"need square matrix with dim divisible by {b}, got "
                         f"{tuple(a.shape)}")
    nb = n // b
    tiles = {
        (i, j): _own_tile(a[i * b:(i + 1) * b, j * b:(j + 1) * b], device)
        for i in range(nb) for j in range(nb)
    }
    return TileStore(tiles, nb, b)


def from_numpy_tiles(tiles: Dict[Key, np.ndarray], nb: int, b: int, *,
                     device: Device = None) -> TileStore:
    """A store holding copies of numpy tiles (for example the reference
    package's ``TileStore`` tiles as ``{k: np.asarray(v)}``), so both
    packages factor the same numbers."""
    device = resolve_device(device)
    return TileStore(
        {k: _own_tile(torch.from_numpy(np.array(v)), device)
         for k, v in tiles.items()}, nb, b)


@dataclasses.dataclass
class CostModel:
    """Analytical per-task costs for the simulator / static scheduler.

    Defaults approximate one Skylake core (paper's testbed: 2x20C Skylake)
    and EDR InfiniBand: the absolute scale is irrelevant for the relative
    policy comparisons; the compute/comm *ratio* is what matters.
    """

    flop_rate: float = 40e9        # effective flops/s per worker (DGEMM-ish)
    panel_flop_rate: float = 12e9  # panel kernels are bandwidth/latency bound
    comm_bw: float = 10e9          # bytes/s inter-rank link
    comm_latency: float = 15e-6    # per-message latency
    dtype_bytes: int = 8

    def gemm(self, b: int) -> float:
        return 2.0 * b ** 3 / self.flop_rate

    def syrk(self, b: int) -> float:
        return 1.0 * b ** 3 / self.flop_rate

    def trsm(self, b: int) -> float:
        return 1.0 * b ** 3 / self.flop_rate

    def potrf(self, b: int) -> float:
        return (b ** 3 / 3.0) / self.panel_flop_rate

    def panel_lu(self, m_tiles: int, b: int) -> float:
        # left-looking panel on m_tiles*b x b block column
        return (m_tiles * b * b * b) / self.panel_flop_rate

    def panel_qr(self, m_tiles: int, b: int) -> float:
        return (2.0 * m_tiles * b * b * b) / self.panel_flop_rate

    def tile_bytes(self, b: int) -> int:
        return b * b * self.dtype_bytes

    def bcast(self, n_tiles: int, b: int, ranks: int = 4) -> float:
        # pipelined broadcast of a factored block column to the other ranks
        return self.comm_latency * max(1, ranks - 1) + \
            n_tiles * self.tile_bytes(b) / self.comm_bw


# ---------------------------------------------------------------------------
# tile kernels
# ---------------------------------------------------------------------------
def tile_potrf(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a diagonal tile.  ``cholesky_ex`` does not
    check ``info`` (``torch.linalg.cholesky`` would synchronise the host on
    every panel to do so); a tile that is not positive definite shows in
    the factorization's residual."""
    l, _info = torch.linalg.cholesky_ex(a)
    return l.contiguous()


def tile_trsm_right_lower_t(a: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Solve X L^T = A for X (the Cholesky column update)."""
    return torch.linalg.solve_triangular(l.mT, a, upper=True,
                                         left=False).contiguous()


def tile_gemm_sub(c: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """C - A @ B^T (trailing update), written into ``c`` in place: the task
    graph gives the updating task exclusive access to its C tile."""
    return tile_matmul(a, b, c, alpha=-1.0, beta=1.0, trans_b=True, out=c)


def tile_gemm_nn_sub(c: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """C - A @ B, written into ``c`` in place."""
    return tile_matmul(a, b, c, alpha=-1.0, beta=1.0, out=c)


def tile_trsm_left_lower_unit(l: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Solve L X = A with unit-diagonal lower L (LU row update)."""
    return torch.linalg.solve_triangular(l, a, upper=False,
                                         unitriangular=True).contiguous()


# ---------------------------------------------------------------------------
# the host-side panels' bridge (the panels are numpy, as in the reference)
# ---------------------------------------------------------------------------
def column_to_host(tiles: List[torch.Tensor]) -> np.ndarray:
    """The block column stacked from ``tiles`` as a writable numpy array:
    one ``torch.cat`` and one ``.cpu()`` — on CUDA, one copy that waits for
    every kernel queued before it on the stream."""
    return torch.cat(tiles).cpu().numpy()


def column_from_host(tiles: List[torch.Tensor], panel: np.ndarray) -> None:
    """Write the stacked ``panel`` back into ``tiles`` in place: one
    host-to-device copy, then one ``copy_`` per tile, so every tile keeps
    its own storage."""
    b = tiles[0].shape[0]
    dev = torch.from_numpy(panel).to(device=tiles[0].device,
                                     dtype=tiles[0].dtype)
    for idx, t in enumerate(tiles):
        t.copy_(dev[idx * b:(idx + 1) * b])
