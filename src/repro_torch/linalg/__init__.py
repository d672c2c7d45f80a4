"""SLATE-style tiled linear algebra on task graphs, on PyTorch tensors.

Cholesky is ported; LU, QR, the gang-scheduled panels and the distributed
graphs are still to come."""

from .cholesky import (build_cholesky_graph, cholesky_extract,
                       cholesky_graph_key, random_spd)
from .tiles import (CostModel, TileStore, from_numpy_tiles, resolve_device,
                    to_tiles)

__all__ = [
    "CostModel",
    "TileStore",
    "build_cholesky_graph",
    "cholesky_extract",
    "cholesky_graph_key",
    "from_numpy_tiles",
    "random_spd",
    "resolve_device",
    "to_tiles",
]
