"""SLATE-style tiled linear algebra on task graphs, on PyTorch tensors — the
paper's evaluation substrate: LU, QR (gang-scheduled multithreaded panels,
run on the host in numpy) and Cholesky (overlap-sensitive light panels),
plus the multi-rank cost-model graphs of :mod:`repro_torch.linalg.dist`."""

from .cholesky import (build_cholesky_graph, cholesky_extract,
                       cholesky_graph_key, random_spd)
from .lu import (build_lu_graph, lu_extract, lu_graph_key,
                 lu_static_recording, random_diagdom)
from .qr import (build_qr_graph, qr_extract_r, qr_graph_key, qr_reconstruct,
                 qr_static_recording)
from .tiles import (CostModel, ShapeOnlyStore, TileStore, from_numpy_tiles,
                    resolve_device, to_tiles)

GRAPH_KEYS = {
    "cholesky": cholesky_graph_key,
    "lu": lu_graph_key,
    "qr": qr_graph_key,
}

KERNELS = {
    "cholesky": build_cholesky_graph,
    "lu": build_lu_graph,
    "qr": build_qr_graph,
}


def paper_graph(kernel: str, nb: int, b: int = 192, **kw):
    """Cost-model-only graph at paper scale (for the simulator / static
    scheduler benchmarks).  ``kernel`` in {cholesky, lu, qr}."""
    return KERNELS[kernel](nb, b, store=None, **kw)


__all__ = [
    "CostModel",
    "GRAPH_KEYS",
    "KERNELS",
    "ShapeOnlyStore",
    "TileStore",
    "build_cholesky_graph",
    "build_lu_graph",
    "build_qr_graph",
    "cholesky_extract",
    "cholesky_graph_key",
    "from_numpy_tiles",
    "lu_extract",
    "lu_graph_key",
    "lu_static_recording",
    "paper_graph",
    "qr_extract_r",
    "qr_graph_key",
    "qr_reconstruct",
    "qr_static_recording",
    "random_diagdom",
    "random_spd",
    "resolve_device",
    "to_tiles",
]
