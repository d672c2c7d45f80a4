"""Production and debug meshes on the process group that is up.

Functions, never module constants, as in the reference: importing this
module touches no process group.  Each builds a ``DeviceMesh`` over the
default group and raises, with the reason, when the group's world size is
not the mesh's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

__all__ = ["make_debug_mesh", "make_mesh", "make_production_mesh"]


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over the default
    process group (ranks in row-major order); ``device_type`` defaults to
    ``"cuda"`` for an NCCL group, else ``"cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group is up: call "
                           "torch.distributed.init_process_group first")
    n = math.prod(shape)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                         f"process group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """Single-pod: (data=16, model=16) = 256 ranks.  Multi-pod: an outer
    "pod" data-parallel axis on top — (pod=2, data=16, model=16) = 512."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return make_mesh((16, 16), ("data", "model"), device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    multi_pod: bool = False,
                    device_type: Optional[str] = None):
    """A small mesh for tests: (data, model), or (2, data, model) with
    ``multi_pod``."""
    if multi_pod:
        return make_mesh((2, n_data, n_model), ("pod", "data", "model"),
                         device_type)
    return make_mesh((n_data, n_model), ("data", "model"), device_type)
