"""Logical-axis -> mesh-axis sharding rules (DP / TP / EP / FSDP) on torch
device meshes.

The port of the reference's ``repro/sharding/rules.py``.  Meshes:

* single-pod: ``(data=16, model=16)``;
* multi-pod:  ``(pod=2, data=16, model=16)`` — ``pod`` is an outer
  data-parallel axis.

====================  =========================
logical axis          mesh axes
====================  =========================
batch                 ("pod", "data") / ("data",)
vocab / heads / ff /
experts / ssm_inner /
kv_heads*             "model"
embed                 the batch axes under FSDP (params only), else none
seq / state / layers  unsharded
====================  =========================

``kv_heads`` falls back to replication when ``n_kv_heads`` does not divide
``|model|`` (:func:`make_ctx`).

``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` (or anything
with ``mesh_dim_names`` and ``shape``, for the rules alone).  A
:class:`PartitionSpec` is a tuple with one entry per dimension: None, a
mesh-axis name, or a tuple of names; it compares equal, element by
element, to the reference's ``jax.sharding.PartitionSpec``.  The model
code runs one SPMD program per rank over this rank's shards
(:func:`local_shape`, :func:`local_slices`) and issues its collectives on
the groups :meth:`ShardCtx.group` gives.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

__all__ = ["PartitionSpec", "ShardCtx", "axes_of", "local_shape",
           "local_slices", "logical_to_pspec", "make_ctx", "mesh_index",
           "mesh_shape", "named", "params_pspecs", "pspec_of"]


class PartitionSpec(tuple):
    """One entry per dimension: None, a mesh-axis name or a tuple of them
    (the reference's ``P``); ``PartitionSpec("data", None)``.  A tuple of
    one name is that name, as ``P`` keeps it."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, (tuple, list)):
                return e[0] if len(e) == 1 else tuple(e)
            return e
        return super().__new__(cls, tuple(canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a device mesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_index(mesh, axes) -> int:
    """This rank's row-major index over ``axes`` of ``mesh``."""
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    shape = mesh_shape(mesh)
    i = 0
    for a in axes_of(axes):
        i = i * shape[a] + coord[names.index(a)]
    return i


def axes_of(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes as a tuple (None: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass
class ShardCtx:
    """Everything the model code needs to know about distribution."""

    mesh: Optional[Any]
    model_axis: str = "model"
    data_axes: Tuple[str, ...] = ("data",)
    pod_axis: Optional[str] = None
    shard_kv: bool = True            # False => replicate KV heads (GQA tp>kv)
    seq_shard_cache: bool = False    # True => KV cache seq dim on batch axes
    fsdp: bool = True                # shard params' d_model dims over the
                                     # batch axes (per-block all-gather)
    remat_group: int = 1             # 2-level remat: checkpoint every k layers
    moe_wire_bf16: bool = False      # MoE EP combine in bf16
    moe_gather_tokens: bool = False  # MoE EP: gather tokens, not weights
    _groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return ((self.pod_axis,) if self.pod_axis else ()) + tuple(self.data_axes)

    @property
    def model_size(self) -> int:
        return self.size(self.model_axis) if self.mesh is not None else 1

    @property
    def dp_size(self) -> int:
        return self.size(self.batch_axes) if self.mesh is not None else 1

    def rules(self) -> Dict[Any, Any]:
        batch = self.batch_axes if self.mesh is not None else ()
        return {
            "batch": batch if batch else None,
            "seq": None,
            "embed": self.batch_axes if (self.fsdp and self.mesh is not None)
            else None,
            "heads": self.model_axis,
            "kv_heads": self.model_axis if self.shard_kv else None,
            "ff": self.model_axis,
            "vocab": self.model_axis,
            "experts": self.model_axis,
            "ssm_inner": self.model_axis,
            "state": None,
            "layers": None,
            None: None,
        }

    # -- the mesh at run time ------------------------------------------
    def size(self, axes) -> int:
        """The number of ranks over ``axes`` (a name or a tuple)."""
        if self.mesh is None:
            return 1
        shape = mesh_shape(self.mesh)
        return math.prod(shape[a] for a in axes_of(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (the order a shard
        along them takes)."""
        return 0 if self.mesh is None else mesh_index(self.mesh, axes)

    def group(self, axes):
        """The process group over ``axes`` holding this rank; None when
        it has one rank (every collective on it is a no-op)."""
        axes = axes_of(axes)
        if self.size(axes) == 1:
            return None
        if axes not in self._groups:
            names = tuple(self.mesh.mesh_dim_names)
            ordered = tuple(a for a in names if a in axes)
            if ordered != axes:
                raise ValueError(f"axes {axes} are not in the mesh's order "
                                 f"{names}")
            if len(axes) == 1:
                self._groups[axes] = self.mesh.get_group(axes[0])
            else:
                self._groups[axes] = self.mesh[axes]._flatten().get_group()
        return self._groups[axes]

    def make_groups(self) -> None:
        """Create every group the model uses now, on every rank in the
        same order (creating a group is itself collective)."""
        for axes in (self.model_axis, self.batch_axes,
                     self.batch_axes + (self.model_axis,)):
            self.group(axes)


def logical_to_pspec(axes: Sequence[Optional[str]],
                     ctx: ShardCtx) -> PartitionSpec:
    r = ctx.rules()
    return PartitionSpec(*[r.get(a) for a in axes])


def params_pspecs(spec_axes_tree, ctx: ShardCtx):
    """Map a logical-axes tree (``lm.spec_axes``) to PartitionSpecs."""
    if isinstance(spec_axes_tree, dict):
        return {k: params_pspecs(v, ctx) for k, v in spec_axes_tree.items()}
    return logical_to_pspec(tuple(spec_axes_tree), ctx)


def local_shape(shape: Sequence[int], pspec: Sequence[Any],
                sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of one rank's shard: each dimension divided by the ranks
    of its spec entry's axes (``sizes``: ``mesh_shape``).  A dimension
    that does not divide raises."""
    out = []
    for n, entry in zip(shape, tuple(pspec) + (None,) * len(shape)):
        k = math.prod(sizes[a] for a in axes_of(entry))
        if n % k:
            raise ValueError(f"dimension {n} of {tuple(shape)} does not "
                             f"divide over {axes_of(entry)} ({k} ranks)")
        out.append(n // k)
    return tuple(out)


def local_slices(shape: Sequence[int], pspec: Sequence[Any],
                 mesh) -> Tuple[slice, ...]:
    """This rank's slice of every dimension of a ``shape`` tensor laid out
    by ``pspec`` over ``mesh`` (None: the whole tensor)."""
    if mesh is None:
        return tuple(slice(0, n) for n in shape)
    loc = local_shape(shape, pspec, mesh_shape(mesh))
    out = []
    for n, entry in zip(loc, tuple(pspec) + (None,) * len(shape)):
        i = mesh_index(mesh, entry) if entry is not None else 0
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


def pspec_of(placements, mesh, ndim: int) -> PartitionSpec:
    """The PartitionSpec of DTensor ``placements`` (one per mesh dimension,
    as :func:`named` gives them) for an ``ndim``-dimensional tensor."""
    entries = [[] for _ in range(ndim)]
    for name, pl in zip(mesh.mesh_dim_names, placements):
        dim = getattr(pl, "dim", None)
        if dim is not None:
            entries[dim].append(name)
    return PartitionSpec(*[None if not e else (e[0] if len(e) == 1
                                               else tuple(e))
                           for e in entries])


def named(tree_pspecs, mesh):
    """DTensor placements for a PartitionSpec tree: per leaf a list with
    one ``Shard(dim)`` or ``Replicate()`` per mesh dimension (a mesh axis
    named by several dimensions' entries is not supported)."""
    from torch.distributed.tensor import Replicate, Shard

    def place(spec):
        out = []
        for name in mesh.mesh_dim_names:
            dims = [d for d, e in enumerate(spec) if name in axes_of(e)]
            if len(dims) > 1:
                raise ValueError(f"axis {name!r} shards two dims of {spec}")
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    if isinstance(tree_pspecs, dict):
        return {k: named(v, mesh) for k, v in tree_pspecs.items()}
    return place(tree_pspecs)


def make_ctx(mesh, cfg=None) -> ShardCtx:
    """A :class:`ShardCtx` for ``mesh``, with KV heads replicated when they
    do not divide the model axis (the reference's rule)."""
    if mesh is None:
        return ShardCtx(mesh=None)
    axis_names = tuple(mesh.mesh_dim_names)
    pod = "pod" if "pod" in axis_names else None
    shard_kv = True
    if cfg is not None and getattr(cfg, "n_kv_heads", 0):
        shard_kv = cfg.n_kv_heads % mesh_shape(mesh)["model"] == 0
    return ShardCtx(mesh=mesh, pod_axis=pod, data_axes=("data",),
                    shard_kv=shard_kv)
