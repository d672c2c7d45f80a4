"""Sharding of the port's models over ``torch.distributed`` device meshes:
the reference's logical-axis rules (:mod:`.rules`) and the differentiable
collectives the per-rank model issues (:mod:`.collectives`)."""

from .rules import (PartitionSpec, ShardCtx, local_shape, logical_to_pspec,
                    make_ctx, named, params_pspecs)

__all__ = ["PartitionSpec", "ShardCtx", "local_shape", "logical_to_pspec",
           "make_ctx", "named", "params_pspecs"]
