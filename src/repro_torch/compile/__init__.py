"""Compiled execution plans.  Only the fusion metadata
(:class:`FuseSpec`) is ported so far; the builders attach it to their
tasks.  Lowering recordings into fused plans arrives with the compiled
scheduler."""

from .fuse import FuseSpec, fuse_spec_of

__all__ = ["FuseSpec", "fuse_spec_of"]
