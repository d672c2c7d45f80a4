"""Checkpoints: the async tensor-tree :class:`Checkpointer` and the
resource-guarded checkpoint-writer tasks."""

from .checkpointer import Checkpointer
from .tasks import (
    CheckpointSink,
    TornWriteError,
    add_checkpoint_tasks,
    checkpoint_resource,
)

__all__ = ["Checkpointer", "CheckpointSink", "TornWriteError",
           "add_checkpoint_tasks", "checkpoint_resource"]
