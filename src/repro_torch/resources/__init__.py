"""Declarative resources & conflict-aware scheduling (ROADMAP item 3).

QuickSched-style scheduling with dependencies *and conflicts*: a task may
declare resources it ``uses`` (exclusively) or ``uses_shared`` (reader
mode) with no ordering edge to the other users.  The
:class:`ResourceArbiter` grants every task's full resource set atomically
at dispatch time — a task never holds one resource while waiting for
another, so conflict scheduling can never deadlock — and defers contended
tasks on a FIFO-fair wait list instead of parking the worker.
"""

from .arbiter import ResourceArbiter, grants_by_resource
from .handle import Resource

__all__ = ["Resource", "ResourceArbiter", "grants_by_resource"]
