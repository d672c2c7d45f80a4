"""Core: the paper's task-graph scheduling extensions (PyTorch port).

Public API:

* :class:`TaskGraph` / :class:`Task` / :class:`ParallelSpec` — task graphs
  with nested data-parallel regions.
* :class:`Channel` / :class:`TaskEvent` / :class:`TaskFrame` — blocking
  communication primitives and suspendable task frames.
* :class:`Runtime` / :func:`run_graph` — the threaded gang-scheduling +
  work-stealing runtime (Algorithms 1 & 2).
* :class:`Simulator` / :func:`simulate` — deterministic discrete-event
  simulator of the same scheduler.
* :class:`ListScheduler` / :class:`StaticSchedule` — frozen schedules
  (wave decomposition, collective total order) that seed replay
  recordings.
* victim policies: ``history`` / ``random`` / ``hybrid`` (Algorithm 2).
"""

from .gang import GangState, is_eligible_to_sched
from .policies import (
    HistoryPolicy,
    HybridPolicy,
    PolicyError,
    RandomPolicy,
    available_policies,
    make_policy,
    register_policy,
    resolve_policy,
)
from .runtime import Runtime, run_graph
from .simulator import DeadlockError, Simulator, simulate
from .static_schedule import (
    GangReservation,
    ListScheduler,
    StaticSchedule,
    issue_offsets_from_schedule,
    microbatch_overlap_graph,
)
from .taskgraph import (
    Channel,
    ChannelEmpty,
    ChannelFull,
    FrameResume,
    ParallelSpec,
    Task,
    TaskContext,
    TaskEvent,
    TaskFrame,
    TaskGraph,
    WaitAnyRequest,
)
from .tracing import Trace

__all__ = [
    "Channel",
    "ChannelEmpty",
    "ChannelFull",
    "DeadlockError",
    "FrameResume",
    "GangReservation",
    "GangState",
    "HistoryPolicy",
    "HybridPolicy",
    "ListScheduler",
    "ParallelSpec",
    "PolicyError",
    "RandomPolicy",
    "Runtime",
    "Simulator",
    "StaticSchedule",
    "Task",
    "TaskContext",
    "TaskEvent",
    "TaskFrame",
    "TaskGraph",
    "Trace",
    "WaitAnyRequest",
    "available_policies",
    "is_eligible_to_sched",
    "issue_offsets_from_schedule",
    "make_policy",
    "microbatch_overlap_graph",
    "register_policy",
    "resolve_policy",
    "run_graph",
    "simulate",
]
