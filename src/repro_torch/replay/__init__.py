"""Record-and-replay subsystem: graph cache + low-contention replay executor.

The repo's flagship workloads — tiled Cholesky/LU/QR sweeps, training steps,
repeated serving requests — execute the same task-graph *shape* over and
over, yet the dynamic runtime re-makes every scheduling decision (indegree
bookkeeping, victim selection, gang-worker reservation) on every run.  This
package records a graph's execution once and replays it with preallocated,
contention-free structures (the Taskgraph/QuickSched record-and-replay
idea):

* :func:`graph_key` / :class:`GraphKey` — canonical structural hash of a
  :class:`~repro_torch.core.taskgraph.TaskGraph` (topology, kinds, costs,
  priorities, parallel specs — **not** callables), so rebuilds of the same
  shape over fresh data share one identity;
* :class:`GraphCache` — recordings keyed on ``(GraphKey, n_workers,
  policy)`` with optional on-disk persistence;
* :class:`Recording` — per-worker execution order, steal decisions, gang
  placements and gang-id issue order, captured from an instrumented dynamic
  run (``Runtime.run(graph, record=True)``) or seeded from a frozen
  :class:`~repro_torch.core.static_schedule.StaticSchedule`
  (:meth:`Recording.from_static_schedule`);
* :class:`ReplayExecutor` — re-executes the graph from the recording with
  preallocated per-worker run lists, per-task dependency counters under
  per-task locks, and recorded gang placements: no victim selection, no
  ``GET_WORKERS`` scan, near-zero fork-lock work.  A facade over the
  unified executor core (:mod:`repro_torch.exec`) — pass ``core=`` to lease warm
  workers shared with other executors;
* :class:`ReplayPool` — persistent per-``(GraphKey, n_workers, policy)``
  leases over one shared worker core per worker count — leased from the
  process-global :class:`~repro_torch.exec.registry.CoreRegistry` by default, so
  several pools in one process share threads — for steady-state serving
  loops: adaptive re-recording on sustained plan deviation or wall-clock
  regression (``latency_drift_factor``), LRU shape eviction
  (``max_shapes``), and worker-count remapping (:func:`remap_recording`)
  of recordings shipped at a different worker count.

The record/replay contract
--------------------------

A recording drives any graph whose :func:`graph_key` digest matches the one
it was recorded for (enforced by :meth:`Recording.validate_against`; opt out
with ``check_digest=False`` for deliberately perturbed graphs, where the
executor still requires a 1:1 task-id cover).  Replay preserves execution
*semantics*, not timing: task results are bit-identical to a dynamic run
because the dependency edges — not the recorded interleaving — gate every
task, and tile-store writes are ordered by those same edges.

Suspendable frames replay deterministically: a recorded run stores every
frame suspension as a :class:`~repro_torch.core.taskgraph.FrameResume` run-list
entry (recording forces a suspension at each ``yield``), and replay
re-suspends at the same points — reproducing the recorded frame
interleaving bit-identically, with per-segment claims keeping fallback
helpers single-shot.  Worker-count remapping keeps a frame's resume entries
adjacent to its start entry on one list.

Deviation limits: when real costs drift from the recorded ones, a worker
whose next recorded entry is not ready within ``stall_timeout`` falls back
to dynamic stealing of ready-but-unclaimed work, so a stale recording
degrades toward dynamic-scheduling performance instead of stalling — but a
recording for a *different structure* (changed nb/b/panel_threads) is
rejected, and region-forking tasks are never stolen from their recorded
spawner.  Recordings key parallel regions by their spawning task, so a task
may fork at most one region per execution (recording and replay both refuse
a second fork loudly).  Gang invariants survive replay: blocking regions run on the
recorded distinct workers and forks are published in recorded (monotonic
gang-id) issue order.
"""

from .cache import GraphCache, cache_key
from .executor import ReplayError, ReplayExecutor, replay_graph
from .graph_key import GraphKey, graph_key
from .pool import PoolEntryStats, PoolRun, ReplayPool
from .recording import GangPlacement, Recording, RecordingError
from .remap import RemapError, remap_recording

__all__ = [
    "GangPlacement",
    "GraphCache",
    "GraphKey",
    "PoolEntryStats",
    "PoolRun",
    "Recording",
    "RecordingError",
    "RemapError",
    "ReplayError",
    "ReplayExecutor",
    "ReplayPool",
    "cache_key",
    "graph_key",
    "remap_recording",
    "replay_graph",
]
