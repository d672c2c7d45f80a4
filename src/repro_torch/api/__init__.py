"""API v2: futures-based graph construction, sessions, plans, run reports.

The user-facing layer over the paper's scheduling extensions:

* :class:`Graph` / :class:`TaskHandle` — dataflow construction: ``add``
  returns a future whose value can be passed as an argument to downstream
  tasks (dependencies inferred, composing with explicit ``deps=``);
* :class:`Session` — owns scheduler selection (``dynamic`` / ``replay`` /
  ``pool``), validates the victim policy up front, and leases warm worker
  cores from the process-global registry;
* :class:`Plan` — ``session.plan(graph)``: the warm/record/replay/remap
  decision as inspectable data;
* :class:`RunReport` — results (``report[handle]``), the recording,
  steal/fallback/suspension statistics and wall clock (host enqueue time
  on a CUDA device).

Everything here is re-exported at the package top level (``import
repro_torch; repro_torch.Session``).
"""

from .graph import Graph, TaskHandle
from .session import Plan, PlanError, RunReport, Session

__all__ = [
    "Graph",
    "Plan",
    "PlanError",
    "RunReport",
    "Session",
    "TaskHandle",
]
