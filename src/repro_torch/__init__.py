"""Task-graph scheduling extensions — the PyTorch/CUDA port.

Same API v2 surface as the reference package, on PyTorch tensors and a
CUDA device::

    import repro_torch

    g = repro_torch.Graph("pipeline")
    a = g.add(lambda: 2, name="a")
    b = g.add(lambda x: x * 21, a, name="b")      # dep inferred from `a`
    with repro_torch.Session(workers=2) as s:
        report = s.run(g)
    assert report[b] == 42

Tensor-making entry points (:mod:`repro_torch.linalg`, ``models``,
``train``, ``checkpoint``) default to the CUDA device and raise when there
is none; pass ``device="cpu"`` to run on the host.  Beside the
factorizations and serving, the port trains: :mod:`repro_torch.optim`
(AdamW), :mod:`repro_torch.data` (the synthetic stream),
:mod:`repro_torch.checkpoint` and :mod:`repro_torch.train` (train steps
and the fault-tolerant trainer).  ``import repro_torch`` pulls in no
torch; the kernels, linalg, models and training subpackages do.
"""

from .api import Graph, Plan, PlanError, RunReport, Session, TaskHandle
from .core import (
    Channel,
    ChannelEmpty,
    ChannelFull,
    DeadlockError,
    ParallelSpec,
    Runtime,
    Task,
    TaskContext,
    TaskEvent,
    TaskGraph,
    run_graph,
)
from .core.policies import PolicyError, available_policies, register_policy

__all__ = [
    "Channel",
    "ChannelEmpty",
    "ChannelFull",
    "DeadlockError",
    "Graph",
    "ParallelSpec",
    "Plan",
    "PlanError",
    "PolicyError",
    "Runtime",
    "RunReport",
    "Session",
    "Task",
    "TaskContext",
    "TaskEvent",
    "TaskGraph",
    "TaskHandle",
    "available_policies",
    "register_policy",
    "run_graph",
]
