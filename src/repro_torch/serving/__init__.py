"""Request-level continuous-batching serving layer (the port of the
reference's ``repro/serving``; ``python -m repro_torch.serving.serve_lm``
is the port of ``examples/serve_lm.py``).

A fixed batch decodes in lockstep —
every request started together, padded to the slowest finisher.  Real
traffic is a *stream*: requests arrive at random times, want different
numbers of tokens, and leave as soon as they are done.  This package serves
that stream on the primitives the runtime already has:

* :class:`~repro_torch.serving.workload.PoissonWorkload` — a seeded,
  deterministic open-loop arrival process (Poisson inter-arrivals, ragged
  per-request token budgets);
* :class:`~repro_torch.serving.engine.ContinuousBatchingEngine` — a
  bounded :class:`~repro_torch.core.taskgraph.Channel` admission queue
  (backpressure for free: a full queue refuses/blocks submitters), per-step
  dynamic batch composition from the in-flight set, per-request early exit
  on EOS / max-token budget, and per-batch-shape decode-step graphs served
  through a :class:`~repro_torch.api.session.Session` — with
  ``scheduler="pool"`` most steps replay a warm recording, and with
  ``procs=N`` the stream shards by request id across worker processes;
* :class:`~repro_torch.serving.metrics.ServingReport` — per-request
  lifecycle records rolled up into p50/p99 per-token latency,
  time-to-first-token and sustained tok/s.
"""

from .engine import AdmissionFull, ContinuousBatchingEngine
from .metrics import RequestRecord, ServingReport
from .request import Request, RequestState
from .workload import PoissonWorkload

__all__ = [
    "AdmissionFull",
    "ContinuousBatchingEngine",
    "PoissonWorkload",
    "Request",
    "RequestRecord",
    "RequestState",
    "ServingReport",
]
