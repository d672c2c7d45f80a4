"""Observability for the live executor stack (the runtime flight recorder).

* :mod:`repro_torch.obs.recorder` — per-worker lock-free ring buffers of
  timestamped point events, with a module-level no-op emitter so tracing
  costs one attribute call when off;
* :mod:`repro_torch.obs.trace` — assembles recorded events into a
  :class:`RuntimeTrace` sharing the simulator's ``Event``/kind schema
  (``breakdown()`` / ``utilization()`` work on both), plus multi-run
  metrics (steal success, resume latency, idle fractions, fallback rate);
* :mod:`repro_torch.obs.spans` — spans inside the program's top-level
  calls (the compiled driver, the train step, flash, the serving engine),
  on while a torch profiler runs or a session traces, on the profiler's
  clock and with their device intervals; :func:`span_trace` reads them;
* :mod:`repro_torch.obs.perfetto` — Chrome/Perfetto ``trace_event`` JSON export
  (one row per worker, flow arrows for steals and channel sends→recvs,
  frame segments as slices) and the matching loader/validator;
* ``python -m repro_torch.obs.export`` — CLI: demo traces, re-export, validation.
"""

from .recorder import NULL_RECORDER, FlightRecorder, NullRecorder, live_recorders
from .trace import RuntimeTrace, assemble
from .perfetto import (load_trace, to_perfetto, validate_trace_json,
                       write_trace)
from .spans import span_trace

__all__ = [
    "FlightRecorder", "NullRecorder", "NULL_RECORDER", "live_recorders",
    "RuntimeTrace", "assemble",
    "to_perfetto", "write_trace", "load_trace", "validate_trace_json",
    "span_trace",
]
