"""Observability: the runtime flight recorder's per-worker event rings
(:mod:`repro_torch.obs.recorder`).  Trace assembly and Perfetto export
arrive with ``trace=True`` support."""

from .recorder import NULL_RECORDER, FlightRecorder, NullRecorder, live_recorders

__all__ = ["FlightRecorder", "NullRecorder", "NULL_RECORDER", "live_recorders"]
