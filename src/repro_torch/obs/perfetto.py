"""Chrome/Perfetto ``trace_event`` JSON export for :class:`RuntimeTrace`.

Open the exported file in https://ui.perfetto.dev or ``chrome://tracing``:

* one named row (thread) per worker, plus an ``external`` row for events
  emitted off the worker pool (e.g. a send from the caller's thread);
* every span is a complete (``ph: "X"``) slice with ``cat`` = its kind
  (``compute``/``comm``/``panel``/``barrier``/``idle``...), frame resume
  segments named ``task#sN``;
* flow arrows (``ph: "s"``/``"f"``) connect steal victims to thieves and
  channel sends to the frame resume segment they woke;
* frame suspensions are instant markers (``ph: "i"``) labelled with the
  suspended request (``recv(chan)@uid``).

Exact round-trip: Perfetto wants integer-ish microseconds in ``ts``/
``dur``, which does not survive ``*1e6 / 1e6`` float trips — so every
event also carries the raw second-resolution floats in ``args`` and
:func:`load_trace` rebuilds a :class:`RuntimeTrace` equal (``==``) to the
exported one.  ``otherData`` carries the schema tag, counters and the
aggregated metrics, which makes the file self-describing for CI
validation (:func:`validate_trace_json`).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from ..core.tracing import SPAN_KINDS
from .trace import RuntimeTrace

__all__ = ["to_perfetto", "write_trace", "load_trace", "validate_trace_json"]

SCHEMA = "repro.obs/1"
_PID = 0


def _us(t: float) -> float:
    return round(t * 1e6, 3)


def to_perfetto(trace: RuntimeTrace, *,
                extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Serialize a :class:`RuntimeTrace` to a ``trace_event`` JSON object."""
    tev: List[Dict[str, Any]] = []
    rows = list(range(trace.n_workers)) + [-1]
    for w in rows:
        name = f"worker {w}" if w >= 0 else "external"
        tid = w if w >= 0 else trace.n_workers
        tev.append({"ph": "M", "pid": _PID, "tid": tid, "name": "thread_name",
                    "args": {"name": name}})
        tev.append({"ph": "M", "pid": _PID, "tid": tid,
                    "name": "thread_sort_index", "args": {"sort_index": tid}})

    for e in trace.events:
        ev = {"ph": "X", "pid": _PID, "tid": e.worker, "ts": _us(e.t0),
              "dur": _us(e.t1 - e.t0), "name": e.label or e.kind,
              "cat": e.kind, "args": {"t0": e.t0, "t1": e.t1,
                                      "kind": e.kind, "label": e.label}}
        if e.kind == "switch" and e.t0 == e.t1:
            # suspension points read better as instants than 0-dur slices
            ev = {"ph": "i", "s": "t", "pid": _PID, "tid": e.worker,
                  "ts": _us(e.t0), "name": e.label or "suspend",
                  "cat": e.kind, "args": {"t0": e.t0, "t1": e.t1,
                                          "kind": e.kind, "label": e.label}}
        tev.append(ev)

    flow_id = 0
    for (victim, thief, t, label) in trace.steal_flows:
        flow_id += 1
        args = {"victim": victim, "thief": thief, "t": t, "label": label}
        tev.append({"ph": "s", "id": flow_id, "pid": _PID, "tid": victim,
                    "ts": _us(t), "name": "steal", "cat": "steal",
                    "args": args})
        tev.append({"ph": "f", "bp": "e", "id": flow_id, "pid": _PID,
                    "tid": thief, "ts": _us(t), "name": "steal",
                    "cat": "steal", "args": args})
    for (src_w, t0, dst_w, t1, label) in trace.frame_flows:
        flow_id += 1
        src_tid = src_w if src_w >= 0 else trace.n_workers
        args = {"src": src_w, "dst": dst_w, "t0": t0, "t1": t1,
                "label": label}
        tev.append({"ph": "s", "id": flow_id, "pid": _PID, "tid": src_tid,
                    "ts": _us(t0), "name": label or "wake", "cat": "frame",
                    "args": args})
        tev.append({"ph": "f", "bp": "e", "id": flow_id, "pid": _PID,
                    "tid": dst_w, "ts": _us(t1), "name": label or "wake",
                    "cat": "frame", "args": args})

    other: Dict[str, Any] = {
        "schema": SCHEMA,
        "n_workers": trace.n_workers,
        "counters": dict(trace.counters),
        "dropped": trace.dropped,
        "metrics": trace.metrics(),
    }
    if extra:
        other.update(extra)
    return {"traceEvents": tev, "displayTimeUnit": "ms", "otherData": other}


def write_trace(trace: RuntimeTrace, path: str, *,
                extra: Optional[Dict[str, Any]] = None) -> str:
    with open(path, "w") as f:
        json.dump(to_perfetto(trace, extra=extra), f)
    return path


def _as_trace_dict(obj: Any) -> Any:
    """Accept a dict, a JSON string, or a file path (str / PathLike)."""
    if isinstance(obj, os.PathLike):
        obj = os.fspath(obj)
    if isinstance(obj, str):
        if obj.lstrip().startswith("{"):
            return json.loads(obj)
        with open(obj) as f:
            return json.load(f)
    return obj


def load_trace(obj: Any) -> RuntimeTrace:
    """Rebuild a :class:`RuntimeTrace` from exported JSON (a dict, a JSON
    string, or a file path).  Uses the exact raw floats stored in each
    event's ``args``, so ``load_trace(to_perfetto(t)) == t``."""
    obj = _as_trace_dict(obj)
    other = obj.get("otherData", {})
    rt = RuntimeTrace(int(other.get("n_workers", 1)))
    rt.counters = {k: int(v) for k, v in other.get("counters", {}).items()}
    rt.dropped = int(other.get("dropped", 0))
    metrics = other.get("metrics")
    if isinstance(metrics, dict):
        # JSON stringifies the per-worker histograms' int keys
        if isinstance(metrics.get("steal_by_victim"), dict):
            metrics["steal_by_victim"] = {
                int(v): hits for v, hits in metrics["steal_by_victim"].items()}
        if isinstance(metrics.get("frame_resumes_by_worker"), dict):
            metrics["frame_resumes_by_worker"] = {
                int(w): n
                for w, n in metrics["frame_resumes_by_worker"].items()}
        rt._metrics_cache = metrics
    flows: Dict[int, Dict[str, Any]] = {}
    for ev in obj.get("traceEvents", []):
        ph = ev.get("ph")
        args = ev.get("args", {})
        if ph in ("X", "i") and "kind" in args:
            rt.record(int(ev["tid"]), float(args["t0"]), float(args["t1"]),
                      str(args["kind"]), str(args.get("label", "")))
        elif ph == "s":
            flows[ev["id"]] = {"cat": ev.get("cat"), **args}
    for fl in flows.values():
        if fl.get("cat") == "steal":
            rt.steal_flows.append((int(fl["victim"]), int(fl["thief"]),
                                   float(fl["t"]), str(fl.get("label", ""))))
        elif fl.get("cat") == "frame":
            rt.frame_flows.append((int(fl["src"]), float(fl["t0"]),
                                   int(fl["dst"]), float(fl["t1"]),
                                   str(fl.get("label", ""))))
            rt.resume_latencies.append(
                max(0.0, float(fl["t1"]) - float(fl["t0"])))
    rt.events.sort(key=lambda e: (e.t0, e.worker, e.t1))
    return rt


def validate_trace_json(obj: Any) -> Dict[str, Any]:
    """Validate an exported trace against the ``repro_torch.obs/1`` schema.
    Returns a summary dict; raises ``ValueError`` with every violation
    found (used by the CI bench-smoke job on the uploaded artifact)."""
    obj = _as_trace_dict(obj)
    errors: List[str] = []
    if not isinstance(obj, dict):
        raise ValueError(f"trace must be a JSON object, got {type(obj)!r}")
    other = obj.get("otherData")
    if not isinstance(other, dict) or other.get("schema") != SCHEMA:
        errors.append(f"otherData.schema must be {SCHEMA!r}")
    tev = obj.get("traceEvents")
    if not isinstance(tev, list) or not tev:
        raise ValueError("traceEvents must be a non-empty list")
    n_workers = int(other.get("n_workers", 0)) if isinstance(other, dict) else 0
    named_rows = set()
    slices = 0
    opens: Dict[Any, str] = {}
    closes: Dict[Any, str] = {}
    for i, ev in enumerate(tev):
        ph = ev.get("ph")
        if ph is None:
            errors.append(f"traceEvents[{i}]: missing ph")
            continue
        if ph == "M":
            if ev.get("name") == "thread_name":
                named_rows.add(ev.get("tid"))
            continue
        if "tid" not in ev or "ts" not in ev:
            errors.append(f"traceEvents[{i}] (ph={ph}): missing tid/ts")
            continue
        if ph == "X":
            slices += 1
            if "dur" not in ev or "name" not in ev:
                errors.append(f"traceEvents[{i}]: X slice needs dur+name")
            if ev.get("cat") not in SPAN_KINDS:
                errors.append(
                    f"traceEvents[{i}]: unknown slice kind {ev.get('cat')!r}")
        elif ph == "s":
            opens[ev.get("id")] = ev.get("cat")
        elif ph == "f":
            closes[ev.get("id")] = ev.get("cat")
    for fid, cat in opens.items():
        if fid not in closes:
            errors.append(f"flow {fid} ({cat}): start without finish")
    for fid, cat in closes.items():
        if fid not in opens:
            errors.append(f"flow {fid} ({cat}): finish without start")
    missing = [w for w in range(n_workers) if w not in named_rows]
    if missing:
        errors.append(f"workers without a named row: {missing}")
    if slices == 0:
        errors.append("no X slices (empty trace?)")
    if errors:
        raise ValueError("invalid trace JSON:\n  " + "\n  ".join(errors))
    return {
        "schema": SCHEMA,
        "n_workers": n_workers,
        "slices": slices,
        "flows": len(opens),
        "rows": len(named_rows),
        "counters": dict(other.get("counters", {})),
    }
