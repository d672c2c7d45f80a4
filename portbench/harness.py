"""One run of one cell: find its files, drive it, trace it, judge it and
print the result line.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<mix>.json``);
the mix names its driver (``drivers/<driver>.py``), which loads the
program, warms it up, measures for ``--seconds``, and checks what the timed
path produced against the plain reference (``reference/``).  The metrics a
cell reports are those ``BENCHMARK.json`` lists for it: the driver takes
the end-to-end ones itself on the host's clock, and each per-layer metric
is read by ``metrics/<metric>.py`` from the run's :class:`Record` (the
program's counters, what the driver measured, and the device trace, whose
idle gaps are named by the benchmark's own spans around its calls into the
program).  Adding a cell, a mix, a configuration or a
per-layer metric adds files and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may never be loaded in a run: JAX and the
#: reference package the port was made from (compared whole: the port's
#: own ``repro_torch`` is not ``repro``)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: the benchmark's spans around its calls into the program; the traced
#: run's idle gaps are named by the innermost one around them
SPAN_NAMES = ("factor", "train.step", "adamw", "flash.pair", "prefill",
              "engine.step")


def load_json(kind: str, name: str) -> Dict[str, Any]:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec() -> Dict[str, Any]:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def metrics_for(spec: Dict[str, Any], section: str,
                cell: str) -> List[Dict[str, Any]]:
    """The entries of ``spec[section]`` that ``cell`` reports: those that
    list it under ``workloads``, and those that list no cells."""
    return [m for m in spec[section]
            if "workloads" not in m or cell in m["workloads"]]


@dataclasses.dataclass
class Cell:
    """A cell's files: its configuration and mix, and the limit of each
    number its run compares (set from the readings PERF.md gives)."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def load_cell(name: str) -> Cell:
    w = load_json("workloads", name)
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"],
                chips=int(w["chips"]), config=load_json("configs", w["config"]),
                traffic=load_json("traffic", w["traffic"]),
                limits={k: float(v) for k, v in w["limits"].items()})


# ---------------------------------------------------------------------------
# what a run records
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DeviceTrace:
    """The profiled part of a run, reduced: device seconds by kernel name
    (with launch counts), the seconds in which any device operation ran,
    the traced window's length, and the idle gaps by the benchmark span
    the host was in."""

    kernels: Dict[str, Tuple[float, int]]
    busy_s: float
    window_s: float
    idle_by_span: Dict[str, float]

    def device_s(self, contains: str) -> Tuple[float, int]:
        """Summed seconds and launches of the kernels whose name contains
        ``contains``."""
        s, n = 0.0, 0
        for k, (sec, cnt) in self.kernels.items():
            if contains in k:
                s += sec
                n += cnt
        return s, n


class Record:
    """Everything a run observed, for the per-layer readers: the program's
    counters (lists of per-call readings), facts the driver measured or
    computed from shapes, and the device trace of the profiled part
    (``--trace 1`` only)."""

    def __init__(self, cell: Cell, device: str):
        self.cell = cell
        self.device_type = device
        self.counters: Dict[str, List[float]] = {}
        self.facts: Dict[str, Any] = {}
        self.trace: Optional[DeviceTrace] = None

    def count(self, name: str, value: float) -> None:
        self.counters.setdefault(name, []).append(float(value))


def annotate(name: str):
    """A span the profiler sees (``record_function``) around a call into
    the program, so the trace's idle gaps can be named by it."""
    import torch
    return torch.profiler.record_function(name)


def sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def profile(rec: Record, body: Callable[[], None]) -> DeviceTrace:
    """Run ``body`` under ``torch.profiler`` and reduce its trace: kernels,
    copies and sets on the device by name, their union's seconds, the
    traced window, and each idle gap of the device charged to the
    innermost benchmark span open on the host at its middle."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if rec.device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(rec.device_type)
    with torch.profiler.profile(activities=acts) as prof:
        with annotate("portbench.traced"):
            body()
            sync(rec.device_type)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_trace(events)


def reduce_trace(events: List[Dict[str, Any]]) -> DeviceTrace:
    """:func:`profile`'s reduction of a Chrome trace's events."""
    window = None
    spans: List[Tuple[float, float, str]] = []
    ops: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        t0, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation":
            if e["name"] == "portbench.traced":
                window = (t0, t0 + dur)
            elif e["name"] in SPAN_NAMES:
                spans.append((t0, t0 + dur, e["name"]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            ops.append((t0, t0 + dur, e["name"]))
    if window is None:
        raise RuntimeError("the trace holds no portbench.traced span")
    lo, hi = window
    kernels: Dict[str, Tuple[float, int]] = {}
    for t0, t1, name in ops:
        s, n = kernels.get(name, (0.0, 0))
        kernels[name] = (s + (t1 - t0) * 1e-6, n + 1)
    # the union of the device's operations, clipped to the window
    busy = 0.0
    gaps: List[Tuple[float, float]] = []
    cur = lo
    for t0, t1, _ in sorted(ops):
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 <= cur:
            continue
        if t0 > cur:
            gaps.append((cur, t0))
            cur = t0
        busy += t1 - cur
        cur = t1
    if cur < hi:
        gaps.append((cur, hi))
    spans.sort(key=lambda s: s[1] - s[0])       # innermost first
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        who = next((n for s0, s1, n in spans if s0 <= mid <= s1), "host")
        idle[who] = idle.get(who, 0.0) + (g1 - g0) * 1e-6
    return DeviceTrace(kernels=kernels, busy_s=busy * 1e-6,
                       window_s=(hi - lo) * 1e-6, idle_by_span=idle)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------
class Run:
    """What a driver is given and fills in.  The driver loads the program
    and warms it up, calls :meth:`window_opens`, measures for
    :attr:`seconds`, calls :meth:`window_closes`, sets the end-to-end
    metrics, and judges the timed path's output with :meth:`check`."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = t_start
        self.rec = Record(cell, device)
        self.e2e: Dict[str, float] = {}
        self.checks: List[Tuple[str, float, float]] = []
        self.attempted = 0
        self.failed = 0
        self.setup_s: Optional[float] = None
        self.memory_peak_bytes = 0
        self.window_peak_bytes = 0

    @property
    def config(self) -> Dict[str, Any]:
        return self.cell.config

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.cell.traffic

    def window_opens(self) -> float:
        """Wait for the device; keep set-up's memory peak and start the
        window's."""
        sync(self.device)
        if self.device == "cuda":
            import torch
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        self.setup_s = t - self.t_start
        return t

    def window_closes(self) -> float:
        """Wait for the device, then read the memory peaks (the window's,
        and the process's so far): the reference, which runs later, may
        not set them."""
        sync(self.device)
        t = time.perf_counter()
        if self.device == "cuda":
            import torch
            self.window_peak_bytes = int(torch.cuda.max_memory_allocated())
            self.memory_peak_bytes = max(self.memory_peak_bytes,
                                         self.window_peak_bytes)
        return t

    def check(self, name: str, value: float) -> None:
        """A number compared: it passes when it is at most the cell's
        limit of that name."""
        self.checks.append((name, float(value),
                            self.cell.limits[name]))

    @property
    def correct(self) -> bool:
        return (bool(self.checks) and self.failed == 0
                and all(math.isfinite(v) and v <= lim
                        for _, v, lim in self.checks))


def forbidden_loaded() -> List[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def execute(cell: Cell, *, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: Optional[float] = None,
            spec: Optional[Dict[str, Any]] = None) -> Tuple[Run, Dict]:
    """Drive ``cell`` once and build its result line (a dict); ``spec`` is
    ``BENCHMARK.json`` (read from the checkout when None)."""
    run = Run(cell, seed, seconds, trace, device,
              time.perf_counter() if t_start is None else t_start)
    driver = load_module("drivers", cell.driver)
    driver.run(run)
    return run, result_line(run, spec if spec is not None
                            else benchmark_spec())


def result_line(run: Run, spec: Dict[str, Any]) -> Dict[str, Any]:
    cell = run.cell.name
    metrics: Dict[str, Dict[str, Any]] = {}
    values = dict(run.e2e)
    values["setup_s"] = run.setup_s
    if not run.trace:
        for m in metrics_for(spec, "end_to_end", cell):
            if values.get(m["name"]) is None:
                raise RuntimeError(f"cell {cell} took no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in metrics_for(spec, "per_layer", cell):
            v = load_module("metrics", m["name"]).read(run.rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device: Dict[str, Any] = {"platform": "gpu" if run.device == "cuda"
                              else run.device,
                              "kind": device_kind(run.device),
                              "count": run.cell.chips,
                              "memory_peak_bytes": run.memory_peak_bytes}
    line: Dict[str, Any] = {"correct": run.correct,
                            "attempted": run.attempted,
                            "failed": run.failed, "metrics": metrics,
                            "device": device}
    tr = run.rec.trace
    if run.trace and tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        top = sorted(tr.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(tr.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[k[:64], v[0]] for k, v in top],
                             "idle_gaps": [[k, v] for k, v in gaps]}
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in run.checks}
    return line


def device_kind(device: str) -> str:
    if device == "cuda":
        import torch
        return torch.cuda.get_device_name(0)
    return device
