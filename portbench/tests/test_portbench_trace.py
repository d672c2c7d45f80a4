"""The trace reduction: busy time is the union of the device's operations
inside the traced window, and each idle gap goes to the innermost
benchmark span open at its middle."""

from __future__ import annotations

import pytest

from portbench import harness


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_reduce_trace_unions_ops_and_names_gaps():
    events = [
        _x("portbench.traced", "user_annotation", 0, 100),
        _x("train.step", "user_annotation", 0, 60),
        _x("adamw", "user_annotation", 60, 40),
        _x("k1", "kernel", 10, 20),            # 10-30
        _x("k2", "kernel", 20, 20),            # 20-40, overlaps k1
        _x("copy", "gpu_memcpy", 70, 10),      # 70-80
        _x("late", "kernel", 95, 20),          # clipped at 100
        _x("aten::mm", "cpu_op", 0, 5),
    ]
    tr = harness.reduce_trace(events)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx((30 + 10 + 5) * 1e-6)
    assert tr.kernels["k1"] == (pytest.approx(20e-6), 1)
    # gaps: 0-10 and 40-70 (its middle, 55, in train.step) under
    # train.step (40 us); 80-95 under adamw (15 us)
    assert tr.idle_by_span["train.step"] == pytest.approx(40e-6)
    assert tr.idle_by_span["adamw"] == pytest.approx(15e-6)
    assert tr.device_s("k") == (pytest.approx(40e-6), 2)


def test_reduce_trace_needs_the_window():
    with pytest.raises(RuntimeError):
        harness.reduce_trace([_x("k", "kernel", 0, 1)])


def test_percentile_is_over_all_values():
    from portbench import yardstick

    assert yardstick.percentile(list(range(11)), 90) == pytest.approx(9.0)
    with pytest.raises(ValueError):
        yardstick.percentile([], 50)
