"""The AfMoE scoring cell on the CPU at a tiny size, through the harness:
a run comes out correct with no dropped pair, a planted capacity (pairs
dropped where the layer keeps a per-expert capacity) does not, and the
float8 control reads far above the program (at the cell's own size, on
the card, above the cell's limit)."""

from __future__ import annotations

import copy
import dataclasses

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import cpu_run

#: Trinity-Mini's shape at a CPU's size: 2 dense then 4 MoE layers, the
#: global (no rope, no window) layer 3 among them, 8 experts top-2 plus
#: one shared, a window of 8
TINY_AFMOE = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16, vocab_size=512,
                  num_hidden_layers=6, num_dense_layers=2, num_experts=8,
                  num_experts_per_tok=2, moe_intermediate_size=32,
                  sliding_window=8, torch_dtype="float32")


def tiny_afmoe_cell() -> harness.Cell:
    cell = copy.deepcopy(harness.load_cell("trinity-mini-score"))
    cell.config.update(TINY_AFMOE)
    cell.config["layer_types"] = cell.config["layer_types"][:6]
    cell.traffic.update(lengths=[16, 24, 32], prompts=12)
    return cell


def test_tiny_cell_is_correct_with_no_dropped_pair():
    _, line = cpu_run(tiny_afmoe_cell())
    assert line["correct"], line["checks"]
    assert line["checks"]["dropped"]["value"] == 0
    assert line["checks"]["route_mismatch"]["value"] == 0
    assert line["checks"]["logit_gap"]["value"] < 1e-4
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"prefill_tok_s", "ttft_p90_ms",
                                    "setup_s"}


def test_float8_control_reads_far_above_the_program():
    from portbench.drivers import score_afmoe

    cell = tiny_afmoe_cell()
    _, line = cpu_run(cell, seed=5)
    out = score_afmoe.control(cell, 5, "cpu")
    assert set(out) == {"logit_gap", "token_gap_ratio", "route_mismatch"}
    # float32 tiny program: ~1e-6; the control's float8 operands: ~0.07
    assert out["logit_gap"] > 100 * line["checks"]["logit_gap"]["value"]
    assert out["token_gap_ratio"] <= 1.0


@pytest.mark.cuda
def test_float8_control_fails_the_limit_at_the_cells_size(cuda):
    import torch

    from portbench.drivers import score_afmoe

    cell = harness.load_cell("trinity-mini-score")
    out = score_afmoe.control(cell, 2**31 + 21, cuda)
    torch.cuda.empty_cache()
    assert any(v > cell.limits[k] for k, v in out.items()), (out,
                                                             cell.limits)


def test_a_capacity_drops_pairs_and_is_not_correct(monkeypatch):
    """The prompt's MoE calls keep a capacity of 1.25 (qwen3-moe's
    schedule) in place of the dropless products."""
    import repro_torch.models.layers as L

    def capped(self, x_flat, wts, ids, capacity, sp=None):
        cfg = dataclasses.replace(self.cfg, capacity_factor=1.25)
        return self._combine_slots(x_flat, wts, ids, L.moe_capacity(
            x_flat.shape[0], cfg), sp)
    monkeypatch.setattr(L.MoE, "combine", capped)
    _, line = cpu_run(tiny_afmoe_cell())
    assert not line["correct"], line["checks"]
    assert line["checks"]["dropped"]["value"] > 0


def test_traced_run_reads_no_device_metric_on_the_cpu():
    _, line = cpu_run(tiny_afmoe_cell(), trace=True)
    assert line["correct"], line["checks"]
    assert line["metrics"]["mfu.trinity"]["value"] > 0
    # spans without device intervals and a trace without kernels: the
    # device metrics read nothing rather than a CPU number
    for metric in ("moe_ms.trinity", "expert_gemm_roofline.trinity",
                   "flash_roofline.trinity", "busy_share.score",
                   "step_gap_ms.score"):
        assert metric not in line["metrics"]


#: (name, parent, device t0, t1) of one traced engine step: two MoE layer
#: calls of one prefill
_SPANS = [
    ("repro.engine.step", None, 0.0, 10.0),
    ("repro.engine.prefill", "repro.engine.step", 0.5, 9.0),
    ("repro.moe.route", "repro.engine.prefill", 1.0, 1.5),
    ("repro.moe.dispatch", "repro.engine.prefill", 1.5, 2.0),
    ("repro.moe.experts", "repro.engine.prefill", 2.0, 4.0),
    ("repro.moe.combine", "repro.engine.prefill", 4.0, 4.5),
    ("repro.moe.shared", "repro.engine.prefill", 4.5, 5.0),
    ("repro.moe.route", "repro.engine.prefill", 5.0, 5.5),
    ("repro.moe.experts", "repro.engine.prefill", 5.5, 7.5),
]


@pytest.mark.parametrize("pairs_ok", [True, False])
def test_span_readers_on_synthetic_spans(monkeypatch, pairs_ok):
    """``moe_ms.trinity`` sums every ``repro.moe.*`` device interval a
    step; ``expert_gemm_roofline.trinity`` divides the calls' bound by the
    ``repro.moe.experts`` intervals, and reads nothing when the program's
    pair counter disagrees with the traced prompts."""
    from repro_torch.obs import spans

    from portbench import yardstick, yardstick_afmoe

    cell = tiny_afmoe_cell()
    cfg = cell.config
    w = spans._Window()
    monkeypatch.setattr(spans, "_window", w)
    sp = spans.Spans(w, False, None, outer=False)
    sids, devices = {}, {}
    for name, parent, d0, d1 in _SPANS:
        w.open[:] = [sids[parent]] if parent else []
        sids[name] = sid = sp.begin(name, d0)
        sp.end(sid, d1)
        devices[sid] = (d0, d1)
    monkeypatch.setattr(spans, "_devices", lambda _w: devices)
    # a 32-token prompt: top-2 pairs in each of the 4 MoE layers
    calls = cfg["num_hidden_layers"] - cfg["num_dense_layers"]
    sp.root = sids["repro.engine.step"]
    sp.count("repro.moe.assignments",
             2 * 32 * calls + (0 if pairs_ok else 1))
    rec = harness.Record(cell, "cuda")
    rec.facts.update(config=cfg, traced_prompts=[32])
    read = {m: harness.load_module("metrics", m).read
            for m in ("moe_ms.trinity", "expert_gemm_roofline.trinity")}
    assert read["moe_ms.trinity"](rec) == pytest.approx(6.5e3)
    bound = calls * yardstick_afmoe.expert_call_bound_s(
        cfg, 64, yardstick.PEAK_BF16_FLOPS, yardstick.HBM_BYTES_PER_S)
    got = read["expert_gemm_roofline.trinity"](rec)
    if pairs_ok:
        assert got == pytest.approx(100.0 * bound / 4.0)
    else:
        assert got is None


def test_prefill_flops_count_the_window_and_the_experts():
    from portbench import yardstick_afmoe

    cfg = harness.load_cell("trinity-mini-score").config
    assert yardstick_afmoe.window_pairs(5, 8) == 15
    assert yardstick_afmoe.window_pairs(10, 4) == 10 + 6 * 4
    # ~6.4 GFLOP a token at 4,096 tokens: 2 x 3.07 B active parameters
    # (the unembedding outside) plus attention
    per_tok = yardstick_afmoe.prefill_flops(cfg, 4096) / 4096
    assert 6.0e9 < per_tok < 7.0e9


def test_a_selection_without_the_bias_is_caught(monkeypatch):
    """The program's routers select the top experts of the scores alone,
    leaving the selection bias out: some rows' selections are more than a
    near tie off the reference's (the tiny cell is float32: its sound runs
    read none; at the cell's size on the card the same fault fails the
    cell's limit, ``tests/test_torch_afmoe_cuda.py``)."""
    import repro_torch.models.layers as L

    route = L.moe_route_sigmoid

    def unbiased(x_flat, router, bias, top_k, scale):
        return route(x_flat, router, torch.zeros_like(bias), top_k, scale)
    monkeypatch.setattr(L, "moe_route_sigmoid", unbiased)
    _, line = cpu_run(tiny_afmoe_cell())
    assert line["checks"]["route_mismatch"]["value"] > 0, line["checks"]
