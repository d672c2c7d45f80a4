"""The controls: the plain reference one precision below the
configuration's, put where the program's output would be, comes out not
correct.  On the card the cells' own sizes (``cuda``); the factorization's
control on the CPU at a tiny size too."""

from __future__ import annotations

import pytest
import torch

from portbench import controls, harness
from portbench.tests.conftest import cpu_run, tiny_cell


def test_factor_control_fails_its_limit_on_the_cpu():
    cell = tiny_cell("chol-n7680-compiled")
    out = controls.factor_control(cell, 5, "cpu")
    assert out["factor_err"] > cell.limits["factor_err"]


def test_train_control_and_faults_run_on_the_cpu():
    cell = tiny_cell("qwen3-14b-train")
    out = controls.train_control(cell, 5, "cpu")
    assert set(out) == {"control", "half_batch", "frozen"}
    assert out["frozen"]["change_gap"] > cell.limits["change_gap"]
    assert all(v >= 0 for v in out["control"].values())


def test_score_control_reads_far_above_the_program_on_the_cpu():
    cell = tiny_cell("qwen3-14b-score")
    _, line = cpu_run(cell, seed=5)
    out = controls.score_control(cell, 5, "cpu")
    assert set(out) == set(line["checks"])
    assert out["logit_gap"] > 3 * line["checks"]["logit_gap"]["value"]
    assert out["token_gap_ratio"] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["chol-n7680-compiled", "qwen3-14b-train",
                                  "qwen3-14b-score"])
def test_control_fails_at_the_cells_size(cuda, cell):
    c = harness.load_cell(cell)
    out = controls.CONTROLS[c.driver](c, 2**31 + 21, cuda)
    torch.cuda.empty_cache()
    if c.driver == "train":
        out = out["control"]
    assert any(v > c.limits[k] for k, v in out.items()), (out, c.limits)
