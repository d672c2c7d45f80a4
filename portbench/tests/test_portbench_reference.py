"""The plain references agree with the port at tiny sizes on the CPU, and
a whole run of each cell kind comes out correct there."""

from __future__ import annotations

import pytest
import torch

from portbench import generate
from portbench.drivers import lm_common, train
from portbench.reference import cholesky, qwen3
from portbench.tests.conftest import TINY_LM, cpu_run, tiny_cell

F32 = dict(TINY_LM, name="tiny", model_type="qwen3", rope_theta=1e6,
           rms_norm_eps=1e-6, tie_word_embeddings=False,
           torch_dtype="float32")


def test_cholesky_reference_matches_the_ports_factor():
    from repro_torch.linalg import (build_cholesky_graph, cholesky_extract,
                                    to_tiles)
    from repro_torch import Session

    a = generate.spd_pool(192, 1, 3, torch.float64, "cpu")[0]
    store = to_tiles(a, 48, device="cpu")
    with Session(2) as s:
        s.run(build_cholesky_graph(4, 48, store=store))
    assert cholesky.factor_error(cholesky_extract(store), a) < 1e-13


def test_qwen3_reference_loss_matches_the_ports():
    from repro_torch.models.lm import loss_fn

    W = generate.DenseWeights(F32, 5, "cpu", torch.float32)
    pcfg, model = lm_common.program_model(F32, W, "cpu")
    b = generate.lm_batches(500, 24, 2, 1, 5, "cpu")[0]
    port = float(loss_fn(model, pcfg, {"tokens": b[:, :-1],
                                       "labels": b[:, 1:]}, remat=False))
    p = {n: W.leaf(n).float() for n in generate.dense_leaf_names(F32)}
    with torch.no_grad():
        ref = float(qwen3.Model(F32).loss(p, b[:, :-1], b[:, 1:]))
    assert abs(port - ref) <= 1e-5 * abs(ref)


def test_qwen3_reference_last_logits_match_the_ports_prefill():
    from repro_torch.models.lm import prefill

    W = generate.DenseWeights(F32, 6, "cpu", torch.float32)
    pcfg, model = lm_common.program_model(F32, W, "cpu")
    prompts = generate.prompts([9, 20], 500, 6, "cpu")
    hs = qwen3.final_hidden(F32, 6, prompts, "cpu")
    for p, h in zip(prompts, hs):
        _, logits = prefill(model, pcfg, {"tokens": p})
        ref = h[-1] @ W.unembed()
        assert torch.allclose(logits[0, -1], ref, rtol=1e-4, atol=1e-4)


def test_qwen3_reference_train_steps_match_the_ports():
    """The port's first steps against the reference's readings, float32."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import StepConfig, make_train_step

    opt = tiny_cell("qwen3-14b-train").traffic["optimizer"]
    W = generate.DenseWeights(F32, 8, "cpu", torch.float32)
    pcfg, model = lm_common.program_model(F32, W, "cpu")
    state = adamw_init(model)
    step = make_train_step(pcfg, AdamWConfig(**opt), None,
                           StepConfig(microbatches=2, overlap="hybrid"))
    batches = generate.lm_batches(500, 16, 4, 3, 8, "cpu")
    prog = {"loss": []}
    for s in range(3):
        model, state, met = step(model, state,
                                 {"tokens": batches[s, :, :-1],
                                  "labels": batches[s, :, 1:]})
        prog["loss"].append(float(met["loss"]))
        if s == 0:
            prog["grad1"] = {n: float(state["m"][n].norm()) / (1 - opt["b1"])
                             for n, _ in model.named_parameters()}
    prog["change"] = {n: float((p.detach() - W.leaf(n)).norm())
                      for n, p in model.named_parameters()}
    ref = qwen3.train_readings(F32, opt, batches, 8, "cpu")
    for a, b in zip(prog["loss"], ref["loss"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    gaps = train.compare(prog, ref)
    assert gaps["loss1_gap"] < 1e-5 and gaps["grad1_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-3


@pytest.mark.parametrize("cell", ["chol-n7680-compiled", "qwen3-14b-train",
                                  "qwen3-14b-score",
                                  "qwen3-14b-train-s4096"])
def test_a_tiny_run_of_each_cell_is_correct(cell):
    run, line = cpu_run(tiny_cell(cell))
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"]
