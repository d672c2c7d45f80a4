"""With the timed path broken underneath, a run comes out not correct: one
test for each fault a cell can have (a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced), on the CPU at a tiny size.  The harness's look for a chip is
skipped; the rest of the run is the benchmark's own."""

from __future__ import annotations

import pytest
import torch

from portbench.tests.conftest import cpu_run, tiny_cell


def _identity_tile(*args):
    return args[0].clone()


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_factor_fault_is_not_correct(monkeypatch, fault):
    import repro_torch.linalg.cholesky as chol

    if fault == "unchanged":
        for name in ("tile_potrf", "tile_trsm_right_lower_t",
                     "tile_gemm_sub"):
            monkeypatch.setattr(chol, name, _identity_tile)
    else:
        real = chol.tile_potrf
        monkeypatch.setattr(chol, "tile_potrf",
                            lambda a: real(a) * (1 + 1e-9))
    _, line = cpu_run(tiny_cell("chol-n7680-compiled"))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_fault_is_not_correct(monkeypatch, fault):
    import repro_torch.train.steps as steps

    if fault == "unchanged":
        monkeypatch.setattr(steps, "adamw_update",
                            lambda cfg, p, g, s, *a: (p, s, {
                                "lr": torch.zeros(()),
                                "grad_norm": torch.zeros(())}))
    else:
        real = steps._on_device

        def half(batch, device):
            out = real(batch, device)
            return {k: v[: v.shape[0] // 2] for k, v in out.items()}
        monkeypatch.setattr(steps, "_on_device", half)
    _, line = cpu_run(tiny_cell("qwen3-14b-train"))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "altered", "logits"])
def test_score_fault_is_not_correct(monkeypatch, fault):
    if fault == "unchanged":
        import repro_torch.models.layers as layers

        real = layers.Block.forward

        def skip(self, x, **kw):
            _, kv = real(self, x, **kw)
            return x, kv
        monkeypatch.setattr(layers.Block, "forward", skip)
    elif fault == "altered":
        import repro_torch.models.serving as serving

        real = serving.greedy_sample
        monkeypatch.setattr(serving, "greedy_sample",
                            lambda logits: (real(logits) + 1) % 512)
    else:
        # the scores altered where they are produced, the greedy pick kept
        import repro_torch.models.lm as lm

        real = lm.prefill

        def scaled(*args, **kw):
            cache, logits = real(*args, **kw)
            return cache, logits * 1.2
        monkeypatch.setattr(lm, "prefill", scaled)
    _, line = cpu_run(tiny_cell("qwen3-14b-score"))
    assert not line["correct"], line["checks"]
