"""The port's MoE against the reference package's, on the same inputs.

``layers.MoE`` computes the reference's single-device ``layers.moe``: the
router in the model's dtype cast to float32, softmax, top-k renormalised
with a 1e-9 floor, each expert keeping the first ``C`` tokens routed to it
in token order (``C = max(1, int(T * top_k * capacity_factor / E))``) and
dropping the rest, the float32 outputs summed in ascending expert id.  The
port runs it as batched products (over every expert's capacity slots for a
prompt, over the routed pairs for a decode step); ``moe_loop_ref`` is the
reference's loop over every expert, literally, and the two are held
against each other and against the reference.

Everything runs in float32 on the CPU from numpy inputs.  XLA and PyTorch
sum the same products in different orders: ``rtol = atol = 1e-4``, the
model tests' tolerance (``tests/test_torch_models.py``).  The reduced
qwen3-moe keeps 8 experts, top-2 and ``capacity_factor`` 1.25, so 16
tokens give ``C = 5``; the inputs are drawn so that an expert is routed
more than 5 tokens, and the test asserts it, so the drop path runs.

The reference's initial weights are scaled for a stacked leaf (its fan-in
counts the layer axis, and the experts' the expert axis too), which would
make the experts' share of a logit vanish, and its 1-D scales start at
zero; the model tests here redraw every matrix with the per-matrix fan-in
rule and every scale as ``1 + 0.1 * noise``, in the numpy tree both
packages then load.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_config
from repro_torch.models import (decode_step, greedy_sample, init_params,
                                params_from_reference, prefill)
from repro_torch.models import layers as L
from repro_torch.models.lm import model_spec, padded_vocab

RTOL = ATOL = 1e-4
ARCHS = ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def reference_tree(cfg, seed: int = 0, xgate: float = 0.8):
    """The reference's initial parameter tree as numpy, every matrix redrawn
    as a standard normal over the square root of its own fan-in (the
    second-to-last axis), every 1-D scale as ``1 + 0.1 * noise`` and a
    vlm's ``xgate`` at ``xgate`` plus noise, so that no block is switched
    off."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))

    def fix(path, x):
        name = path[-1].key
        stacked = path[0].key in ("blocks", "enc_blocks")
        if x.ndim - stacked >= 2:
            y = rng.standard_normal(x.shape) / np.sqrt(x.shape[-2])
        elif name == "xgate":
            y = xgate + 0.05 * rng.standard_normal(x.shape)
        else:
            y = 1.0 + 0.1 * rng.standard_normal(x.shape)
        return y.astype(x.dtype)

    return jax.tree_util.tree_map_with_path(fix, tree)


def _moe_params(cfg, rng):
    """One MoE layer's parameters as numpy, drawn by the per-matrix rule."""
    def draw(spec):
        if isinstance(spec, dict):
            return {k: draw(v) for k, v in spec.items()}
        shape, _ = spec
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])
                ).astype(np.float32)
    return draw(jax_layers.moe_spec(cfg))


def _moe_module(tcfg, tree):
    mod = L.MoE(tcfg, dtype=torch.float32, device=torch.device("cpu"))
    with torch.no_grad():
        for name, p in mod.named_parameters():
            node = tree
            for key in name.split("."):
                node = node[key]
            p.copy_(torch.from_numpy(node))
    return mod


def _routed_counts(mod, x_flat, tcfg):
    _, ids = L.moe_route(x_flat, mod.router, tcfg.top_k)
    return torch.bincount(ids.flatten(), minlength=tcfg.n_experts)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S", [(2, 8), (1, 37), (4, 1)])
def test_moe_layer_matches_the_reference(arch, B, S):
    """B * S = 16 at qwen3-moe's reduced config is the drop case (C = 5);
    37 tokens a ragged one; 4 single tokens a decode step's routing."""
    cfg = jax_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    rng = np.random.default_rng(3)
    p = _moe_params(cfg, rng)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ref = jax_layers.moe(jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(x))
    mod = _moe_module(tcfg, p)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert got.shape == (B, S, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    T = B * S
    C = L.moe_capacity(T, tcfg)
    assert C == min(jax_layers._moe_capacity(T, cfg), T)
    if arch == "qwen3-moe-235b-a22b" and T == 16:
        assert C == 5
        counts = _routed_counts(mod, torch.from_numpy(x).view(T, -1), tcfg)
        # an expert overflows its capacity: tokens past the fifth are dropped
        assert counts.max().item() > C, counts.tolist()


@pytest.mark.parametrize("schedule", ["_combine_slots",
                                      "_combine_pairs"])
@pytest.mark.parametrize("T,seed", [(16, 0), (16, 1), (40, 2), (3, 3)])
def test_moe_schedules_equal_the_per_expert_loop(schedule, T, seed):
    """Both batched schedules against ``moe_loop_ref``, the reference's loop
    over every expert: the same routing, drops and ascending-id sum.
    Dropping matters: without the capacity the outputs differ."""
    tcfg = get_config("qwen3-moe-235b-a22b").reduced()
    rng = np.random.default_rng(seed)
    mod = _moe_module(tcfg, _moe_params(
        jax_get_config("qwen3-moe-235b-a22b").reduced(), rng))
    x = torch.from_numpy(rng.standard_normal((T, tcfg.d_model))
                         .astype(np.float32))
    with torch.no_grad():
        wts, ids = L.moe_route(x, mod.router, tcfg.top_k)
        C = L.moe_capacity(T, tcfg)
        want = L.moe_loop_ref(x, wts, ids, mod.wg, mod.wu, mod.wd, C)
        got = getattr(mod, schedule)(x, wts, ids, C)
        roomy = getattr(mod, schedule)(x, wts, ids, T)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    counts = torch.bincount(ids.flatten(), minlength=tcfg.n_experts)
    if counts.max().item() > C:
        assert not torch.allclose(roomy, want, rtol=1e-3, atol=1e-4)
    else:
        torch.testing.assert_close(roomy, want, rtol=1e-5, atol=1e-6)


def test_moe_capacity_keeps_the_first_tokens_in_token_order():
    """Every token routed to expert 0 only: the first C tokens keep their
    output, the rest get none, whichever schedule runs."""
    tcfg = get_config("qwen3-moe-235b-a22b").reduced(top_k=1)
    T, D = 16, tcfg.d_model
    rng = np.random.default_rng(5)
    mod = _moe_module(tcfg, _moe_params(
        jax_get_config("qwen3-moe-235b-a22b").reduced(top_k=1), rng))
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    wts = torch.ones((T, 1))
    ids = torch.zeros((T, 1), dtype=torch.int64)
    C = L.moe_capacity(T, tcfg)
    assert C == 2
    with torch.no_grad():
        for schedule in (mod._combine_slots, mod._combine_pairs):
            y = schedule(x, wts, ids, C)
            assert y[:C].abs().min() > 0
            assert not y[C:].any()
        loop = L.moe_loop_ref(x, wts, ids, mod.wg, mod.wu, mod.wd, C)
    assert torch.equal(loop[C:], torch.zeros_like(loop[C:]))


def test_moe_route_breaks_ties_toward_the_lower_expert_like_lax_top_k():
    """Equal router logits: ``lax.top_k`` keeps the lowest expert ids, and
    so does the port's stable sort."""
    T, D, E, k = 4, 8, 8, 2
    x = np.ones((T, D), np.float32)
    router = np.zeros((D, E), np.float32)
    router[:, 5] = 0.5                      # expert 5 first, then 0 and 1 tie
    router[:, [0, 1, 2]] = 0.25
    wts, ids = L.moe_route(torch.from_numpy(x), torch.from_numpy(router), k)
    probs = jax.nn.softmax(jnp.asarray(x @ router), axis=-1)
    jw, ji = jax.lax.top_k(probs, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_allclose(wts.numpy(),
                               np.asarray(jw / jw.sum(-1, keepdims=True)),
                               rtol=1e-6)
    assert ids[0].tolist() == [5, 0]


def test_moe_model_params_round_trip_from_the_reference():
    cfg = jax_get_config("llama4-maverick-400b-a17b").reduced()
    tcfg = get_config("llama4-maverick-400b-a17b").reduced()
    tree = reference_tree(cfg)
    model = params_from_reference(tcfg, tree, device="cpu")
    names = dict(model.named_parameters())
    blocks = tree["blocks"]["moe"]
    for i in range(cfg.n_layers):
        for leaf in ("router", "wg", "wu", "wd"):
            assert torch.equal(names[f"blocks.{i}.moe.{leaf}"],
                               torch.from_numpy(blocks[leaf][i]))
        assert torch.equal(names[f"blocks.{i}.moe.shared.wd"],
                           torch.from_numpy(blocks["shared"]["wd"][i]))
    assert names["blocks.0.moe.wg"].shape == (8, 128, 64)
    assert names["blocks.0.moe.shared.wg"].shape == (128, 256)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(np.asarray(x).size for x in jax.tree.leaves(tree))
    assert set(model_spec(tcfg)["blocks"]["moe"]) == {
        "router", "wg", "wu", "wd", "shared"}


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_prefill_and_decode_match_the_reference(arch):
    """Prefill of two 8-token prompts (16 tokens: qwen3-moe's C = 5, with
    drops) and three decode steps (two tokens a step: the routed-pair
    schedule), against the reference on the same weights."""
    B, P, steps = 2, 8, 3
    cfg = jax_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    tree = reference_tree(cfg)
    model = params_from_reference(tcfg, tree, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P),
                                               dtype=np.int32)
    max_len = P + steps + 1
    jcache, jlogits = jax.jit(lambda p, b: jax_prefill(
        p, cfg, b, None, max_len=max_len))(jparams, {"tokens": tokens})
    jdec = jax.jit(lambda p, c, t: jax_decode_step(p, cfg, c, t, None))
    cache, logits = prefill(model, tcfg, {"tokens": tokens}, max_len=max_len)
    assert logits.shape == (B, 1, padded_vocab(tcfg))
    toks, jtoks = [], []
    for step in range(steps + 1):
        np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {step}")
        tok = greedy_sample(logits)
        jtok = jnp.argmax(jlogits[:, -1], -1)[:, None].astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        toks.append(tok)
        jtoks.append(jtok)
        if step < steps:
            cache, logits = decode_step(model, tcfg, cache, tok)
            jcache, jlogits = jdec(jparams, jcache, jtok)
    assert cache["index"] == P + steps
    np.testing.assert_allclose(_np(cache["k"][:, :, :P + steps]),
                               _np(jcache["k"][:, :, :P + steps]),
                               rtol=RTOL, atol=ATOL)
    assert len(np.unique(torch.cat(toks, 1).numpy())) > 1


def test_moe_init_draws_every_expert_leaf():
    cfg = get_config("llama4-maverick-400b-a17b").reduced()
    model = init_params(cfg, seed=0, device="cpu")
    p = dict(model.named_parameters())
    wg = p["blocks.0.moe.wg"]
    assert wg.abs().max() > 0 and not torch.equal(wg[0], wg[1])
    # fan-in over all but the last axis, as the reference's rule
    assert wg.abs().max() <= 2.0 / (8 * 128) ** 0.5
    assert p["blocks.0.moe.shared.wg"].abs().max() > 0


def test_serve_lm_serves_moe_in_batch_and_poisson(capsys):
    from repro_torch.serving import serve_lm

    argv = ["--arch", "qwen3-moe-235b-a22b", "--reduced", "--device", "cpu",
            "--layers", "2", "--prompt-len", "16"]
    gen = serve_lm.main(argv + ["--tokens", "4"])
    assert gen.shape == (4, 4)
    report = serve_lm.main(argv + ["--arrivals", "poisson", "--requests",
                                   "4", "--tokens", "8"])
    assert report.completed == 4
    assert "qwen3-moe-235b-a22b-smoke" in capsys.readouterr().out
