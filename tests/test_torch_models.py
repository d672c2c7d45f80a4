"""The port's dense LM against the reference package's, on the same weights.

The reference's ``init_params(cfg, PRNGKey(0))`` is converted leaf by leaf
(``params_from_reference``).  Its norm scales ``ln1``, ``ln2`` and
``final_norm`` start at zero (``layers.materialize`` matches only the
prefixes ``norm``/``gamma``), which would zero every block's input and
every logit, so the test replaces every 1-D scale with ``1 + 0.1 * noise``
from numpy, in the tree that both packages then use.

Both run in float32 on the CPU: the port's attention takes its kernels'
plain versions there, the reference its jitted ``prefill`` and
``decode_step``.  XLA and PyTorch sum the same products in different
orders, so the logits agree to about 1e-5 of their scale; the tolerance is
``rtol = atol = 1e-4``.  Greedy tokens must be identical.

The prompt (80 tokens) is longer than the reduced gemma3 window (64), so
the sliding window masks keys in prefill and in every decode step; with six
layers gemma3's last layer is global (window 0, theta 1e6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import (decode_step, greedy_sample, init_params,
                                make_decode_state, params_from_reference,
                                prefill, zeros_cache)
from repro_torch.models.lm import layer_flags, padded_vocab
from repro_torch.sharding import ShardCtx

RTOL = ATOL = 1e-4
PROMPT, STEPS, BATCH = 80, 8, 2

CASES = {
    "qwen3-14b": dict(),
    "gemma3-12b": dict(),
    "gemma3-12b-6l": dict(n_layers=6),
}


def _arch(case: str) -> str:
    return case.removesuffix("-6l")


def reference_tree(cfg, seed: int = 0):
    """The reference's initial parameters as numpy, with random scales."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))

    def fix(path, x):
        name = path[-1].key
        if name in ("ln1", "ln2", "final_norm", "gamma_q", "gamma_k"):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(fix, tree)


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(case, cfg, numpy tree, the port's LM, reference params)."""
    case = request.param
    cfg = jax_get_config(_arch(case)).reduced(**CASES[case])
    tree = reference_tree(cfg)
    tcfg = get_config(_arch(case)).reduced(**CASES[case])
    model = params_from_reference(tcfg, tree, device="cpu")
    return case, cfg, tcfg, model, jax.tree.map(jnp.asarray, tree)


def _prompt(cfg, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_configs_match_the_reference():
    for arch in ARCHS:
        ours, ref = get_config(arch), jax_get_config(arch)
        for field in ref.__dataclass_fields__:
            assert getattr(ours, field) == getattr(ref, field), (arch, field)
        assert ours.param_count() == ref.param_count()
        assert ours.reduced().param_count() == ref.reduced().param_count()
    qwen = get_config("qwen3-14b")
    assert qwen.torch_dtype == torch.bfloat16 and padded_vocab(qwen) == 152064


def test_layer_flags_match_the_reference():
    from repro.models.lm import layer_flags as jax_layer_flags
    for arch in ("qwen3-14b", "gemma3-12b", "deepseek-67b"):
        ours = layer_flags(get_config(arch))
        ref = jax_layer_flags(jax_get_config(arch))
        assert ours["window"] == np.asarray(ref["window"]).tolist()
        np.testing.assert_array_equal(np.float32(ours["theta"]),
                                      np.asarray(ref["theta"]))


def test_params_from_reference_round_trips(pair):
    case, cfg, tcfg, model, _ = pair
    tree = reference_tree(cfg)
    names = dict(model.named_parameters())
    assert torch.equal(names["embed.table"], torch.from_numpy(tree["embed"]["table"]))
    for i in range(cfg.n_layers):
        assert torch.equal(names[f"blocks.{i}.attn.wq"],
                           torch.from_numpy(tree["blocks"]["attn"]["wq"][i]))
        assert torch.equal(names[f"blocks.{i}.mlp.wd"],
                           torch.from_numpy(tree["blocks"]["mlp"]["wd"][i]))
        assert torch.equal(names[f"blocks.{i}.ln1"],
                           torch.from_numpy(tree["blocks"]["ln1"][i]))
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(np.asarray(x).size for x in jax.tree.leaves(tree))


def test_prefill_and_decode_match_the_reference(pair):
    case, cfg, tcfg, model, jparams = pair
    tokens = _prompt(cfg)
    max_len = PROMPT + STEPS + 1
    jpre = jax.jit(lambda p, b: jax_prefill(p, cfg, b, None, max_len=max_len))
    jdec = jax.jit(lambda p, c, t: jax_decode_step(p, cfg, c, t, None))
    jcache, jlogits = jpre(jparams, {"tokens": jnp.asarray(tokens)})
    cache, logits = prefill(model, tcfg, {"tokens": tokens}, max_len=max_len)
    assert logits.shape == (BATCH, 1, padded_vocab(tcfg))
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(cache["k"][:, :, :PROMPT]),
                               _np(jcache["k"][:, :, :PROMPT]),
                               rtol=RTOL, atol=ATOL)
    assert cache["index"] == int(jcache["index"]) == PROMPT

    tok = greedy_sample(logits)
    jtok = jnp.argmax(jlogits[:, -1], -1)[:, None].astype(jnp.int32)
    toks, jtoks = [tok], [jtok]
    for _ in range(STEPS):
        assert np.array_equal(tok.numpy(), np.asarray(jtok))
        cache, logits = decode_step(model, tcfg, cache, tok)
        jcache, jlogits = jdec(jparams, jcache, jtok)
        np.testing.assert_allclose(_np(logits), _np(jlogits),
                                   rtol=RTOL, atol=ATOL)
        tok = greedy_sample(logits)
        jtok = jnp.argmax(jlogits[:, -1], -1)[:, None].astype(jnp.int32)
        toks.append(tok)
        jtoks.append(jtok)
    assert cache["index"] == PROMPT + STEPS
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(),
                                  np.concatenate(jtoks, 1))
    # the streams are not degenerate: the random scales give real logits
    assert len(np.unique(torch.cat(toks, 1).numpy())) > 1


def test_init_params_follows_the_fan_in_rule():
    cfg = get_config("qwen3-14b").reduced()
    a = init_params(cfg, seed=3, device="cpu")
    b = init_params(cfg, seed=3, device="cpu")
    c = init_params(cfg, seed=4, device="cpu")
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    assert not torch.equal(pa["blocks.0.attn.wq"], pc["blocks.0.attn.wq"])
    wq = pa["blocks.0.attn.wq"]
    assert wq.abs().max() <= 2.0 / cfg.d_model ** 0.5
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 0.88) < 0.05
    for n in ("blocks.0.ln1", "blocks.0.attn.gamma_q", "final_norm"):
        assert torch.equal(pa[n], torch.ones_like(pa[n]))
    _, logits = prefill(a, cfg, {"tokens": _prompt(cfg)})
    assert torch.isfinite(logits).all() and logits.abs().max() > 0


def test_other_families_raise_naming_the_roadmap_item():
    """Every family the repo configures builds and prefills on the CPU (the
    moe, encdec and vlm families raised here until they were ported); what
    the port still lacks, a sharding context, raises naming its ROADMAP
    item; a sharding context without a mesh is the ctx=None path, bit for
    bit (the sharded paths run in test_torch_sharding.py)."""
    rng = np.random.default_rng(0)
    by_family = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        by_family.setdefault(cfg.family, arch)
    assert sorted(by_family) == ["dense", "encdec", "hybrid", "moe", "ssm",
                                 "vlm"]
    for family, arch in sorted(by_family.items()):
        cfg = get_config(arch).reduced()
        model = init_params(cfg, device="cpu")
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, 6))}
        if family == "vlm":
            batch["patches"] = rng.standard_normal(
                (1, cfg.n_patches, cfg.d_model)).astype(np.float32)
        if family == "encdec":
            batch["enc_input"] = rng.standard_normal(
                (1, 5, cfg.d_model)).astype(np.float32)
        cache, logits = prefill(model, cfg, batch)
        assert logits.shape == (1, 1, padded_vocab(cfg)), family
        assert torch.isfinite(logits).all(), family
        assert cache["index"] == 6
        _, again = prefill(model, cfg, batch, ctx=ShardCtx(mesh=None))
        assert torch.equal(again, logits), family


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    cfg = get_config("qwen3-14b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zeros_cache(cfg, 1, 8)
    model = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_decode_state(model, cfg, {"tokens": _prompt(cfg)}, n_shards=2,
                          max_len=PROMPT + 2)
