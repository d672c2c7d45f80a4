"""The port's cross-attention, encoder and the enc-dec and VLM models against
the reference package's, on the same numpy inputs.

* Cross-attention (``Attention(memory=)``) against ``layers.attention(
  memory=)``: K and V projected from the memory, ``qk_norm`` where set, no
  rope and no mask, through ``wo``; a prompt of ``Sq`` tokens over ``M !=
  Sq`` memory rows (flash attention, non-causal) and one token (decode
  attention at ``length = M``).
* The encoder (``lm._encode``): full self-attention with rope over the
  source positions, then the MLP, no final norm; at the reference serve
  path's 32 frames and at a ragged 37.
* ``prefill`` and three ``decode_step``\\ s of reduced seamless-m4t (encdec)
  and llama-3.2-vision (vlm).

Everything is float32 on the CPU; the tolerance is the model tests'
``rtol = atol = 1e-4`` (XLA and PyTorch sum the same products in other
orders) and greedy tokens must be identical.  A fresh model's ``xgate``
is 0 in both packages (every 1-D leaf that is not a scale starts at zero),
and ``tanh(0)`` switches every vlm cross layer off; the trees here set it
to about 0.8 (``test_torch_moe.reference_tree``), and a test shows that
the patches then move the logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_config as jax_get_config
from repro.models import decode_step as jax_decode_step
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts
from repro_torch.models import (build_decode_graph, cache_struct,
                                decode_step, greedy_sample, init_params,
                                make_decode_state, params_from_reference,
                                prefill, zeros_cache)
from repro_torch.models import layers as L
from repro_torch.models.lm import _encode, layer_flags, padded_vocab
from test_torch_moe import reference_tree

RTOL = ATOL = 1e-4
ENCDEC, VLM = "seamless-m4t-medium", "llama-3.2-vision-11b"
CROSS_ARCHS = (ENCDEC, VLM)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _memory_batch(cfg, B, P, frames=32, seed=2):
    """Prompts from numpy seed 1 and the memory input from seed 2, as
    ``serve_lm`` makes them."""
    batch = {"tokens": np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, P), dtype=np.int32)}
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    else:
        batch["enc_input"] = rng.standard_normal(
            (B, frames, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=CROSS_ARCHS)
def pair(request):
    """(cfg, tcfg, numpy tree, the port's LM, the reference's params)."""
    arch = request.param
    cfg = jax_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    tree = reference_tree(cfg)
    model = params_from_reference(tcfg, tree, device="cpu")
    return cfg, tcfg, tree, model, jax.tree.map(jnp.asarray, tree)


def _attn_params(cfg, rng):
    out = {}
    for name, (shape, _) in jax_layers.attn_spec(cfg).items():
        scale = np.sqrt(shape[-2]) if len(shape) == 2 else 1.0
        base = 0.0 if len(shape) == 2 else 1.0
        out[name] = (base + rng.standard_normal(shape) / scale
                     ).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", ENCDEC, VLM])
@pytest.mark.parametrize("S,M", [(24, 40), (70, 33), (1, 40), (1, 1)])
def test_cross_attention_matches_the_reference(arch, S, M):
    """qwen3-moe's config adds ``qk_norm``; seamless is MHA, the vlm
    grouped; ``S = 1`` is a decode step's single query."""
    cfg = jax_get_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    rng = np.random.default_rng(7)
    p = _attn_params(cfg, rng)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, M, cfg.d_model)).astype(np.float32)
    ref, none = jax_layers.attention(jax.tree.map(jnp.asarray, p), cfg,
                                     jnp.asarray(x), memory=jnp.asarray(mem))
    assert none is None
    attn = L.Attention(tcfg, dtype=torch.float32, device=torch.device("cpu"))
    with torch.no_grad():
        for name, t in attn.named_parameters():
            t.copy_(torch.from_numpy(p[name]))
        got, kv = attn(torch.from_numpy(x), memory=torch.from_numpy(mem))
    assert kv is None and got.shape == (2, S, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("frames", [32, 37])
def test_encoder_matches_the_reference(frames):
    cfg = jax_get_config(ENCDEC).reduced()
    tcfg = get_config(ENCDEC).reduced()
    tree = reference_tree(cfg)
    model = params_from_reference(tcfg, tree, device="cpu")
    x = np.random.default_rng(4).standard_normal(
        (2, frames, cfg.d_model)).astype(np.float32)
    ref = jax_lm._encode(jax.tree.map(jnp.asarray, tree), cfg,
                         jnp.asarray(x), None)
    got = _encode(model, tcfg, torch.from_numpy(x))
    assert got.shape == (2, frames, cfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_encoder_attention_is_not_causal_and_rotates_positions():
    """A change to the last source frame moves the first frame's encoding
    (no causal mask); the same frames in another order encode differently
    (rope over the source positions)."""
    cfg = get_config(ENCDEC).reduced()
    model = init_params(cfg, seed=0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 32, cfg.d_model)).astype(np.float32))
    base = _encode(model, cfg, x)
    moved = x.clone()
    moved[0, -1] += 1.0
    assert not torch.allclose(_encode(model, cfg, moved)[0, 0], base[0, 0])
    flipped = _encode(model, cfg, x.flip(1)).flip(1)
    assert not torch.allclose(flipped, base, atol=1e-4)


def test_params_round_trip_the_cross_and_encoder_leaves(pair):
    cfg, tcfg, tree, model, _ = pair
    names = dict(model.named_parameters())
    blocks = tree["blocks"]
    for i in range(cfg.n_layers):
        assert torch.equal(names[f"blocks.{i}.xattn.wk"],
                           torch.from_numpy(blocks["xattn"]["wk"][i]))
        assert torch.equal(names[f"blocks.{i}.lnx"],
                           torch.from_numpy(blocks["lnx"][i]))
        if cfg.family == "vlm":
            assert torch.equal(names[f"blocks.{i}.xgate"],
                               torch.from_numpy(blocks["xgate"][i]))
    if cfg.family == "encdec":
        for i in range(cfg.enc_layers):
            assert torch.equal(
                names[f"enc_blocks.{i}.attn.wq"],
                torch.from_numpy(tree["enc_blocks"]["attn"]["wq"][i]))
            assert torch.equal(
                names[f"enc_blocks.{i}.mlp.wd"],
                torch.from_numpy(tree["enc_blocks"]["mlp"]["wd"][i]))
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(np.asarray(x).size for x in jax.tree.leaves(tree))
    assert ("blocks.0.xgate" in names) == (cfg.family == "vlm")
    assert ("enc_blocks.0.ln1" in names) == (cfg.family == "encdec")


def test_cache_layout_matches_the_reference(pair):
    cfg, tcfg, _, _, _ = pair
    for n_patches in (0, 40):
        ref = jax_lm.cache_struct(cfg, 3, 20, n_patches)
        ours = cache_struct(tcfg, 3, 20, n_patches)
        assert set(ours) == set(ref)
        for key in ("k", "v", "memory"):
            assert ours[key][0] == tuple(ref[key].shape), key
    cache = zeros_cache(tcfg, 2, 9, device="cpu", n_patches=5)
    assert cache["memory"].shape == (2, 5, tcfg.d_model)
    if tcfg.family == "vlm":
        assert layer_flags(tcfg)["use_cross"] == np.asarray(
            jax_lm.layer_flags(cfg)["use_cross"]).tolist()
        assert layer_flags(get_config(VLM))["use_cross"].count(True) == 8


def test_prefill_and_decode_match_the_reference(pair):
    """Prefill of two 12-token prompts with their memories (32 encoder
    frames, or 16 patches) and three decode steps."""
    cfg, tcfg, _, model, jparams = pair
    B, P, steps = 2, 12, 3
    batch = _memory_batch(cfg, B, P)
    max_len = P + steps + 1
    jcache, jlogits = jax.jit(lambda p, b: jax_prefill(
        p, cfg, b, None, max_len=max_len))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jdec = jax.jit(lambda p, c, t: jax_decode_step(p, cfg, c, t, None))
    cache, logits = prefill(model, tcfg, batch, max_len=max_len)
    assert logits.shape == (B, 1, padded_vocab(tcfg))
    np.testing.assert_allclose(_np(cache["memory"]), _np(jcache["memory"]),
                               rtol=RTOL, atol=ATOL)
    toks = []
    for step in range(steps + 1):
        np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {step}")
        tok = greedy_sample(logits)
        jtok = jnp.argmax(jlogits[:, -1], -1)[:, None].astype(jnp.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        toks.append(tok)
        if step < steps:
            cache, logits = decode_step(model, tcfg, cache, tok)
            jcache, jlogits = jdec(jparams, jcache, jtok)
    assert cache["index"] == P + steps
    np.testing.assert_allclose(_np(cache["k"][:, :, :P + steps]),
                               _np(jcache["k"][:, :, :P + steps]),
                               rtol=RTOL, atol=ATOL)
    assert len(np.unique(torch.cat(toks, 1).numpy())) > 1


def test_memory_moves_the_logits(pair):
    """Other patches (or encoder frames) give other logits in prefill and
    in a decode step: the cross path is on.  With every ``xgate`` at 0, as
    a fresh model has it, the patches change nothing."""
    cfg, tcfg, tree, model, _ = pair
    a = _memory_batch(cfg, 1, 8, seed=2)
    b = _memory_batch(cfg, 1, 8, seed=3)
    ca, la = prefill(model, tcfg, a, max_len=10)
    cb, lb = prefill(model, tcfg, b, max_len=10)
    assert not torch.allclose(la, lb, atol=1e-3)
    tok = torch.zeros((1, 1), dtype=torch.int32)
    _, da = decode_step(model, tcfg, ca, tok)
    _, db = decode_step(model, tcfg, cb, tok)
    assert not torch.allclose(da, db, atol=1e-3)
    if cfg.family == "vlm":
        with torch.no_grad():
            for blk in model.blocks:
                blk.xgate.zero_()
        try:
            _, za = prefill(model, tcfg, a, max_len=10)
            _, zb = prefill(model, tcfg, b, max_len=10)
        finally:
            with torch.no_grad():
                for i, blk in enumerate(model.blocks):
                    blk.xgate.copy_(torch.from_numpy(
                        tree["blocks"]["xgate"][i]))
        assert torch.equal(za, zb)


def test_decode_graph_equals_the_plain_loop_lane_by_lane(pair):
    """``make_decode_state`` splits the memory input with the prompts, so
    each lane's cache carries its own memory through the decode-step
    graphs; each lane's tokens equal that request served alone."""
    cfg, tcfg, _, model, _ = pair
    B, P, steps = 3, 10, 4
    batch = _memory_batch(cfg, B, P)
    max_len = P + steps + 1
    state = make_decode_state(model, tcfg, batch, n_shards=B,
                              max_len=max_len, device="cpu")
    for sh in state.shards:
        assert sh.cache["memory"].shape[0] == 1
    with repro_torch.Session(2) as s:
        for _ in range(steps - 1):
            s.run(build_decode_graph(
                state, lambda p, c, t: decode_step(p, tcfg, c, t)))
    for b in range(B):
        alone = {k: v[b:b + 1] for k, v in batch.items()}
        cache, logits = prefill(model, tcfg, alone, max_len=max_len)
        tok = greedy_sample(logits)
        toks = [tok]
        for _ in range(steps - 1):
            cache, logits = decode_step(model, tcfg, cache, tok)
            tok = greedy_sample(logits)
            toks.append(tok)
        assert torch.equal(state.tokens()[b:b + 1], torch.cat(toks, 1))


def test_cross_paths_take_the_attention_wrappers(monkeypatch):
    """Cross prefill calls flash attention with ``causal=False`` over the
    memory's length, a decode step decode attention at ``length = M``; the
    CPU calls are not launches."""
    from repro_torch.models import layers

    cfg = get_config(VLM).reduced()
    model = init_params(cfg, seed=0, device="cpu")
    seen = []
    real_flash, real_decode = layers.flash_attention, layers.decode_attention

    def flash(q, k, v, **kw):
        seen.append(("flash", q.shape[2], k.shape[2], kw.get("causal")))
        return real_flash(q, k, v, **kw)

    def decode(q, k, v, length, **kw):
        seen.append(("decode", k.shape[1], length))
        return real_decode(q, k, v, length, **kw)

    monkeypatch.setattr(layers, "flash_attention", flash)
    monkeypatch.setattr(layers, "decode_attention", decode)
    before = launch_counts()
    batch = _memory_batch(cfg, 1, 9)
    cache, logits = prefill(model, cfg, batch, max_len=11)
    decode_step(model, cfg, cache, greedy_sample(logits))
    n, M = cfg.n_layers, cfg.n_patches
    crosses = layer_flags(cfg)["use_cross"].count(True)
    assert seen.count(("flash", 9, 9, True)) == n
    assert seen.count(("flash", 9, M, False)) == crosses
    assert seen.count(("decode", 11, 10)) == n
    assert seen.count(("decode", M, M)) == crosses
    assert len(seen) == 2 * (n + crosses)
    assert launch_counts() == before


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_serve_lm_serves_the_cross_families(arch, capsys):
    from repro_torch.serving import serve_lm

    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--layers", "2",
            "--prompt-len", "12", "--tokens", "4"]
    gen = serve_lm.main(argv)
    loop = serve_lm.main(argv + ["--scheduler", "jit"])
    assert gen.shape == (4, 4) and torch.equal(gen, loop)
    assert f"arch={arch}-smoke" in capsys.readouterr().out


@pytest.mark.parametrize("arch", CROSS_ARCHS)
def test_serve_lm_refuses_poisson_for_the_cross_families(arch, capsys):
    from repro_torch.serving import serve_lm

    with pytest.raises(SystemExit):
        serve_lm.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--arrivals", "poisson"])
    assert ("--arrivals poisson supports decoder-only families"
            in capsys.readouterr().err)


def test_memory_inputs_follow_the_reference_serve_path():
    from repro_torch.serving.serve_lm import ENC_FRAMES, memory_inputs

    vlm, enc = get_config(VLM).reduced(), get_config(ENCDEC).reduced()
    assert memory_inputs(vlm, 3, "cpu")["patches"].shape == (3, 16, 128)
    assert memory_inputs(enc, 3, "cpu")["enc_input"].shape == (
        3, ENC_FRAMES, 128) == (3, 32, 128)
    assert memory_inputs(get_config("qwen3-14b").reduced(), 3, "cpu") == {}
    full = memory_inputs(get_config(VLM), 1, "cpu")["patches"]
    assert full.shape == (1, 1600, 4096) and full.dtype == torch.bfloat16
