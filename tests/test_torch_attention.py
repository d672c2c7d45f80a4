"""The port's attention against the reference package's, on the CPU.

On the CPU the port's wrappers run their plain versions
(``repro_torch.kernels.ref``); they are held against the Pallas kernels in
interpret mode (KV heads repeated, as those kernels take them), against the
reference oracles in ``repro.kernels.ref``, and against the functions of
``repro.models.layers`` that the kernels replace on the model path
(``_chunked_attn`` for prefill, ``decode_attention`` for decode), which add
grouped-query heads, a sliding window and a ragged S.  The CUDA kernels
themselves are checked against the plain versions on the card by
``tests/test_torch_cuda.py``.

Inputs come from ``numpy.random.default_rng(seed)``.  float32 uses
``tests/test_kernels.py``'s kernel tolerance, ``rtol = atol = 2e-5``.

Gradients: ``flash_attention_bwd`` (the backward of ``FlashAttentionFn``,
in torch ops) against ``torch.autograd`` through ``flash_attention_ref``
in float64, where the two compute the same sums in another order (``rtol
= atol = 1e-10``), and against ``jax.grad`` of ``_chunked_attn`` in
float32 (the kernel tolerance again); the kernels without a backward
refuse inputs that require grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import layers as jax_layers
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (BWD_BLOCK, FlashAttentionFn,
                                                 flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.ref import decode_attention_ref, flash_attention_ref

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(x)


# ---------------------------------------------------------------------------
# prefill: flash attention
@pytest.mark.parametrize("B,H,S,d", [(1, 2, 256, 64), (2, 1, 128, 32)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0)])
def test_flash_plain_matches_pallas_interpret_and_oracle(B, H, S, d, causal,
                                                         window):
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, B, H, S, d) for _ in range(3))
    ours = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               window=window)
    pallas = jax_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window, mode="interpret",
                                     bq=128, bk=128)
    oracle = jax_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal,
                                         window=window)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("S", [200, 64, 1])
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 1)])
@pytest.mark.parametrize("window", [0, 48])
def test_flash_plain_matches_chunked_attn_with_gqa(S, H, KV, window):
    """``layers._chunked_attn`` as ``attention`` calls it for prefill:
    (B, S, heads, hd) layout, grouped KV heads, any S (it pads)."""
    rng = np.random.default_rng(1)
    B, hd = 2, 32
    q = _rand(rng, B, S, H, hd)
    k, v = _rand(rng, B, S, KV, hd), _rand(rng, B, S, KV, hd)
    ref = jax_layers._chunked_attn(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, window=window,
                                   q_offset=0)
    ours = flash_attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                           _t(v).transpose(1, 2), causal=True, window=window)
    np.testing.assert_allclose(ours.transpose(1, 2).numpy(), np.asarray(ref),
                               **TOL)


@pytest.mark.parametrize("Sq,Sk", [(24, 70), (70, 24), (1, 40), (9, 9)])
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 4)])
def test_flash_non_causal_unequal_lengths_match_chunked_attn(Sq, Sk, H, KV):
    """``layers._chunked_attn(causal=False)`` as the encoder and
    cross-attention call it: Sq queries over Sk keys, grouped heads, no
    mask; the wrapper's plain version on CPU tensors, and the same through
    ``flash_attention_ref`` directly."""
    rng = np.random.default_rng(6)
    B, hd = 2, 32
    q = _rand(rng, B, Sq, H, hd)
    k, v = _rand(rng, B, Sk, KV, hd), _rand(rng, B, Sk, KV, hd)
    ref = jax_layers._chunked_attn(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=False, window=0,
                                   q_offset=0)
    args = (_t(q).transpose(1, 2), _t(k).transpose(1, 2),
            _t(v).transpose(1, 2))
    ours = flash_attention(*args, causal=False)
    assert ours.shape == (B, H, Sq, hd)
    np.testing.assert_allclose(ours.transpose(1, 2).numpy(), np.asarray(ref),
                               **TOL)
    plain = flash_attention_ref(*args, causal=False)
    assert torch.equal(plain, ours)


def test_flash_wrapper_refuses_what_prefill_does_not_call():
    q = torch.zeros(1, 2, 8, 16)
    kv = torch.zeros(1, 1, 6, 16)
    with pytest.raises(NotImplementedError, match="Queue B item 3"):
        flash_attention(q, kv, kv)
    with pytest.raises(NotImplementedError, match="causal=True"):
        flash_attention(q, kv, kv, causal=True)
    assert flash_attention(q, kv, kv, causal=False).shape == (1, 2, 8, 16)
    with pytest.raises(NotImplementedError, match="q_offset"):
        flash_attention(q, q[:, :1], q[:, :1], q_offset=4)
    with pytest.raises(ValueError, match="group"):
        flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), q.double(), q.double())


# ---------------------------------------------------------------------------
# prefill gradients: FlashAttentionFn and flash_attention_bwd
#
# (B, H, KV, Sq, Sk, d, causal, window): causal, windowed, grouped heads
# (4 / 2), non-causal Sq != Sk both ways, and lengths that are not a
# multiple of BWD_BLOCK (600 and 530 span two blocks, the second ragged)
GRAD_CASES = [(2, 4, 2, 600, 600, 16, True, 0),
              (1, 4, 2, 600, 600, 16, True, 100),
              (1, 4, 4, 77, 77, 8, True, 0),
              (2, 4, 2, 70, 530, 8, False, 0),
              (1, 4, 2, 530, 41, 8, False, 0),
              (1, 2, 1, 37, 37, 8, True, 5)]
F64_GRAD_TOL = dict(rtol=1e-10, atol=1e-10)


def _grad_inputs(rng, B, H, KV, Sq, Sk, d, dtype=np.float64):
    q = rng.standard_normal((B, H, Sq, d)).astype(dtype)
    k, v = (rng.standard_normal((B, KV, Sk, d)).astype(dtype)
            for _ in range(2))
    dout = rng.standard_normal((B, H, Sq, d)).astype(dtype)
    return q, k, v, dout


@pytest.mark.parametrize("B,H,KV,Sq,Sk,d,causal,window", GRAD_CASES)
def test_flash_bwd_matches_autograd_of_the_plain_version_in_float64(
        B, H, KV, Sq, Sk, d, causal, window):
    assert max(Sq, Sk) < 2 * BWD_BLOCK
    rng = np.random.default_rng(11)
    q, k, v, dout = (_t(x) for x in _grad_inputs(rng, B, H, KV, Sq, Sk, d))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention_ref(*leaves, causal=causal, window=window)
    expect = torch.autograd.grad(out, leaves, dout)
    got = flash_attention_bwd(q, k, v, out.detach(), dout, causal=causal,
                              window=window)
    for name, g, e in zip("qkv", got, expect):
        assert g.dtype == torch.float64 and g.shape == e.shape, name
        np.testing.assert_allclose(g.numpy(), e.numpy(), **F64_GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("B,H,KV,Sq,Sk,d,causal,window", GRAD_CASES)
def test_flash_gradients_match_jax_grad_of_chunked_attn(B, H, KV, Sq, Sk, d,
                                                         causal, window):
    """The wrapper with grad on (``FlashAttentionFn`` on CPU tensors)
    against ``jax.grad`` of ``layers._chunked_attn`` in its (B, S, heads,
    hd) layout, for the same output gradient, in float32.  A transposed
    ``dout`` also checks a non-contiguous output gradient."""
    rng = np.random.default_rng(12)
    q, k, v, dout = _grad_inputs(rng, B, H, KV, Sq, Sk, d, np.float32)
    tr = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3))  # noqa: E731

    def f(qj, kj, vj):
        out = jax_layers._chunked_attn(qj, kj, vj, causal=causal,
                                       window=window, q_offset=0)
        return jnp.sum(out * jnp.asarray(tr(dout)))

    expect = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(tr(q)), jnp.asarray(tr(k)), jnp.asarray(tr(v)))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, causal=causal, window=window)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(
        out.grad_fn).__name__
    out.backward(_t(tr(dout)).transpose(1, 2))
    for name, t, e in zip("qkv", leaves, expect):
        np.testing.assert_allclose(t.grad.transpose(1, 2).numpy(),
                                   np.asarray(e), **TOL, err_msg=f"d{name}")


def test_flash_with_grad_gives_the_no_grad_calls_bits():
    """The Function's forward is the same call: the output is bit-identical
    to the direct one's, which carries no history; CPU calls count no
    launch either way."""
    rng = np.random.default_rng(13)
    q, k, v, _ = (_t(x) for x in _grad_inputs(rng, 2, 4, 2, 70, 70, 16,
                                              np.float32))
    before = launch_counts()
    plain = flash_attention(q, k, v, causal=True, window=9)
    assert plain.grad_fn is None
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    tracked = flash_attention(*leaves, causal=True, window=9)
    assert torch.equal(tracked.detach(), plain)
    direct = FlashAttentionFn.apply(*leaves, True, 9, 0)
    assert torch.equal(direct.detach(), plain)
    with torch.no_grad():
        assert flash_attention(*leaves, causal=True, window=9).grad_fn is None
    assert launch_counts() == before


def test_decode_attention_refuses_inputs_that_require_grad():
    """No backward: with grad on, a q, k or v that requires grad raises
    before the device dispatch (the same on either device); under
    ``no_grad`` the call runs."""
    q = torch.zeros(1, 2, 8)
    kv = torch.zeros(1, 6, 1, 8)
    for args in ((q.requires_grad_(), kv, kv),
                 (q.detach(), kv.clone().requires_grad_(), kv)):
        with pytest.raises(RuntimeError, match="no backward"):
            decode_attention(*args, 3)
        with torch.no_grad():
            assert decode_attention(*args, 3).shape == (1, 2, 8)


# ---------------------------------------------------------------------------
# decode: flash-decoding
@pytest.mark.parametrize("B,H,S,d,length", [(2, 2, 1024, 64, 700),
                                            (1, 4, 512, 128, 512),
                                            (1, 2, 512, 32, 1)])
def test_decode_plain_matches_pallas_interpret_and_oracle(B, H, S, d, length):
    rng = np.random.default_rng(2)
    q = _rand(rng, B, H, d)
    k, v = _rand(rng, B, S, H, d), _rand(rng, B, S, H, d)
    ours = ops.decode_attention(_t(q), _t(k), _t(v), length)
    pallas = jax_ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), length,
                                      mode="interpret", bk=256)
    oracle = jax_ref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), length)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("S,length", [(200, 200), (200, 137), (89, 1)])
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 1)])
@pytest.mark.parametrize("window", [0, 64])
def test_decode_plain_matches_layers_decode_attention(S, length, H, KV,
                                                      window):
    """``layers.decode_attention`` as ``attention`` calls it per decode
    step: (B, 1, H, hd) query, (B, S_max, KV, hd) cache, a window."""
    rng = np.random.default_rng(3)
    B, hd = 2, 32
    q = _rand(rng, B, 1, H, hd)
    k, v = _rand(rng, B, S, KV, hd), _rand(rng, B, S, KV, hd)
    ref = jax_layers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), length, window=window)
    ours = decode_attention(_t(q)[:, 0], _t(k), _t(v), length, window=window)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref)[:, 0], **TOL)


def test_decode_at_length_zero_gives_zeros_like_the_pallas_kernel():
    """The Pallas kernel masks with a finite NEG_INF and divides by
    max(l, 1e-30), so an empty cache gives zeros (its oracle gives NaN);
    the port keeps the kernel's behaviour, windowed or not."""
    rng = np.random.default_rng(4)
    q = _rand(rng, 2, 4, 64)
    k, v = _rand(rng, 2, 512, 4, 64), _rand(rng, 2, 512, 4, 64)
    pallas = np.asarray(jax_ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0, mode="interpret",
        bk=256))
    assert not pallas.any()
    assert np.isnan(np.asarray(jax_ref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0))).all()
    for window in (0, 16):
        ours = decode_attention(_t(q), _t(k)[:, :, :2], _t(v)[:, :, :2], 0,
                                window=window)
        assert torch.equal(ours, torch.zeros_like(ours))
        assert torch.equal(decode_attention_ref(_t(q), _t(k), _t(v), 0),
                           torch.zeros(2, 4, 64))


def test_prefill_window_of_one_keeps_the_diagonal_only():
    q = torch.randn(1, 2, 5, 8)
    assert torch.isfinite(flash_attention_ref(q, q, q)).all()
    out = flash_attention_ref(q, q, q, causal=True, window=1)
    assert torch.allclose(out, q)


def test_decode_wrapper_checks_its_inputs():
    q = torch.zeros(1, 4, 16)
    kv = torch.zeros(1, 10, 2, 16)
    with pytest.raises(ValueError, match="outside 0..10"):
        decode_attention(q, kv, kv, 11)
    with pytest.raises(TypeError, match="host integer"):
        decode_attention(q, kv, kv, torch.tensor(3))
    strided = torch.zeros(1, 10, 16, 2).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(q, strided, strided, 3)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(torch.zeros(1, 4, 300), torch.zeros(1, 10, 2, 300),
                         torch.zeros(1, 10, 2, 300), 3)


def test_cpu_calls_do_not_count_as_launches():
    before = launch_counts()
    q = torch.zeros(1, 2, 4, 8)
    flash_attention(q, q, q)
    decode_attention(q[:, :, 0], q.transpose(1, 2), q.transpose(1, 2), 2)
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# the CUDA kernels' schedules, emulated in plain torch
#
# The bfloat16 prefill kernel rounds p to bfloat16 before p . V on the
# tensor cores (the reference's layers._chunked_attn does so too), which the
# plain version does not: each p_j carries a relative error of at most
# u = 2**-8, so the output moves by at most u * sum_j p_j |v_j| / l, u times
# the attention of |v| (tests/test_torch_cuda.py and chip_smoke.py hold the
# kernel to that limit on the card).
FLASH_P_ROUND = 2.0 ** -8


def _emulate_tc_prefill(q, k, v, *, causal, window, drop_diagonal=False,
                        bk=64):
    """The bfloat16 prefill kernel's rounding points: bf16 q . k^T summed in
    float32, a running max per 64-key tile, p rounded to bf16 per tile for
    p . V with float32 sums, l summed from the float32 p, the carry
    rescaled at each tile.  Returns float32 (B, H, S, d)."""
    B, H, S, d = q.shape
    rep = H // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s_all = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / np.sqrt(d)
    pos = torch.arange(S)
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    if drop_diagonal:
        mask &= pos[:, None] != pos[None, :]
    m = torch.full((B, H, S, 1), -np.inf)
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, d)
    for k0 in range(0, S, bk):
        s = s_all[..., k0:k0 + bk].masked_fill(~mask[:, k0:k0 + bk], -np.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        base = torch.where(torch.isfinite(m_new), m_new, torch.zeros(()))
        corr = torch.where(torch.isfinite(m_new), torch.exp(m - base),
                           torch.ones(()))
        p = torch.exp(s - base)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.bfloat16().float() @ vf[:, :, k0:k0 + bk]
        m = m_new
    return acc / l.clamp_min(1e-30)


def _prefill_limit(q, k, v, ref, *, causal, window):
    """float32 sums' tolerance plus the derived allowance for rounding p."""
    absv = flash_attention_ref(q.float(), k.float(), v.float().abs(),
                               causal=causal, window=window)
    return TOL["atol"] + TOL["rtol"] * ref.abs() + FLASH_P_ROUND * absv


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("S,d,causal,window", [(200, 32, True, 0),
                                               (130, 64, True, 48),
                                               (96, 64, False, 0)])
def test_prefill_kernel_rounding_holds_the_derived_limit(seed, S, d, causal,
                                                         window):
    rng = np.random.default_rng(seed)
    q = _t(_rand(rng, 1, 4, S, d)).bfloat16()
    k = _t(_rand(rng, 1, 2, S, d)).bfloat16()
    v = _t(_rand(rng, 1, 2, S, d)).bfloat16()
    ref = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                              window=window)
    got = _emulate_tc_prefill(q, k, v, causal=causal, window=window)
    limit = _prefill_limit(q, k, v, ref, causal=causal, window=window)
    diff = (got - ref).abs()
    assert torch.isfinite(got).all()
    assert (diff <= limit).all(), (diff / limit).max().item()
    # the rounding is real: the emulation is not the plain version's bits
    assert diff.max().item() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefill_emulation_with_a_dropped_diagonal_key_fails_the_limit(seed):
    rng = np.random.default_rng(seed)
    q = _t(_rand(rng, 1, 4, 200, 32)).bfloat16()
    k = _t(_rand(rng, 1, 2, 200, 32)).bfloat16()
    v = _t(_rand(rng, 1, 2, 200, 32)).bfloat16()
    ref = flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    got = _emulate_tc_prefill(q, k, v, causal=True, window=0,
                              drop_diagonal=True)
    limit = _prefill_limit(q, k, v, ref, causal=True, window=0)
    assert ((got - ref).abs() / limit).max().item() > 10


def test_decode_splits_cover_every_valid_key_once():
    """decode_splits cuts [lo, length) into ranges that, taken as the kernel
    takes them, cover every valid key exactly once."""
    from repro_torch.kernels.decode_attention import MAX_SPLITS, decode_splits

    for window in (0, 64):
        for kv in range(1, 33):
            for length in range(0, 4097):
                lo, splits, per = decode_splits(length, window, kv, 128)
                assert lo == (max(0, length - window) if window else 0)
                assert 1 <= splits <= MAX_SPLITS and per >= 0
                covered, nxt = 0, lo
                for s in range(splits):
                    ks = min(lo + s * per, length)
                    ke = min(ks + per, length)
                    assert ks == nxt or ks == ke == length
                    covered += ke - ks
                    nxt = ke
                assert nxt == length and covered == length - lo


@pytest.mark.parametrize("length,window,KV,d", [(545, 0, 8, 128),
                                                (3, 0, 8, 128),
                                                (1000, 64, 32, 112),
                                                (0, 0, 2, 32)])
def test_decode_split_plan_does_not_depend_on_the_batch(length, window, KV,
                                                        d):
    """The cut takes no batch size and no tensor, so a lane's split, and
    with it its bits, is the same whoever else is in the batch; and the
    same integers give the same cut."""
    import inspect

    from repro_torch.kernels.decode_attention import decode_splits

    assert list(inspect.signature(decode_splits).parameters) == [
        "length", "window", "kv_heads", "head_dim"]
    assert len({decode_splits(length, window, KV, d) for _ in range(3)}) == 1
    lo, splits, per = decode_splits(length, window, KV, d)
    assert splits == min(16, max(1, -(-256 // KV)))


def _emulate_split_decode(q, k, v, length, window):
    """The decode kernel's schedule in float32: per split of
    decode_splits, an (m, l, acc) per head (m = -inf, l = 0, acc = 0 for
    an empty range), then the merge in split order with weights
    e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30)."""
    from repro_torch.kernels.decode_attention import decode_splits

    B, H, d = q.shape
    KV = k.shape[2]
    rep = H // KV
    lo, splits, per = decode_splits(length, window, KV, d)
    qh = q.float().reshape(B, KV, rep, d)
    parts = []
    for s in range(splits):
        ks = min(lo + s * per, length)
        ke = min(ks + per, length)
        if ke == ks:
            parts.append((torch.full((B, KV, rep), -np.inf),
                          torch.zeros(B, KV, rep),
                          torch.zeros(B, KV, rep, d)))
            continue
        sc = torch.einsum("bgrd,bsgd->bgrs", qh, k[:, ks:ke].float())
        sc = sc / np.sqrt(d)
        m = sc.amax(dim=-1)
        p = torch.exp(sc - m[..., None])
        acc = torch.einsum("bgrs,bsgd->bgrd", p, v[:, ks:ke].float())
        parts.append((m, p.sum(dim=-1), acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    f = [torch.where(torch.isfinite(m), torch.exp(m - mx), torch.zeros(()))
         for m, _, _ in parts]
    total = sum(l * fs for (_, l, _), fs in zip(parts, f))
    inv = 1.0 / total.clamp_min(1e-30)
    out = sum(acc * (fs * inv)[..., None] for (_, _, acc), fs in zip(parts, f))
    return out.reshape(B, H, d)


@pytest.mark.parametrize("S,length,window,H,KV,d", [
    (545, 545, 0, 40, 8, 128),       # sixteen splits of 35 keys
    (545, 3, 0, 40, 8, 128),         # fewer keys than splits: 13 empty
    (545, 0, 0, 40, 8, 128),         # no key at all: zeros
    (1033, 1000, 64, 40, 8, 128),    # a window
    (300, 300, 100, 16, 8, 256),
    (545, 545, 0, 32, 32, 112),      # zamba2's shared block
    (200, 137, 0, 4, 1, 32),         # one KV head: sixteen splits
])
def test_decode_split_merge_emulation_matches_plain_version(S, length, window,
                                                            H, KV, d):
    rng = np.random.default_rng(5)
    q = _t(_rand(rng, 2, H, d))
    k, v = _t(_rand(rng, 2, S, KV, d)), _t(_rand(rng, 2, S, KV, d))
    got = _emulate_split_decode(q, k, v, length, window)
    assert not torch.isnan(got).any()
    expect = decode_attention_ref(q, k, v, length, window=window)
    np.testing.assert_allclose(got.numpy(), expect.numpy(), **TOL)
    if length == 0:
        assert not got.any()
