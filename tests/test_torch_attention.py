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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import layers as jax_layers
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
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


def test_flash_wrapper_refuses_what_prefill_does_not_call():
    q = torch.zeros(1, 2, 8, 16)
    kv = torch.zeros(1, 1, 6, 16)
    with pytest.raises(NotImplementedError, match="Queue B item 3"):
        flash_attention(q, kv, kv)
    with pytest.raises(NotImplementedError, match="q_offset"):
        flash_attention(q, q[:, :1], q[:, :1], q_offset=4)
    with pytest.raises(ValueError, match="group"):
        flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), q.double(), q.double())


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
