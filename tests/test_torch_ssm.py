"""The port's SSM and hybrid families against the reference package's.

* The SSD chunk scan: the port's plain version (``ssd_scan_ref``, what the
  CUDA kernel's wrapper runs on CPU tensors) against the Pallas kernel in
  interpret mode and against the reference's own oracle, float32, at the
  reference's limit ``rtol = atol = 1e-4`` (``tests/test_kernels.py``);
  the CUDA kernel's three passes (state increments and ``C·Bᵀ``, the state
  recurrence, the outputs), written out in torch on its padded scratch
  layout, against the same two; and its shared-memory plan.
* ``ssd_chunked`` and ``_causal_conv`` against ``repro.models.ssm``'s.
* The scan's gradient (``SSDScanFn``, through ``ssd_chunked`` and on the
  kernel's layout) against ``jax.grad`` of the reference's
  ``ssd_chunked`` and ``ssd_scan_ref`` and against autograd through the
  float64 plain version, at ``SCAN_GRAD_RTOL``; and where the reference's
  gradient is NaN (a chunk decaying past ~88), the port's finite and equal
  to the float64 one.
* The reduced mamba2-2.7b and zamba2-7b through ``params_from_reference``:
  ``forward`` against the reference's and against a prefill and one
  decode step (``test_arch_smoke.py::test_decode_matches_forward``);
  an 80-token prompt (ragged at the reduced chunk of 32), then 8 decode
  steps, logits within ``1e-4`` and greedy tokens identical, as
  ``tests/test_torch_models.py`` does for qwen3.  The reference initialises
  ``a_log``, ``dt_bias``, ``d_skip`` and its norm scales at zero or one,
  and its zero ``ln1`` and ``final_norm`` zero every logit; the tree both
  packages use here has every 1-D leaf drawn from numpy instead, so the
  decay, step-size and skip paths are not trivial.
* The reduced zamba2 served: decode graphs on ``Session(2)`` against the
  plain loop, the engine against each request alone, and the port's engine
  against the reference's, with identical token streams.

Everything runs in float32 on the CPU, where the port's kernels take their
plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro
import repro_torch
from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jax_ops
from repro.kernels.ssd_scan import ssd_scan_ref as jax_ssd_scan_ref
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import ssm as jax_ssm
from repro.models.lm import layer_flags as jax_layer_flags
from repro.serving import ContinuousBatchingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.models import (build_decode_graph, cache_struct, decode_step,
                                forward, greedy_sample, init_params,
                                make_decode_state, n_attn_slots,
                                params_from_reference, prefill, zeros_cache)
from repro_torch.models.lm import layer_flags, logits_from_hidden, padded_vocab
from repro_torch.models.ssm import _causal_conv, ssd_chunked
from repro_torch.serving import ContinuousBatchingEngine, PoissonWorkload

RTOL = ATOL = 1e-4
#: the scan's gradients, float32 against float32 (the reference's, or
#: float64 autograd for the float32 port): the same products summed in
#: another order, at most a few float32 units of each leaf's largest entry
#: per term over sums of L N terms; 1e-4 of that entry, as
#: tests/test_torch_train.py's GRAD_RTOL
SCAN_GRAD_RTOL = 1e-4
PROMPT, STEPS, BATCH = 80, 8, 2
ARCHS = ("mamba2-2.7b", "zamba2-7b")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the SSD chunk scan
def _scan_inputs(B, nc, L, H, N, P, *, seed, steep=False, pad=0):
    """xdt, cs, Bm, Cm in the kernel's layout, float32 numpy.  ``steep``
    makes the model's decay (step sizes ~0.75, a = -1: cs falls to about
    -0.75 L across a chunk, so exp(cs_i - cs_j) above the diagonal
    overflows); ``pad`` zeroes the last chunk's last steps as the model's
    padding does (dt = 0: flat cs, zero xdt)."""
    rng = np.random.default_rng(seed)
    xdt = 0.2 * rng.standard_normal((B, nc, L, H, P))
    if steep:
        la = -(0.75 + 0.05 * rng.standard_normal((B, nc, L, H)))
    else:
        la = -0.05 * np.abs(rng.standard_normal((B, nc, L, H)))
    Bm = 0.3 * rng.standard_normal((B, nc, L, N))
    Cm = 0.3 * rng.standard_normal((B, nc, L, N))
    if pad:
        la[:, -1, L - pad:] = 0.0
        xdt[:, -1, L - pad:] = 0.0
        Bm[:, -1, L - pad:] = 0.0
        Cm[:, -1, L - pad:] = 0.0
    cs = np.cumsum(la, axis=2)
    return [a.astype(np.float32) for a in (xdt, cs, Bm, Cm)]


@pytest.mark.parametrize("B,nc,L,H,N,P,steep,pad", [
    (1, 3, 32, 4, 16, 32, False, 0),       # tests/test_kernels.py's shapes
    (2, 2, 64, 2, 32, 64, False, 0),
    (1, 3, 32, 4, 16, 32, False, 16),      # a padded last chunk
    (1, 1, 20, 4, 16, 32, False, 0),       # one short chunk, L = T < chunk
    (1, 2, 128, 2, 16, 32, True, 0),       # the model's decay: overflow above
])
def test_ssd_scan_ref_matches_pallas_kernel_and_oracle(B, nc, L, H, N, P,
                                                       steep, pad):
    arrays = _scan_inputs(B, nc, L, H, N, P, seed=3, steep=steep, pad=pad)
    y, s = ops.ssd_scan(*(torch.from_numpy(a) for a in arrays))
    assert y.shape == (B, nc, L, H, P) and y.dtype == torch.float32
    assert s.shape == (B, H, N, P) and s.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    jarrays = [jnp.asarray(a) for a in arrays]
    jy, js = jax_ops.ssd_scan(*jarrays, mode="interpret")
    oy, os_ = jax_ssd_scan_ref(*jarrays)
    for want_y, want_s in ((jy, js), (oy, os_)):
        np.testing.assert_allclose(_np(y), _np(want_y), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_np(s), _np(want_s), rtol=RTOL, atol=ATOL)
    assert launch_counts()["ssd_scan"] == 0          # CPU: the plain version


def test_ssd_scan_checks_its_inputs():
    xdt, cs, Bm, Cm = (torch.from_numpy(a) for a in
                       _scan_inputs(1, 2, 8, 2, 4, 32, seed=0))
    with pytest.raises(ValueError, match="cs must be"):
        ops.ssd_scan(xdt, cs[..., :1], Bm, Cm)
    with pytest.raises(ValueError, match="Cm must be"):
        ops.ssd_scan(xdt, cs, Bm, Cm[..., :3])
    with pytest.raises(TypeError, match="cs must be float32"):
        ops.ssd_scan(xdt, cs.double(), Bm, Cm)
    with pytest.raises(TypeError, match="Bm is torch.bfloat16"):
        ops.ssd_scan(xdt, cs, Bm.bfloat16(), Cm)


def _kernel_passes(xdt, cs, Bm, Cm):
    """The SSD kernel's decomposition (``csrc/ssd_scan.cu``) in torch, on
    its scratch layout: each chunk's ``(C·Bᵀ)ᵀ`` and ``Cᵀ`` stacked, with
    output row i in column ``(i % RS) * R + i // RS``, and its own state
    increment; then the state recurrence over the chunks, leaving the
    incoming state in the increments' place; then per head ``y = Aᵀᵀ ·
    [xdt; s_in]`` with ``Aᵀ`` built from the scratch, the decay masked
    before its exp, and the rows read back in slot order."""
    B, nc, L, H, P = xdt.shape
    N = Bm.shape[-1]
    cb_shape, st_shape = ss.scratch_shapes(B, nc, L, H, N, P)
    Lp, LR = -(-L // 16) * 16, cb_shape[-1]
    rs = 512 // (P // 4)
    R = LR // rs
    row = torch.tensor([(s % R) * rs + s // R for s in range(LR)])
    real = row < L
    cb = torch.zeros(cb_shape)
    gt = (Cm @ Bm.mT).mT                                  # (B, nc, k, i)
    cb[:, :, :L, real] = gt[:, :, :, row[real]]
    cb[:, :, Lp:Lp + N, real] = Cm.mT[:, :, :, row[real]]
    w_end = torch.exp(cs[:, :, -1:, :] - cs)
    st = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bm, w_end, xdt)
    assert st.shape == st_shape
    s = torch.zeros(B, H, N, P)
    for c in range(nc):
        inc = st[:, c].clone()
        st[:, c] = s
        s = s * torch.exp(cs[:, c, -1])[:, :, None, None] + inc
    zero = torch.zeros(())
    rows = row.clamp(max=L - 1)
    cs_row = cs[:, :, rows, :]                            # (B, nc, LR, H)
    keep = (torch.arange(L)[:, None] <= row[None, :]) & real[None, :]
    diff = cs_row[:, :, None, :, :] - cs[:, :, :, None, :]   # (.., k, s, H)
    w = torch.where(keep[None, None, :, :, None],
                    cb[:, :, :L, :, None]
                    * torch.exp(torch.where(keep[None, None, :, :, None],
                                            diff, zero)), zero)
    ec = torch.where(real[None, None, :, None], torch.exp(cs_row), zero)
    a_c = cb[:, :, Lp:Lp + N, :, None] * ec[:, :, None, :, :]
    y_slot = (torch.einsum("bcksh,bckhp->bcshp", w, xdt)
              + torch.einsum("bcnsh,bchnp->bcshp", a_c, st))
    y = torch.zeros_like(xdt)
    y[:, :, row[real]] = y_slot[:, :, real]
    return y, s


@pytest.mark.parametrize("B,nc,L,H,N,P,steep,pad", [
    (2, 3, 32, 4, 16, 32, False, 0),
    (1, 3, 32, 4, 16, 32, False, 16),      # a padded last chunk
    (1, 1, 20, 4, 16, 32, False, 0),       # L = 20: Lp = 32 in the scratch
    (1, 2, 128, 2, 16, 32, True, 0),       # the model's decay: overflow above
])
def test_ssd_kernel_decomposition_matches_pallas_kernel_and_oracle(
        B, nc, L, H, N, P, steep, pad):
    arrays = _scan_inputs(B, nc, L, H, N, P, seed=5, steep=steep, pad=pad)
    y, s = _kernel_passes(*(torch.from_numpy(a) for a in arrays))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    jarrays = [jnp.asarray(a) for a in arrays]
    jy, js = jax_ops.ssd_scan(*jarrays, mode="interpret")
    oy, os_ = jax_ssd_scan_ref(*jarrays)
    for want_y, want_s in ((jy, js), (oy, os_)):
        np.testing.assert_allclose(_np(y), _np(want_y), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_np(s), _np(want_s), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("L,N,P,fits", [
    (128, 64, 64, True),                   # zamba2-7b's prefill chunk
    (128, 128, 64, True),                  # mamba2-2.7b's
    (32, 16, 32, True),                    # the reduced configs
    (100, 64, 64, True),                   # a short prompt's one chunk
    (256, 128, 64, False),                 # 483 KB
    (128, 256, 64, False),
])
def test_ssd_kernel_plan_depends_on_shape_and_refuses_what_cannot_fit(
        L, N, P, fits):
    size = ss.smem_bytes(L, N, P)
    assert size == ss.smem_bytes(L, N, P)
    assert (size <= ss.MAX_SMEM_BYTES) == fits
    Lp, Np = -(-L // 16) * 16, -(-N // 16) * 16
    cb, st = ss.scratch_shapes(2, 3, L, 5, N, P)
    assert cb[:3] == (2, 3, Lp + Np) and cb[3] >= Lp and st == (2, 3, 5, N, P)
    if fits:                               # the output block holds Aᵀ
        assert size >= 4 * (Lp + Np) * cb[3]


@pytest.mark.parametrize("nc,H", [(4, 112), (4, 80), (32, 112), (1, 112),
                                  (3, 8), (1, 1), (200, 3)])
def test_ssd_chunk_groups_cover_every_head_once(nc, H):
    """The kernel's blocks take a chunk's heads in contiguous ranges [g H //
    groups, (g + 1) H // groups): each head once, no range empty, sizes
    within one of each other, at most one block per SM over the row."""
    groups = ss.chunk_groups(nc, H)
    assert groups == ss.chunk_groups(nc, H) and 1 <= groups <= H
    ranges = [range(g * H // groups, (g + 1) * H // groups)
              for g in range(groups)]
    assert [h for r in ranges for h in r] == list(range(H))
    sizes = {len(r) for r in ranges}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert nc * groups <= max(ss.TARGET_BLOCKS, nc)


def test_ssd_chunk_groups_at_the_prefill_shapes_and_refuse_empty_scans():
    assert ss.chunk_groups(4, 112) == 28           # zamba2-7b: 112 blocks
    assert ss.chunk_groups(4, 80) == 27            # mamba2-2.7b: 108 blocks
    assert ss.chunk_groups(32, 112) == 4           # T = 4096: 128 blocks
    assert ss.chunk_groups(1, 8) == 8              # fewer heads than SMs
    for nc, H in ((0, 4), (4, 0)):
        with pytest.raises(ValueError, match="empty scan"):
            ss.chunk_groups(nc, H)


@pytest.mark.parametrize("T,chunk", [(96, 32), (80, 32), (20, 32)])
def test_ssd_chunked_matches_the_reference(T, chunk):
    B, H, P, N = 2, 3, 16, 8
    rng = np.random.default_rng(4)
    xs = (0.3 * rng.standard_normal((B, T, H, P))).astype(np.float32)
    dt = (0.75 + 0.1 * rng.standard_normal((B, T, H))).astype(np.float32)
    a = (-np.exp(0.3 * rng.standard_normal(H))).astype(np.float32)
    Bm = (0.3 * rng.standard_normal((B, T, N))).astype(np.float32)
    Cm = (0.3 * rng.standard_normal((B, T, N))).astype(np.float32)
    y, s = ssd_chunked(*(torch.from_numpy(x) for x in (xs, dt, a, Bm, Cm)),
                       chunk=chunk)
    jy, js = jax_ssm.ssd_chunked(*(jnp.asarray(x) for x in (xs, dt, a, Bm,
                                                             Cm)),
                                 chunk=chunk)
    assert y.shape == (B, T, H, P) and s.shape == (B, H, N, P)
    np.testing.assert_allclose(_np(y), _np(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(s), _np(js), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T", [1, 2, 9])
def test_causal_conv_matches_the_reference(T, with_state):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, T, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32) if with_state \
        else None
    y, ns = _causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                         None if st is None else torch.from_numpy(st))
    jy, jns = jax_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_np(ns), _np(jns))


# ---------------------------------------------------------------------------
# the SSD scan's gradient
def _assert_grads_close(got, want, names, what):
    """Each gradient within SCAN_GRAD_RTOL of its leaf's largest entry, and
    finite."""
    for name, g, w in zip(names, got, want):
        g, w = _np(g).astype(np.float64), np.asarray(w, dtype=np.float64)
        assert np.isfinite(g).all(), f"{what}: d{name} is not finite"
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=SCAN_GRAD_RTOL * scale,
                                   err_msg=f"{what}: d{name}")


def _chunked_inputs(B, T, H, N, P, *, seed, dt_scale=0.1, a=None):
    """xs, dt, a, Bm, Cm of ``ssd_chunked`` as an SSM layer makes them
    (silu'd x, B and C; dt = softplus(dt_scale N(0, 1) + 0.5)), float32
    numpy; ``a`` defaults to rates around -0.3."""
    rng = np.random.default_rng(seed)

    def silu(x):
        return x / (1.0 + np.exp(-x))

    xs = silu(rng.standard_normal((B, T, H, P)))
    dt = np.log1p(np.exp(dt_scale * rng.standard_normal((B, T, H)) + 0.5))
    if a is None:
        a = -0.3 * np.exp(0.3 * rng.standard_normal(H))
    Bm, Cm = silu(rng.standard_normal((B, T, N))), silu(
        rng.standard_normal((B, T, N)))
    return [np.asarray(x, dtype=np.float32) for x in (xs, dt, a, Bm, Cm)]


def _ssd_chunked_f64(xs, dt, a, Bm, Cm, *, chunk):
    """``ssd_chunked`` in float64: ``ssd_scan_inputs``' padding, cumulative
    sum and ``xs * dt`` written out in float64, then the plain scan, which
    runs float64 inputs in float64 (its ``where`` after the ``exp`` is safe
    there: ``exp(cs_i - cs_j)`` stays finite to 709)."""
    Bsz, T, H, P = xs.shape
    N = Bm.shape[-1]
    L = min(chunk, T)
    nc = -(-T // L)
    pad = nc * L - T
    xs = F.pad(xs, (0, 0, 0, 0, 0, pad)).reshape(Bsz, nc, L, H, P)
    dt = F.pad(dt, (0, 0, 0, pad)).reshape(Bsz, nc, L, H)
    Bm = F.pad(Bm, (0, 0, 0, pad)).reshape(Bsz, nc, L, N)
    Cm = F.pad(Cm, (0, 0, 0, pad)).reshape(Bsz, nc, L, N)
    y, s = ssd_scan_ref(xs * dt[..., None], torch.cumsum(dt * a, dim=2),
                        Bm, Cm)
    return y.reshape(Bsz, nc * L, H, P)[:, :T], s


def _weights(shape_y, shape_s, seed, with_final):
    rng = np.random.default_rng(seed)
    wy = rng.standard_normal(shape_y).astype(np.float32)
    ws = (rng.standard_normal(shape_s).astype(np.float32) if with_final
          else np.zeros(shape_s, np.float32))
    return wy, ws


def _port_chunked_grads(arrays, wy, ws, chunk, dtype=torch.float32):
    """The gradients of sum(y * wy) + sum(final * ws) with respect to xs,
    dt, a, Bm and Cm, through the port's ``ssd_chunked`` (float32, the
    scan's Function) or ``_ssd_chunked_f64`` (float64 autograd).  With
    ``ws`` zero the final state is left out of the loss, so its gradient
    reaches the Function as None."""
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_() for x in arrays]
    fn = ssd_chunked if dtype == torch.float32 else _ssd_chunked_f64
    y, s = fn(*leaves, chunk=chunk)
    loss = (y * torch.from_numpy(wy).to(dtype)).sum()
    if ws.any():
        loss = loss + (s * torch.from_numpy(ws).to(dtype)).sum()
    return torch.autograd.grad(loss, leaves)


def _jax_chunked_grads(arrays, wy, ws, chunk):
    def loss(*args):
        y, s = jax_ssm.ssd_chunked(*args, chunk=chunk)
        return jnp.sum(y * wy) + jnp.sum(s * ws)
    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(x) for x in arrays))


CHUNKED_NAMES = ("xs", "dt", "a", "Bm", "Cm")


@pytest.mark.parametrize("B,T,H,N,P,chunk,with_final", [
    (1, 96, 3, 8, 16, 32, False),          # three chunks, the state unused
    (2, 80, 2, 8, 16, 32, True),           # ragged, B > 1, a state gradient
    (2, 20, 3, 4, 8, 32, True),            # one short chunk, L = T
])
def test_ssd_chunked_gradients_match_jax_grad_and_float64(B, T, H, N, P,
                                                          chunk, with_final):
    """``ssd_chunked``'s gradients through the scan's Function (and the
    padding, cumulative sum and casts around it) against ``jax.grad`` of
    the reference's ``ssd_chunked`` and against autograd through its
    float64 formulation, where the reference is finite (decay rates near
    -0.3: a chunk's decay stays far below 88)."""
    arrays = _chunked_inputs(B, T, H, N, P, seed=6)
    wy, ws = _weights((B, T, H, P), (B, H, N, P), 7, with_final)
    got = _port_chunked_grads(arrays, wy, ws, chunk)
    ref = _jax_chunked_grads(arrays, wy, ws, chunk)
    f64 = _port_chunked_grads(arrays, wy, ws, chunk, torch.float64)
    assert all(np.isfinite(np.asarray(r)).all() for r in ref)
    _assert_grads_close(got, ref, CHUNKED_NAMES, "port vs jax.grad")
    _assert_grads_close(got, f64, CHUNKED_NAMES, "port vs float64")
    assert launch_counts()["ssd_scan"] == 0          # CPU: the plain version


@pytest.mark.parametrize("B,nc,L,H,N,P,steep,pad", [
    (2, 3, 32, 4, 16, 32, False, 0),
    (1, 3, 32, 4, 16, 32, False, 16),      # a padded last chunk
    (1, 2, 64, 2, 8, 16, True, 0),         # steep, but below exp's overflow
])
def test_ssd_scan_gradients_match_jax_grad_and_float64(B, nc, L, H, N, P,
                                                      steep, pad):
    """``SSDScanFn`` on the kernel's layout against ``jax.grad`` of the
    reference's ``ssd_scan_ref`` and against autograd through the float64
    plain version, with gradients of both y and the final state;
    ``ssd_scan_bwd`` in float64 is that autograd to rounding."""
    arrays = _scan_inputs(B, nc, L, H, N, P, seed=8, steep=steep, pad=pad)
    wy, ws = _weights((B, nc, L, H, P), (B, H, N, P), 9, True)
    leaves = [torch.from_numpy(x).requires_grad_() for x in arrays]
    y, s = ss.ssd_scan(*leaves)
    got = torch.autograd.grad((y * torch.from_numpy(wy)).sum()
                              + (s * torch.from_numpy(ws)).sum(), leaves)

    def loss(*args):
        y, s = jax_ssd_scan_ref(*args)
        return jnp.sum(y * wy) + jnp.sum(s * ws)
    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        *(jnp.asarray(x) for x in arrays))
    d64 = [torch.from_numpy(x).double().requires_grad_() for x in arrays]
    y, s = ssd_scan_ref(*d64)
    dy, dfinal = torch.from_numpy(wy).double(), torch.from_numpy(ws).double()
    f64 = torch.autograd.grad((y * dy).sum() + (s * dfinal).sum(), d64)
    names = ("xdt", "cs", "Bm", "Cm")
    _assert_grads_close(got, ref, names, "port vs jax.grad")
    _assert_grads_close(got, f64, names, "port vs float64")
    exact = ss.ssd_scan_bwd(*(t.detach() for t in d64), dy, dfinal)
    for name, g, w in zip(names, exact, f64):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12,
                                   msg=lambda m, n=name: f"d{n}: {m}")


def test_ssd_gradient_is_finite_where_the_reference_is_nan():
    """The reference's fault (ROADMAP Queue C item C7): past a chunk decay
    of ~88, ``exp(cs_i - cs_j)`` above the diagonal overflows, and
    ``where(mask, exp(diff), 0)``'s gradient multiplies that inf by 0, so
    ``jax.grad`` of ``ssd_chunked`` gives NaN in dt's and a's gradients
    (xs's, Bm's and Cm's stay finite).  The port masks before the exp: its
    gradients are all finite, equal to the float64 formulation's (where
    the overflow never happens) and to the reference's where that is
    finite.  Chunk 128, as published, with a = -1 and step sizes near
    0.97: a chunk decays by ~124."""
    chunk, B, T, H, N, P = 128, 1, 256, 2, 8, 16
    arrays = _chunked_inputs(B, T, H, N, P, seed=10,
                             a=-np.ones(H, np.float32))
    decay = -np.cumsum(arrays[1] * arrays[2], axis=1)
    assert decay[:, chunk - 1].min() > 88 and decay[:, T - 1].min() > 176
    wy, ws = _weights((B, T, H, P), (B, H, N, P), 11, True)
    ref = [np.asarray(r) for r in _jax_chunked_grads(arrays, wy, ws, chunk)]
    assert not np.isfinite(ref[1]).all() and not np.isfinite(ref[2]).all()
    for i in (0, 3, 4):
        assert np.isfinite(ref[i]).all()
    got = _port_chunked_grads(arrays, wy, ws, chunk)
    f64 = _port_chunked_grads(arrays, wy, ws, chunk, torch.float64)
    _assert_grads_close(got, f64, CHUNKED_NAMES, "port vs float64")
    for i in (0, 3, 4):
        _assert_grads_close([got[i]], [ref[i]], [CHUNKED_NAMES[i]],
                            "port vs jax.grad where finite")


# ---------------------------------------------------------------------------
# the reduced models
def ssm_reference_tree(cfg, seed: int = 0):
    """The reference's initial parameters as numpy, with every 1-D leaf
    (stacked: every per-layer vector) drawn from numpy: norm scales near
    one, ``a_log``, ``dt_bias`` and ``d_skip`` around zero."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))

    def fix(path, x):
        name = path[-1].key
        stacked = path[0].key == "blocks"
        if x.ndim - stacked != 1:
            return x
        noise = rng.standard_normal(x.shape)
        if name in ("a_log", "dt_bias", "d_skip"):
            return (0.5 * noise).astype(x.dtype)
        return (1.0 + 0.1 * noise).astype(x.dtype)

    return jax.tree_util.tree_map_with_path(fix, tree)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(cfg, tcfg, the port's LM, reference params)."""
    cfg = jax_get_config(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    tree = ssm_reference_tree(cfg)
    model = params_from_reference(tcfg, tree, device="cpu")
    return cfg, tcfg, model, jax.tree.map(jnp.asarray, tree)


def _prompt(cfg, batch=BATCH, length=PROMPT, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, length), dtype=np.int32)


def test_layout_matches_the_reference(pair):
    cfg, tcfg, model, _ = pair
    tree = ssm_reference_tree(cfg)
    names = dict(model.named_parameters())
    for i in range(cfg.n_layers):
        for leaf in ("wx", "a_log", "conv_x", "norm"):
            assert torch.equal(names[f"blocks.{i}.ssm.{leaf}"],
                               torch.from_numpy(tree["blocks"]["ssm"][leaf][i]))
    if cfg.family == "hybrid":
        assert torch.equal(names["shared.attn.wq"],
                           torch.from_numpy(tree["shared"]["attn"]["wq"]))
        ref_flags = jax_layer_flags(cfg)
        flags = layer_flags(tcfg)
        assert flags["use_attn"] == np.asarray(ref_flags["use_attn"]).tolist()
        assert flags["attn_slot"] == np.asarray(ref_flags["attn_slot"]).tolist()
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(np.asarray(x).size for x in jax.tree.leaves(tree))
    from repro.models.lm import cache_struct as jax_cache_struct
    ref = jax_cache_struct(cfg, 2, 9)
    ours = cache_struct(tcfg, 2, 9)
    assert sorted(ours) == sorted(ref)
    for name, (shape, dt) in ours["ssm"].items():
        assert shape == ref["ssm"][name].shape
        assert str(dt).split(".")[-1] == str(ref["ssm"][name].dtype)
    if "k" in ref:
        assert ours["k"][0] == ref["k"].shape
        assert ours["k"][0][0] == n_attn_slots(tcfg)


def test_prefill_and_decode_match_the_reference(pair):
    cfg, tcfg, model, jparams = pair
    tokens = _prompt(cfg)
    max_len = PROMPT + STEPS + 1
    jpre = jax.jit(lambda p, b: jax_prefill(p, cfg, b, None, max_len=max_len))
    jdec = jax.jit(lambda p, c, t: jax_decode_step(p, cfg, c, t, None))
    jcache, jlogits = jpre(jparams, {"tokens": jnp.asarray(tokens)})
    cache, logits = prefill(model, tcfg, {"tokens": tokens}, max_len=max_len)
    assert logits.shape == (BATCH, 1, padded_vocab(tcfg))
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=RTOL, atol=ATOL)
    for name in ("ssm", "conv_x", "conv_b", "conv_c"):
        np.testing.assert_allclose(_np(cache["ssm"][name]),
                                   _np(jcache["ssm"][name]),
                                   rtol=RTOL, atol=ATOL)
    if cfg.family == "hybrid":
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
    np.testing.assert_allclose(_np(cache["ssm"]["ssm"]),
                               _np(jcache["ssm"]["ssm"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(),
                                  np.concatenate(jtoks, 1))
    # the streams are not degenerate: the random leaves give real logits
    assert len(np.unique(torch.cat(toks, 1).numpy())) > 1


def test_decode_matches_forward_and_the_reference(pair):
    """The port of ``tests/test_arch_smoke.py::test_decode_matches_forward``:
    a prefill of ``PROMPT - 1`` tokens and one decode step give the logits
    of ``forward`` over all ``PROMPT`` at the last position (the chunked
    scan against the recurrent step), within ``RTOL``; and ``forward``'s
    hidden states equal the reference's (scoring, no gradient)."""
    cfg, tcfg, model, jparams = pair
    tokens = _prompt(cfg)
    s0 = PROMPT - 1
    cache, _ = prefill(model, tcfg, {"tokens": tokens[:, :s0]},
                       max_len=PROMPT + 1)
    _, dec = decode_step(model, tcfg, cache,
                         torch.from_numpy(tokens[:, s0:]).long())
    with torch.no_grad():
        h = forward(model, tcfg, {"tokens": tokens})
        full = logits_from_hidden(model, tcfg, h)
    assert h.shape == (BATCH, PROMPT, tcfg.d_model)
    np.testing.assert_allclose(_np(dec[:, 0]), _np(full[:, s0]), rtol=RTOL,
                               atol=ATOL)
    jh = jax_forward(jparams, cfg, {"tokens": jnp.asarray(tokens)}, None)
    np.testing.assert_allclose(_np(h), _np(jh), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_an_ssm_cache_that_never_fills(arch):
    cfg = get_config(arch).reduced()
    model = init_params(cfg, seed=0, device="cpu")
    names = dict(model.named_parameters())
    for n in ("blocks.0.ln1", "blocks.0.ssm.norm", "final_norm"):
        assert torch.equal(names[n], torch.ones_like(names[n]))
    for n in ("blocks.0.ssm.a_log", "blocks.0.ssm.dt_bias",
              "blocks.0.ssm.d_skip"):
        assert not names[n].any()
    # a cache of 3 positions: the prompt fills it, so only an ssm model,
    # whose state has no length, can decode on
    cache, logits = prefill(model, cfg, {"tokens": _prompt(cfg, 1, 3)},
                            max_len=3)
    assert torch.isfinite(logits).all() and logits.abs().max() > 0
    tok = greedy_sample(logits)
    if cfg.family == "hybrid":
        with pytest.raises(ValueError, match="the cache is full"):
            decode_step(model, cfg, cache, tok)
    else:
        assert "k" not in cache
        for _ in range(2):
            cache, logits = decode_step(model, cfg, cache, tok)
            tok = greedy_sample(logits)
        assert cache["index"] == 5 and torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_default_to_cuda_and_raise_without_it(arch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    cfg = get_config(arch).reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zeros_cache(cfg, 1, 8)
    model = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_decode_state(model, cfg, {"tokens": _prompt(cfg)}, n_shards=2,
                          max_len=PROMPT + 2)


# ---------------------------------------------------------------------------
# the reduced zamba2 served
PROMPT_LEN, BUDGET = (36, 72), (2, 6)
MAX_LEN = PROMPT_LEN[1] + BUDGET[1] + 1


@pytest.fixture(scope="module")
def zamba():
    cfg = jax_get_config("zamba2-7b").reduced()
    tcfg = get_config("zamba2-7b").reduced()
    tree = ssm_reference_tree(cfg)
    model = params_from_reference(tcfg, tree, device="cpu")
    return cfg, tcfg, model, jax.tree.map(jnp.asarray, tree)


def _port_engine(session, tcfg, model, **kw):
    return ContinuousBatchingEngine(
        session,
        lambda cache, tok: decode_step(model, tcfg, cache, tok),
        lambda prompt: prefill(model, tcfg, {"tokens": prompt},
                               max_len=MAX_LEN),
        step_time=0.01, **kw)


def test_decode_graph_matches_the_plain_loop(zamba):
    """make_decode_state + build_decode_graph on a 2-worker session give
    the plain decode loop's tokens, bit for bit, at one lane per shard."""
    _, tcfg, model, _ = zamba
    prompts = _prompt(tcfg, 4, 45)
    steps, max_len = 6, 45 + 6 + 1
    state = make_decode_state(model, tcfg, {"tokens": prompts}, n_shards=4,
                              max_len=max_len, device="cpu")
    with repro_torch.Session(2) as s:
        for _ in range(steps - 1):
            s.run(build_decode_graph(
                state, lambda p, c, t: decode_step(p, tcfg, c, t)))
    loop = []
    for b in range(4):
        cache, logits = prefill(model, tcfg, {"tokens": prompts[b:b + 1]},
                                max_len=max_len)
        tok = greedy_sample(logits)
        toks = [tok]
        for _ in range(steps - 1):
            cache, logits = decode_step(model, tcfg, cache, tok)
            tok = greedy_sample(logits)
            toks.append(tok)
        loop.append(torch.cat(toks, 1))
    assert state.tokens().shape == (4, steps)
    assert torch.equal(state.tokens(), torch.cat(loop, 0))


def test_engine_serves_the_reference_engines_token_streams(zamba):
    cfg, tcfg, model, jparams = zamba
    workload = PoissonWorkload(100.0, 6, seed=0, prompt_len=PROMPT_LEN,
                               max_new_tokens=BUDGET,
                               vocab_size=cfg.vocab_size)
    jpre = jax.jit(lambda p, b: jax_prefill(p, cfg, b, None, max_len=MAX_LEN))
    jdec = jax.jit(lambda p, c, t: jax_decode_step(p, cfg, c, t, None))
    with repro.Session(2) as s:
        ref = JaxEngine(s, lambda c, t: jdec(jparams, c, t),
                        lambda prompt: jpre(jparams, {"tokens": prompt}),
                        max_batch=3, step_time=0.01).run(workload.requests())
    with repro_torch.Session(2) as s:
        ours = _port_engine(s, tcfg, model, max_batch=3).run(
            workload.requests())
    with repro_torch.Session(2) as s:
        alone = _port_engine(s, tcfg, model, max_batch=1).run(
            workload.requests())
    assert ours.tokens_by_rid() == ref.tokens_by_rid()
    assert ours.tokens_by_rid() == alone.tokens_by_rid()
    assert ours.shape_counts == ref.shape_counts
    assert ours.completed == 6 and max(ours.shape_counts) > 1
