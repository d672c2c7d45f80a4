"""The optimizer's CUDA kernel (``kernels/csrc/adamw.cu``) on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; each is marked ``cuda``
and skips where ``torch.cuda.is_available()`` is false.  The file imports
no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_adamw_cuda.py

The kernel is held to the chunked torch ops of ``optim/adamw.py`` (its
plain version) bit for bit, given the same clip scale; its norm to a
float64 norm; and two planted faults, built from a copy of the source,
must fail the same check.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import adamw as K
from repro_torch.kernels import cuda_lib, launch_counts
from repro_torch.optim import adamw as A

pytestmark = pytest.mark.cuda

CFG = A.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10, clip_norm=1.0,
                    weight_decay=0.1)
#: a bf16 gradient's sizes: one element, a few, a ragged vector count, and
#: more than one chunk of the plain version
SIZES = [1, 7, 4097, (1 << 25) + 3]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _leaf(n, p_dtype, g_dtype, dev, seed, offsets=(0, 0, 0, 0)):
    """p, g, m, v of ``n`` elements, each a view at its offset into a flat
    buffer: p ~ N(0, 1), g ~ 3 N(0, 1), m ~ 0.1 N(0, 1), v ~ 0.01 |N|."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for (scale, dt, absolute), off in zip(
            ((1.0, p_dtype, False), (3.0, g_dtype, False),
             (0.1, torch.float32, False), (0.01, torch.float32, True)),
            offsets):
        flat = torch.randn(n + off, generator=gen, device=dev) * scale
        if absolute:
            flat = flat.abs()
        out.append(flat.to(dt)[off:off + n])
    return out


def _scalars(dev, step=3):
    """lr and the bias corrections as ``optim/adamw.py`` forms them."""
    step = torch.tensor(step, dtype=torch.int32, device=dev)
    stepf = step.float()
    return (A.lr_schedule(CFG, step), 1 - CFG.b1 ** stepf,
            1 - CFG.b2 ** stepf)


def _plain_scale(g, max_norm):
    return A._clip_scale(A._squares([("g", g)], None), max_norm, None)[1]


def _both(p, g, m, v, max_norm=1.0):
    """The leaf after the plain version and after the kernel, from the
    same start and the plain version's clip scale."""
    dev = p.device
    lr, bc1, bc2 = _scalars(dev)
    scale = _plain_scale(g, max_norm)
    plain = [t.clone() for t in (p, g, m, v)]
    A._clip_(plain[1], scale)
    A._plain_leaf(CFG, *plain, lr, bc1, bc2)
    fused = [t.clone() for t in (p, g, m, v)]
    assert K.takes(*fused)
    before = launch_counts()["adamw"]
    K.update(*fused, scale, lr, bc1, bc2, CFG.b1, CFG.b2, CFG.eps,
             CFG.weight_decay)
    torch.cuda.synchronize()
    assert launch_counts()["adamw"] == before + 1
    assert torch.equal(fused[1], g)         # the gradient is only read
    return plain, fused


def _same_bits(plain, fused):
    for name, a, b in zip("pmv", (plain[0], plain[2], plain[3]),
                          (fused[0], fused[2], fused[3])):
        if not torch.equal(a, b):
            bad = (a != b).nonzero()
            return f"{name}: {bad.numel()} elements differ, first {bad[:3]}"
    return None


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p_dtype", ["bfloat16", "float32"])
def test_kernel_update_is_bit_identical_to_the_plain_version(
        cuda, p_dtype, g_dtype, n):
    """Given the plain version's clip scale (well below 1 here), the
    kernel's p, m and v have the plain version's bits."""
    p, g, m, v = _leaf(n, getattr(torch, p_dtype), getattr(torch, g_dtype),
                       cuda, seed=n)
    plain, fused = _both(p, g, m, v, max_norm=0.5)
    assert _same_bits(plain, fused) is None, _same_bits(plain, fused)
    assert not torch.equal(plain[2], m)


@pytest.mark.parametrize("offsets", [
    (3, 3, 3, 3),       # all alike: a scalar head, vectors, a scalar tail
    (0, 5, 0, 0),       # the gradient alone misaligned: read one by one
    (1, 2, 3, 0),       # p, m and v unlike: every element one by one
])
@pytest.mark.parametrize("p_dtype", ["bfloat16", "float32"])
def test_kernel_takes_views_at_odd_offsets(cuda, p_dtype, offsets):
    """Views into flat buffers at odd element offsets, as a bucket's
    gradients lie in its flat buffer."""
    for n in (13, 4097, 100_003):
        p, g, m, v = _leaf(n, getattr(torch, p_dtype), torch.float32, cuda,
                           seed=n, offsets=offsets)
        plain, fused = _both(p, g, m, v)
        assert _same_bits(plain, fused) is None, (n, _same_bits(plain, fused))


@pytest.mark.parametrize("p_dtype", ["bfloat16", "float32"])
def test_adamw_update_equals_the_plain_update_over_steps(cuda, p_dtype):
    """Whole updates of a three-leaf tree, three steps, through
    ``adamw_update`` and ``adamw_update_ref``: with the clip at rest (a
    norm far below ``clip_norm``, so both scales are exactly 1) every
    parameter, m and v keeps the same bits; the norms agree to 1e-6."""
    dt = getattr(torch, p_dtype)
    gen = torch.Generator(device=cuda).manual_seed(5)
    shapes = {"w": (301, 17), "b": (17,), "norm": (4099,)}

    class Leaves(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, s in shapes.items():
                setattr(self, k, torch.nn.Parameter(
                    torch.randn(s, generator=gen, device=cuda).to(dt),
                    requires_grad=False))

    fused_tree = Leaves()
    plain_tree = Leaves()
    plain_tree.load_state_dict(fused_tree.state_dict())
    cfg = A.AdamWConfig(lr=1e-3, warmup_steps=1, clip_norm=1e30)
    sf, sp = A.adamw_init(fused_tree), A.adamw_init(plain_tree)
    for _ in range(3):
        grads = {k: torch.randn(s, generator=gen, device=cuda)
                 for k, s in shapes.items()}
        _, sf, inf = A.adamw_update(cfg, fused_tree,
                                    {k: g.clone() for k, g in grads.items()},
                                    sf)
        _, sp, inp = A.adamw_update_ref(cfg, plain_tree, grads, sp)
        np.testing.assert_allclose(float(inf["grad_norm"]),
                                   float(inp["grad_norm"]), rtol=1e-6)
    for k in shapes:
        assert torch.equal(getattr(fused_tree, k), getattr(plain_tree, k)), k
        assert torch.equal(sf["m"][k], sp["m"][k]), k
        assert torch.equal(sf["v"][k], sp["v"][k]), k


@pytest.mark.parametrize("p_dtype", ["bfloat16", "float32"])
def test_bf16_gradient_clip_on_the_card_is_the_hosts(cuda, p_dtype):
    """A bfloat16 gradient with a clip scale that bfloat16 cannot hold:
    ``clip_by_global_norm`` on the card rounds the float32 product once,
    as the host and the reference do, and the kernel's update from the
    unclipped gradient has the bits of the plain update on the card from
    the host's clipped one, given that scale.  (The update is compared on
    the card: the host's ``torch.sqrt`` of a float32 tensor is not
    correctly rounded in every element, the card's is.)"""
    p, g, m, v = _leaf(100_003, getattr(torch, p_dtype), torch.bfloat16,
                       cuda, seed=21, offsets=(3, 3, 3, 3))
    grads, gn = A.clip_by_global_norm({"g": g.clone()}, 0.7)
    scale = torch.clamp(0.7 / torch.clamp(gn, min=1e-12), max=1.0)
    assert scale.item() < 1.0
    assert scale.bfloat16().float().item() != scale.item()
    want = (g.cpu().float() * scale.cpu()).to(torch.bfloat16)
    assert torch.equal(grads["g"].cpu(), want)
    lr, bc1, bc2 = _scalars(cuda)
    plain = [t.clone() for t in (p, want.to(cuda), m, v)]
    A._plain_leaf(CFG, *plain, lr, bc1, bc2)
    fused = [t.clone() for t in (p, g, m, v)]
    K.update(*fused, scale, lr, bc1, bc2, CFG.b1, CFG.b2, CFG.eps,
             CFG.weight_decay)
    wrong = _same_bits(plain, fused)
    assert wrong is None, wrong


def test_norm_agrees_with_float64_and_repeats_its_bits(cuda):
    """The norm pass over leaves of every size, bf16 and float32, views at
    odd offsets, with ``shares`` weights: within 1e-6 of the float64
    weighted norm, and the same bits on a second run."""
    leaves, weights = [], []
    for i, n in enumerate(SIZES + [778_567]):
        for dt in (torch.float32, torch.bfloat16):
            _, g, _, _ = _leaf(n, torch.float32, dt, cuda, seed=7 + i,
                               offsets=(0, i % 3, 0, 0))
            leaves.append(g)
            weights.append((0.25, 1.0, 0.5)[i % 3])
    before = launch_counts()["adamw"]
    sq = K.sum_squares(leaves, weights)
    again = K.sum_squares(leaves, weights)
    torch.cuda.synchronize()
    assert launch_counts()["adamw"] == before + 2 * (len(leaves) + 1)
    want = sum(w * float((g.double() ** 2).sum())
               for g, w in zip(leaves, weights))
    assert abs(float(sq) ** 0.5 - want ** 0.5) <= 1e-6 * want ** 0.5
    assert torch.equal(sq, again)
    # the weights are taken: halving every weight halves the sum
    half = K.sum_squares(leaves, [w / 2 for w in weights])
    np.testing.assert_allclose(float(half), float(sq) / 2, rtol=1e-6)


def test_reduced_train_step_goes_through_the_kernel(cuda):
    """qwen3-14b's reduced config cut to 2 layers, bf16 on the card: three
    hybrid steps of 2 microbatches through the kernel and through the
    plain version from one start.  The losses agree to 1e-5 and the
    parameters to a bf16 unit but where an Adam step turns a gradient's
    sign near zero into a whole lr (the norms differ in their last bits);
    the span counters put every element on the kernel's path."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models import LM, init_params
    from repro_torch.obs import span_trace
    from repro_torch.obs import spans
    from repro_torch.train import StepConfig, make_train_step

    cfg = get_config("qwen3-14b").reduced(n_layers=2, dtype="bfloat16")
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      global_batch=4, seed=1))
    opt_cfg = A.AdamWConfig(lr=1e-3, warmup_steps=0)
    step = make_train_step(cfg, opt_cfg, None,
                           StepConfig(microbatches=2, overlap="hybrid"))
    fused = init_params(cfg, seed=0)
    plain = LM(cfg, cuda)
    plain.load_state_dict(fused.state_dict())
    n_params = sum(p.numel() for p in fused.parameters())
    sf, sp = A.adamw_init(fused), A.adamw_init(plain)
    losses = {"fused": [], "plain": []}
    for i in range(3):
        batch = data.batch_at(i)
        call = spans.open_call("test.step", traced=True)
        try:
            fused, sf, mf = step(fused, sf, batch)
        finally:
            call.close()
        counters = span_trace().counters
        assert counters["repro.optim.fused_params"] == n_params
        assert counters["repro.optim.plain_params"] == 0
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("repro_torch.train.steps.adamw_update",
                       A.adamw_update_ref)
            plain, sp, mp_ = step(plain, sp, batch)
        losses["fused"].append(float(mf["loss"]))
        losses["plain"].append(float(mp_["loss"]))
        np.testing.assert_allclose(float(mf["grad_norm"]),
                                   float(mp_["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(losses["fused"], losses["plain"], rtol=1e-5)
    diff = torch.cat([(p.float() - plain.get_parameter(n).float()).abs()
                      .ravel() for n, p in fused.named_parameters()])
    assert diff.max().item() <= 3 * 2 * opt_cfg.lr
    assert (diff > 1e-2 * opt_cfg.lr).float().mean().item() <= 1e-3
    assert torch.equal(sf["step"], sp["step"])


#: planted faults: (source text, replacement), each found exactly once
FAULTS = {
    "skip a leaf's last element": (
        "if (tid < n - body_end) update_at",
        "if (tid < n - body_end - 1) update_at"),
    "drop weight decay": (
        "delta = __fadd_rn(delta, __fmul_rn(p, c.wd));",
        "delta = __fadd_rn(delta, __fmul_rn(p, 0.0f));"),
}


@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_planted_faults_fail_the_bit_check(cuda, fault, monkeypatch,
                                           tmp_path):
    """A copy of the source with a fault written in, built apart, fails
    the bit-identity check at a ragged size; the copy without one passes
    in the same harness."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in cuda_lib.CSRC.glob("*.cuh"):
        (csrc / f.name).write_text(f.read_text())
    text = (cuda_lib.CSRC / "adamw.cu").read_text()
    if fault is not None:
        old, new = FAULTS[fault]
        assert text.count(old) == 1, fault
        text = text.replace(old, new)
    (csrc / "adamw.cu").write_text(text)
    monkeypatch.setattr(cuda_lib, "CSRC", csrc)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_lib, "_libs", {})
    monkeypatch.setattr(K, "_fns", None)
    p, g, m, v = _leaf(4097, torch.bfloat16, torch.float32, cuda, seed=11)
    wrong = _same_bits(*_both(p, g, m, v))
    if fault is None:
        assert wrong is None, wrong
    else:
        assert wrong is not None, f"the fault '{fault}' passed"


def test_unbuildable_kernel_raises(cuda, monkeypatch, tmp_path):
    """No fallback: when the kernel cannot be built, a CUDA leaf raises."""
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib, "NVCC_FLAGS",
                        cuda_lib.NVCC_FLAGS + ("--no-such-nvcc-flag",))
    monkeypatch.setattr(cuda_lib, "_libs", {})
    monkeypatch.setattr(K, "_fns", None)
    model = torch.nn.Linear(4, 4, device=cuda)
    grads = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    with pytest.raises(cuda_lib.BuildError):
        A.adamw_update(CFG, model, grads, A.adamw_init(model))
