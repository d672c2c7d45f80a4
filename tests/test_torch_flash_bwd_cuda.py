"""The flash backward kernel's dispatch on the card (``@pytest.mark.cuda``;
skips without a CUDA device).

What the kernel (``csrc/flash_attention.cu``'s ``flash_bwd_*``) does not
take keeps the torch-op backward (float32, a head of 256), counted as the
plain path inside a traced call, and an output gradient it cannot read in
place is refused, not copied.  Its gradients at the train cells' shapes
are held to chip_smoke.py's derived limits by ``tests/test_torch_cuda.py::
test_flash_attention_gradients_on_card`` and by chip_smoke.py itself.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_bwd_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.obs import span_trace, spans

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def _inputs(seed, B, H, KV, Sq, Sk, d, dtype, device):
    rng = np.random.default_rng(seed)
    shapes = ((B, H, Sq, d), (B, KV, Sk, d), (B, KV, Sk, d), (B, H, Sq, d))
    return [torch.from_numpy(rng.standard_normal(s)).to(device, dtype)
            for s in shapes]


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128),
                                     (torch.bfloat16, 256)])
def test_what_the_kernel_does_not_take_keeps_the_torch_op_backward(
        cuda, dtype, d):
    """float32 inputs and gemma3's head of 256: no backward launch, the
    plain path's counter, the gradients of flash_attention_bwd."""
    q, k, v, dout = _inputs(41, 1, 4, 2, 200, 200, d, dtype, cuda)
    reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    call = spans.open_call("test.flash_bwd", traced=True)
    try:
        out = flash_attention(*leaves, causal=True)
        got = torch.autograd.grad(out, leaves, dout)
    finally:
        call.close()
    torch.cuda.synchronize()
    counters = span_trace().counters
    assert launch_counts()["flash_attention_bwd"] == 0
    assert counters["repro.flash.bwd_plain"] == 1
    assert counters["repro.flash.bwd_kernel"] == 0
    want = flash_attention_bwd(q, k, v, out.detach(), dout, causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_backward_kernel_raises_on_a_dout_it_cannot_read_in_place(cuda):
    """An output gradient whose head dimension is not contiguous is
    refused with the reason, not copied."""
    q, k, v, _ = _inputs(42, 1, 4, 2, 128, 128, 64, torch.bfloat16, cuda)
    dout = torch.randn(1, 4, 64, 128, dtype=torch.bfloat16,
                       device=cuda).transpose(-1, -2)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        torch.autograd.grad(out, leaves, dout)
