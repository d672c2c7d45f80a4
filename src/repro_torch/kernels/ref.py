"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

The CPU tests run them, ``chip_smoke.py`` holds each kernel against them on
the card, and a kernel's wrapper takes them for tensors that lie on the CPU.
On a CUDA tensor the main path never reaches them.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["tile_matmul_ref"]


def tile_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                    c: Optional[torch.Tensor] = None, *, alpha: float = 1.0,
                    beta: float = 1.0, trans_b: bool = False) -> torch.Tensor:
    """``beta * c + alpha * a @ op(b)`` with ``op(b) = b.T`` if ``trans_b``.

    float64 accumulates in float64; every other type in float32, with the
    result cast back to ``a.dtype`` (as the reference package's
    ``tile_matmul_ref`` does).  ``c=None`` drops the C term."""
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    bb = b.mT if trans_b else b
    out = alpha * (a.to(acc) @ bb.to(acc))
    if c is not None:
        out = out + beta * c.to(acc)
    return out.to(a.dtype)
