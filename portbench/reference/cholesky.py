"""The plain reference of a Cholesky factorization: ``torch.linalg.cholesky``
of the whole matrix, in the matrix's own type."""

from __future__ import annotations

import torch


def factor(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cholesky(a)


def factor_error(L: torch.Tensor, a: torch.Tensor) -> float:
    """The largest entry of ``L - L_ref`` over the largest entry of
    ``L_ref``, ``L_ref`` the reference's factor of ``a``."""
    ref = factor(a)
    return float((L.to(ref.dtype) - ref).abs().max() / ref.abs().max())


def control_factor(a: torch.Tensor) -> torch.Tensor:
    """The control: the reference one precision down (float32 for a
    float64 matrix), put where the program's factor would be."""
    low = {torch.float64: torch.float32, torch.float32: torch.bfloat16}
    return torch.linalg.cholesky(a.to(low[a.dtype])).to(a.dtype)
