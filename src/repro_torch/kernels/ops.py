"""Public kernel entry points, in the reference package's ``ops`` names.

Dispatch is by the device of the tensors (see each kernel's wrapper
module): CUDA tensors launch the hand-written kernel, CPU tensors run the
plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from .decode_attention import decode_attention as _decode_attention
from .flash_attention import flash_attention as _flash_attention
from .tile_matmul import tile_matmul as _tile_matmul

__all__ = ["decode_attention", "flash_attention", "tile_matmul"]


def tile_matmul(a: torch.Tensor, b: torch.Tensor,
                c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a @ b`` (``+ c`` when given): the Pallas ``tile_matmul``'s function
    and its oracle's ``+ C`` form."""
    return _tile_matmul(a, b, c)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """The Pallas ``flash_attention``'s function on ``(B, H, S, d)``
    tensors; k/v may hold fewer (grouped) heads than q."""
    return _flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int, *, window: int = 0) -> torch.Tensor:
    """The Pallas ``decode_attention``'s function: q ``(B, H, d)`` over
    k/v ``(B, S, KV, d)``; k/v may hold fewer (grouped) heads than q."""
    return _decode_attention(q, k, v, length, window=window)
