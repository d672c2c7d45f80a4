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
from .ssd_scan import ssd_scan as _ssd_scan
from .tile_matmul import tile_matmul as _tile_matmul

__all__ = ["decode_attention", "flash_attention", "ssd_scan", "tile_matmul"]


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


def ssd_scan(xdt: torch.Tensor, cs: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor):
    """The Pallas ``ssd_scan``'s function: the Mamba2 SSD chunk scan over
    xdt ``(B, nc, L, H, P)``, cs ``(B, nc, L, H)`` and Bm/Cm ``(B, nc, L,
    N)``; returns ``(y, final_state)``."""
    return _ssd_scan(xdt, cs, Bm, Cm)
