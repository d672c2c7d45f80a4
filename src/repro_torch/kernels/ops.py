"""Public kernel entry points, in the reference package's ``ops`` names.

Dispatch is by the device of the tensors (see
:mod:`repro_torch.kernels.tile_matmul`): CUDA tensors launch the
hand-written kernel, CPU tensors run the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from .tile_matmul import tile_matmul as _tile_matmul

__all__ = ["tile_matmul"]


def tile_matmul(a: torch.Tensor, b: torch.Tensor,
                c: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``a @ b`` (``+ c`` when given): the Pallas ``tile_matmul``'s function
    and its oracle's ``+ C`` form."""
    return _tile_matmul(a, b, c)
