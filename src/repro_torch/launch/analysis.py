"""What one rank's program of a cell costs, counted as it runs.

The port's counterpart of the reference's ``hlo_analysis.py``: there is no
HLO to parse, so :func:`analyze` runs the cell's per-rank program once
(under the caller's ``FakeTensorMode``, so no memory is held and no device
works) with ``torch.utils.flop_counter.FlopCounterMode``, the collective
counter of :mod:`repro_torch.sharding.collectives` and a count of the
bytes live at once (:class:`LiveBytes`).  Every collective and product is
counted as often as it runs (the reference's trip-count correction is not
needed), backward and recomputation included.  The FLOPs are those of the code that ran: on CPU
fake tensors the kernels' plain versions (the plain flash attention
computes the whole S x S square).
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..sharding import collectives as C

__all__ = ["LiveBytes", "analyze"]


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages the program makes that are alive at once,
    at most (``peak``): each operator's new output storage counts from the
    operator until its last tensor is freed.  The arguments, made before,
    do not count.  (``MemTracker`` hooks every module's outputs for the
    backward pass and refuses outputs that take no gradient, as a decode
    step's do.)"""

    def __init__(self):
        super().__init__()
        self.live: Dict[int, list] = {}
        self.current = self.peak = 0

    def _drop(self, key: int) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.current -= entry[0]
            del self.live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key not in self.live:
                self.live[key] = [st.nbytes(), 0]
                self.current += st.nbytes()
                self.peak = max(self.peak, self.current)
            self.live[key][1] += 1
            weakref.finalize(t, self._drop, key)
        return out


def analyze(fn: Callable, *args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once; returns ``{"collectives": {kind: {"count",
    "bytes"}, "total_bytes", "total_count"}, "dot_flops", "temp_bytes"}``
    (``temp_bytes``: :class:`LiveBytes`'s peak)."""
    C.reset_counts()
    flops = FlopCounterMode(display=False)
    live = LiveBytes()
    with flops, live:
        fn(*args)
    return {"collectives": C.counts(),
            "dot_flops": float(flops.get_total_flops()),
            "temp_bytes": int(live.peak)}
