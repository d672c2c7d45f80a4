"""Async checkpoints of tensor trees, in the reference's on-disk layout.

The port of the reference's ``repro/checkpoint/checkpointer.py``:

* a tree is nested dicts whose leaves are tensors (or numpy arrays or
  numbers); each leaf is saved as a ``.npy`` under ``step_XXXXXXXX/`` with
  a JSON manifest (``step``, ``extra``, and per leaf its path, file,
  shape and dtype), the reference's format;
* writes go to ``<step>.tmp`` and are renamed when complete, so a
  preempted save never corrupts the latest checkpoint; the oldest steps
  beyond ``keep`` are removed;
* the device-to-host copy (``.cpu()``, a copy even for a CPU tensor, so a
  later in-place update cannot reach the saved values) happens
  synchronously in ``save`` and ``save_async``; ``save_async`` runs the
  file I/O on a background thread, overlapping the next train steps.

numpy has no bfloat16: a bfloat16 leaf is saved as its ``uint16`` bits
with ``"dtype": "bfloat16"`` in the manifest and restored bit for bit.
``restore(device=)`` puts every leaf on ``device`` (CUDA by default).
``restore(shardings=, mesh=)`` is the reference's elastic restore: each
leaf the ``shardings`` tree places (DTensor placements per mesh
dimension, as ``sharding.named`` gives them) is loaded whole from its file
and cut to this rank's shard, so a checkpoint saved on one mesh restores
on any other.  A checkpoint holds whole leaves: a sharded trainer gathers
them first and its rank 0 alone writes.  A float32 checkpoint the
reference wrote restores here as it is.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..linalg.tiles import resolve_device
from ..sharding.rules import local_slices, pspec_of

__all__ = ["Checkpointer"]

Device = Union[str, torch.device, None]


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _unflatten(flat: Dict[Tuple[str, ...], Any]):
    root: Dict = {}
    for path, v in flat.items():
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return root


def _to_host(x):
    """A leaf as ``(numpy array, manifest dtype)``, copied off the device
    (and off the live CPU tensor)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(x)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, device: torch.device):
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict] = None) -> str:
        self.wait()
        host = {p: _to_host(x) for p, x in _flatten(tree).items()}
        return self._write(step, host, extra or {})

    def save_async(self, step: int, tree, extra: Optional[Dict] = None) -> None:
        """Device->host copy happens here; file IO on a background thread."""
        self.wait()
        host = {p: _to_host(x) for p, x in _flatten(tree).items()}

        def work():
            try:
                self._write(step, host, extra or {})
            except BaseException as e:     # surfaced by the next wait()
                self._error = e

        self._pending = threading.Thread(target=work, daemon=True)
        self._pending.start()

    def wait(self) -> None:
        """Join the pending background write; raise its error, if any."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("a background checkpoint write failed") from err

    def _write(self, step: int, host, extra: Dict) -> str:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for i, (path, (arr, dtype)) in enumerate(sorted(host.items())):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({
                "path": list(path), "file": fname,
                "shape": list(arr.shape), "dtype": dtype,
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, device: Device = None,
                shardings=None, mesh=None):
        """Load a checkpoint (the latest by default) as ``(tree,
        manifest)``, every leaf a tensor on ``device`` (CUDA by default,
        raising without one); ``(None, None)`` when there is none.  With
        ``shardings`` (a tree over the saved one whose leaves are DTensor
        placements, one per dimension of ``mesh``, or None for a whole
        leaf) each placed leaf is this rank's shard."""
        dev = resolve_device(device)
        flat_sh = _flatten(shardings) if shardings is not None else {}
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for leaf in manifest["leaves"]:
            path = tuple(leaf["path"])
            arr = np.load(os.path.join(d, leaf["file"]))
            placements = flat_sh.get(path)
            if placements is not None:
                arr = np.ascontiguousarray(arr[local_slices(
                    arr.shape, pspec_of(placements, mesh, arr.ndim), mesh)])
            flat[path] = _from_host(arr, leaf["dtype"], dev)
        return _unflatten(flat), manifest
