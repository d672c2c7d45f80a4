"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface; the
sources share the headers ``csrc/*.cuh``.  At first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/``
at the root of the checkout, named by a hash of the source, every header
and the flags, so an unchanged source is never rebuilt and an edited
header rebuilds every kernel; the library is then loaded with
:mod:`ctypes`.  A failed build raises
:class:`BuildError` carrying ``nvcc``'s output — there is no fallback.

Every kernel wrapper owns a :class:`LaunchCounter` and adds one to it where
it launches its kernel, and nowhere else, so a run can show that its path
went through the kernel.  A launch made while the calling thread captures
a CUDA graph (inside :func:`capturing_launches`) only records the kernel
into the graph; it is tallied for that graph, and every replay of the
graph adds the tally to the counts (:func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator

__all__ = ["BUILD_DIR", "BuildError", "LaunchCounter", "add_launches",
           "build", "capturing_launches", "load", "library_path",
           "refuse_grad", "require_aligned"]

CSRC = Path(__file__).resolve().parent / "csrc"
#: ``<checkout>/build/kernels`` (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildError(RuntimeError):
    """A kernel source failed to compile (or no ``nvcc`` was found)."""


#: per thread: the launch tally of the CUDA graph it is capturing, if any
_capture = threading.local()


class LaunchCounter:
    """A kernel's launch count: a plain integer, bumped under a lock because
    several worker threads launch the same kernel concurrently."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        """Count ``n`` launches; on a thread that is capturing a CUDA graph
        they go to the graph's tally instead, since nothing ran."""
        tally = getattr(_capture, "tally", None)
        if tally is not None:
            tally[self] = tally.get(self, 0) + n
            return
        with self._lock:
            self.count += n

    def reset(self) -> None:
        with self._lock:
            self.count = 0


@contextlib.contextmanager
def capturing_launches() -> Iterator[Dict[LaunchCounter, int]]:
    """While the block runs, launches this thread makes are tallied in the
    yielded ``{counter: launches}`` instead of counted: the block captures
    them into a CUDA graph, which runs them later (:func:`add_launches` at
    each replay).  Other threads keep counting as usual."""
    if getattr(_capture, "tally", None) is not None:
        raise RuntimeError("this thread is already capturing launches")
    _capture.tally = tally = {}
    try:
        yield tally
    finally:
        _capture.tally = None


def add_launches(tally: Dict[LaunchCounter, int]) -> None:
    """Count the launches a captured graph's replay ran."""
    for counter, n in tally.items():
        counter.add(n)


def require_aligned(name: str, t, dims, copy: str, align: int = 16) -> None:
    """Raise ``ValueError`` unless ``t``'s base address and its strides
    along ``dims`` (``{dim: what}``) are multiples of ``align`` bytes, as
    ``copy`` (a TMA or bulk copy reading the tensor in place; nothing is
    ever copied to fix it) needs."""
    if t.data_ptr() % align:
        raise ValueError(f"{name} starts at an address that is not a multiple "
                         f"of {align} bytes; {copy} reads it in place and "
                         f"needs that alignment (the wrapper copies nothing)")
    item = t.element_size()
    for dim, what in dims.items():
        if (t.stride(dim) * item) % align:
            raise ValueError(
                f"{name}'s {what} stride of {t.stride(dim)} elements "
                f"({t.stride(dim) * item} bytes) is not a multiple of {align} "
                f"bytes; {copy} reads it in place and needs that alignment "
                f"(the wrapper copies nothing)")


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel without a backward would drop a gradient: it
    launches on raw pointers, so its output carries no autograd history.
    Checked before dispatch, so the CPU's plain version refuses alike;
    under ``torch.no_grad()`` (every serving and factorization path) or on
    tensors that do not require grad, it passes."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: its kernel's output would carry no "
            f"gradient to inputs that require one; call it under "
            f"torch.no_grad() or on detached tensors (flash_attention and "
            f"ssd_scan are differentiable, through FlashAttentionFn and "
            f"SSDScanFn)")


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's default location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.access(c, os.X_OK):
            return c
    raise BuildError("no nvcc found (set CUDA_HOME or put nvcc on PATH); "
                     "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: keyed on a
    hash of the source text, of every ``csrc/*.cuh`` header (name and
    text; a source may include any of them) and of the compiler flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together; returns each name's build seconds (0.0
    for a library already built).  ``nvcc``'s report (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside each library as
    ``.log``."""
    names = list(dict.fromkeys(names))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    seconds: Dict[str, float] = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            seconds[name] = 0.0
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        pending[name] = (proc, tmp, lib, time.perf_counter())
    failures = []
    for name, (proc, tmp, lib, t0) in pending.items():
        output, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        lib.with_suffix(".log").write_text(output)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on csrc/{name}.cu "
                            f"(exit {proc.returncode}):\n{output}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise BuildError("\n".join(failures))
    return seconds


_libs: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
