"""Deterministic sharded synthetic data pipeline with background prefetch.

The port's own copy of the reference's ``repro/data/pipeline.py``, which
is numpy only: ``batch_at`` gives the reference's batches bit for bit, so
either package can resume the other's stream.  Batches stay numpy on the
host; the trainer moves them to the device.

Production shape: per-host sharded batches (each host materializes only its
slice), deterministic from (seed, step) — so restart/elastic-reshard resumes
produce identical streams — plus a double-buffered prefetch thread so host
data generation overlaps device compute (the paper's comm/compute-overlap
discipline applied to the input pipeline)."""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    extra: Tuple[Tuple[str, Tuple[int, ...]], ...] = ()   # e.g. (("patches",(1600,128)),)

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticLMData:
    """Markov-ish synthetic token stream: next-token structure exists (so
    loss decreases in the e2e example) but generation is pure numpy."""

    def __init__(self, cfg: DataConfig, prefetch: int = 2):
        self.cfg = cfg
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._step = 0
        self._thread: Optional[threading.Thread] = None

    # -- deterministic batch synthesis -----------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        b, s, v = cfg.host_batch, cfg.seq_len, cfg.vocab_size
        # structured stream: x_{t+1} = (a * x_t + c) % v with noise
        a = 31, 17
        x0 = rng.integers(0, v, size=(b, 1))
        mult = rng.choice(a, size=(b, 1))
        t = np.arange(s + 1)
        toks = (x0 * np.power(mult, t % 7, dtype=np.int64) + 13 * t) % v
        noise = rng.random((b, s + 1)) < 0.05
        toks = np.where(noise, rng.integers(0, v, size=(b, s + 1)), toks)
        out = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        for name, shape in cfg.extra:
            out[name] = rng.standard_normal((b,) + shape).astype(np.float32)
        return out

    # -- prefetching iterator ---------------------------------------------
    def start(self, from_step: int = 0) -> None:
        self._step = from_step
        self._stop.clear()

        def worker():
            step = from_step
            while not self._stop.is_set():
                batch = self.batch_at(step)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, batch), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        if self._thread is None:
            self.start(self._step)
        while True:
            yield self._q.get()

    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step, "seed": self.cfg.seed}
