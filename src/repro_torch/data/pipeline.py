"""Deterministic synthetic LM data pipeline (the twin of
``repro/data/pipeline.py``, numpy only, batch for batch the same).

The pipeline synthesizes a *learnable* token stream (noisy modular
arithmetic progressions — a model that learns drives the loss well below
uniform entropy).  Everything is deterministic in (seed, step, host),
host-sharded by process, and prefetched on a background thread;
``state_dict()/load_state_dict()`` checkpoint the cursor so a restart
resumes mid-epoch without replaying data.  Batches are numpy arrays; the
trainer moves them to its device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["SyntheticLM", "DataPipeline"]


class SyntheticLM:
    """tokens[t+1] = (tokens[t] + stride) % vocab with occasional noise —
    next-token prediction is learnable from (token, stride-class)."""

    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0,
                 n_strides: int = 8, noise: float = 0.05):
        self.vocab = max(vocab_size, 16)
        self.seq_len = seq_len
        self.seed = seed
        self.n_strides = n_strides
        self.noise = noise

    def sample(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed * 1_000_003 + index) & 0xFFFFFFFF)
        stride = 1 + int(rng.integers(self.n_strides))
        start = int(rng.integers(self.vocab))
        toks = (start + stride * np.arange(self.seq_len + 1)) % self.vocab
        flips = rng.random(self.seq_len + 1) < self.noise
        toks = np.where(flips, rng.integers(0, self.vocab, self.seq_len + 1), toks)
        return toks[:-1].astype(np.int32), toks[1:].astype(np.int32)


class DataPipeline:
    def __init__(
        self,
        dataset: SyntheticLM,
        global_batch: int,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
        start_step: int = 0,
    ):
        assert global_batch % process_count == 0
        self.ds = dataset
        self.global_batch = global_batch
        self.local_batch = global_batch // process_count
        self.process_index = process_index
        self.process_count = process_count
        self.step = start_step
        self._prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- deterministic batch construction ----------------------------------
    def build_batch(self, step: int) -> dict:
        base = step * self.global_batch + self.process_index * self.local_batch
        toks = np.empty((self.local_batch, self.ds.seq_len), np.int32)
        labs = np.empty_like(toks)
        for i in range(self.local_batch):
            toks[i], labs[i] = self.ds.sample(base + i)
        return {"tokens": toks, "labels": labs}

    # -- iteration with background prefetch ---------------------------------
    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.build_batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        self._q = queue.Queue(maxsize=self._prefetch)
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        try:
            while True:
                step, batch = self._q.get()
                self.step = step + 1
                yield batch
        finally:
            self.stop()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None

    # -- elastic restart ------------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.ds.seed}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
