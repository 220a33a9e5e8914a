"""Data pipeline: deterministic synthetic LM shards + prefetch.

Port of ``repro/data/pipeline.py``, a copy: the same numpy draw, so the
same tokens as the reference for the same (seed, step, host).

Design mirrors a production host-sharded loader:
* the dataset is addressed by (step, host) so any host can (re)produce its
  shard without coordination — this is what makes checkpoint/restart and
  elastic rescaling exact: the cursor is just the step counter;
* a background :class:`Prefetcher` thread keeps ``depth`` batches ready so
  host compute overlaps device compute (double buffering);
* the loader is exposed to the auto-parallelizer as an ``@io_task`` source
  (``make_data_source``), ordered by the RealWorld token like any effect.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..core import io_task


class SyntheticLMDataset:
    """Zipf-ish token stream; (step, host)-addressable, deterministic."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 *, n_hosts: int = 1, host_id: int = 0, seed: int = 0):
        assert global_batch % n_hosts == 0
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.host_batch = global_batch // n_hosts
        self.global_batch = global_batch
        self.n_hosts = n_hosts
        self.host_id = host_id
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        # zipf-ish marginal over the vocab (realistic embedding access skew)
        z = rng.zipf(1.3, size=(self.host_batch, self.seq_len + 1))
        toks = (z % (self.vocab_size - 2)) + 1
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background thread keeping ``depth`` batches ready."""

    def __init__(self, dataset: SyntheticLMDataset, start_step: int = 0,
                 depth: int = 2):
        self.dataset = dataset
        self.step = start_step
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self) -> None:
        s = self.step
        while not self._stop.is_set():
            batch = self.dataset.batch_at(s)
            while not self._stop.is_set():
                try:
                    self._q.put((s, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def next(self) -> Dict[str, np.ndarray]:
        s, batch = self._q.get()
        self.step = s + 1
        return batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1.0)


def make_data_source(dataset: SyntheticLMDataset):
    """Expose the loader as an effectful task (RealWorld-ordered)."""
    state = {"step": 0}

    @io_task(name="load_batch", cost=0.01, meta={"idempotent": True})
    def load_batch():
        b = dataset.batch_at(state["step"])
        state["step"] += 1
        return b

    return load_batch
