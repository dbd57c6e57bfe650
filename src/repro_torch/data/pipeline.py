"""Deterministic, shard-aware, checkpointable data pipeline (a copy of
``repro.data.pipeline``: numpy only, so batches are the reference's bit for
bit for the same ``(seed, step, shard)``).

Every batch is a pure function of (seed, step, shard) — Philox-style
counter-based generation via numpy's default_rng keyed by (seed, step,
shard). Properties the fault-tolerance story relies on (DESIGN.md §6):

  * restart-replay exactness: resuming at step k regenerates the identical
    batch k — no iterator state to checkpoint beyond the step counter;
  * elasticity: re-sharding to a different dp count re-partitions the same
    global token stream (shard = global row index // rows_per_shard);
  * prefetch: a background thread keeps ``prefetch`` batches ready.

The token stream is a synthetic Zipf-like LM surrogate with in-sequence
structure (so losses move during the example runs); swap ``_sample_rows``
for a tokenized corpus reader in production.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3

    def _sample_rows(self, rng: np.random.Generator, n: int) -> np.ndarray:
        # Zipf marginals + a repeated-motif structure for learnability.
        base = rng.zipf(self.zipf_a, size=(n, self.seq_len))
        toks = (base % (self.vocab_size - 2)) + 1
        motif_len = 16
        motif = toks[:, :motif_len]
        reps = self.seq_len // (motif_len * 4)
        for r in range(reps):
            off = (r + 1) * motif_len * 4
            if off + motif_len <= self.seq_len:
                toks[:, off: off + motif_len] = motif
        return toks.astype(np.int32)

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = self._sample_rows(rng, self.global_batch)
        return {"tokens": toks,
                "loss_mask": np.ones_like(toks, np.float32)}

    def shard_batch_at(self, step: int, shard: int, n_shards: int
                       ) -> Dict[str, np.ndarray]:
        """The shard's slice of the global batch — elastic-safe: computed
        from global row indices, so any (shard, n_shards) factorization of
        the same global batch sees consistent data."""
        assert self.global_batch % n_shards == 0
        rows = self.global_batch // n_shards
        full = self.global_batch_at(step)
        sl = slice(shard * rows, (shard + 1) * rows)
        return {k: v[sl] for k, v in full.items()}


class DataIterator:
    """Prefetching iterator over a dataset, resumable at any step."""

    def __init__(self, dataset: SyntheticLMDataset, start_step: int = 0,
                 shard: int = 0, n_shards: int = 1, prefetch: int = 2):
        self.dataset = dataset
        self.step = start_step
        self.shard = shard
        self.n_shards = n_shards
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = self.dataset.shard_batch_at(step, self.shard,
                                                self.n_shards)
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
