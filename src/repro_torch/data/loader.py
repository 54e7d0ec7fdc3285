"""Deterministic batch iterators.

* ``FederatedBatches``: per-device minibatch sampling for the FL simulator -
  produces stacked (m, batch, ...) arrays so the simulator can vmap over the
  device axis.  Sampling is uniform with replacement (matches the paper's
  S_i^(k) "chosen uniformly at random from the local dataset").
  ``stage(T)`` pre-draws T iterations worth of sample *indices* at once so
  the scan engine can keep the whole horizon on device (gathering rows from
  the device-resident dataset per step) instead of round-tripping a fresh
  host batch every iteration.
* ``lm_batches``: contiguous next-token LM batches from a token stream.
"""
from __future__ import annotations

import numpy as np


class FederatedBatches:
    def __init__(self, x: np.ndarray, y: np.ndarray, parts: list[np.ndarray], batch: int, seed: int = 0):
        self.x, self.y = x, y
        self.parts = parts
        self.batch = batch
        self.rng = np.random.default_rng(seed)

    @property
    def m(self) -> int:
        return len(self.parts)

    def next(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (xb (m, batch, dim), yb (m, batch))."""
        xs, ys = [], []
        for p in self.parts:
            idx = self.rng.choice(p, size=self.batch, replace=True)
            xs.append(self.x[idx])
            ys.append(self.y[idx])
        return np.stack(xs), np.stack(ys)

    def stage(self, T: int) -> np.ndarray:
        """Pre-draws the dataset indices for T iterations: (T, m, batch) int32.

        Consumes the rng stream exactly as T ``next()`` calls would (same
        per-step, per-device draw order), so a scan over staged indices
        reproduces the legacy per-step loop sample-for-sample.  Indices are
        returned instead of gathered rows to keep staging O(T m batch) ints
        rather than O(T m batch dim) floats; the engine gathers from the
        device-resident (x, y) arrays inside the scanned step.
        """
        idx = np.empty((T, len(self.parts), self.batch), np.int32)
        for t in range(T):
            for i, p in enumerate(self.parts):
                idx[t, i] = self.rng.choice(p, size=self.batch, replace=True)
        return idx


def lm_batches(stream: np.ndarray, batch: int, seq: int, *, seed: int = 0):
    """Yields dicts {tokens, targets} of shape (batch, seq)."""
    rng = np.random.default_rng(seed)
    n = len(stream) - seq - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        toks = np.stack([stream[s : s + seq] for s in starts])
        tgts = np.stack([stream[s + 1 : s + seq + 1] for s in starts])
        yield {"tokens": toks.astype(np.int32), "targets": tgts.astype(np.int32)}


def federated_lm_parts(stream: np.ndarray, m: int) -> list[np.ndarray]:
    """Contiguous shard of the stream per FL device (non-iid by position)."""
    return np.array_split(stream, m)
