"""Deterministic synthetic LM token pipeline with host prefetch.

Tokens are a counter-based hash stream (stateless, seekable): shard-safe
(each DP rank reads a disjoint slice by stride), restart-safe (resume at any
step without replaying), and infinite.  ``Prefetcher`` overlaps host batch
synthesis with device compute on a background thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Tuple

import numpy as np


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """xorshift-multiply hash (vectorized, deterministic)."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(16))) * np.uint64(0x45d9f3b)
    x = (x ^ (x >> np.uint64(16))) * np.uint64(0x45d9f3b)
    x = x ^ (x >> np.uint64(16))
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def token_batch(step: int, batch: int, seq: int, vocab: int,
                rank: int = 0, world: int = 1, seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, targets) for a global step; rank slices the global batch."""
    per = batch // world
    base = (np.uint64(step) * np.uint64(batch * (seq + 1))
            + np.uint64(rank * per * (seq + 1))
            + np.uint64(seed) * np.uint64(0x9E3779B9))
    idx = base + np.arange(per * (seq + 1), dtype=np.uint64)
    toks = (_hash_u32(idx) % np.uint32(vocab)).astype(np.int32)
    toks = toks.reshape(per, seq + 1)
    return toks[:, :-1], toks[:, 1:]


class Prefetcher:
    """Background-thread prefetch of host batches (depth-bounded queue)."""

    def __init__(self, make_batch, depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                self._q.put(self._make(self._step), timeout=0.1)
                self._step += 1
            except queue.Full:
                continue

    def next(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
