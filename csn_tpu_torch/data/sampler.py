"""Infinite permutation sampler (`MinkowskiNet/lib/dataloader.py:1-34`).

The port's own copy of `csn_tpu/data/sampler.py` (no JAX in either).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class InfSampler:
    """Repeats a (re)shuffled permutation of dataset indices forever."""

    def __init__(self, n: int, shuffle: bool = True,
                 rng: Optional[np.random.Generator] = None):
        self.n = n
        self.shuffle = shuffle
        self.rng = rng or np.random.default_rng()
        self._queue: list = []

    def _refill(self):
        perm = np.arange(self.n)
        if self.shuffle:
            self.rng.shuffle(perm)
        self._queue = perm.tolist()

    def __next__(self) -> int:
        if not self._queue:
            self._refill()
        return self._queue.pop()

    def take(self, k: int):
        return [next(self) for _ in range(k)]
