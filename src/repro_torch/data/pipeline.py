"""LM batching (copy of ``LMBatcher`` in ``repro/data/pipeline.py``).

Pure numpy with a seeded host rng; deterministic per seed, so the port
and the reference cut the same windows.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class LMBatcher:
    """Next-token-prediction windows over a token stream."""

    def __init__(self, tokens: np.ndarray, batch_size: int, seq_len: int,
                 seed: int = 0):
        self.tokens = tokens
        self.batch, self.seq = batch_size, seq_len
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        starts = self.rng.integers(0, len(self.tokens) - self.seq - 1,
                                   size=self.batch)
        window = np.stack([self.tokens[s:s + self.seq + 1] for s in starts])
        return {"tokens": window[:, :-1].astype(np.int32),
                "labels": window[:, 1:].astype(np.int64)}
