"""Synthetic LM corpus (copy of ``SyntheticLM`` in ``repro/data/synthetic.py``).

``SyntheticLM`` is a Zipf-distributed token stream with a planted bigram
structure.  Pure numpy with a seeded ``default_rng``, so the port draws
the same tokens as the reference for the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    num_tokens: int = 1 << 20
    vocab_size: int = 512
    seed: int = 0

    def generate(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # Zipf unigram + deterministic planted bigram for 25% of steps
        ranks = np.arange(1, v + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(v, size=self.num_tokens, p=probs)
        succ = rng.permutation(v)          # planted bigram successor table
        follow = rng.random(self.num_tokens) < 0.25
        toks[1:] = np.where(follow[1:], succ[toks[:-1]], toks[1:])
        return toks.astype(np.int32)
