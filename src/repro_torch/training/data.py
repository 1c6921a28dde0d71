"""Synthetic LM data pipeline: seeded, shard-aware, infinite.

A copy of ``src/repro/training/data.py`` (pure numpy; the port keeps its
own so that it imports nothing of the JAX package): the same seed gives
bit-identical batches.  ``structured=True`` produces sequences with
learnable bigram structure (each token determined by the previous one via
a fixed random permutation + noise) so small models can demonstrably
learn.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structured: bool = True
    noise: float = 0.1


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.perm = rng.permutation(cfg.vocab_size)

    def batches(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.cfg
        step = start_step
        while True:
            rng = np.random.default_rng((cfg.seed, step))
            if cfg.structured:
                tok = np.empty((cfg.global_batch, cfg.seq_len), np.int32)
                tok[:, 0] = rng.integers(0, cfg.vocab_size, cfg.global_batch)
                for t in range(1, cfg.seq_len):
                    nxt = self.perm[tok[:, t - 1]]
                    noise = rng.random(cfg.global_batch) < cfg.noise
                    rand = rng.integers(0, cfg.vocab_size, cfg.global_batch)
                    tok[:, t] = np.where(noise, rand, nxt)
            else:
                tok = rng.integers(0, cfg.vocab_size,
                                   (cfg.global_batch, cfg.seq_len),
                                   dtype=np.int32)
            yield {"tokens": tok}
            step += 1
