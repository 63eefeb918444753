"""Synthetic deterministic token pipeline (the port's own copy of
``repro.data.tokens``; numpy only, bitwise the same batches).

Host-side generator producing shardable batches: each (host, step) pair maps
to a disjoint PRNG stream, so data-parallel workers never need coordination
and restart-from-checkpoint reproduces the exact stream (the cursor is part
of the checkpoint). A lightweight Zipf-ish unigram over the vocab plus a
Markov bigram mixer gives losses that actually *decrease* during the example
runs (pure uniform tokens would not). Batches leave as numpy arrays; the
trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2


class TokenPipeline:
    """Deterministic, seekable synthetic stream (the data substrate)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        self._step = 0
        rng = np.random.default_rng(cfg.seed)
        # fixed unigram (Zipf) + a sparse "bigram" shift pattern
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._unigram = p / p.sum()
        self._shift = rng.integers(1, cfg.vocab_size,
                                   size=min(cfg.vocab_size, 4096))

    @property
    def step(self) -> int:
        return self._step

    def seek(self, step: int) -> None:
        """Restart support: position the stream at `step` (O(1))."""
        self._step = step

    def next_batch(self) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, self.host_id, self._step))
        toks = rng.choice(cfg.vocab_size, p=self._unigram,
                          size=(self.local_batch, cfg.seq_len + 1))
        # inject predictable structure: half the positions continue a pattern
        mixer = self._shift[toks[:, :-1] % len(self._shift)]
        structured = (toks[:, :-1] + mixer) % cfg.vocab_size
        mask = rng.random((self.local_batch, cfg.seq_len)) < 0.5
        nxt = np.where(mask, structured, toks[:, 1:])
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": nxt.astype(np.int32),
        }
        self._step += 1
        return batch

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
