"""Deterministic, shard-aware input pipelines (host NumPy).

A copy of ``repro.data.pipeline``: the batches equal the reference's bit
for bit.  The per-batch seed ``hash((seed, step, host_index)) % 2**31``
is the same in every process, because Python's hash of a tuple of ints
is not randomized.

Production posture: every host derives its own shard of every batch from
(seed, step, host_index) alone — no coordinator, no state to checkpoint
beyond the step counter, and any replacement host can resume mid-run
(the fault-tolerance story depends on this).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

import numpy as np

from repro_torch.data.synthetic import zipf_queries


@dataclasses.dataclass
class QueryBatcher:
    """Streams fixed-size DLRM query batches, shardable by host.

    Batch for step ``s`` on host ``h`` is derived from seed ``(seed, s, h)``
    so restart/elastic-rescale replays identically.
    """

    num_rows: int
    batch_size: int
    mean_bag: float
    seed: int = 0
    host_index: int = 0
    num_hosts: int = 1
    zipf_a: float = 1.2

    def batch(self, step: int) -> List[np.ndarray]:
        local = self.batch_size // self.num_hosts
        return zipf_queries(
            self.num_rows,
            local,
            self.mean_bag,
            zipf_a=self.zipf_a,
            seed=hash((self.seed, step, self.host_index)) % (2**31),
        )

    def __iter__(self) -> Iterator[List[np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass
class TokenBatcher:
    """Streams (tokens, labels) LM batches of synthetic text-like data.

    Token stream is a Zipf-over-vocab Markov-ish sequence: cheap, seeded,
    shardable, and enough structure that a few hundred training steps show
    a falling loss (used by the end-to-end example).
    """

    vocab_size: int
    batch_size: int
    seq_len: int
    seed: int = 0
    host_index: int = 0
    num_hosts: int = 1

    def batch(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        local = max(1, self.batch_size // self.num_hosts)
        rng = np.random.default_rng(hash((self.seed, step, self.host_index)) % (2**31))
        # Zipf unigram + local repetition structure (learnable bigrams)
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        p = ranks**-1.1
        p /= p.sum()
        base = rng.choice(self.vocab_size, size=(local, self.seq_len + 1), p=p)
        # inject deterministic bigram structure: x[t+1] = (x[t]*7+3) % V on 1/3 of positions
        mask = rng.random((local, self.seq_len)) < 0.34
        nxt = (base[:, :-1] * 7 + 3) % self.vocab_size
        base[:, 1:] = np.where(mask, nxt, base[:, 1:])
        return base[:, :-1].astype(np.int32), base[:, 1:].astype(np.int32)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
