"""Deterministic synthetic LM data: a learnable Markov-ish token stream.

Offline container => no real corpus. The stream has genuine structure
(low-entropy bigram transitions + periodic motifs) so cross-entropy has
a floor well below uniform and convergence curves mean something —
needed by the rank-sweep reproduction (paper Table 3's qualitative
claims) and the hillclimb integration tests.

Host-sharded: each host materializes only its slice of the global batch
(data-parallel contract at 1000+ nodes).

A numpy-only copy of the JAX package's ``data/synthetic.py``: both
packages draw the same batches from the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    seed: int = 0
    branching: int = 4      # out-degree of the bigram graph (entropy knob)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse deterministic bigram table: token t -> one of `branching`
        # successors, chosen by a position-dependent selector
        self.successors = rng.integers(0, self.vocab, size=(self.vocab, self.branching))

    def sequence(self, idx: int) -> np.ndarray:
        """Deterministic sequence for global index idx (reproducible
        across restarts — checkpoint resume re-generates identically)."""
        rng = np.random.default_rng((self.seed, idx))
        toks = np.empty(self.seq_len + 1, dtype=np.int32)
        toks[0] = rng.integers(0, self.vocab)
        sel = rng.integers(0, self.branching, size=self.seq_len)
        for i in range(self.seq_len):
            toks[i + 1] = self.successors[toks[i], sel[i]]
        return toks

    def batch(self, step: int, batch_size: int, shard: int = 0, num_shards: int = 1):
        """Global batch row i lives on shard i % num_shards. Returns this
        shard's (tokens, labels) of shape (batch_size/num_shards, seq)."""
        assert batch_size % num_shards == 0
        local = batch_size // num_shards
        rows = [self.sequence(step * batch_size + shard * local + i) for i in range(local)]
        arr = np.stack(rows)
        return arr[:, :-1], arr[:, 1:]


def make_batch_iterator(ds: SyntheticLMDataset, batch_size: int,
                        start_step: int = 0, shard: int = 0, num_shards: int = 1
                        ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    step = start_step
    while True:
        yield ds.batch(step, batch_size, shard, num_shards)
        step += 1
