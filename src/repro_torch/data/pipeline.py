"""Deterministic sharded synthetic token pipeline with O(1) skip-ahead (a
copy of ``repro/data/pipeline.py``, which is numpy only: the batches are
bit-equal to the reference's).

Every batch is a pure function of (seed, step, shard) via counter-based
Philox keys: resuming a run at step N reproduces exactly the batches a
never-interrupted run would have seen at step N (no state to checkpoint, no
epoch bookkeeping), and each data-parallel shard draws disjoint streams.

The stream has document structure (exponential lengths, EOS separators) and
a Zipfian unigram distribution, so losses behave like language data rather
than uniform noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    shard_index: int = 0       # this host's data shard
    num_shards: int = 1
    eos_id: int = 0
    mean_doc_len: int = 512

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError("global_batch must divide evenly across shards")

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.num_shards

    def _rng(self, step: int) -> np.random.Generator:
        # Philox counter key is 2x64-bit: (seed|shard, step)
        key = ((self.seed << 32) | self.shard_index, step)
        return np.random.Generator(np.random.Philox(key=key))

    def batch(self, step: int) -> dict:
        """{"tokens": [local_batch, seq], "labels": same} int32.

        Labels are next-token targets (shift-by-one within the sampled
        window; the window is seq_len+1 wide so no token is wasted)."""
        rng = self._rng(step)
        B, S = self.local_batch, self.seq_len
        # Zipfian unigrams (clipped to vocab); EOS document separators.
        toks = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
        toks = (toks % (self.vocab_size - 1)) + 1          # 0 reserved: EOS
        doc_end = rng.random((B, S + 1)) < (1.0 / self.mean_doc_len)
        toks = np.where(doc_end, self.eos_id, toks)
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def shard(self, shard_index: int, num_shards: int) -> "TokenPipeline":
        """Re-shard (elastic re-scale): same seed -> same global stream."""
        return dataclasses.replace(self, shard_index=shard_index,
                                   num_shards=num_shards)
