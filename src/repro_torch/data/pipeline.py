"""Token data pipeline for the training examples: a deterministic synthetic
LM stream (zipfian unigram mixture with induced bigram structure so the loss
actually decreases), shard-aware batching."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def synthetic_token_batches(vocab_size: int, batch: int, seq_len: int,
                            *, seed: int = 0,
                            with_frames: bool = False,
                            frame_len: int = 0, d_model: int = 0
                            ) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    # zipf-ish unigram with a deterministic successor table (learnable bigram)
    ranks = np.arange(1, vocab_size + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    succ = rng.permutation(vocab_size)
    while True:
        base = rng.choice(vocab_size, size=(batch, seq_len + 1), p=probs)
        # 50% of positions follow the bigram successor rule
        follow = rng.random((batch, seq_len)) < 0.5
        for t in range(1, seq_len + 1):
            base[:, t] = np.where(follow[:, t - 1],
                                  succ[base[:, t - 1]], base[:, t])
        out = {"tokens": base[:, :-1].astype(np.int32),
               "labels": base[:, 1:].astype(np.int32)}
        if with_frames:
            out["frames"] = rng.normal(
                0, 1, (batch, frame_len, d_model)).astype(np.float32)
        yield out
