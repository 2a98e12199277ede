"""The benchmark's token source: a frozen copy of the port's Zipf-like
synthetic stream (``repro_torch.data.pipeline.SyntheticTokens``), drawn
per (seed, index) for any rows and length, so that the program receives
only the generated tensors.

The original fixes the permutation of the vocabulary (which ids are the
frequent ones) once per seed. Here each batch draws its own: with random
weights, which experts the few most frequent ids route to decides how
many (token, choice) pairs a MoE layer drops, so a permutation per seed
made the seed change the work (a seed's whole window routed alike, and
runs of one seed agreed within 0.1% while seeds differed by 3.5%). A
permutation per batch gives every seed the same work on average."""

from __future__ import annotations

import numpy as np


class ZipfTokens:
    """Zipf-like unigram ids under a permutation of the vocabulary drawn
    per batch, with the copy pattern of the original (the second half of
    each row repeats the first)."""

    def __init__(self, vocab_size: int, seed: int):
        self.vocab_size = vocab_size
        self.seed = int(seed)
        probs = 1.0 / np.arange(1, vocab_size + 1, dtype=np.float64)
        self._probs = probs / probs.sum()

    def batch(self, index: int, rows: int, seq_len: int) -> dict[str, np.ndarray]:
        """Rows ``[rows, seq_len]`` of ids and their next-token labels, a
        pure function of (seed, index, rows, seq_len)."""
        rng = np.random.default_rng([self.seed, int(index), rows, seq_len])
        perm = rng.permutation(self.vocab_size)
        toks = perm[rng.choice(self.vocab_size, size=(rows, seq_len + 1), p=self._probs)]
        half = seq_len // 2
        toks[:, half + 1: seq_len + 1] = toks[:, 1: seq_len - half + 1]
        return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}
