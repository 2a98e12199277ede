# Copied from src/repro/data/pipeline.py; its unused jax imports dropped.
"""Deterministic synthetic token pipeline.

Stateless by construction: ``batch_for_step(step)`` is a pure function of
(seed, step, shape), so checkpoint restart resumes the exact data stream with
no pipeline state to save — the fault-tolerance contract of the framework.
Host-sharding is positional: each data-parallel host slices its rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "SyntheticTokens", "make_pipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    memory_len: int = 0   # >0: also emit stub frame/patch embeddings
    d_model: int = 0


class SyntheticTokens:
    """Zipf-ish synthetic LM stream with next-token labels."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # Zipf-like unigram distribution fixed by seed (structured enough
        # that loss decreases during the e2e example runs).
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        probs /= probs.sum()
        self._probs = probs
        self._perm = rng.permutation(cfg.vocab_size)

    def batch_for_step(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ step)
        base = rng.choice(
            cfg.vocab_size, size=(cfg.global_batch, cfg.seq_len + 1), p=self._probs
        )
        toks = self._perm[base]
        # Inject a copy pattern so models can actually learn something.
        half = cfg.seq_len // 2
        toks[:, half + 1 : cfg.seq_len + 1] = toks[:, 1 : cfg.seq_len - half + 1]
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if cfg.memory_len:
            batch["memory"] = rng.standard_normal(
                (cfg.global_batch, cfg.memory_len, cfg.d_model)
            ).astype(np.float32)
        return batch

    def host_shard(
        self, batch: dict[str, np.ndarray], host_id: int, n_hosts: int
    ) -> dict[str, np.ndarray]:
        per = self.cfg.global_batch // n_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in batch.items()}


def make_pipeline(cfg: DataConfig) -> SyntheticTokens:
    return SyntheticTokens(cfg)
