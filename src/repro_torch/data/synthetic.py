"""Deterministic synthetic LM data: seeded, checkpointable, shard-aware
(port of ``repro.data.synthetic``, numpy only: the batches are the JAX
package's bit for bit).

Token streams are generated per (seed, step) so a restarted run resumes on
exactly the batch it would have seen — the data side of fault tolerance.
A Zipf-like marginal over the vocab plus short repeated motifs gives the
loss curve actual structure to learn (unlike uniform noise).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.3
    motif_len: int = 16
    motif_prob: float = 0.5


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -a
    return p / p.sum()


class SyntheticTokens:
    """Stateless-per-step batch generator (state = step index)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._probs = _zipf_probs(cfg.vocab_size, cfg.zipf_a)

    def batch_at(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        toks = rng.choice(cfg.vocab_size, size=(cfg.global_batch, cfg.seq_len),
                          p=self._probs).astype(np.int32)
        # plant repeated motifs: predictable continuations to learn
        n_mot = int(cfg.motif_prob * cfg.global_batch)
        if n_mot and cfg.seq_len >= 2 * cfg.motif_len:
            rows = rng.choice(cfg.global_batch, size=n_mot, replace=False)
            motif = rng.choice(min(1000, cfg.vocab_size),
                               size=(n_mot, cfg.motif_len)).astype(np.int32)
            reps = cfg.seq_len // cfg.motif_len
            tiled = np.tile(motif, (1, reps))[:, :cfg.seq_len]
            toks[rows] = tiled
        return toks


@dataclasses.dataclass(frozen=True)
class MultimodalConfig:
    frontend_len: int
    frontend_dim: int


def stub_frontend_batch(step: int, batch: int, length: int, dim: int,
                        seed: int = 99) -> np.ndarray:
    """Precomputed frame/patch embeddings for the audio/vlm stubs."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    return (rng.standard_normal((batch, length, dim)) * 0.02).astype(np.float32)
