"""Count matrices the port is checked and measured on (plain numpy).

Copies of the JAX package's generators, so the port's tests and
``chip_smoke.py`` need nothing of that package:

  random_counts          ``repro.testing.dist_cases._setup_pattern``
  banded_counts          ``repro.testing.dist_cases._banded_counts``
  hugetrace_like_counts  ``benchmarks/sparse_pattern.py``
  ragged_counts          ``benchmarks/collective_sweep.py`` (a [P] vector)
"""

from __future__ import annotations

import numpy as np


def random_counts(p: int, seed: int = 0, max_count: int = 13) -> np.ndarray:
    """Uniform random counts in [0, max_count)."""
    return np.random.default_rng(seed).integers(0, max_count, size=(p, p))


def banded_counts(p: int, width: int = 1, base: int = 11, seed: int = 3) -> np.ndarray:
    """Sparse ring-banded pattern: counts only within ``width`` ring hops,
    so lock rounds beyond ``width`` hops carry nothing and are elided."""
    rng = np.random.default_rng(seed)
    c = np.zeros((p, p), np.int64)
    for i in range(p):
        for d in range(-width, width + 1):
            c[i, (i + d) % p] = rng.integers(1, base)
    return c


def hugetrace_like_counts(p: int, base_rows: int, seed: int = 7,
                          hot_ranks=(5, 6, 7), hot_factor: float = 6.0) -> np.ndarray:
    """Banded structure plus receiver hot spots (the paper's hugetrace-00020
    signature: near-diagonal locality, a few heavily loaded receivers)."""
    rng = np.random.default_rng(seed)
    c = np.zeros((p, p), np.int64)
    for i in range(p):
        for j in range(p):
            band = max(0.0, 1.0 - abs(i - j) / 2.5)     # near-diagonal locality
            c[i, j] = rng.poisson(base_rows * (0.15 + band))
    for j in hot_ranks:                                  # skewed receivers
        c[:, j] = (c[:, j] * hot_factor).astype(np.int64)
    return c


def ragged_counts(p: int, seed: int = 5) -> np.ndarray:
    """Ragged ``[P]`` count vector with one hot rank: the padding gate for
    the allgatherv and reduce-scatter families."""
    rng = np.random.default_rng(seed)
    c = rng.integers(8, 48, p).astype(np.int64)
    c[0] += 64
    return c
