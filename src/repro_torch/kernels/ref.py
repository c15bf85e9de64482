"""Plain oracles for the port's kernels (port of ``repro.kernels.ref``).

The kernels run over P virtual ranks at once, so the row gather here takes
a leading rank dimension: ``x [P, S, *F]``, ``idx``/``valid [P, N]``.
"""

from __future__ import annotations

import numpy as np
import torch


def gather_rows_ref(x: torch.Tensor, idx: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Masked row gather per rank: out[p, t] = valid[p, t] ? x[p, idx[p, t]] : 0."""
    ranks = torch.arange(x.shape[0], device=x.device).unsqueeze(1)
    out = x[ranks, idx.long()]
    mask = valid.bool().reshape(valid.shape + (1,) * (out.dim() - 2))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def a2a_bucketed_ref(packed_all: np.ndarray, p: int, capacity: int) -> np.ndarray:
    """Global oracle for the bucketed exchange (fence and lock kernels share
    identical functional semantics — only synchronization differs).

    packed_all: [P, P*C, F...] every rank's bucketed send buffer.
    returns:    [P, P*C, F...] where out[i, j*C:(j+1)*C] = packed[j, i*C:(i+1)*C].
    """
    out = np.zeros_like(packed_all)
    for i in range(p):
        for j in range(p):
            out[i, j * capacity:(j + 1) * capacity] = \
                packed_all[j, i * capacity:(i + 1) * capacity]
    return out
