"""Pure-numpy global oracle for alltoallv — the correctness reference.

A copy of ``repro.core.reference`` (the port imports nothing of the JAX
package).  Operates on the *global* view: given every rank's ragged send
buffer and the count matrix, produce every rank's ragged recv buffer.  All
backends, kernels, and the baseline are tested against this.
"""

from __future__ import annotations

import numpy as np

from . import metadata as md


def alltoallv_global(
    sendbufs: np.ndarray,      # [P, S_rows, F...] padded ragged send buffers
    send_counts: np.ndarray,   # [P, P]
    recv_rows: int,
) -> np.ndarray:
    """Returns [P, recv_rows, F...]; rows beyond a rank's total recv are 0."""
    sc = np.asarray(send_counts, np.int64)
    p = sc.shape[0]
    sd = md.displacements(sc)
    rc = md.recv_counts(sc)
    rd = md.displacements(rc)
    out = np.zeros((p, recv_rows) + sendbufs.shape[2:], sendbufs.dtype)
    for i in range(p):          # sender
        for j in range(p):      # receiver
            n = sc[i, j]
            if n == 0:
                continue
            out[j, rd[j, i]: rd[j, i] + n] = sendbufs[i, sd[i, j]: sd[i, j] + n]
    return out


def make_testbufs(send_counts: np.ndarray, feature_shape=(), dtype=np.float32,
                  send_rows: int | None = None, seed: int = 0) -> np.ndarray:
    """Deterministic per-(sender, dest, row) payload for element-wise checks.

    Mirrors the paper's validation pattern (elements destined for rank j are
    tagged with the sender's identity) but with full-rank uniqueness: value =
    hash(sender, dest, row_within_block, feature_pos) so any misrouting or
    offset error is caught, not just sender mixups.
    """
    rng = np.random.default_rng(seed)
    sc = np.asarray(send_counts, np.int64)
    p = sc.shape[0]
    sd = md.displacements(sc)
    rows = send_rows if send_rows is not None else int(sc.sum(axis=1).max(initial=1))
    rows = max(rows, 1)
    bufs = np.zeros((p, rows) + tuple(feature_shape), dtype)
    for i in range(p):
        for j in range(p):
            n = int(sc[i, j])
            if n == 0:
                continue
            block = rng.standard_normal((n,) + tuple(feature_shape)).astype(dtype)
            # Tag plane 0 with a unique (sender, dest, k) code when possible.
            code = (i * p + j) * 1000 + np.arange(n)
            if block.ndim == 1:
                block = code.astype(dtype)
            else:
                flat = block.reshape(n, -1)
                flat[:, 0] = code.astype(dtype)
                block = flat.reshape(block.shape)
            bufs[i, sd[i, j]: sd[i, j] + n] = block
    return bufs
