"""Exchange bodies of the persistent alltoallv engine (port of
``repro.core.variants``: fence, lock and the local pack/unpack).

The JAX package runs these per shard inside ``shard_map``.  The port runs
P virtual ranks on one device, so every function takes the global view
with a leading rank dimension: send buffers ``[P, S, *F]``, bucketed
layouts ``[P, P*C, *F]``, index tables ``[P, N]``.

  fence  one epoch in which every bucket moves at once: the hand-written
         fence kernel (K2), the analogue of the ``MPI_Win_fence`` pair
         bracketing all puts.
  lock   (P-1) serialised pairwise rounds (ring or XOR pairwise schedule),
         each shrunk to its round capacity and elided when empty: the lock
         kernel (K4), one launch per active round.

``pack_rows`` / ``unpack_rows`` are the ``pack_impl="jnp"`` gathers
(``index_select`` plus a mask, as the JAX package's are ``jnp.take`` plus a
mask); ``pack_impl="pallas"`` takes the gather kernel (K1) in
``repro_torch.kernels.ops`` instead.  The leader-combined hierarchy and the
ragged exchange arrive with their own slices.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..kernels import ops as kops


# ---------------------------------------------------------------------------
# Local pack / unpack (the "jnp" path; the kernel path lives in kernels.ops)
# ---------------------------------------------------------------------------


def _take_rows(x: torch.Tensor, src_idx: torch.Tensor) -> torch.Tensor:
    p, s = x.shape[:2]
    offs = torch.arange(p, device=x.device, dtype=torch.int64).unsqueeze(1) * s
    flat = x.reshape((p * s,) + tuple(x.shape[2:]))
    rows = flat.index_select(0, (src_idx.long() + offs).reshape(-1))
    return rows.reshape(tuple(src_idx.shape) + tuple(x.shape[2:]))


def pack_rows(x: torch.Tensor, src_idx: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Gather ragged send rows into the bucketed layout.

    x:       [P, S, *F]   ragged send buffers (padded to the max over ranks)
    src_idx: [P, P*C]     gather map (constant under a persistent plan)
    valid:   [P, P*C]     padding mask
    """
    out = _take_rows(x, src_idx)
    mask = valid.reshape(valid.shape + (1,) * (out.dim() - 2))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def unpack_rows(buckets: torch.Tensor, src_idx: torch.Tensor,
                valid: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Gather the bucketed recv layout back into the ragged recv buffers.
    Given ``out``, only valid rows are written into it (write-through)."""
    rows = _take_rows(buckets, src_idx)
    mask = valid.reshape(valid.shape + (1,) * (rows.dim() - 2))
    if out is None:
        return torch.where(mask, rows, torch.zeros((), dtype=rows.dtype,
                                                   device=rows.device))
    out.copy_(torch.where(mask, rows, out))
    return out


# ---------------------------------------------------------------------------
# Fence: one epoch, every bucket in flight
# ---------------------------------------------------------------------------


def fence_exchange(packed: torch.Tensor, p: int, capacity: int) -> torch.Tensor:
    """[P, P*C, *F] -> [P, P*C, *F]; output bucket j of rank i holds rank
    j's data for i."""
    return kops.rma_alltoallv(packed, variant="fence", p=p, capacity=capacity)


# ---------------------------------------------------------------------------
# Lock: per-target pairwise epochs
# ---------------------------------------------------------------------------


def lock_exchange(
    packed: torch.Tensor,
    p: int,
    capacity: int,
    round_capacities: Sequence[int] | None,
    schedule: str = "ring",
) -> torch.Tensor:
    """(P-1) serialized pairwise rounds; round r moves bucket (i -> i+r).

    ``round_capacities[r]`` lets a *persistent* plan shrink each round to the
    largest message actually exchanged in it — metadata a non-persistent call
    cannot exploit (it passes None: every round at the global capacity).  A
    round capacity of 0 means the round carries no data on any rank, and the
    persistent schedule elides it: no launch.  Rows of a received bucket
    above its round capacity are zero.
    """
    return kops.rma_alltoallv(packed, variant="lock", p=p, capacity=capacity,
                              round_capacities=round_capacities,
                              schedule=schedule)


# ---------------------------------------------------------------------------
# Metadata recomputed on the device (the *non-persistent* path pays this per
# call).  Persistent plans bake their index maps on host at INIT
# (metadata.baked_index_tables); these twins exist so baseline.py models
# the per-call cost honestly, and for baked_metadata=False plans.
# ---------------------------------------------------------------------------


def exchange_counts_in_graph(counts: torch.Tensor) -> torch.Tensor:
    """Every rank's send-count row -> its recv-count row: the INIT-time
    ``MPI_Alltoall(sendcounts)``.  Over virtual ranks it is a transpose."""
    return counts.t().contiguous()


def pack_index_map_in_graph(
    counts_rows: torch.Tensor, displs_rows: torch.Tensor, p: int, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device twin of ``metadata.pack_index_map`` for every rank: [P, P*C]."""
    t = torch.arange(p * capacity, device=counts_rows.device)
    peer = t // capacity
    k = t % capacity
    cnt = counts_rows[:, peer]
    valid = k < cnt
    src = displs_rows[:, peer] + torch.minimum(k, (cnt - 1).clamp(min=0))
    return torch.where(valid, src, 0).to(torch.int32), valid


def unpack_index_map_in_graph(
    recv_counts_rows: torch.Tensor, rdispls_rows: torch.Tensor, p: int,
    capacity: int, out_rows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device twin of ``metadata.unpack_index_map``: [P, out_rows]."""
    m = torch.arange(out_rows, device=recv_counts_rows.device,
                     dtype=rdispls_rows.dtype)
    edges = torch.cat([rdispls_rows,
                       (rdispls_rows[:, -1] + recv_counts_rows[:, -1])[:, None]],
                      dim=1)
    queries = m.expand(recv_counts_rows.shape[0], out_rows).contiguous()
    peer = (torch.searchsorted(edges, queries, right=True) - 1).clamp(0, p - 1)
    within = m - rdispls_rows.gather(1, peer)
    valid = within < recv_counts_rows.gather(1, peer)
    src = peer * capacity + within.clamp(max=capacity - 1)
    return torch.where(valid, src, 0).to(torch.int32), valid


def displacements_in_graph(counts_rows: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along each rank's row."""
    return torch.cumsum(counts_rows, dim=1) - counts_rows
