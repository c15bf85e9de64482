"""Public wrappers around the port's kernels (port of ``repro.kernels.ops``).

The JAX package pads features to the TPU's 128 lanes and picks a row tile
that divides the row count; both are TPU tiling rules, and the Hopper
kernels need neither: they move rows of any byte width and any count.
Every function takes the global view over P virtual ranks (leading
dimension P).  CPU tensors run the kernels' plain versions, CUDA tensors
the kernels.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .a2a_fence import (rma_alltoallv_fence, rma_alltoallv_fence_fused,
                        rma_alltoallv_fence_fused_peer, rma_alltoallv_fence_peer)
from .a2a_hier import rma_hier_leader_exchange
from .a2a_lock import rma_alltoallv_lock, rma_alltoallv_lock_peer
from .gather_matmul import gather_matmul
from .gather_rows import gather_rows


def pack(x: torch.Tensor, src_idx: torch.Tensor, valid: torch.Tensor, *,
         x2: torch.Tensor | None = None,
         runs: torch.Tensor | None = None) -> torch.Tensor:
    """Ragged send buffers ``[P, S, *F]`` -> bucketed layout ``[P, P*C, *F]``.
    ``x2`` is a second source read past ``x``'s rows; ``runs`` the tables'
    INIT-baked run table (``gather_rows.bake_runs`` of ``src_idx`` and
    ``valid``)."""
    return gather_rows(x, src_idx, valid, x2=x2, runs=runs)


def unpack(buckets: torch.Tensor, src_idx: torch.Tensor, valid: torch.Tensor,
           out: torch.Tensor | None = None, *,
           runs: torch.Tensor | None = None) -> torch.Tensor:
    """Bucketed recv layout -> ragged recv buffers ``[P, recv_rows, *F]``.
    Given ``out``, valid rows are stored into it in place (write-through)."""
    return gather_rows(buckets, src_idx, valid, out=out, runs=runs)


def fused_pack_alltoallv(x: torch.Tensor, src_idx: torch.Tensor,
                         valid: torch.Tensor, *, p: int,
                         capacity: int) -> torch.Tensor:
    """Fused pack + fence epoch: rows go from the ragged send buffers
    straight into their destination buckets.  CUDA tensors take the K3
    kernel ``a2a_fence.fused_kernel_for`` names (the bulk-copy kernel for
    16-byte rows on aligned bases, else one warp per row)."""
    return rma_alltoallv_fence_fused(x, src_idx, valid, p, capacity)


def fused_hier_leader_exchange(s1_recv: torch.Tensor, s2_src: torch.Tensor,
                               s2_valid: torch.Tensor, *, s2_from: torch.Tensor,
                               row_round: torch.Tensor) -> torch.Tensor:
    """Stage 2 of the leader-combined hierarchy in one kernel (K5):
    stage-1 recv buffers ``[P, S1, *F]`` -> stage-2 recv ``[P, total_s2, *F]``.

    ``s2_from`` and ``row_round`` are the device copies of the schedule's
    ``metadata.hier_stage2_from`` and ``hier_row_rounds``, which a plan
    bakes and uploads once.  There is no fallback to
    ``variants.stage2_leader_ppermute``: CPU tensors take K5's plain version.
    """
    return rma_hier_leader_exchange(s1_recv, s2_src, s2_valid, s2_from,
                                    row_round)


def rma_alltoallv(packed: torch.Tensor, *, variant: str, p: int, capacity: int,
                  round_capacities: Sequence[int] | None = None,
                  schedule: str = "ring", groups: int = 1) -> torch.Tensor:
    """Bucketed alltoallv, ``[P, P*C, *F]`` -> ``[P, P*C, *F]``.

    variant="fence": one epoch, all bucket copies in flight at once; with
                     ``groups`` > 1, ``groups`` independent exchanges of P
                     ranks each (``[groups*P, P*C, *F]``) in one launch.
    variant="lock":  serialised rounds; on CUDA the kernel
                     ``a2a_lock.kernel_for`` names: one clustered launch
                     per epoch for 16-byte rows on aligned bases, else one
                     launch per active round.
    """
    if variant == "fence":
        return rma_alltoallv_fence(packed, p, capacity, groups)
    if groups != 1:
        raise ValueError("groups applies to variant='fence' only")
    if variant == "lock":
        return rma_alltoallv_lock(packed, p, capacity, round_capacities,
                                  schedule)
    raise ValueError(f"variant must be 'fence' or 'lock', got {variant!r}")


def rma_alltoallv_peer(packed: torch.Tensor, win, *, variant: str,
                       capacity: int,
                       round_capacities: Sequence[int] | None = None,
                       schedule: str = "ring") -> None:
    """One rank's bucketed exchange with one process per rank: its send
    buckets ``[P*C, *F]`` into every rank's window ``win``
    (``rma_signal.PeerWindow``); nothing is returned, the rows land in the
    windows.  variant="fence": the peer K2 between the window's OPEN and
    CLOSE; "lock": the peer K4, round by round."""
    if variant == "fence":
        rma_alltoallv_fence_peer(packed, win, capacity)
    elif variant == "lock":
        rma_alltoallv_lock_peer(packed, win, capacity, round_capacities,
                                schedule)
    else:
        raise ValueError(f"variant must be 'fence' or 'lock', got {variant!r}")


def fused_pack_alltoallv_peer(x: torch.Tensor, src_idx: torch.Tensor,
                              valid: torch.Tensor, win, *,
                              capacity: int) -> None:
    """The fused pack + fence epoch of one rank with one process per rank:
    its send rows ``x [S, *F]`` through its row of the pack tables straight
    into every rank's window (the peer K3)."""
    rma_alltoallv_fence_fused_peer(x, src_idx, valid, win, capacity)


def fused_unpack_matmul(x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                        valid: torch.Tensor | None = None,
                        scales: torch.Tensor | None = None) -> torch.Tensor:
    """Fused unpack-gather-matmul (K6): ``out[e] = (x[idx[e]] * valid[e]) @ w[e]``.

    The expert FFN's gate and up products read their rows straight out of
    the receive buffer ``x [rows, *F]`` through the regroup table ``idx
    [E, N]``, so the regrouped ``[E, N, D]`` buffer is never written.
    ``scales`` (``[rows, 1]``, a wire codec's per-row dequant factors) is
    handled as the JAX package's kernel path handles it: ``x`` is cast to
    ``w``'s dtype and pre-scaled before the call.  Differentiable in ``x``
    and ``w``; CPU tensors take K6's plain version.
    """
    idx = torch.as_tensor(idx, dtype=torch.int32, device=w.device)
    if valid is None:
        valid = torch.ones(idx.shape, dtype=torch.bool, device=w.device)
    x2d = x.reshape(x.shape[0], -1)
    if scales is not None or x2d.dtype != w.dtype:
        x2d = x2d.to(w.dtype)
        if scales is not None:
            x2d = x2d * scales.to(w.dtype)
    return gather_matmul(x2d, idx, valid.bool(), w)
