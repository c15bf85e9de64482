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

from .a2a_fence import rma_alltoallv_fence, rma_alltoallv_fence_fused
from .a2a_lock import rma_alltoallv_lock
from .gather_rows import gather_rows


def pack(x: torch.Tensor, src_idx: torch.Tensor,
         valid: torch.Tensor) -> torch.Tensor:
    """Ragged send buffers ``[P, S, *F]`` -> bucketed layout ``[P, P*C, *F]``."""
    return gather_rows(x, src_idx, valid)


def unpack(buckets: torch.Tensor, src_idx: torch.Tensor, valid: torch.Tensor,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """Bucketed recv layout -> ragged recv buffers ``[P, recv_rows, *F]``.
    Given ``out``, valid rows are stored into it in place (write-through)."""
    return gather_rows(buckets, src_idx, valid, out=out)


def fused_pack_alltoallv(x: torch.Tensor, src_idx: torch.Tensor,
                         valid: torch.Tensor, *, p: int,
                         capacity: int) -> torch.Tensor:
    """Fused pack + fence epoch: rows go from the ragged send buffers
    straight into their destination buckets."""
    return rma_alltoallv_fence_fused(x, src_idx, valid, p, capacity)


def rma_alltoallv(packed: torch.Tensor, *, variant: str, p: int, capacity: int,
                  round_capacities: Sequence[int] | None = None,
                  schedule: str = "ring") -> torch.Tensor:
    """Bucketed alltoallv, ``[P, P*C, *F]`` -> ``[P, P*C, *F]``.

    variant="fence": one epoch, all bucket copies in flight at once.
    variant="lock":  serialised rounds, one launch per active round.
    """
    if variant == "fence":
        return rma_alltoallv_fence(packed, p, capacity)
    if variant == "lock":
        return rma_alltoallv_lock(packed, p, capacity, round_capacities,
                                  schedule)
    raise ValueError(f"variant must be 'fence' or 'lock', got {variant!r}")
