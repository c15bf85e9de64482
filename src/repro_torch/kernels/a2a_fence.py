"""K2 and K3: the fence-synchronised alltoallv epoch over P virtual ranks.

Port of the Pallas kernels ``repro.kernels.a2a_fence.rma_alltoallv_fence``
(the paper's Algorithm 1) and ``rma_alltoallv_fence_fused`` (the same epoch
with the pack gather fused in).  The CUDA kernels are in
``csrc/a2a_fence.cu``; its note says how the epoch's open and close
barriers become launch boundaries on one device.

Layout, global view: rank ``i`` owns ``packed[i]`` (bucket ``j`` holds its
rows for rank ``j``) and ``out[i]`` (bucket ``j`` holds rank ``j``'s rows
for it):

    out[tgt][src*C + k] = packed[src][tgt*C + k]

K2 also exchanges ``groups`` independent groups of ``p`` ranks in one
launch (``packed [groups*p, p*C, *F]``, group ``g`` owning ranks
``g*p .. g*p+p-1``): the inner all-to-alls of the leader-combined hierarchy.

A CPU tensor takes the plain version in this module; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .gather_rows import row_bytes
from .ref import gather_rows_ref

FENCE = _build.register(_build.CudaKernel(
    "a2a_fence", "a2a_fence", "repro_a2a_fence",
    [_build.VOIDP, _build.VOIDP] + [_build.I64] * 4 + [_build.VOIDP]))
FUSED = _build.register(_build.CudaKernel(
    "a2a_fence_fused", "a2a_fence", "repro_a2a_fence_fused",
    [_build.VOIDP] * 4 + [_build.I64] * 4 + [_build.VOIDP]))


def _check_packed(packed: torch.Tensor, p: int, capacity: int,
                  groups: int = 1) -> None:
    want = (groups * p, p * capacity)
    if packed.dim() < 2 or tuple(packed.shape[:2]) != want:
        raise ValueError(f"packed must be [G*P={want[0]}, P*C={want[1]}, *F], "
                         f"got {tuple(packed.shape)}")


def _transpose_buckets(packed: torch.Tensor, p: int, capacity: int,
                       groups: int = 1) -> torch.Tensor:
    feat = tuple(packed.shape[2:])
    return (packed.reshape((groups, p, p, capacity) + feat).transpose(1, 2)
            .contiguous().view((groups * p, p * capacity) + feat))


def rma_alltoallv_fence(packed: torch.Tensor, p: int, capacity: int,
                        groups: int = 1) -> torch.Tensor:
    """[G*P, P*C, *F] -> [G*P, P*C, *F]: the whole fence epoch of every
    group in one launch."""
    _check_packed(packed, p, capacity, groups)
    if packed.device.type == "cpu":
        return rma_alltoallv_fence_plain(packed, p, capacity, groups)
    _build.check_cuda(packed)
    out = torch.empty_like(packed)
    FENCE.launch(packed.data_ptr(), out.data_ptr(), groups, p, capacity,
                 row_bytes(packed), _build.stream_handle(packed))
    return out


def rma_alltoallv_fence_plain(packed: torch.Tensor, p: int, capacity: int,
                              groups: int = 1) -> torch.Tensor:
    _check_packed(packed, p, capacity, groups)
    FENCE.plain_calls += 1
    return _transpose_buckets(packed, p, capacity, groups)


def _check_fused(x, src_idx, valid, p, capacity) -> None:
    if x.dim() < 2 or x.shape[0] != p:
        raise ValueError(f"x must be [P={p}, S, *F], got {tuple(x.shape)}")
    if tuple(src_idx.shape) != (p, p * capacity) or valid.shape != src_idx.shape:
        raise ValueError(f"src_idx/valid must be [{p}, {p * capacity}], got "
                         f"{tuple(src_idx.shape)}/{tuple(valid.shape)}")
    if src_idx.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError(f"src_idx must be int32 and valid bool, got "
                         f"{src_idx.dtype}/{valid.dtype}")


def rma_alltoallv_fence_fused(x: torch.Tensor, src_idx: torch.Tensor,
                              valid: torch.Tensor, p: int,
                              capacity: int) -> torch.Tensor:
    """Fused pack + fence epoch: ragged ``x [P, S, *F]`` and the baked pack
    tables ``[P, P*C]`` -> the bucketed recv layout ``[P, P*C, *F]``; the
    padded send layout is never written."""
    _check_fused(x, src_idx, valid, p, capacity)
    if x.device.type == "cpu":
        return rma_alltoallv_fence_fused_plain(x, src_idx, valid, p, capacity)
    _build.check_cuda(x, src_idx, valid)
    out = torch.empty((p, p * capacity) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    FUSED.launch(x.data_ptr(), src_idx.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), p, x.shape[1], capacity, row_bytes(x),
                 _build.stream_handle(x))
    return out


def rma_alltoallv_fence_fused_plain(x: torch.Tensor, src_idx: torch.Tensor,
                                    valid: torch.Tensor, p: int,
                                    capacity: int) -> torch.Tensor:
    _check_fused(x, src_idx, valid, p, capacity)
    FUSED.plain_calls += 1
    return _transpose_buckets(gather_rows_ref(x, src_idx, valid), p, capacity)
