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

Which K3 kernel a call takes (``fused_kernel_for``), by a rule on the
inputs alone:

- CPU tensors: the plain version below;
- CUDA tensors whose row width is a multiple of 16 bytes up to 32 KiB on a
  16-byte aligned ``x``: ``fence_fused_bulk_kernel``, one output tile of
  about 8 KiB per block, each tile's runs of consecutive source rows moved
  with 1-D TMA bulk copies and all-invalid tiles stored as zeros (counter
  ``FUSED_BULK``);
- other CUDA tensors: ``fence_fused_kernel``, one warp per output row
  (counter ``FUSED``).

K2 takes CPU tensors to its plain version and CUDA tensors to its kernel.
No kernel is a fallback for another: a build or launch error raises.
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
FUSED_BULK = _build.register(_build.CudaKernel(
    "a2a_fence_fused_bulk", "a2a_fence", "repro_a2a_fence_fused_bulk",
    [_build.VOIDP] * 4 + [_build.I64] * 5 + [_build.VOIDP]))

# The bulk kernel's tiles (csrc/a2a_fence.cu): about 8 KiB of rows, at
# most 32 rows (one table word per lane), rows of at most 32 KiB; bulk
# copies move 16-byte multiples.
TILE_BYTES = 8192
MAX_TILE_ROWS = 32
MAX_ROW_BYTES = 32768
BULK_ALIGN = 16


def fused_kernel_choice(device_type: str, row_width: int, x_addr: int) -> str:
    """The rule of ``fused_kernel_for`` on plain values: "plain", "bulk" or
    "warp"."""
    if device_type == "cpu":
        return "plain"
    if (0 < row_width <= MAX_ROW_BYTES and row_width % BULK_ALIGN == 0
            and x_addr % BULK_ALIGN == 0):
        return "bulk"
    return "warp"


def fused_kernel_for(x: torch.Tensor) -> str:
    """Which kernel ``rma_alltoallv_fence_fused(x, ...)`` takes."""
    return fused_kernel_choice(x.device.type, row_bytes(x), x.data_ptr())


def fused_cuda_kernel(row_width: int) -> _build.CudaKernel:
    """The K3 kernel a CUDA call with rows of ``row_width`` bytes on an
    aligned ``x`` (any fresh torch allocation) launches: what a plan names."""
    return (FUSED_BULK if fused_kernel_choice("cuda", row_width, 0) == "bulk"
            else FUSED)


def fused_tile_rows(row_width: int) -> int:
    """Rows of one tile (one block's stage) of the bulk kernel."""
    return max(1, min(MAX_TILE_ROWS, TILE_BYTES // row_width))


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
    padded send layout is never written.  On CUDA the kernel
    ``fused_kernel_for`` names."""
    _check_fused(x, src_idx, valid, p, capacity)
    if x.device.type == "cpu":
        return rma_alltoallv_fence_fused_plain(x, src_idx, valid, p, capacity)
    if fused_kernel_for(x) == "bulk":
        return fence_fused_bulk_kernel(x, src_idx, valid, p, capacity)
    return fence_fused_warp_kernel(x, src_idx, valid, p, capacity)


def _fused_out(x, src_idx, valid, p, capacity) -> torch.Tensor:
    _check_fused(x, src_idx, valid, p, capacity)
    _build.check_cuda(x, src_idx, valid)
    return torch.empty((p, p * capacity) + tuple(x.shape[2:]), dtype=x.dtype,
                       device=x.device)


def fence_fused_bulk_kernel(x: torch.Tensor, src_idx: torch.Tensor,
                            valid: torch.Tensor, p: int,
                            capacity: int) -> torch.Tensor:
    """K3 by ``fence_fused_bulk_kernel`` (CUDA only; the launcher refuses
    rows or bases it cannot take)."""
    out = _fused_out(x, src_idx, valid, p, capacity)
    rb = row_bytes(x)
    FUSED_BULK.launch(x.data_ptr(), src_idx.data_ptr(), valid.data_ptr(),
                      out.data_ptr(), p, x.shape[1], capacity, rb,
                      fused_tile_rows(rb) if rb else 1,
                      _build.stream_handle(x))
    return out


def fence_fused_warp_kernel(x: torch.Tensor, src_idx: torch.Tensor,
                            valid: torch.Tensor, p: int,
                            capacity: int) -> torch.Tensor:
    """K3 by ``fence_fused_kernel``, one warp per row (CUDA only; any row
    width and base)."""
    out = _fused_out(x, src_idx, valid, p, capacity)
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
