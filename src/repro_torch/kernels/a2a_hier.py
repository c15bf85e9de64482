"""K5: stage 2 of the leader-combined hierarchy over P virtual ranks.

Port of the Pallas kernel ``repro.kernels.a2a_hier.rma_hier_leader_exchange``
(the fused inter-group leader epoch).  The CUDA kernel is
``csrc/a2a_hier.cu``; its note says how the leader barrier and the staging
slabs of the TPU kernel become launch boundaries on one device.

It computes ``core.variants.stage2_leader_ppermute``: for each destination
rank ``dst`` and each row ``r`` of macro-round ``m``'s slab,

    src = s2_from[dst, m]                 (the schedule's round_perms[m] pair)
    out[dst, r] = src >= 0 and s2_valid[src, r] ? s1_recv[src, s2_src[src, r]] : 0

``s1_recv`` is ``[P, S1, *F]`` (any dtype: rows move as raw bytes),
``s2_src``/``s2_valid`` are ``[P, total_s2]`` int32/bool, ``s2_from`` is
``[P, n_macro]`` int32 and ``row_round`` the ``[total_s2]`` int16 round of
each slab row (``metadata.hier_stage2_from`` and ``hier_row_rounds`` bake
both at INIT).  The Pallas kernel addresses its partner by the physical
inner rank and so ignores ``hier_leader_perm``; this kernel follows the
schedule's leader roles.

A CPU tensor takes the plain version in this module; a CUDA tensor
launches the kernel or raises; a ``meta`` tensor gets the output's shape.
"""

from __future__ import annotations

import torch

from . import _build
from .gather_rows import row_bytes
from .ref import gather_rows_ref

HIER = _build.register(_build.CudaKernel(
    "a2a_hier", "a2a_hier", "repro_hier_leader_exchange",
    [_build.VOIDP] * 6 + [_build.I64] * 5 + [_build.VOIDP], kid="K5"))


def _out_shape(s1_recv, s2_src, s2_valid, s2_from, row_round) -> tuple[int, ...]:
    if s1_recv.dim() < 2:
        raise ValueError(f"s1_recv must be [P, S1, *F], got {tuple(s1_recv.shape)}")
    p = s1_recv.shape[0]
    if (s2_src.dim() != 2 or s2_src.shape[0] != p
            or s2_valid.shape != s2_src.shape):
        raise ValueError(f"s2_src/s2_valid must be [P={p}, total_s2], got "
                         f"{tuple(s2_src.shape)}/{tuple(s2_valid.shape)}")
    if s2_from.dim() != 2 or s2_from.shape[0] != p:
        raise ValueError(f"s2_from must be [P={p}, n_macro], got "
                         f"{tuple(s2_from.shape)}")
    if tuple(row_round.shape) != (s2_src.shape[1],):
        raise ValueError(f"row_round must be [total_s2={s2_src.shape[1]}], got "
                         f"{tuple(row_round.shape)}")
    if (s2_src.dtype != torch.int32 or s2_valid.dtype != torch.bool
            or s2_from.dtype != torch.int32 or row_round.dtype != torch.int16):
        raise ValueError(
            f"s2_src, s2_valid, s2_from and row_round must be int32, bool, "
            f"int32 and int16, got {s2_src.dtype}, {s2_valid.dtype}, "
            f"{s2_from.dtype} and {row_round.dtype}")
    return (p, s2_src.shape[1]) + tuple(s1_recv.shape[2:])


@_build.counted(HIER, lambda out, *tensors: (
    0, _build.tensor_bytes(*tensors, out)))
def rma_hier_leader_exchange(s1_recv: torch.Tensor, s2_src: torch.Tensor,
                             s2_valid: torch.Tensor, s2_from: torch.Tensor,
                             row_round: torch.Tensor) -> torch.Tensor:
    """Stage-1 recv buffers ``[P, S1, *F]`` -> stage-2 recv buffers
    ``[P, total_s2, *F]``: every active round's slabs in one launch (on
    ``meta`` the output's shape alone)."""
    shape = _out_shape(s1_recv, s2_src, s2_valid, s2_from, row_round)
    if s1_recv.device.type == "meta":
        _build.check_meta(s1_recv, s2_src, s2_valid, s2_from, row_round)
        return s1_recv.new_empty(shape)
    if s1_recv.device.type == "cpu":
        return rma_hier_leader_exchange_plain(s1_recv, s2_src, s2_valid,
                                              s2_from, row_round)
    _build.check_cuda(s1_recv, s2_src, s2_valid, s2_from, row_round)
    out = torch.empty(shape, dtype=s1_recv.dtype, device=s1_recv.device)
    if out.numel() == 0:
        return out                   # no slab row: nothing to launch
    HIER.launch(s1_recv.data_ptr(), s2_src.data_ptr(), s2_valid.data_ptr(),
                s2_from.data_ptr(), row_round.data_ptr(), out.data_ptr(),
                shape[0], s1_recv.shape[1], shape[1], s2_from.shape[1],
                row_bytes(s1_recv), _build.stream_handle(s1_recv))
    return out


def rma_hier_leader_exchange_plain(s1_recv: torch.Tensor, s2_src: torch.Tensor,
                                   s2_valid: torch.Tensor, s2_from: torch.Tensor,
                                   row_round: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the CPU path, and the card's yardstick."""
    _out_shape(s1_recv, s2_src, s2_valid, s2_from, row_round)
    HIER.plain_calls += 1
    slabs = gather_rows_ref(s1_recv, s2_src, s2_valid)      # every leader's slabs
    src = s2_from.long()[:, row_round.long()]               # [P, total_s2]
    rows = torch.arange(src.shape[1], device=src.device)
    out = slabs[src.clamp(min=0), rows[None, :]]
    mask = (src >= 0).reshape(src.shape + (1,) * (out.dim() - 2))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))
