"""K1: masked row gather over P virtual ranks (the pack/unpack hot spot).

Port of the Pallas kernel ``repro.kernels.gather_rows.gather_rows``.  The
CUDA kernel is ``csrc/gather_rows.cu``; its note says what bounds it and
how it is laid out.

    out[p, t] = valid[p, t] ? x[p, idx[p, t]] : 0

``x`` is ``[P, S, *F]`` (any dtype: rows move as raw bytes), ``idx`` is
``[P, N]`` int32 and ``valid`` is ``[P, N]`` bool.  Given ``out``, the
gather writes through: valid rows are stored into ``out`` in place and
invalid rows keep what ``out`` held (the unpack of a standalone epoch
stores straight into the plan's window this way).

A CPU tensor takes the plain version below; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .ref import gather_rows_ref

KERNEL = _build.register(_build.CudaKernel(
    "gather_rows", "gather_rows", "repro_gather_rows",
    [_build.VOIDP] * 4 + [_build.I64] * 4 + [_build.INT, _build.VOIDP]))


def row_bytes(x: torch.Tensor) -> int:
    """Bytes of one row of ``x [P, rows, *F]``."""
    return math.prod(x.shape[2:]) * x.element_size()


def _out_shape(x, idx, valid, out) -> tuple[int, ...]:
    if x.dim() < 2:
        raise ValueError(f"x must be [P, S, *F], got {tuple(x.shape)}")
    if idx.dim() != 2 or idx.shape[0] != x.shape[0] or valid.shape != idx.shape:
        raise ValueError(f"idx/valid must be [P={x.shape[0]}, N], got "
                         f"{tuple(idx.shape)}/{tuple(valid.shape)}")
    if idx.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError(f"idx must be int32 and valid bool, got "
                         f"{idx.dtype}/{valid.dtype}")
    shape = (x.shape[0], idx.shape[1]) + tuple(x.shape[2:])
    if out is not None and (tuple(out.shape) != shape or out.dtype != x.dtype):
        raise ValueError(f"out must be {shape} {x.dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    return shape


def gather_rows(x: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
    shape = _out_shape(x, idx, valid, out)
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx, valid, out)
    _build.check_cuda(x, idx, valid, *(() if out is None else (out,)))
    skip_invalid = out is not None
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    KERNEL.launch(x.data_ptr(), idx.data_ptr(), valid.data_ptr(),
                  out.data_ptr(), x.shape[0], x.shape[1], idx.shape[1],
                  row_bytes(x), int(skip_invalid), _build.stream_handle(x))
    return out


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: the CPU path, and the card's yardstick."""
    _out_shape(x, idx, valid, out)
    KERNEL.plain_calls += 1
    rows = gather_rows_ref(x, idx, valid)
    if out is None:
        return rows
    mask = valid.reshape(valid.shape + (1,) * (rows.dim() - 2))
    out.copy_(torch.where(mask, rows, out))
    return out
