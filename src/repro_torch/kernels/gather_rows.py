"""K1: masked row gather over P virtual ranks (the pack/unpack hot spot).

Port of the Pallas kernel ``repro.kernels.gather_rows.gather_rows``.  The
CUDA kernels are in ``csrc/gather_rows.cu``; its note says what bounds them
and how they are laid out.

    out[p, t] = valid[p, t] ? x[p, idx[p, t]] : 0

``x`` is ``[P, S, *F]`` (any dtype: rows move as raw bytes), ``idx`` is
``[P, N]`` int32 and ``valid`` is ``[P, N]`` bool.  Given ``x2``
(``[P, S2, *F]``), the gather reads the two buffers as if concatenated
along dim 1: an index below ``S`` reads ``x``, one at or above it reads
row ``idx - S`` of ``x2`` (the hierarchy's stage-3 pack reads the stage-2
rows and the send buffer this way, so they are never concatenated).
Given ``out``, the gather writes through: valid rows are stored into
``out`` in place and invalid rows keep what ``out`` held (the unpack of a
standalone epoch stores straight into the plan's window this way).

Under a persistent plan ``idx`` and ``valid`` never change, so INIT turns
them into a run table (``gather_runs``): the output in order as chunks of
consecutive source rows landing on consecutive output rows, or of zero
rows.  ``bake_runs`` uploads it as a ``RunTable`` bound to the ``idx`` and
``valid`` tensors it was made from; a call that passes it beside other
tables, or over sources too short for its chunks, is refused on any
device.  Which kernel a call takes (``kernel_for``), by a rule on the
inputs alone:

- CPU tensors: the plain version below;
- ``meta`` tensors: an empty output of the right shape, nothing computed
  or counted as a launch (the dry run traces a step this way);
- CUDA calls that carry a run table, with rows a multiple of 16 bytes and
  16-byte aligned ``x``, ``x2`` and ``out``: ``gather_runs_kernel``, one
  chunk per block (counter ``RUNS``);
- other CUDA calls: ``gather_warp_kernel``, one warp per output row, which
  reads ``idx`` and ``valid`` at run time (counter ``KERNEL``).

No kernel is a fallback for another: a build or launch error raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from .ref import gather_rows_ref

KERNEL = _build.register(_build.CudaKernel(
    "gather_rows", "gather_rows", "repro_gather_rows",
    [_build.VOIDP] * 5 + [_build.I64] * 5 + [_build.INT, _build.VOIDP],
    kid="K1"))
RUNS = _build.register(_build.CudaKernel(
    "gather_rows_runs", "gather_rows", "repro_gather_rows_runs",
    [_build.VOIDP] * 3 + [_build.I64] + [_build.VOIDP] + [_build.I64] * 4
    + [_build.INT, _build.VOIDP], kid="K1"))

# The columns of a run table, one row per chunk (int32).
RANK, OUT_ROW, SOURCE, SRC_ROW, ROWS = range(5)
# SOURCE: rows of x, rows of x2, or zero rows.
FROM_X, FROM_X2, ZEROS = 0, 1, 2
# Most bytes of one chunk (a single wider row is a chunk of its own).
# Chosen on an H100 by timing the pack of chip_smoke.py's configs A and B
# at 8-64 KiB: 16 KiB was the fastest at A and as fast as any at B; larger
# chunks leave fewer blocks to overlap one chunk's loads with another's
# stores, smaller ones spend more of each block on its table read.
RUN_CHUNK_BYTES = 16384
RUN_ALIGN = 16


def row_bytes(x: torch.Tensor) -> int:
    """Bytes of one row of ``x [P, rows, *F]``."""
    return math.prod(x.shape[2:]) * x.element_size()


def gather_runs(idx, valid, row_width: int, split: int | None = None,
                chunk_bytes: int | None = RUN_CHUNK_BYTES) -> np.ndarray:
    """The run table of a constant gather: int32 ``[chunks, 5]``, columns
    ``RANK, OUT_ROW, SOURCE, SRC_ROW, ROWS``, in output order.

    Chunk ``c`` writes rows ``OUT_ROW .. OUT_ROW + ROWS`` of rank ``RANK``'s
    output: zeros (``SOURCE == ZEROS``), or rows ``SRC_ROW .. SRC_ROW +
    ROWS`` of that rank's ``x`` (``FROM_X``) or ``x2`` (``FROM_X2``).  A
    chunk is a run of consecutive source rows landing on consecutive output
    rows (or of invalid rows), cut to at most ``chunk_bytes // row_width``
    rows (at least one; ``None``: not cut).  With ``split``, an index below
    it reads ``x`` and one at or above it row ``idx - split`` of ``x2``; no
    run straddles the split.
    """
    idx = np.asarray(idx, np.int64)
    valid = np.asarray(valid, bool)
    if idx.ndim != 2 or valid.shape != idx.shape:
        raise ValueError(f"idx/valid must be [P, N], got {idx.shape}/{valid.shape}")
    p, n = idx.shape
    if idx.size == 0:
        return np.zeros((0, 5), np.int32)
    second = (idx >= split) if split is not None else np.zeros_like(valid)
    source = np.where(valid, np.where(second, FROM_X2, FROM_X), ZEROS)
    row = np.where(valid, idx - np.where(second, split or 0, 0), 0)
    new = np.ones((p, n), bool)
    new[:, 1:] = (source[:, 1:] != source[:, :-1]) | (
        valid[:, 1:] & (row[:, 1:] != row[:, :-1] + 1))
    starts = np.flatnonzero(new)
    lengths = np.diff(np.append(starts, p * n))
    most = (int(lengths.max()) if chunk_bytes is None
            else max(1, chunk_bytes // max(row_width, 1)))
    pieces = -(-lengths // most)
    first = np.repeat(starts, pieces)
    k = np.arange(int(pieces.sum())) - np.repeat(np.cumsum(pieces) - pieces,
                                                 pieces)
    off = k * most
    table = np.empty((first.size, 5), np.int64)
    table[:, RANK], table[:, OUT_ROW] = np.divmod(first + off, n)
    table[:, SOURCE] = source.reshape(-1)[first]
    table[:, SRC_ROW] = np.where(table[:, SOURCE] == ZEROS, 0,
                                 row.reshape(-1)[first] + off)
    table[:, ROWS] = np.minimum(most, np.repeat(lengths, pieces) - off)
    if table.max() > np.iinfo(np.int32).max:
        raise ValueError("run table entries exceed int32")
    return table.astype(np.int32)


@dataclass(frozen=True, eq=False)
class RunTable:
    """A run table on the device, bound to the ``idx`` and ``valid``
    tensors it was baked from (``bake_runs``), with the rows of each
    source its chunks read: ``gather_rows`` takes it only beside those
    same tensors and over sources that hold those rows."""

    chunks: torch.Tensor        # int32 [n_chunks, 5], columns RANK..ROWS
    idx: torch.Tensor
    valid: torch.Tensor
    split: int | None           # rows of x when the gather reads x2 too
    x_rows: int                 # rows of x the chunks read
    x2_rows: int                # rows of x2 the chunks read


def bake_runs(idx: torch.Tensor, valid: torch.Tensor, row_width: int,
              split: int | None = None, chunk_bytes: int | None = RUN_CHUNK_BYTES,
              host=None) -> RunTable:
    """``gather_runs`` of the constant gather ``(idx, valid)``, checked to
    cover its ``[P, N]`` output once, in order, from rows at or past 0, and
    uploaded to ``idx``'s device.  ``host`` are the same two tables as
    numpy arrays (a plan holds them); without it they are read back."""
    if host is None:
        host = (idx.cpu().numpy(), valid.cpu().numpy())
    table = gather_runs(*host, row_width, split, chunk_bytes)
    p, n = idx.shape
    rows = table[:, ROWS].astype(np.int64)
    out_row = table[:, OUT_ROW].astype(np.int64)
    start = table[:, RANK] * np.int64(n) + out_row
    if (rows.sum() != p * n or not np.array_equal(start, np.cumsum(rows) - rows)
            or (rows < 1).any() or (out_row + rows > n).any()
            or (table[:, SRC_ROW] < 0).any()):
        raise ValueError(f"the run table does not cover the [{p}, {n}] output "
                         "once, in order, from source rows >= 0")
    ends = table[:, SRC_ROW] + rows
    x_rows, x2_rows = (int(ends[table[:, SOURCE] == s].max(initial=0))
                       for s in (FROM_X, FROM_X2))
    return RunTable(torch.from_numpy(table).to(idx.device), idx, valid, split,
                    x_rows, x2_rows)


def kernel_choice(device_type: str, row_width: int, addrs, has_runs: bool) -> str:
    """The rule of ``kernel_for`` on plain values: "plain", "runs" or
    "warp".  ``addrs`` are the base addresses of x, x2 (if any) and out."""
    if device_type == "cpu":
        return "plain"
    if (has_runs and row_width > 0 and row_width % RUN_ALIGN == 0
            and all(a % RUN_ALIGN == 0 for a in addrs)):
        return "runs"
    return "warp"


def kernel_for(x: torch.Tensor, out: torch.Tensor | None = None,
               x2: torch.Tensor | None = None, runs=None) -> str:
    """Which kernel ``gather_rows(x, ..., out=out, x2=x2, runs=runs)`` takes
    (an ``out`` of None is a fresh, aligned allocation)."""
    addrs = [t.data_ptr() for t in (x, x2, out) if t is not None]
    return kernel_choice(x.device.type, row_bytes(x), addrs, runs is not None)


def cuda_kernel(row_width: int, runs: bool) -> _build.CudaKernel:
    """The K1 kernel a CUDA call with rows of ``row_width`` bytes on aligned
    buffers (any fresh torch allocation) launches, with or without a run
    table: what a plan names."""
    return RUNS if kernel_choice("cuda", row_width, (), runs) == "runs" else KERNEL


def _out_shape(x, idx, valid, out, x2=None, runs=None) -> tuple[int, ...]:
    if x.dim() < 2:
        raise ValueError(f"x must be [P, S, *F], got {tuple(x.shape)}")
    if idx.dim() != 2 or idx.shape[0] != x.shape[0] or valid.shape != idx.shape:
        raise ValueError(f"idx/valid must be [P={x.shape[0]}, N], got "
                         f"{tuple(idx.shape)}/{tuple(valid.shape)}")
    if idx.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError(f"idx must be int32 and valid bool, got "
                         f"{idx.dtype}/{valid.dtype}")
    if x2 is not None and (x2.dim() != x.dim() or x2.shape[0] != x.shape[0]
                           or x2.shape[2:] != x.shape[2:] or x2.dtype != x.dtype):
        raise ValueError(f"x2 must be [P={x.shape[0]}, S2, "
                         f"{', '.join(map(str, x.shape[2:]))}] {x.dtype}, got "
                         f"{tuple(x2.shape)} {x2.dtype}")
    if runs is not None:
        if runs.idx is not idx or runs.valid is not valid:
            raise ValueError("runs was baked from other idx/valid tensors")
        s2 = 0 if x2 is None else x2.shape[1]
        if (runs.split != (None if x2 is None else x.shape[1])
                or runs.x_rows > x.shape[1] or runs.x2_rows > s2):
            raise ValueError(
                f"runs reads {runs.x_rows} rows of x and {runs.x2_rows} of x2 "
                f"split at {runs.split}; got {x.shape[1]} and {s2} rows")
    shape = (x.shape[0], idx.shape[1]) + tuple(x.shape[2:])
    if out is not None and (tuple(out.shape) != shape or out.dtype != x.dtype):
        raise ValueError(f"out must be {shape} {x.dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    return shape


def _gather_cost(result, x, idx, valid, out=None, *, x2=None, runs=None):
    return 0, _build.tensor_bytes(x, x2, idx, valid, result)


@_build.counted(KERNEL, _gather_cost)
def gather_rows(x: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                out: torch.Tensor | None = None, *,
                x2: torch.Tensor | None = None,
                runs: torch.Tensor | None = None) -> torch.Tensor:
    """The masked gather; ``runs`` is ``bake_runs`` of these ``idx`` and
    ``valid`` (split at ``x.shape[1]`` when ``x2`` is given), which the
    caller keeps for as long as the tables stand.  On CUDA the kernel
    ``kernel_for`` names; on ``meta`` the output's shape alone."""
    shape = _out_shape(x, idx, valid, out, x2, runs)
    if x.device.type == "meta":
        _build.check_meta(x, idx, valid,
                          *(t for t in (out, x2) if t is not None))
        return out if out is not None else x.new_empty(shape)
    if x.device.type == "cpu":
        return gather_rows_plain(x if x2 is None else torch.cat([x, x2], dim=1),
                                 idx, valid, out)
    _build.check_cuda(x, idx, valid, *(t for t in (out, x2) if t is not None),
                      *(() if runs is None else (runs.chunks,)))
    if kernel_for(x, out, x2, runs) == "runs":
        return _launch_runs(x, out, x2, runs, shape)
    return _launch_warp(x, idx, valid, out, x2, shape)


def gather_warp_kernel(x: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                       out: torch.Tensor | None = None, *,
                       x2: torch.Tensor | None = None) -> torch.Tensor:
    """K1 by ``gather_rows_kernel``, one warp per output row reading ``idx``
    and ``valid`` (CUDA only; any row width and base)."""
    shape = _out_shape(x, idx, valid, out, x2)
    _build.check_cuda(x, idx, valid, *(t for t in (out, x2) if t is not None))
    return _launch_warp(x, idx, valid, out, x2, shape)


def _launch_runs(x, out, x2, runs, shape) -> torch.Tensor:
    skip_invalid = out is not None
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    chunks = runs.chunks
    RUNS.launch(x.data_ptr(), 0 if x2 is None else x2.data_ptr(),
                chunks.data_ptr(), chunks.shape[0], out.data_ptr(), x.shape[1],
                0 if x2 is None else x2.shape[1], shape[1], row_bytes(x),
                int(skip_invalid), _build.stream_handle(x))
    return out


def _launch_warp(x, idx, valid, out, x2, shape) -> torch.Tensor:
    skip_invalid = out is not None
    if out is None:
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
    KERNEL.launch(x.data_ptr(), 0 if x2 is None else x2.data_ptr(),
                  idx.data_ptr(), valid.data_ptr(), out.data_ptr(), x.shape[0],
                  x.shape[1], 0 if x2 is None else x2.shape[1], idx.shape[1],
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
