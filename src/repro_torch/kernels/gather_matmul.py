"""K6: fused unpack-gather-matmul over the MoE receive buffer.

Port of the Pallas kernel ``repro.kernels.gather_matmul.gather_matmul``
(``src/repro/kernels/gather_matmul.py:94``).  The CUDA kernels are in
``csrc/gather_matmul.cu``; its note says what bounds them (bytes, at the
serve shapes) and how each is built.

    out[e, n] = valid[e, n] ? x[idx[e, n]] @ w[e] : 0

``x`` is ``[R, D]``, ``idx``/``valid`` are ``[E, N]`` int32/bool, ``w`` is
``[E, D, F]`` in ``x``'s dtype (float32 or bfloat16), and ``out``
is ``[E, N, F]`` in that dtype, summed in float32.  Invalid rows are +0.0
by selection: a NaN in a source row that only invalid entries reference
does not reach the output.

Which kernel a call takes (``kernel_for``), by a rule on the inputs alone:

- CPU tensors: the plain version below;
- ``meta`` tensors: an empty output of the right shape, nothing computed
  or counted as a launch (the dry run traces a step this way);
- bfloat16 on CUDA with D and F positive multiples of 8 and ``x`` and ``w``
  16-byte aligned: ``gather_matmul_wgmma`` (TMA weight ring, gathered rows
  by ``cp.async``, ``wgmma``; counter ``WGMMA_KERNEL``), the serve path's;
- any other bfloat16 call on CUDA: ``gather_matmul_tc`` (``mma.sync``;
  counter ``KERNEL``);
- float32 on CUDA: ``gather_matmul_f32`` (CUDA-core FMAs, exact float32;
  counter ``KERNEL``).

Each is a hand-written kernel chosen by shape, not a fallback: a build or
launch error raises.  ``wgmma_geometry`` computes the wgmma kernel's
launch (its shared memory, rows per block and grid), which the C launcher
checks against its own before launching.

``gather_matmul`` is an ``autograd.Function`` (a ctypes kernel's output
carries no ``grad_fn``); its backward is the plain PyTorch transpose of
the JAX package's custom VJP (``repro.kernels.ops``): ``dw`` and the row
gradients by batched products, ``dx`` by a scatter-add.
"""

from __future__ import annotations

import dataclasses

import torch

from . import _build

KERNEL = _build.register(_build.CudaKernel(
    "gather_matmul", "gather_matmul", "repro_gather_matmul",
    [_build.VOIDP] * 5 + [_build.I64] * 4 + [_build.INT, _build.VOIDP],
    kid="K6"))
WGMMA_KERNEL = _build.register(_build.CudaKernel(
    "gather_matmul_wgmma", "gather_matmul", "repro_gather_matmul_wgmma",
    [_build.VOIDP] * 5 + [_build.I64] * 4
    + [_build.INT, _build.INT, _build.I64, _build.VOIDP], kid="K6"))

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The wgmma kernel's tiles (csrc/gather_matmul.cu, namespace wg).
WG_BK = 64                  # D per ring stage
WG_TILE_F = 128             # F columns per block
WG_M_TILE = 64              # rows per wgmma
WG_W_BYTES = WG_BK * WG_TILE_F * 2
WG_X_TILE_BYTES = WG_M_TILE * WG_BK * 2


@dataclasses.dataclass(frozen=True)
class WgmmaGeometry:
    slots: int          # m64 row tiles per consumer warpgroup (1 or 2)
    rows_per_block: int  # rows of N one block covers (128 or 256)
    stages: int         # ring depth
    smem_bytes: int     # dynamic shared memory per block
    grid: int           # blocks: row chunks x experts x F tiles


def wgmma_geometry(e: int, n: int, f: int) -> WgmmaGeometry:
    """The launch of ``gather_matmul_wgmma`` for ``E=e, N=n, F=f``: up to
    128 rows a block holds two m64 tiles in a 3-stage ring (two blocks per
    SM), beyond that 256 rows in a 4-stage ring; each stage holds a
    ``[64, 128]`` w tile and the block's rows for 64 of D."""
    slots = 1 if n <= 2 * WG_M_TILE else 2
    rows = 2 * slots * WG_M_TILE
    stages = 3 if slots == 1 else 4
    smem = stages * (WG_W_BYTES + 2 * slots * WG_X_TILE_BYTES) + 1024
    grid = -(-n // rows) * e * -(-f // WG_TILE_F)
    return WgmmaGeometry(slots, rows, stages, smem, grid)


def kernel_choice(device_type: str, dtype: torch.dtype, d: int, f: int,
                  x_addr: int, w_addr: int) -> str:
    """The rule of ``kernel_for`` on plain values: "plain", "wgmma",
    "mma_sync" or "cuda_core"."""
    if device_type == "cpu":
        return "plain"
    if dtype == torch.float32:
        return "cuda_core"
    if (d > 0 and d % 8 == 0 and f % 8 == 0 and x_addr % 16 == 0
            and w_addr % 16 == 0):
        return "wgmma"
    return "mma_sync"


def kernel_for(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which kernel ``gather_matmul_kernel(x, idx, valid, w)`` takes."""
    return kernel_choice(x.device.type, x.dtype, x.shape[1], w.shape[2],
                         x.data_ptr(), w.data_ptr())


def _check(x, idx, valid, w) -> None:
    if x.dim() != 2 or w.dim() != 3 or idx.dim() != 2:
        raise ValueError(f"want x [R, D], idx [E, N], w [E, D, F]; got "
                         f"{tuple(x.shape)}, {tuple(idx.shape)}, {tuple(w.shape)}")
    if valid.shape != idx.shape or w.shape[:2] != (idx.shape[0], x.shape[1]):
        raise ValueError(f"valid {tuple(valid.shape)} / w {tuple(w.shape)} do "
                         f"not match idx {tuple(idx.shape)} and x D={x.shape[1]}")
    if idx.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError(f"idx must be int32 and valid bool, got "
                         f"{idx.dtype}/{valid.dtype}")
    if w.dtype != x.dtype or x.dtype not in DTYPES:
        raise ValueError(f"x and w must share one of {list(DTYPES)}, got "
                         f"{x.dtype}/{w.dtype}")


def _rows(x, idx, valid) -> torch.Tensor:
    """The gathered rows ``[E, N, D]``, +0.0 where invalid."""
    e, n = idx.shape
    h = x.index_select(0, idx.reshape(-1).long()).view(e, n, x.shape[1])
    return torch.where(valid.view(e, n, 1), h, 0.0)


def gather_matmul_plain(x: torch.Tensor, idx: torch.Tensor,
                        valid: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``index_select``, a masked select, then
    ``torch.bmm``.  The CPU path, and the card's yardstick."""
    _check(x, idx, valid, w)
    KERNEL.plain_calls += 1
    return torch.bmm(_rows(x, idx, valid), w)


def _cost(out, x, idx, valid, w):
    """2*E*N*D*F operations; x, the tables, w and the output once."""
    e, n = idx.shape
    return (2 * e * n * x.shape[1] * w.shape[2],
            _build.tensor_bytes(x, idx, valid, w, out))


@_build.counted(KERNEL, _cost)
def gather_matmul_kernel(x: torch.Tensor, idx: torch.Tensor,
                         valid: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward without autograd: plain version on the CPU, on CUDA the
    kernel ``kernel_for`` names, on ``meta`` the output's shape alone."""
    _check(x, idx, valid, w)
    if x.device.type == "meta":
        _build.check_meta(x, idx, valid, w)
        return x.new_empty((idx.shape[0], idx.shape[1], w.shape[2]))
    if x.device.type == "cpu":
        return gather_matmul_plain(x, idx, valid, w)
    _build.check_cuda(x, idx, valid, w)
    e, n = idx.shape
    d, f = x.shape[1], w.shape[2]
    out = torch.empty((e, n, f), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), idx.data_ptr(), valid.data_ptr(), w.data_ptr(),
            out.data_ptr(), e, n, d, f)
    if kernel_for(x, w) == "wgmma":
        g = wgmma_geometry(e, n, f)
        WGMMA_KERNEL.launch(*args, g.slots, g.smem_bytes, g.grid,
                            _build.stream_handle(x))
    else:
        KERNEL.launch(*args, DTYPES[x.dtype], _build.stream_handle(x))
    return out


class _GatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, valid, w):
        ctx.save_for_backward(x, idx, valid, w)
        return gather_matmul_kernel(x, idx, valid, w)

    @staticmethod
    def backward(ctx, g):
        x, idx, valid, w = ctx.saved_tensors
        e, n = idx.shape
        gc = g.to(x.dtype)
        dw = dx = None
        if ctx.needs_input_grad[3]:
            dw = torch.bmm(_rows(x, idx, valid).transpose(1, 2), gc).to(w.dtype)
        if ctx.needs_input_grad[0]:
            dh = torch.bmm(gc, w.to(x.dtype).transpose(1, 2))
            dh = torch.where(valid.view(e, n, 1), dh, 0.0)
            dx = torch.zeros_like(x).index_add_(
                0, idx.reshape(-1).long(), dh.reshape(e * n, -1))
        return dx, None, None, dw


def gather_matmul(x: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """``out[e] = where(valid[e], x[idx[e]], 0) @ w[e]``, differentiable in
    ``x`` and ``w``."""
    return _GatherMatmul.apply(x, idx, valid, w)
