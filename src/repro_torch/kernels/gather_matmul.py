"""K6: fused unpack-gather-matmul over the MoE receive buffer.

Port of the Pallas kernel ``repro.kernels.gather_matmul.gather_matmul``.
The CUDA kernel is ``csrc/gather_matmul.cu``; its note says what bounds it
and what its simple design leaves for later.

    out[e, n] = valid[e, n] ? x[idx[e, n]] @ w[e] : 0

``x`` is ``[R, D]``, ``idx``/``valid`` are ``[E, N]`` int32/bool, ``w`` is
``[E, D, F]`` in ``x``'s dtype (float32 or bfloat16), and ``out``
is ``[E, N, F]`` in that dtype, summed in float32.  Invalid rows are +0.0
by selection: a NaN in a source row that only invalid entries reference
does not reach the output.

A CPU tensor takes the plain version below; a CUDA tensor launches the
kernel or raises.  ``gather_matmul`` is an ``autograd.Function`` (a ctypes
kernel's output carries no ``grad_fn``); its backward is the plain PyTorch
transpose of the JAX package's custom VJP (``repro.kernels.ops``): ``dw``
and the row gradients by batched products, ``dx`` by a scatter-add.
"""

from __future__ import annotations

import torch

from . import _build

KERNEL = _build.register(_build.CudaKernel(
    "gather_matmul", "gather_matmul", "repro_gather_matmul",
    [_build.VOIDP] * 5 + [_build.I64] * 4 + [_build.INT, _build.VOIDP]))

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def gather_matmul_kernel(x: torch.Tensor, idx: torch.Tensor,
                         valid: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The forward without autograd: plain version on the CPU, K6 on CUDA."""
    _check(x, idx, valid, w)
    if x.device.type == "cpu":
        return gather_matmul_plain(x, idx, valid, w)
    _build.check_cuda(x, idx, valid, w)
    e, n = idx.shape
    d, f = x.shape[1], w.shape[2]
    out = torch.empty((e, n, f), dtype=x.dtype, device=x.device)
    KERNEL.launch(x.data_ptr(), idx.data_ptr(), valid.data_ptr(), w.data_ptr(),
                  out.data_ptr(), e, n, d, f, DTYPES[x.dtype],
                  _build.stream_handle(x))
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
