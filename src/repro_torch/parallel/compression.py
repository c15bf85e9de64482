"""Gradient compression: int8 symmetric-quantized all-reduce with error
feedback (port of ``repro.parallel.compression``).

For bandwidth-bound data-parallel gradient sync, quantizing to int8 before
the reduce cuts DP collective bytes 4x (fp32) / 2x (bf16).  Error feedback
(Seide et al.; 1-bit SGD lineage) accumulates the quantization residual into
the next step so the compression bias vanishes in expectation.

The JAX package runs ``compressed_psum`` per shard under ``shard_map``.
On one card the data-parallel replicas are virtual: each holds the same
gradients (autodiff already mean-reduced the loss), so the psum over
``n_replicas`` of them is that many identical addends summed in rank order,
as XLA sums them, and each leaf is quantized whole (one scale per tensor;
the JAX package's scale is per model shard of a leaf).
"""

from __future__ import annotations

import torch

from .._tree import leaves, unflatten_like


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def replica_mean(x: torch.Tensor, n_replicas: int) -> torch.Tensor:
    """``psum(x) / n`` over ``n_replicas`` replicas that all hold ``x``."""
    acc = x
    for _ in range(n_replicas - 1):
        acc = acc + x
    return acc / float(n_replicas)


def compressed_psum(x: torch.Tensor, n_replicas: int,
                    err: torch.Tensor | None = None):
    """Quantized all-reduce over ``n_replicas`` data replicas.

    Returns (mean-reduced x, new error-feedback residual).  The int8 payload
    is what crosses the wire; scales are reduced at fp32.
    """
    x32 = x.float()
    if err is not None:
        x32 = x32 + err
    q, scale = quantize_int8(x32)
    local_deq = dequantize_int8(q, scale)
    new_err = x32 - local_deq
    # int8 payloads summed at int32 width; per-rank scales differ, so the
    # reduce is of scale-weighted values.
    payload = q.to(torch.int32).float() * scale
    return replica_mean(payload, n_replicas).to(x.dtype), new_err


def compressed_psum_tree(grads, n_replicas: int, err_tree=None):
    """Tree version; threads per-leaf error-feedback state."""
    flat = leaves(grads)
    errs = leaves(err_tree) if err_tree is not None else [None] * len(flat)
    out, new_errs = [], []
    for g, e in zip(flat, errs):
        r, ne = compressed_psum(g, n_replicas, e)
        out.append(r)
        new_errs.append(ne)
    return unflatten_like(grads, out), unflatten_like(grads, new_errs)
