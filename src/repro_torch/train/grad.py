"""Gradient utilities: global-norm clipping, microbatch accumulation, and
the data-parallel gradient syncs: int8 with error feedback, and the
plan-backed reduce-scatter + allgatherv pair (port of
``repro.train.grad``).

The JAX package runs the syncs per shard under ``shard_map`` at TP-only
specs, every leaf replicated across the data axes.  On one card the data
replicas are virtual ranks of the mesh and each holds the same gradients,
as the JAX docstring says of its replicas: the sync takes the one global
tree and moves it as every replica would.  Data axes absent from the mesh
(or of size 1) drop out, as in JAX.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .._tree import leaves, tree_map, unflatten_like


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def _dp_axes(mesh, dp_axes) -> tuple[str, ...]:
    return tuple(a for a in dp_axes
                 if a in mesh.axis_names and int(mesh.shape[a]) > 1)


def _n_dp(mesh, dp) -> int:
    n = 1
    for a in dp:
        n *= int(mesh.shape[a])
    return n


def compressed_sync(mesh, dp_axes) -> Callable:
    """The int8 + error-feedback data-parallel gradient sync:
    ``sync(grads, err) -> (grads, new_err)``, ``compression.
    compressed_psum_tree`` over the data replicas of ``dp_axes``.  Replicas
    quantize identical inputs, so the sync is quantize-with-EF in value;
    what changes is what crosses the wire.  With no data axis left it is
    the local quantize + EF pass."""
    from ..parallel import compression

    n_dp = _n_dp(mesh, _dp_axes(mesh, dp_axes))

    def sync(grads, err):
        return compression.compressed_psum_tree(grads, n_dp, err)

    return sync


def persistent_rs_sync(mesh, dp_axes, error_feedback: bool = False) -> Callable:
    """Plan-backed DP gradient sync (``grad_sync="persistent_rs"``).

    The leaves flatten into one fp32 row buffer; a persistent
    reduce-scatter plan over the data axes sums it across the replicas
    (counts fixed by the parameter geometry, so INIT warm-starts from the
    plan store), the matching allgatherv plan gathers the 1/P shards back
    (both uniform and tile-aligned: the identity fast path) and the mean
    follows: the Rabenseifner RS+AG form of the all-reduce.  In the global
    view of the virtual ranks the buffer is ``[n_dp, n_dp*cap]``, one
    identical row per replica; the reduce-scatter's fence epoch is one K2
    launch on a card, and the result is replica 0's row.

    ``error_feedback=True`` quantizes each leaf with the carried residual
    folded in and sends the dequantized payload.  Returns
    ``sync(grads, err) -> (grads, new_err)`` with error feedback,
    ``sync(grads) -> grads`` without.
    """
    from ..core import allgatherv_init, metadata as md, reduce_scatter_init
    from ..parallel import compression

    dp = _dp_axes(mesh, dp_axes)
    n_dp = _n_dp(mesh, dp)
    axis = dp[0] if len(dp) == 1 else dp

    def _wire(flat_leaves):
        """flatten -> plan RS -> plan AG -> mean -> unflatten (fp32)."""
        flat = (torch.cat([l.reshape(-1) for l in flat_leaves])
                if len(flat_leaves) > 1 else flat_leaves[0].reshape(-1))
        n = flat.shape[0]
        if n_dp > 1 and n:
            cap = md.round_up(-(-n // n_dp), md.TILE_ROWS)
            counts = np.full(n_dp, cap, np.int64)
            rs = reduce_scatter_init(counts, (), torch.float32, mesh,
                                     axis=axis, embeddable=True)
            ag = allgatherv_init(counts, (), torch.float32, mesh,
                                 axis=axis, embeddable=True)
            padded = flat.new_zeros((n_dp, n_dp * cap))
            padded[:, :n] = flat
            del flat
            shard = rs.embed()(padded)
            del padded
            flat = ag.embed()(shard)[0, :n] / n_dp
        out, off = [], 0
        for l in flat_leaves:
            out.append(flat[off:off + l.numel()].view(l.shape))
            off += l.numel()
        return out

    if error_feedback:
        def sync_ef(grads, err):
            flat_g = leaves(grads)
            wire, new_err = [], []
            for x, e in zip(flat_g, leaves(err)):
                carry = x.float() + e.float()
                q, scale = compression.quantize_int8(carry)
                deq = compression.dequantize_int8(q, scale)
                wire.append(deq)
                new_err.append((carry - deq).to(e.dtype))
            synced = _wire(wire)
            return (unflatten_like(grads, [s.to(x.dtype) for s, x in
                                           zip(synced, flat_g)]),
                    unflatten_like(grads, new_err))

        return sync_ef

    def sync(grads):
        flat_g = leaves(grads)
        synced = _wire([l.float() for l in flat_g])
        return unflatten_like(grads, [s.to(l.dtype)
                                      for s, l in zip(synced, flat_g)])

    return sync


def value_and_grad(loss_fn: Callable, params, batch):
    """``loss_fn(params, batch) -> (loss, metrics)`` and the gradient of
    ``loss`` with respect to every leaf of ``params`` (a tree of the same
    structure).  The leaves are detached views that require grad, so the
    caller's tensors are untouched; metrics come back detached.  A leaf
    the loss does not reach gets a zero gradient, as under ``jax.grad``
    (an int8 wire codec's ``round`` cuts every expert weight's path)."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(unflatten_like(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten_like(params, list(grads))


def accumulate_grads(loss_fn: Callable, params, batch: dict, n_micro: int):
    """Split the batch into ``n_micro`` slices along dim 0 and accumulate.

    ``loss_fn(params, microbatch) -> (loss, metrics)``.  Returns the
    mean-reduced (loss, metrics, grads).  With ``n_micro > 1`` the
    gradients accumulate in fp32, as the JAX scan's carry does."""
    if n_micro <= 1:
        return value_and_grad(loss_fn, params, batch)

    def micro(i):
        out = {}
        for k, x in batch.items():
            b = x.shape[0]
            assert b % n_micro == 0, (b, n_micro)
            m = b // n_micro
            out[k] = x[i * m:(i + 1) * m]
        return out

    loss, metrics, grads = value_and_grad(loss_fn, params, micro(0))
    acc = tree_map(lambda g: g.float(), grads)
    for i in range(1, n_micro):
        l_i, m_i, g_i = value_and_grad(loss_fn, params, micro(i))
        acc = tree_map(torch.add, acc, g_i)
        loss = loss + l_i
        metrics = {k: metrics[k] + m_i[k] for k in metrics}
    inv = 1.0 / n_micro
    return (loss * inv, {k: v * inv for k, v in metrics.items()},
            tree_map(lambda g: g * inv, acc))
