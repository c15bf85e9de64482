"""Ulysses-style sequence-parallel attention through the alltoallv engine
(port of ``repro.models.ulysses``).

DeepSpeed-Ulysses (arXiv:2309.14509) computes attention with
sequence-sharded activations by exchanging shards twice per layer:

    [B, S/P, H, d]  --all-to-all-->  [B, S, H/P, d]     (heads out, seq in)
    ... attention over the full sequence on local heads ...
    [B, S, H/P, d]  --all-to-all-->  [B, S/P, H, d]

Both exchanges are *uniform* alltoallvs, the degenerate case of the
paper's engine: every pair moves the same S/P x H/P block.  They go
through ``core.variants.uniform_bucketed_exchange``: the fence (one K2
launch on a card) or, over a grouped ``(outer, inner)`` pair, the
leader-combined ``fence_hierarchy`` (K2 for hops 1 and 3).  A uniform
exchange is its own transpose, so each runs under
``variants.self_adjoint_exchange`` and its backward is the same exchange
on the cotangent.  The positions gather rides a persistent allgatherv plan
(``allgatherv_init(..., embeddable=True)``) through ``plan.embed()``, as
the JAX package's does.  This is the engine's second consumer after the
MoE dispatch.

The JAX package runs the body per shard under ``shard_map``.  Here the
``plan.p`` ranks of ``plan.axis`` are virtual ranks on one device, in the
global view ``models/moe.py`` uses: rank ``i`` owns positions
``[i*S/P, (i+1)*S/P)`` of every sequence, and the body is batched over
every rank at once (``[P, B, S/P, H, d]``).  Other mesh axes hold replicas
of the same computation and are computed once.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import allgatherv_init
from ..core import variants as core_variants
from ..parallel.sharding import current_mesh


@dataclasses.dataclass(frozen=True)
class UlyssesPlan:
    """Persistent head-exchange geometry (INIT-time metadata)."""

    # mesh axis carrying the sequence shards: one name, or a linearized
    # (outer, inner) pair when the sequence spans a grouped (pod, chip) mesh
    axis: str | tuple[str, str]
    p: int             # shards
    n_heads: int
    head_dim: int
    # route the head exchange through the leader-combined hierarchical
    # schedule: O((P/g)^2) cross-group messages per exchange instead of
    # O(P * P/g).  Requires a 2-axis ``axis``.
    hier: bool = False

    @staticmethod
    def build(n_heads: int, head_dim: int, mesh=None, axis="model",
              hier: bool = False):
        mesh = mesh if mesh is not None else current_mesh()
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if mesh is not None and all(a in mesh.axis_names for a in axes):
            p = math.prod(mesh.axis_sizes(axes))
        else:
            p = 1
        if hier and len(axes) != 2:
            raise ValueError("hier head exchange needs axis=(outer, inner)")
        if n_heads % max(p, 1):
            raise ValueError(f"{n_heads} heads not divisible by {p} shards")
        return UlyssesPlan(axis=axis if isinstance(axis, str) else axes,
                           p=p, n_heads=n_heads, head_dim=head_dim, hier=hier)


def _head_exchange(packed: torch.Tensor, plan: UlyssesPlan) -> torch.Tensor:
    """Bucketed ``[P, P*B, ...]`` exchange, bucket j of rank i for rank j:
    the flat fence epoch, or the leader-combined hierarchical schedule on
    a grouped (outer, inner) mesh (the same rows in the same places).
    Table-free, through the shared uniform-bucket switch: the feature
    shape varies per call site (sequence x head slices), so there is no
    frozen pattern for a table-backed plan to key on."""
    variant = "fence_hierarchy" if plan.hier else "fence"
    sizes = current_mesh().axis_sizes(plan.axis) if plan.hier else (plan.p,)
    cap = packed.shape[1] // plan.p

    def exchange(t: torch.Tensor) -> torch.Tensor:
        return core_variants.uniform_bucketed_exchange(t, variant, cap, sizes)

    return core_variants.self_adjoint_exchange(exchange, packed.contiguous())


def _seq_to_heads(x: torch.Tensor, plan: UlyssesPlan) -> torch.Tensor:
    """``[P, B, S_loc, H, d] -> [P, B, S_loc*P, H/P, d]`` (every rank)."""
    n, b, s_loc, h, d = x.shape
    p = plan.p
    # bucket j = my sequence shard's slice of head-group j
    packed = x.reshape(n, b, s_loc, p, h // p, d).permute(0, 3, 1, 2, 4, 5)
    packed = packed.reshape(n, p * b, s_loc, h // p, d)
    out = _head_exchange(packed, plan)
    out = out.reshape(n, p, b, s_loc, h // p, d).permute(0, 2, 1, 3, 4, 5)
    return out.reshape(n, b, p * s_loc, h // p, d)


def _heads_to_seq(x: torch.Tensor, plan: UlyssesPlan) -> torch.Tensor:
    """``[P, B, S, H/P, d] -> [P, B, S/P, H, d]`` (the inverse exchange)."""
    n, b, s, hp, d = x.shape
    p = plan.p
    packed = x.reshape(n, b, p, s // p, hp, d).permute(0, 2, 1, 3, 4, 5)
    packed = packed.reshape(n, p * b, s // p, hp, d)
    out = _head_exchange(packed, plan)
    # recv bucket i = my position block computed with head-group i:
    # [p, b, s_loc, hp, d] -> [b, s_loc, (p, hp)=H, d]
    out = out.reshape(n, p, b, s // p, hp, d).permute(0, 2, 3, 1, 4, 5)
    return out.reshape(n, b, s // p, p * hp, d)


def ulysses_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,  # [B, S, H, d]
    positions: torch.Tensor,                            # [B, S]
    plan: UlyssesPlan,
    causal: bool = True,
) -> torch.Tensor:
    """Attention over sequence-sharded q/k/v (MHA: n_kv == n_heads).

    q/k/v are the global ``[B, S, H, d]`` tensors, sharded on dim 1 over
    ``plan.axis``: each rank holds S/P positions of all H heads, exchanges
    into all S positions of H/P heads, attends, and exchanges back.
    """
    mesh = current_mesh()
    if plan.p == 1 or mesh is None:
        return _attend(q, k, v, positions, causal)
    b, s = positions.shape
    p, s_loc = plan.p, s // plan.p

    # The positions gather rides a persistent allgatherv plan: the pattern
    # (p uniform shards of S/P rows) is frozen by the layer geometry, so
    # the plan warm-starts from the store, and the embedded epoch is the
    # bare gather where S/P is tile-aligned (the identity fast path).
    # Signature-keyed through the global PlanCache, so later calls reuse it.
    gplan = allgatherv_init(
        np.full(p, s_loc, np.int64), (b,), positions.dtype, mesh,
        axis=plan.axis,
        variant="fence_hierarchy" if plan.hier else "fence",
        embeddable=True)
    gather_pos = gplan.embed()

    def shards(t):                          # [B, S, ...] -> [P, B, S/P, ...]
        return t.reshape((b, p, s_loc) + tuple(t.shape[2:])).transpose(0, 1)

    qh = _seq_to_heads(shards(q), plan)
    kh = _seq_to_heads(shards(k), plan)
    vh = _seq_to_heads(shards(v), plan)
    own = shards(positions).transpose(1, 2)              # [P, s_loc, B] rows
    if gplan.send_rows != s_loc:
        own = torch.cat([own, own.new_zeros((p, gplan.send_rows - s_loc, b))],
                        dim=1)
    pos_full = gather_pos(own.contiguous())[:, :s].transpose(1, 2)  # [P, B, S]
    hp, d = qh.shape[3], qh.shape[4]
    o = _attend(qh.reshape(p * b, s, hp, d), kh.reshape(p * b, s, hp, d),
                vh.reshape(p * b, s, hp, d), pos_full.reshape(p * b, s),
                causal)
    out = _heads_to_seq(o.reshape(p, b, s, hp, d), plan)  # [P, B, S/P, H, d]
    return out.transpose(0, 1).reshape(q.shape)


def _attend(q, k, v, positions, causal):
    """Plain softmax attention ``[B, S, H, d]`` (fp32 softmax)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        mask = positions[:, None, :, None] >= positions[:, None, None, :]
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
