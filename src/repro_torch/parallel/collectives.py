"""Collective helpers: hierarchical (pod-aware) gradient reduction (port of
``repro.parallel.collectives``).

On a multi-pod mesh the flat all-reduce over (pod, data) pays the slow
inter-pod links for the full payload.  The hierarchical schedule,
reduce-scatter within the pod, all-reduce the 1/P_data shard across pods,
all-gather within the pod, moves only payload/P_data bytes over the
inter-pod links: the locality idea of the paper's fence-hierarchy variant.

With a ``mesh`` the RS+AG pair rides persistent plans of the exchange
engine (``core.patterns``): one uniform counts vector is the single source
of the shard geometry for both sides, the plans warm-start from the plan
store, and the pair takes row counts the raw path cannot (non-divisible
rows pad to the tile capacity; zero rows are sum-inert).

The JAX package calls these inside ``shard_map`` on each rank's shard.
Here every rank is a virtual rank on one device and ``x`` is the global
view ``[n_outer * n_inner, *local]``: rank ``o * n_inner + q`` (outer-major,
as ``P(("pod", "data"))`` lays the ranks out) holds its local shard, and
``scatter_dim`` indexes the local shape, as in JAX.  Every rank receives
the mean.  The axis sizes come from ``mesh``, or else from the active mesh
(``parallel.sharding.axis_rules``), as JAX's ``axis_size`` reads the
enclosing ``shard_map``'s.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..roofline.trace import per_rank_bytes, report_collective
from .sharding import current_mesh


def plan_rs_ag_pair(rows: int, feature_shape, dtype, inner_axis: str, mesh):
    """The promoted ``psum_scatter`` + ``all_gather`` pair as persistent
    plans.

    Returns ``(rs_plan, ag_plan, capacity)``: a reduce-scatter plan and its
    matching allgatherv plan over ``inner_axis``, both built from ONE
    uniform counts vector (``capacity`` rows per rank, ``rows`` padded up
    to the tile grid).  Both plans are embeddable and signature-keyed
    through the global ``PlanCache``, so they warm-start from the plan
    store like every other consumer of the engine.
    """
    from ..core import allgatherv_init, metadata as md, reduce_scatter_init

    inner = int(mesh.shape[inner_axis])
    cap = max(md.round_up(-(-rows // inner), md.TILE_ROWS), md.TILE_ROWS)
    counts = np.full(inner, cap, np.int64)
    rs = reduce_scatter_init(counts, tuple(feature_shape), dtype, mesh,
                             axis=inner_axis, embeddable=True)
    ag = allgatherv_init(counts, tuple(feature_shape), dtype, mesh,
                         axis=inner_axis, embeddable=True)
    return rs, ag, cap


def _sizes(mesh, axes) -> tuple[int, ...]:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("no mesh: pass mesh= or call under axis_rules(..., "
                         "mesh)")
    return mesh.axis_sizes(axes)


def _sum_ranks(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in rank order, kept as a leading dim of 1."""
    acc = x[:1]
    for r in range(1, x.shape[0]):
        acc = acc + x[r:r + 1]
    return acc


def hierarchical_psum_mean(x: torch.Tensor, inner_axis: str, outer_axis: str,
                           scatter_dim: int = 0, mesh=None) -> torch.Tensor:
    """Mean-reduce over (inner, outer) with pod-aware scheduling.

    ``x [n_outer * n_inner, *local]``.  With ``mesh`` the inner RS/AG pair
    rides the persistent plans of ``plan_rs_ag_pair`` (any row count;
    padding is sum-inert): one reduce-scatter epoch per pod (K2 on a card),
    the shards summed across pods, one allgatherv epoch per pod (the bare
    gather: uniform tile-aligned counts).  Without it the raw path needs
    ``local.shape[scatter_dim]`` divisible by the inner axis size and falls
    back to a flat sum otherwise.
    """
    from ..core.variants import per_group

    outer, inner = _sizes(mesh, (outer_axis, inner_axis))
    n = inner * outer
    if x.shape[0] != n:
        raise ValueError(f"x has {x.shape[0]} ranks, the mesh {n}")
    local = tuple(x.shape[1:])
    if mesh is not None and inner > 1:
        xt = x.movedim(scatter_dim + 1, 1)                  # [n, rows, *F]
        rows = xt.shape[1]
        rs, ag, cap = plan_rs_ag_pair(rows, xt.shape[2:], x.dtype,
                                      inner_axis, mesh)
        pad = inner * cap - rows
        if pad:
            xt = torch.cat([xt, xt.new_zeros((n, pad) + tuple(xt.shape[2:]))],
                           dim=1)
        # 1. persistent reduce-scatter within each pod
        shard = per_group(rs.embed(), xt.contiguous(), outer)   # [n, cap, *F]
        # 2. all-reduce the shard across pods (1/inner of the bytes)
        report_collective("all-reduce", per_rank_bytes(shard), outer)
        shard = shard.reshape((outer, inner, cap) + tuple(shard.shape[2:]))
        shard = _sum_ranks(shard).expand_as(shard).reshape(
            (n, cap) + tuple(shard.shape[3:]))
        # 3. persistent all-gather within each pod
        full = per_group(ag.embed(), shard.contiguous(), outer)[:, :rows]
        return full.movedim(1, scatter_dim + 1) / n
    if local[scatter_dim] % inner:
        return flat_psum_mean(x, (outer_axis, inner_axis))
    # 1. reduce-scatter within the pod: rank q keeps the sum of chunk q
    xs = x.reshape((outer, inner) + local[:scatter_dim]
                   + (inner, local[scatter_dim] // inner)
                   + local[scatter_dim + 1:])
    shard = _sum_ranks(xs.movedim(1, 0))[0]            # [outer, ..., inner, ...]
    # 2. all-reduce the shard across pods; 3. all-gather within the pod
    local_bytes = per_rank_bytes(x)
    report_collective("reduce-scatter", local_bytes // inner, inner)
    report_collective("all-reduce", local_bytes // inner, outer)
    report_collective("all-gather", local_bytes, inner)
    full = _sum_ranks(shard)[0].reshape(local)
    return (full / n).expand((n,) + local).contiguous()


def flat_psum_mean(x: torch.Tensor, axes) -> torch.Tensor:
    """Mean over the ranks of ``axes`` of the active mesh: ``x [n, *local]``
    with ``n`` the product of their sizes, every rank a copy of the mean."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    n = math.prod(_sizes(None, names))
    if x.shape[0] != n:
        raise ValueError(f"x has {x.shape[0]} ranks, the axes {n}")
    report_collective("all-reduce", per_rank_bytes(x), n)
    return (_sum_ranks(x) / n).expand_as(x).contiguous()
