"""Public persistent-alltoallv API: INIT / START / WAIT / FREE (port of
``repro.core.api``).

    mesh = VirtualMesh((P,), ("x",))                 # P ranks on one card
    plan = alltoallv_init(send_counts, feature_shape, dtype, mesh,
                          axis="x", variant="fence", pack_impl="pallas")
    recv = plan.start(sendbuf)     # enqueue the epoch
    recv = plan.wait(recv)         # epoch close
    ...
    plan.free()

    fn = plan.embed()              # the epoch body for a host program:
    out = fn(x)                    # [P, send_rows, *F] -> [P, recv_rows, *F]

Variants ported so far:

  fence  one epoch with every bucket in flight.  Best default for dense,
         roughly uniform patterns; ``pack_impl="fused"`` gathers rows
         straight from the send buffers into their destination buckets.
  lock   (P-1) pairwise rounds with per-round capacities; empty rounds
         are elided at INIT.  Wins sparse/banded (neighborhood) patterns;
         loses under receiver skew (the hottest pair gates every round).
  fence_hierarchy
         leader-combined three-hop exchange over ``axis=(outer, inner)`` of
         ``VirtualMesh((P_outer, P_inner), ("o", "i"))``: one combined slab
         per group pair instead of one message per rank pair, so padding
         amortizes over the group pair.  ``pack_impl="fused"`` runs stage 2
         as one kernel; ``hier_leader_perm`` picks which inner rank of each
         group plays each leader role.

``variant="auto"`` and ``"ragged"``, the other collectives, wire codecs and
the plan store raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import Sequence

from . import metadata as md
from ._init_stats import INIT_STATS
from .plan import AlltoallvPlan, ExchangePlan, ExchangeSpec, PlanCache, not_ported

_GLOBAL_CACHE = PlanCache()


def exchange_init(
    collective: str,
    send_counts,
    feature_shape: Sequence[int],
    dtype,
    mesh,
    axis: str | Sequence[str] = "x",
    variant: str = "fence",
    lock_schedule: str = "ring",
    tile_rows: int | None = None,
    pack_impl: str = "jnp",
    baked_metadata: bool = True,
    cache: PlanCache | None = None,
    store=None,
    codec: str = "identity",
    hier_leader_perm: Sequence[Sequence[int]] | None = None,
) -> ExchangePlan:
    """Collective-agnostic INIT: build (or fetch) a persistent plan.

    ``mesh`` is a ``launch.mesh.VirtualMesh``.  ``baked_metadata=False``
    recomputes the pack/unpack index maps on the device every epoch (the
    A/B mode of the JAX package).  ``store`` may be None or False (no plan
    store); a store is not ported yet.
    """
    if variant == "auto":
        raise not_ported("variant='auto'", "Autotune")
    if store is not None and store is not False:
        raise not_ported("store=", "Plan store")
    axis_t = (axis,) if isinstance(axis, str) else tuple(axis)
    spec = ExchangeSpec(
        send_counts=md._as_counts(send_counts),
        feature_shape=tuple(int(s) for s in feature_shape),
        dtype=dtype,
        axis=axis_t,
        variant=variant,
        lock_schedule=lock_schedule,
        tile_rows=tile_rows if tile_rows is not None else md.TILE_ROWS,
        pack_impl=pack_impl,
        baked_metadata=baked_metadata,
        codec=codec,
        hier_leader_perm=hier_leader_perm,
        collective=collective,
    )
    return (cache or _GLOBAL_CACHE).get(spec, mesh)


def alltoallv_init(
    send_counts,
    feature_shape: Sequence[int],
    dtype,
    mesh,
    axis: str | Sequence[str] = "x",
    variant: str = "fence",
    lock_schedule: str = "ring",
    tile_rows: int | None = None,
    pack_impl: str = "jnp",
    baked_metadata: bool = True,
    cache: PlanCache | None = None,
    store=None,
    codec: str = "identity",
    hier_leader_perm: Sequence[Sequence[int]] | None = None,
) -> AlltoallvPlan:
    """Persistent alltoallv INIT (see ``exchange_init`` for the contract)."""
    return exchange_init(
        "alltoallv", send_counts, feature_shape, dtype, mesh, axis=axis,
        variant=variant, lock_schedule=lock_schedule, tile_rows=tile_rows,
        pack_impl=pack_impl, baked_metadata=baked_metadata, cache=cache,
        store=store, codec=codec, hier_leader_perm=hier_leader_perm)


def global_plan_cache() -> PlanCache:
    return _GLOBAL_CACHE


def reset_global_plan_cache() -> None:
    global _GLOBAL_CACHE
    _GLOBAL_CACHE = PlanCache()


def init_stats() -> dict:
    """Snapshot of the process-wide INIT counters (``core._init_stats``)."""
    return INIT_STATS.as_dict()


def reset_init_stats() -> None:
    INIT_STATS.reset()
