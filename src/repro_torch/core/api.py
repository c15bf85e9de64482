"""Public persistent-collective API: INIT / START / WAIT / FREE (port of
``repro.core.api``).

    mesh = VirtualMesh((P,), ("x",))                 # P ranks on one card
    # or one process per rank, each running the same calls on its shard:
    # mesh = init_process_mesh(rank, P, "tcp://localhost:29511")
    plan = alltoallv_init(send_counts, feature_shape, dtype, mesh,
                          axis="x", variant="fence", pack_impl="pallas")
    recv = plan.start(sendbuf)     # enqueue the epoch
    recv = plan.wait(recv)         # epoch close
    ...
    plan.free()

    fn = plan.embed()              # the epoch body for a host program:
    out = fn(x)                    # [P, send_rows, *F] -> [P, recv_rows, *F]

    allgatherv_init(counts, ...)      # counts[i]: rows rank i contributes
    reduce_scatter_init(counts, ...)  # counts[j]: rows rank j receives (sum)

Variants:

  auto   measure every applicable variant at INIT (interleaved
         min-of-bursts, ``core.autotune``, each call blocked until the
         stream is idle) and keep the fastest; the decision is cached per
         decision signature and device.  ``embeddable=True`` drops the
         variants ``embed()`` cannot run (ragged); an ``error_tol`` adds
         the ``variant@codec`` arms it admits.  ``plan.auto_choice`` holds
         the arm times and the Eq. 1-3 fit of the decision.
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
         group plays each leader role.  allgatherv: nested gathers.
  ragged alltoallv only: every valid row straight from its send buffer into
         the window at its put displacement, no capacity padding; one K1
         launch from an INIT-baked run table per epoch on a card.

``codec`` (``parallel.wirecodec``) moves encoded wire rows; a lossy codec
needs a declared ``error_tol`` covering its error bound.  ``store=``
(``repro_torch.planstore``) warm-starts INIT from artifacts of earlier
processes: baked tables, hierarchy schedules and auto decisions.
"""

from __future__ import annotations

from typing import Sequence

from ..parallel import wirecodec
from . import metadata as md
from . import patterns
from ._init_stats import INIT_STATS, capturing_inits, record_init_request
from .autotune import autotune_variant
from .plan import (PROCESS_MESH_ITEM, AlltoallvPlan, ExchangePlan,
                   ExchangeSpec, PlanCache)

_GLOBAL_CACHE = PlanCache()


def _resolve_store(store):
    """None -> the process default (``repro_torch.planstore.configure`` /
    ``REPRO_TORCH_PLANSTORE_DIR``), False -> explicitly disabled, anything
    else is used as-is (duck-typed PlanStore)."""
    if store is False:
        return None
    if store is not None:
        return store
    from .. import planstore

    return planstore.default_store()


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
    autotune_iters: int = 12,
    store=None,
    embeddable: bool = False,
    codec: str = "identity",
    error_tol: float | None = None,
    hier_leader_perm: Sequence[Sequence[int]] | None = None,
) -> ExchangePlan:
    """Collective-agnostic INIT: build (or fetch) a persistent plan.

    ``collective`` names the exchange family (``core.patterns``);
    ``send_counts`` is the family's natural counts form: the ``[P, P]``
    matrix for alltoallv, a ``[P]`` vector (or its expanded matrix) for
    allgatherv / reduce_scatter.  ``mesh`` is a ``launch.mesh.VirtualMesh``
    or a ``ProcessMesh`` (one process per rank: every rank passes the
    global count matrix, and INIT raises on every rank if they differ;
    alltoallv fence and lock only, see ``plan.ProcessExchangePlan``).
    ``baked_metadata=False`` recomputes the pack/unpack index maps on the
    device every epoch (the A/B mode of the JAX package).  A non-identity
    ``codec`` requires an ``error_tol`` covering the codec's declared
    relative error bound.

    ``store`` selects the persistent plan store (``repro_torch.planstore``):
    None uses the process default (``planstore.configure`` /
    ``REPRO_TORCH_PLANSTORE_DIR``; no store when neither is set), False
    disables it, and a ``PlanStore`` / ``TieredPlanStore`` is used as-is.
    A stored pattern's INIT skips the table bakes and, under
    ``variant="auto"``, the measurement sweep; a cold INIT publishes what
    it baked and measured.  Entries are keyed on the device kind of
    ``mesh.device``.

    ``variant="auto"`` measures all applicable variants once at INIT
    (``autotune_iters`` calls per arm) and returns the fastest plan; the
    chosen variant and per-candidate timings land on ``plan.auto_choice``.
    With an ``error_tol`` the sweep also measures the codec arms the
    tolerance admits.  ``embeddable=True`` declares the plan will be
    consumed through ``plan.embed()``: the sweep then excludes candidates
    the embedded form cannot run (``ragged``).
    """
    if codec != "identity":
        wirecodec.require(codec, error_tol)   # unknown names / lossy opt-in
    axis_t = (axis,) if isinstance(axis, str) else tuple(axis)
    if variant == "auto":
        # auto resolves to a measured concrete variant below; the spec needs
        # a valid placeholder to pass construction.  fused+2-axis (and a
        # non-identity leader perm) are only valid for the hierarchy, so
        # those combinations placehold there.
        placeholder = ("fence_hierarchy"
                       if len(axis_t) == 2 and (pack_impl == "fused"
                                                or hier_leader_perm)
                       else "fence")
    else:
        placeholder = variant
    spec = ExchangeSpec(
        send_counts=patterns.as_matrix(collective, send_counts),
        feature_shape=tuple(int(s) for s in feature_shape),
        dtype=dtype,
        axis=axis_t,
        variant=placeholder,
        lock_schedule=lock_schedule,
        tile_rows=tile_rows if tile_rows is not None else md.TILE_ROWS,
        pack_impl=pack_impl,
        baked_metadata=baked_metadata,
        codec=codec,
        hier_leader_perm=hier_leader_perm,
        collective=collective,
    )
    if capturing_inits():
        # Everything a prewarm process needs to replay this INIT verbatim
        # (``planstore.prewarm``): the exchange mesh is reconstructible from
        # axis names + sizes alone — the signature never covers other axes.
        # The fields are the JAX package's, so records replay in either.
        record_init_request({
            "collective": collective,
            "send_counts": spec.send_counts.tolist(),
            "feature_shape": list(spec.feature_shape),
            "dtype": md.dtype_name(dtype),
            "axis": list(axis_t),
            "axis_sizes": [int(s) for s in mesh.axis_sizes(axis_t)],
            "variant": variant,
            "lock_schedule": spec.lock_schedule,
            "tile_rows": spec.tile_rows,
            "pack_impl": spec.pack_impl,
            "baked_metadata": spec.baked_metadata,
            "embeddable": bool(embeddable),
            "autotune_iters": int(autotune_iters),
            "codec": spec.codec,
            "error_tol": (float(error_tol) if error_tol is not None
                          else None),
            "hier_leader_perm": ([list(r) for r in spec.hier_leader_perm]
                                 if spec.hier_leader_perm else None),
        })
    resolved_store = _resolve_store(store)
    if variant == "auto" and getattr(mesh, "is_process_mesh", False):
        raise NotImplementedError(
            f"variant='auto' over a process mesh (one process per rank) is "
            f"not ported yet: {PROCESS_MESH_ITEM}")
    if variant == "auto":
        return autotune_variant(spec, mesh, cache or _GLOBAL_CACHE,
                                iters=autotune_iters, embeddable=embeddable,
                                error_tol=error_tol, store=resolved_store)
    return (cache or _GLOBAL_CACHE).get(spec, mesh, store=resolved_store)


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
    autotune_iters: int = 12,
    store=None,
    embeddable: bool = False,
    codec: str = "identity",
    error_tol: float | None = None,
    hier_leader_perm: Sequence[Sequence[int]] | None = None,
) -> AlltoallvPlan:
    """Persistent alltoallv INIT (see ``exchange_init`` for the contract)."""
    return exchange_init(
        "alltoallv", send_counts, feature_shape, dtype, mesh, axis=axis,
        variant=variant, lock_schedule=lock_schedule, tile_rows=tile_rows,
        pack_impl=pack_impl, baked_metadata=baked_metadata, cache=cache,
        autotune_iters=autotune_iters, store=store, embeddable=embeddable,
        codec=codec, error_tol=error_tol, hier_leader_perm=hier_leader_perm)


def allgatherv_init(
    counts,
    feature_shape: Sequence[int],
    dtype,
    mesh,
    axis: str | Sequence[str] = "x",
    variant: str = "fence",
    lock_schedule: str = "ring",
    tile_rows: int | None = None,
    cache: PlanCache | None = None,
    autotune_iters: int = 12,
    store=None,
    embeddable: bool = False,
) -> ExchangePlan:
    """Persistent allgatherv INIT: ``counts[i]`` = rows rank i contributes.

    Every rank's epoch input is its own ``[send_rows, *F]`` contribution;
    the output is the ragged concatenation of all contributions (identical
    on every rank).  Variants: fence (every bucket replicated at once),
    lock (a ring of bucket copies), fence_hierarchy (nested inner/outer
    gathers on a grouped mesh), or auto.  Uniform tile-aligned counts hit the
    identity fast path: the embedded epoch is the bare gather.
    """
    return exchange_init(
        "allgatherv", counts, feature_shape, dtype, mesh, axis=axis,
        variant=variant, lock_schedule=lock_schedule, tile_rows=tile_rows,
        cache=cache, autotune_iters=autotune_iters, store=store,
        embeddable=embeddable)


def reduce_scatter_init(
    counts,
    feature_shape: Sequence[int],
    dtype,
    mesh,
    axis: str | Sequence[str] = "x",
    variant: str = "fence",
    lock_schedule: str = "ring",
    tile_rows: int | None = None,
    cache: PlanCache | None = None,
    autotune_iters: int = 12,
    store=None,
    embeddable: bool = False,
) -> ExchangePlan:
    """Persistent reduce-scatter INIT: ``counts[j]`` = rows rank j receives.

    Every rank's epoch input is the full per-destination concatenation
    (``sum(counts)`` rows); rank j's output is the element-wise SUM of the
    P blocks destined for it.  Variants: fence (the fence epoch, K2 on a
    card, then the sum in rank order), lock (ring accumulation) or auto; the
    leader-combined hierarchy and wire codecs are forbidden
    (``core.patterns``).
    """
    return exchange_init(
        "reduce_scatter", counts, feature_shape, dtype, mesh, axis=axis,
        variant=variant, lock_schedule=lock_schedule, tile_rows=tile_rows,
        cache=cache, autotune_iters=autotune_iters, store=store,
        embeddable=embeddable)


def global_plan_cache() -> PlanCache:
    return _GLOBAL_CACHE


def reset_global_plan_cache() -> None:
    global _GLOBAL_CACHE
    _GLOBAL_CACHE = PlanCache()


def init_stats() -> dict:
    """Snapshot of the process-wide INIT counters (``core._init_stats``):
    cold vs warm INITs, table bakes, autotune measurement bursts, and
    plan-store hit/miss/invalid/put counts."""
    return INIT_STATS.as_dict()


def reset_init_stats() -> None:
    INIT_STATS.reset()
