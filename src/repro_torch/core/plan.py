"""ExchangePlan — the persistent ``MPIX_Request`` analogue (port of
``repro.core.plan``: the alltoallv, allgatherv and reduce-scatter families;
fence, lock, the leader-combined hierarchy and the ragged variant; wire
codecs).

``alltoallv_init`` (api.py) builds a plan from a frozen communication
pattern over P virtual ranks (``launch.mesh.VirtualMesh``).  INIT performs,
once:

  1. the metadata exchange (recv counts, displacements, put displacements),
  2. the capacity schedule (fence bucket size, per-round lock capacities)
     plus the *sparsity analysis*: lock rounds whose capacity is 0 are
     dropped from the epoch,
  3. host-baked pack/unpack index tables (the pattern's ``bake_tables``):
     every rank's gather maps as ``[P, P*C]`` / ``[P, recv_rows]`` tables,
     uploaded to the device once and handed to every START, so no index-map
     arithmetic remains in the epoch; for an alltoallv
     ``variant="fence_hierarchy"`` the leader-combined schedule
     (``metadata.hier_two_stage_schedule``) with its eight tables instead,
     and for ``variant="ragged"`` one flat gather from the send buffers
     straight into the window (``variants.ragged_tables``),
  4. window acquisition from the WindowCache (reused while total_recv_bytes
     is unchanged, recreated otherwise — the paper's rule).

``compile()`` uploads the tables; on a card it turns each table the epoch
gathers with K1 into its run table (``gather_rows.bake_runs``: the gather
as chunks of contiguous rows, read once per chunk, not per row), and it
builds the kernels the epoch launches.
START enqueues the epoch's launches on the current stream and returns
without waiting (genuine start semantics); WAIT synchronises that stream.
``start_pipelined`` rotates through window slots so epoch k+1 can be
enqueued while epoch k's output is still being consumed.  ``embed()``
returns the epoch body as a function for a host program (MoE dispatch,
Ulysses) that owns its buffers.

The spec's ``collective`` resolves to an ``ExchangePattern``
(``core.patterns``) that owns the family's count structure, geometry,
tables and, for allgatherv and reduce-scatter, the epoch body.  A
non-identity ``codec`` (``parallel.wirecodec``) encodes the send rows before
the pack and decodes them after the unpack; the packs and the exchange move
wire rows, with the per-row scales inlined as extra lanes (``jnp`` packs of
2-D rows) or on a ``[rows, 1]`` side channel through the same exchange.

Each plan records its epochs into ``core._exec_stats.EXEC_TELEMETRY`` (the
dispatch wall time of ``start``, or whole epochs through ``record_epoch``)
and, with ``obs.spans.TRACER`` on, emits the JAX plan's spans: ``plan_init``,
``index_table_bake`` / ``hier_schedule_bake``, ``plan_compile`` and one
``epoch`` per START.  ``variant="auto"`` resolves in ``core.autotune``.
``PlanCache.get(..., store=)`` puts the persistent plan store
(``repro_torch.planstore``) behind the in-memory cache: a miss loads the
pattern's baked tables or hierarchy schedule from it (a warm INIT), a cold
build publishes them.  Capturing the epoch in a CUDA graph at
``compile()``, as the JAX plan's AOT compile does, arrives with a later
slice of the port (ROADMAP.md).

On a ``launch.mesh.ProcessMesh`` (one process per rank) ``PlanCache.get``
builds a ``ProcessExchangePlan``: the same INIT on every rank after a
collective check that they agree, this rank's table rows only, windows
registered across the processes, and the peer forms of K2, K3 and K4.
"""

from __future__ import annotations

import dataclasses
import math
import time
from functools import partial
from typing import Any, Callable

import numpy as np
import torch

from ..kernels import a2a_fence, a2a_hier, a2a_lock, gather_rows, rma_signal
from ..kernels import ops as kops
from ..obs.spans import TRACER
from ..parallel import wirecodec
from ..roofline.trace import per_rank_bytes, report_collective
from . import metadata as md
from . import patterns as patterns_mod
from . import variants
from ._exec_stats import EXEC_TELEMETRY
from ._init_stats import INIT_STATS
from .window import Window, WindowCache

VARIANTS = ("fence", "lock", "fence_hierarchy", "ragged")


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype for a torch dtype, numpy dtype or type, or a name."""
    return getattr(torch, md.dtype_name(dtype))


class WarmStartError(Exception):
    """A warm artifact does not fit the plan being built (table geometry
    or leader permutation mismatch).  ``PlanCache.get`` catches this and falls back to a cold
    INIT — a defective warm artifact must never produce a wrong plan."""


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: ndarray field
class ExchangeSpec:
    """Frozen description of one exchange pattern (the INIT arguments).

    The fields and rules are the JAX package's, so specs and signature
    digests line up across the two packages.  ``send_counts`` is always the
    *expanded* square ``[P, P]`` matrix (``patterns.as_matrix``).
    """

    send_counts: Any                      # [P, P] host array, rows = sender
    feature_shape: tuple[int, ...]        # trailing dims of one row
    dtype: Any
    axis: tuple[str, ...]                 # 1 mesh axis, or (outer, inner)
    variant: str = "fence"
    lock_schedule: str = "ring"           # ring | pairwise
    tile_rows: int = md.TILE_ROWS
    pack_impl: str = "jnp"                # jnp | pallas | fused
    baked_metadata: bool = True           # False: maps recomputed every epoch
    codec: str = "identity"               # wire codec (parallel.wirecodec)
    hier_leader_perm: tuple[tuple[int, ...], ...] | None = None
    collective: str = "alltoallv"         # exchange family (core.patterns)

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}")
        pattern = patterns_mod.get(self.collective)   # validates the name
        if self.collective != "alltoallv":
            if self.variant not in pattern.supported_variants:
                raise ValueError(
                    f"collective {self.collective!r} supports variants "
                    f"{pattern.supported_variants}, not {self.variant!r}")
            if self.codec != "identity" and not pattern.supports_codec:
                raise ValueError(
                    f"collective {self.collective!r} forbids wire codecs "
                    "(reduced/replicated rows cannot ride an encoded wire)")
            if self.pack_impl != "jnp":
                raise ValueError(
                    f"collective {self.collective!r} uses the jnp "
                    "pack/unpack path (kernel tile shapes are baked for "
                    "the alltoallv bucket layout)")
            if not self.baked_metadata:
                raise ValueError(
                    f"collective {self.collective!r} requires "
                    "baked_metadata=True (no in-graph A/B twin exists)")
            if self.hier_leader_perm is not None:
                raise ValueError(
                    f"collective {self.collective!r} has no leader roles "
                    "(its hierarchy is nested gathers, not a leader "
                    "schedule); hier_leader_perm must be None")
        if self.hier_leader_perm is not None:
            lp = tuple(tuple(int(x) for x in row)
                       for row in self.hier_leader_perm)
            for row in lp:
                if sorted(row) != list(range(len(row))):
                    raise ValueError(
                        f"hier_leader_perm row {row} is not a permutation")
            if md.leader_perm_is_identity(lp):
                lp = None                 # identity keys as the perm-free era
            elif self.variant != "fence_hierarchy":
                raise ValueError("hier_leader_perm only applies to "
                                 "variant='fence_hierarchy'")
            object.__setattr__(self, "hier_leader_perm", lp)
        if self.codec not in wirecodec.CODECS:
            raise ValueError(f"unknown wire codec {self.codec!r}; "
                             f"have {sorted(wirecodec.CODECS)}")
        if self.codec != "identity" and self.variant == "ragged":
            raise ValueError("wire codecs put decoded rows through the "
                             "pack/unpack path; variant='ragged' writes raw "
                             "wire bytes into the window and supports "
                             "codec='identity' only")
        if self.codec != "identity" and not self.baked_metadata:
            raise ValueError("wire codecs require baked_metadata=True (the "
                             "A/B in-graph mode measures the uncoded seed "
                             "path)")
        if self.variant == "fence_hierarchy" and len(self.axis) != 2:
            raise ValueError("fence_hierarchy needs axis=(outer, inner)")
        if self.variant == "ragged" and len(self.axis) != 1:
            raise ValueError("variant ragged takes a single axis")
        if len(self.axis) not in (1, 2):
            # fence/lock accept a 2-axis mesh factorization too (the
            # exchange then runs over the linearized axis pair).
            raise ValueError(f"axis must name 1 or 2 mesh axes, got {self.axis}")
        if self.variant == "fence_hierarchy" and not self.baked_metadata:
            raise ValueError("fence_hierarchy is driven by the INIT-baked "
                             "two-stage tables; it requires baked_metadata")
        if self.pack_impl not in ("jnp", "pallas", "fused"):
            raise ValueError(f"unknown pack_impl {self.pack_impl!r}")
        if self.pack_impl == "fused" and self.variant not in (
                "fence", "fence_hierarchy"):
            raise ValueError("pack_impl='fused' fuses the gather into the "
                             "RMA kernel; it requires variant='fence' or "
                             "'fence_hierarchy'")
        if self.pack_impl == "fused" and self.variant == "fence" \
                and len(self.axis) != 1:
            raise ValueError("the fused fence kernel exchanges over a "
                             "single mesh axis")
        if self.pack_impl == "fused" and not self.baked_metadata:
            raise ValueError("pack_impl='fused' needs host-baked index maps")


def signature(spec: ExchangeSpec, mesh) -> md.PatternSignature:
    """The plan-cache key of ``spec`` on ``mesh``."""
    row_bytes = math.prod(spec.feature_shape) * torch_dtype(spec.dtype).itemsize
    return md.PatternSignature.build(
        np.asarray(spec.send_counts), spec.feature_shape, spec.dtype,
        spec.variant, spec.axis, row_bytes,
        lock_schedule=spec.lock_schedule, tile_rows=spec.tile_rows,
        pack_impl=spec.pack_impl, baked_metadata=spec.baked_metadata,
        axis_sizes=mesh.axis_sizes(spec.axis),
        codec=spec.codec, hier_leader_perm=spec.hier_leader_perm or (),
        collective=spec.collective)


def bakes_run_tables(device: torch.device, row_bytes: int) -> bool:
    """Whether ``compile()`` bakes K1's run tables: on a card, for rows
    that K1's rule sends to the run kernel.  On the CPU every gather takes
    the plain version, which reads none."""
    return (device.type == "cuda" and gather_rows.cuda_kernel(
        row_bytes, runs=True) is gather_rows.RUNS)


class ExchangePlan:
    """Persistent request object: metadata, window and device tables.

    Collective-agnostic: the spec's ``collective`` resolves to an
    ``ExchangePattern`` (``core.patterns``) that owns the count structure,
    the buffer geometry, the table bake, identity detection and, for
    non-alltoallv families, the epoch body.
    """

    def __init__(self, spec: ExchangeSpec, mesh,
                 window_cache: WindowCache | None = None, warm=None):
        """``warm`` is an optional artifact (duck-typed: anything with an
        ``index_tables`` attribute holding ``metadata.BakedIndexTables``, or
        a ``hier_schedule`` holding a ``metadata.HierSchedule``).  When it
        carries what this spec needs, the host-side bake is skipped; a
        geometry or leader-permutation mismatch raises WarmStartError
        (caller falls back cold)."""
        self.spec = spec
        self.mesh = mesh
        self.warm_loaded = False
        self.pattern = patterns_mod.get(spec.collective)
        t0 = time.perf_counter()

        sc = np.asarray(spec.send_counts, dtype=np.int64)
        self.p = sc.shape[0]
        self.pattern.validate_matrix(sc)
        axis_sizes = mesh.axis_sizes(spec.axis)
        p_mesh = int(np.prod(axis_sizes))
        if p_mesh != self.p:
            raise ValueError(
                f"counts are {self.p}x{self.p} but axis {spec.axis} has size {p_mesh}")

        # --- metadata exchange (host-side; the INIT-time MPI_Alltoall) ---
        self.send_counts = sc
        self.recv_counts = md.recv_counts(sc)
        self.sdispls = md.displacements(sc)
        self.rdispls = md.displacements(self.recv_counts)
        self.put_displs = md.put_displacements(sc)

        # --- capacity schedule + sparsity analysis ---
        self.capacity = md.global_capacity(sc, spec.tile_rows)
        if spec.variant == "lock":
            # Schedule-aware: ring and XOR rounds gate on different diagonals.
            self.round_capacities = (
                md.xor_round_capacities(sc, spec.tile_rows)
                if spec.lock_schedule == "pairwise"
                else md.ring_round_capacities(sc, spec.tile_rows))
            self.lock_rounds_total = self.p - 1
            self.lock_rounds_active = int(
                md.active_round_schedule(self.round_capacities).size)
        else:
            self.round_capacities = None
            self.lock_rounds_total = self.lock_rounds_active = None
        # --- buffer geometry (padded to the max over ranks) ---
        # Pattern-owned: allgatherv sends ONE bucket and receives P;
        # reduce_scatter sends P buckets and receives one reduced bucket.
        self.send_rows = self.pattern.send_rows(sc, spec.tile_rows)
        self.recv_rows = self.pattern.recv_rows(sc, spec.tile_rows)

        # --- leader-combined two-stage schedule (alltoallv hierarchy) ---
        # Other families' fence_hierarchy is nested gathers over the
        # (outer, inner) axes: no leader schedule to bake.
        if spec.variant == "fence_hierarchy" and spec.collective == "alltoallv":
            self.p_outer, self.p_inner = axis_sizes
            want_perm = md.normalize_leader_perm(
                spec.hier_leader_perm, self.p_outer, self.p_inner)
            warm_sched = getattr(warm, "hier_schedule", None)
            if warm_sched is not None:
                if (warm_sched.p_outer != self.p_outer
                        or warm_sched.p_inner != self.p_inner
                        or warm_sched.unpack_src.shape != (self.p, self.recv_rows)):
                    raise WarmStartError(
                        f"hier schedule geometry ({warm_sched.p_outer}x"
                        f"{warm_sched.p_inner}, unpack {warm_sched.unpack_src.shape})"
                        f" does not fit plan ({self.p_outer}x{self.p_inner},"
                        f" recv_rows {self.recv_rows})")
                if tuple(map(tuple, warm_sched.leader_perm)) != want_perm:
                    raise WarmStartError(
                        f"hier schedule leader_perm {warm_sched.leader_perm} "
                        f"does not match requested {want_perm}")
                self.hier_schedule = warm_sched
                self.warm_loaded = True
            else:
                INIT_STATS.bump("table_bakes")
                with TRACER.span("hier_schedule_bake", "init.bake",
                                 p=self.p, variant=spec.variant):
                    self.hier_schedule = md.hier_two_stage_schedule(
                        sc, self.p_outer, self.p_inner, self.recv_rows,
                        spec.tile_rows, leader_perm=want_perm)
            self.hierarchy_remote_needed = self.hier_schedule.remote_needed
            self.cross_group_puts = self.hier_schedule.cross_group_puts
        else:
            self.p_outer, self.p_inner = (
                axis_sizes if spec.variant == "fence_hierarchy" else (None, None))
            self.hier_schedule = None
            self.hierarchy_remote_needed = None
            self.cross_group_puts = None

        self.dtype = torch_dtype(spec.dtype)
        self.row_bytes = math.prod(spec.feature_shape) * self.dtype.itemsize
        self.signature = signature(spec, mesh)

        # --- wire codec: the rows the packs and the exchange move ---
        self.codec = (wirecodec.get(spec.codec) if spec.codec != "identity"
                      else None)
        self.wire_row_bytes = self.row_bytes
        self.inline_lanes = 0
        if self.codec is not None:
            # Scales ride inline as extra wire lanes where the reference
            # gathers run on 2-D payloads (one exchange moves both); the
            # kernel packs and the hierarchy keep the [rows, 1] side channel.
            if (len(spec.feature_shape) == 1 and self.codec.has_scales
                    and spec.variant != "fence_hierarchy"
                    and spec.pack_impl == "jnp"):
                self.inline_lanes = self.codec.scale_lanes
            self.wire_row_bytes = ((math.prod(spec.feature_shape)
                                    + self.inline_lanes)
                                   * self.codec.wire_dtype.itemsize)

        # --- window (paper: reuse while total_recv_bytes unchanged) ---
        self._window_cache = window_cache if window_cache is not None else WindowCache()
        self.window: Window = self._acquire_window()

        # --- host-baked pack/unpack index maps ---------------------------
        # Computed once on host, uploaded once by compile().
        # (baked_metadata=False recomputes them on the device every epoch,
        # for A/B benchmarking.)
        if self.hier_schedule is not None:
            # The schedule's eight tables (s1 pack, s2 slab build, s3
            # scatter build, final unpack), then the two K5 reads in place
            # of the round permutations.
            self.index_tables = None
            sched = self.hier_schedule
            self._table_host = sched.tables + (md.hier_stage2_from(sched),
                                               md.hier_row_rounds(sched))
        elif spec.variant == "ragged":
            # No pack/unpack tables (as in the JAX plan): one flat gather
            # from every send buffer into every window slice, which is the
            # JAX epoch's ragged_all_to_all at output_offsets = put_displs.
            self.index_tables = None
            self._table_host = variants.ragged_tables(
                sc, self.sdispls, self.put_displs, self.send_rows,
                self.recv_rows)
        elif spec.baked_metadata:
            want_pack, want_unpack = self.pattern.table_shapes(
                self.p, self.capacity, self.recv_rows)
            warm_tables = getattr(warm, "index_tables", None)
            if warm_tables is not None:
                if (warm_tables.pack_src.shape != want_pack
                        or warm_tables.unpack_src.shape != want_unpack):
                    raise WarmStartError(
                        f"baked tables {warm_tables.pack_src.shape}/"
                        f"{warm_tables.unpack_src.shape} do not fit "
                        f"{spec.collective} plan (want {want_pack}/"
                        f"{want_unpack})")
                tables = warm_tables
                self.warm_loaded = True
            else:
                INIT_STATS.bump("table_bakes")
                with TRACER.span("index_table_bake", "init.bake",
                                 p=self.p, variant=spec.variant,
                                 collective=spec.collective):
                    tables = self.pattern.bake_tables(sc, self.capacity,
                                                      self.recv_rows)
            self.index_tables = tables
            self._table_host = (tables.pack_src, tables.pack_valid,
                                tables.unpack_src, tables.unpack_valid)
        else:
            self.index_tables = None
            self._table_host = (sc, self.sdispls, self.recv_counts, self.rdispls)

        # Uniform all-equal patterns have identity pack/unpack maps (the
        # ragged layout IS the bucketed layout): the embedded form elides
        # both gathers for them (the MoE bucket layout).  The hierarchy
        # bakes no such tables and keeps its table path, but on such a
        # pattern its epoch is the flat all-to-all all the same.
        uniform = self.pattern.identity_maps(sc, self.capacity,
                                             self.send_rows, self.recv_rows)
        self.identity_maps = bool(self.index_tables is not None and uniform)
        self.uniform_full = bool(spec.collective == "alltoallv" and uniform)

        self._tables: tuple[torch.Tensor, ...] | None = None
        self._pack: Callable | None = None
        self._packs: tuple[Callable, Callable] | None = None
        self._unpack: Callable | None = None
        # K1's run tables on a card, by table name (``_run_sources``).
        self.run_tables: dict[str, gather_rows.RunTable] = {}
        self._stage2: Callable | None = None
        self._ref_stage2: Callable | None = None
        self._pattern_epoch: Callable | None = None
        self._embedded: dict[int, Callable] = {}
        self._grouped_hier: dict[int, tuple] = {}
        # The transposed epoch (autograd), baked at the first backward.
        self._transposes: dict[int, tuple] = {}
        self._twin: "ExchangePlan | None" = None
        self._stream = None
        self.init_host_seconds = time.perf_counter() - t0
        self.init_compile_seconds = 0.0
        self.init_run_table_seconds = 0.0
        self.starts = 0
        # EXECUTE telemetry: start()/start_pipelined() record their epoch
        # dispatch wall time into this plan's ring (keyed by signature
        # digest) unless disabled — drivers that time whole epochs
        # themselves flip record_starts off and call record_epoch instead.
        self.record_starts = True
        # The variant="auto" decision this plan won (core.autotune), if any.
        self.auto_choice: dict | None = None
        INIT_STATS.bump("warm_inits" if self.warm_loaded else "cold_inits")
        # Prebuilt once so the epoch hot path emits spans with zero dict
        # allocation (``TRACER.emit_span`` stores the same dict by ref).
        self._digest = self.signature.digest
        self._epoch_span_args = {"digest": self._digest,
                                 "variant": spec.variant,
                                 "collective": spec.collective}
        if TRACER.enabled:
            TRACER.emit_span("plan_init", "init", t0, time.perf_counter(),
                             {"digest": self._digest,
                              "variant": spec.variant,
                              "collective": spec.collective,
                              "warm": self.warm_loaded,
                              "p": self.p,
                              "codec": spec.codec})

    def _acquire_window(self) -> Window:
        return self._window_cache.get(self.recv_rows, self.spec.feature_shape,
                                      self.dtype)

    # -- geometry ------------------------------------------------------------
    @property
    def global_send_shape(self) -> tuple[int, ...]:
        return (self.p * self.send_rows,) + self.spec.feature_shape

    @property
    def global_recv_shape(self) -> tuple[int, ...]:
        return (self.p * self.recv_rows,) + self.spec.feature_shape

    # -- COMPILE --------------------------------------------------------------
    def _exchange_kernel(self, row_width: int):
        return (a2a_fence.fence_cuda_kernel(row_width, self.capacity)
                if self.spec.variant == "fence"
                else a2a_lock.cuda_kernel(row_width))

    def kernels(self) -> tuple:
        """The hand-written kernels this plan's epoch launches on a card, by
        the K1-K4 wrappers' rules (``gather_rows.kernel_for``,
        ``fence_kernel_for``, ``fused_kernel_for``, ``kernel_for``) for the
        width of the rows the epoch moves (wire rows under a codec) and the
        capacity of its buckets, on aligned buffers (a buffer at a base that
        is not a 16-byte multiple takes the other K1, K2, K3 or K4 kernel).
        K1 runs from the baked run tables, except with
        ``baked_metadata=False``.  A codec's ``[rows, 1]`` scale side
        channel adds the exchange at 4-byte rows; the allgatherv exchanges
        and the reduce-scatter lock are plain tensor ops."""
        spec, rb = self.spec, self.wire_row_bytes
        if spec.variant == "ragged":
            return (gather_rows.cuda_kernel(rb, runs=True),)
        if spec.collective != "alltoallv":
            return ((self._exchange_kernel(rb),)
                    if spec.collective == "reduce_scatter"
                    and spec.variant == "fence" else ())
        k1 = gather_rows.cuda_kernel(rb, runs=spec.baked_metadata)
        if spec.variant == "fence_hierarchy":
            s = self.hier_schedule
            caps = ((s.s1_cap,) if s.remote_needed else ()) + (s.s3_cap,)
            k2 = tuple(dict.fromkeys(a2a_fence.fence_cuda_kernel(rb, c)
                                     for c in caps))
            return {"jnp": k2, "pallas": k2 + (k1,),
                    "fused": k2 + (a2a_hier.HIER, k1)}[spec.pack_impl]
        if spec.pack_impl == "fused":
            found = (a2a_fence.fused_cuda_kernel(rb), k1)
        elif spec.pack_impl == "pallas":
            found = (k1, self._exchange_kernel(rb))
        else:
            found = (self._exchange_kernel(rb),)
        if self._side_channel:
            found += (self._exchange_kernel(4),)
        return tuple(dict.fromkeys(found))

    @property
    def _side_channel(self) -> bool:
        """Whether a codec's scales move on their own ``[rows, 1]`` channel."""
        return (self.codec is not None and self.codec.has_scales
                and not self.inline_lanes)

    def _run_sources(self) -> dict[str, tuple[int, int | None]]:
        """The baked tables the epoch gathers with K1, by name, as
        ``(i, split)``: ``idx`` and ``valid`` are tables ``i`` and ``i + 1``
        of the plan.  The ragged epoch's flat gather; the flat pack
        (``pack_impl="pallas"``) and unpack; the hierarchy's stage-1 pack,
        its stage-3 pack (two sources split at ``total_s2``, or the send
        buffer alone when all-local) and its unpack.  Empty for
        ``pack_impl="jnp"`` or unbaked tables."""
        spec, s = self.spec, self.hier_schedule
        if spec.variant == "ragged":
            return {"ragged": (0, None)}
        if spec.pack_impl == "jnp" or not spec.baked_metadata:
            return {}
        if s is not None:
            sources = {"s3": (4, s.total_s2 if s.remote_needed else None),
                       "unpack": (6, None)}
            if s.remote_needed:
                sources["s1"] = (0, None)
            return sources
        sources = {"unpack": (2, None)}
        if spec.pack_impl == "pallas":
            sources["pack"] = (0, None)
        return sources

    def compile(self) -> "ExchangePlan":
        """Upload the tables and, where a card's K1 reads them, their run
        tables; bind the epoch's gathers and build the epoch's kernels."""
        if self._tables is not None:
            return self
        t0 = time.perf_counter()
        with TRACER.span("plan_compile", "init", digest=self._digest,
                         variant=self.spec.variant):
            self._compile_impl()
        self.init_compile_seconds = time.perf_counter() - t0
        return self

    def _compile_impl(self) -> None:
        spec, dev = self.spec, self.mesh.device
        if spec.baked_metadata or spec.variant == "ragged":
            self._tables = tuple(torch.tensor(np.asarray(t), device=dev)
                                 for t in self._table_host)
        else:
            self._tables = tuple(torch.tensor(t, dtype=torch.int32, device=dev)
                                 for t in self._table_host)
        runs = {}
        if bakes_run_tables(dev, self.wire_row_bytes):
            t1 = time.perf_counter()
            t, h = self._tables, self._table_host
            runs = {name: gather_rows.bake_runs(
                        t[i], t[i + 1], self.wire_row_bytes, split,
                        host=(h[i], h[i + 1]))
                    for name, (i, split) in self._run_sources().items()}
            self.init_run_table_seconds = time.perf_counter() - t1
        self.run_tables = runs
        kernel_gathers = spec.pack_impl != "jnp"
        self._unpack = (partial(kops.unpack, runs=runs.get("unpack"))
                        if kernel_gathers else variants.unpack_rows)
        if spec.collective != "alltoallv":
            self._pattern_epoch = self.pattern.build_epoch(self)
        elif self.hier_schedule is not None:
            # Stage 2: K5 for pack_impl="fused", else the per-round selects.
            s2_from, row_round = self._tables[8:10]
            self._ref_stage2 = partial(variants.stage2_leader_ppermute,
                                       schedule=self.hier_schedule,
                                       s2_from=s2_from)
            self._stage2 = (partial(kops.fused_hier_leader_exchange,
                                    s2_from=s2_from, row_round=row_round)
                            if spec.pack_impl == "fused" else self._ref_stage2)
            self._packs = ((partial(kops.pack, runs=runs.get("s1")),
                            partial(kops.pack, runs=runs.get("s3")))
                           if kernel_gathers else (variants.pack_rows,) * 2)
        elif spec.pack_impl == "pallas":
            self._pack = partial(kops.pack, runs=runs.get("pack"))
        else:  # "jnp" ("fused" packs inside K3)
            self._pack = variants.pack_rows
        if dev.type == "cuda":
            for k in self.kernels():
                k._load()

    # -- per-epoch body ---------------------------------------------------------
    def _send_view(self, sendbuf: torch.Tensor, shapes) -> torch.Tensor:
        """``sendbuf`` as ``[P, send_rows, *F]``, if it has one of ``shapes``,
        the plan's dtype and lies on the mesh's device; else raise."""
        if (tuple(sendbuf.shape) not in shapes or sendbuf.dtype != self.dtype
                or sendbuf.device != self.mesh.device):
            raise ValueError(
                f"send buffer must be {' or '.join(map(str, shapes))} "
                f"{self.dtype} on {self.mesh.device}, got "
                f"{tuple(sendbuf.shape)} {sendbuf.dtype} on {sendbuf.device}")
        return sendbuf.reshape((-1, self.send_rows) + self.spec.feature_shape)

    def _exchange(self, packed: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """The bucketed fence or lock exchange ``[P, P*C, *F]``, or
        ``groups`` of them (``[groups*P, P*C, *F]``): one fence launch, one
        lock epoch per group."""
        if self.spec.variant == "fence":
            return variants.fence_exchange(packed, self.p, self.capacity,
                                           groups)
        return variants.per_group(
            lambda b: variants.lock_exchange(b, self.p, self.capacity,
                                             self.round_capacities,
                                             self.spec.lock_schedule),
            packed, groups)

    def _hier_body(self, groups: int) -> tuple:
        """The hierarchy epoch's eight device tables, stage 2 and packs for
        ``groups`` independent groups of the plan's P ranks: for one group
        the compiled ones; for more, every table tiled ``groups`` times
        and the stage-2 sender table offset to each group's ranks (with
        K1's run tables of the tiled tables on a card), built once per
        ``groups``."""
        self.compile()
        if groups == 1:
            return self._tables[:8], self._stage2, self._packs
        if groups in self._grouped_hier:
            return self._grouped_hier[groups]
        spec, dev, h = self.spec, self.mesh.device, self._table_host
        host = [np.tile(np.asarray(t), (groups, 1)) for t in h[:8]]
        s2_from = np.asarray(h[8])
        host.append(np.concatenate(
            [np.where(s2_from >= 0, s2_from + g * self.p, -1)
             for g in range(groups)]).astype(s2_from.dtype))
        tables = tuple(torch.tensor(t, device=dev) for t in host)
        row_round = self._tables[9]
        runs = {}
        if bakes_run_tables(dev, self.wire_row_bytes):
            runs = {name: gather_rows.bake_runs(
                        tables[i], tables[i + 1], self.wire_row_bytes,
                        split, host=(host[i], host[i + 1]))
                    for name, (i, split) in self._run_sources().items()
                    if name != "unpack"}
        stage2 = (partial(kops.fused_hier_leader_exchange, s2_from=tables[8],
                          row_round=row_round)
                  if spec.pack_impl == "fused" else
                  partial(variants.stage2_leader_ppermute,
                          schedule=self.hier_schedule, s2_from=tables[8]))
        packs = ((partial(kops.pack, runs=runs.get("s1")),
                  partial(kops.pack, runs=runs.get("s3")))
                 if spec.pack_impl != "jnp" else (variants.pack_rows,) * 2)
        self._grouped_hier[groups] = (tables[:8], stage2, packs)
        return self._grouped_hier[groups]

    def _buckets(self, x: torch.Tensor, groups: int = 1):
        """Pack and exchange ``x [P, send_rows, *W]`` (wire rows under a
        codec; the hierarchy also ``[groups*P, ...]``): returns the recv
        layout the final unpack reads, and the unpack tables."""
        spec, p, cap = self.spec, self.p, self.capacity
        if self.hier_schedule is not None:
            t, stage2, packs = self._hier_body(groups)
            buckets = variants.hierarchy_exchange_combined(
                x, t[:6], self.hier_schedule, stage2=stage2, packs=packs,
                groups=groups)
            return buckets, t[6], t[7]
        if spec.baked_metadata:
            src, valid, rsrc, rvalid = self._tables
        else:
            sc, sd, rc, rd = self._tables
            src, valid = variants.pack_index_map_in_graph(sc, sd, p, cap)
            rsrc, rvalid = variants.unpack_index_map_in_graph(
                rc, rd, p, cap, self.recv_rows)

        if spec.pack_impl == "fused":
            # Pack fused into the fence kernel: rows go straight from the
            # send buffers into their destination buckets, never
            # materializing the padded [P, P*C, F] send layout (on a card
            # the K3 kernel ``a2a_fence.fused_kernel_for`` names).
            report_collective("all-to-all", p * cap * per_rank_bytes(x)
                              // x.shape[1], p)
            buckets = kops.fused_pack_alltoallv(x, src, valid, p=p,
                                                capacity=cap)
        else:
            buckets = self._exchange(self._pack(x, src, valid))
        return buckets, rsrc, rvalid

    def _move(self, x: torch.Tensor, unpack: Callable,
              groups: int = 1) -> torch.Tensor:
        """Pack, exchange and unpack ``x [groups*P, send_rows, *W]`` (wire
        rows under a codec) into ``[groups*P, recv_rows, *W]``, padding rows
        zero (``unpack`` decides).  Differentiable where the JAX package's
        embedded body is; where a Pallas kernel of that body has no
        transpose, the backward raises as ``jax.vjp`` does."""
        def fn(t: torch.Tensor) -> torch.Tensor:
            buckets, rsrc, rvalid = self._buckets(t, groups)
            return unpack(buckets, rsrc, rvalid)

        spec = self.spec
        # The JAX body's gathers are Pallas kernels in the flat "pallas"
        # and "fused" bodies; the hierarchy's are jnp, its "fused" stage 2
        # a Pallas kernel.
        pallas = spec.pack_impl == "fused" or (
            spec.pack_impl == "pallas" and self.hier_schedule is None)
        if pallas and not self.uniform_full:
            return variants.untransposable(fn, x, (
                f"the backward of the embedded alltoallv epoch "
                f"({spec.variant}, pack_impl {spec.pack_impl!r}): the JAX "
                f"package's body runs a Pallas kernel there, and a Pallas "
                f"kernel has no transpose rule, so jax.vjp raises "
                f"NotImplementedError too"))
        return self._linear(fn, x, groups, spec.pack_impl == "pallas")

    def _linear(self, fn: Callable, x: torch.Tensor, groups: int,
                kernel_gathers: bool) -> torch.Tensor:
        """``fn(x)`` for a row move of this plan's pattern, differentiable.
        On a uniform full pattern the move is its own transpose (the
        hierarchy's epoch moves the rows as the flat all-to-all does);
        otherwise the backward is the transposed flat epoch
        (``_transposed_epoch``), with K1 gathers where ``kernel_gathers``."""
        if self.uniform_full:
            return variants.self_adjoint_exchange(fn, x)
        return variants.linear_exchange(
            fn, partial(self._transposed_epoch, groups=groups,
                        kernel_gathers=kernel_gathers), x)

    def _transpose_tables(self, groups: int) -> tuple:
        """The transposed epoch's tables for ``groups`` groups, baked once,
        at the first backward, in numpy from the plan's flat pack and unpack
        tables (a hierarchy plan bakes the flat tables of its counts first):
        both maps are injective, so each transpose is the gather by the
        inverse table (``variants.invert_gather``).  Returns the host and
        device ``(unpack_inv, unpack_inv_valid [G*P, P*C], pack_inv,
        pack_inv_valid [G*P, send_rows])``, the lock's round capacities of
        the transposed pattern, and a dict for K1's run tables."""
        if groups not in self._transposes:
            if self.hier_schedule is None:
                flat = self._table_host[:4]
            else:
                t = md.baked_index_tables(self.send_counts, self.capacity,
                                          self.recv_rows)
                flat = (t.pack_src, t.pack_valid, t.unpack_src,
                        t.unpack_valid)
            host = (variants.invert_gather(flat[2], flat[3],
                                           self.p * self.capacity)
                    + variants.invert_gather(flat[0], flat[1],
                                             self.send_rows))
            host = tuple(np.tile(h, (groups, 1)) for h in host)
            dev = tuple(torch.from_numpy(h).to(self.mesh.device)
                        for h in host)
            caps = None
            if self.spec.variant == "lock":
                sc_t = self.send_counts.T
                caps = (md.xor_round_capacities(sc_t, self.spec.tile_rows)
                        if self.spec.lock_schedule == "pairwise" else
                        md.ring_round_capacities(sc_t, self.spec.tile_rows))
            self._transposes[groups] = (host, dev, caps, {})
        return self._transposes[groups]

    def _transposed_epoch(self, ct: torch.Tensor, groups: int = 1,
                          kernel_gathers: bool = False) -> torch.Tensor:
        """The transpose of the move ``[groups*P, send_rows, *W] ->
        [groups*P, recv_rows, *W]``, on the cotangent ``ct``: the unpack's
        transpose (the gather by the inverse unpack table), the same bucket
        exchange (K2 for the fence and the hierarchy, K4 for the lock, at
        the transposed pattern's round capacities), then the pack's
        transpose.  Rows no forward gather read get zero.  It is the flat
        alltoallv epoch of the transposed counts; for a hierarchy plan too,
        which moves the rows of the same map.  ``kernel_gathers`` takes K1
        for both gathers, from run tables of the inverse maps on a card."""
        host, dev, caps, runs = self._transpose_tables(groups)
        p, cap = self.p, self.capacity
        if kernel_gathers:
            rb = math.prod(ct.shape[2:]) * ct.element_size()
            if bakes_run_tables(ct.device, rb) and rb not in runs:
                runs[rb] = tuple(gather_rows.bake_runs(
                    dev[i], dev[i + 1], rb, None, host=(host[i], host[i + 1]))
                    for i in (0, 2))
            r_unpack, r_pack = runs.get(rb, (None, None))
            buckets = kops.pack(ct, dev[0], dev[1], runs=r_unpack)
        else:
            buckets = variants.pack_rows(ct, dev[0], dev[1])
        if self.spec.variant == "lock":
            moved = variants.per_group(
                lambda b: variants.lock_exchange(b, p, cap, caps,
                                                 self.spec.lock_schedule),
                buckets, groups)
        else:
            moved = variants.fence_exchange(buckets, p, cap, groups)
        if kernel_gathers:
            return kops.unpack(moved, dev[2], dev[3], runs=r_pack)
        return variants.unpack_rows(moved, dev[2], dev[3])

    def _pattern_transpose(self, ct: torch.Tensor) -> torch.Tensor:
        """The backward of an allgatherv or reduce-scatter epoch: the
        other family's embedded epoch over the same counts, on the
        cotangent.  The allgatherv's transpose sums the P copies of each
        row (a reduce-scatter); the reduce-scatter's hands each summed
        row's cotangent to every contributor (an allgatherv).  The twin
        plan (a fence for an allgatherv hierarchy: the reduce-scatter has
        none) is built at the first backward; its recv and send rows are
        this plan's send and recv rows."""
        if self._twin is None:
            spec = self.spec
            other, c = (("reduce_scatter", self.send_counts[:, 0])
                        if spec.collective == "allgatherv"
                        else ("allgatherv", self.send_counts[0]))
            self._twin = ExchangePlan(ExchangeSpec(
                send_counts=patterns_mod.as_matrix(other, c),
                feature_shape=spec.feature_shape, dtype=spec.dtype,
                axis=spec.axis,
                variant="fence" if spec.variant == "fence_hierarchy"
                else spec.variant,
                lock_schedule=spec.lock_schedule, tile_rows=spec.tile_rows,
                collective=other), self.mesh, self._window_cache)
        return self._twin.embed()(ct)

    @property
    def _unpack_valid(self) -> torch.Tensor:
        """The final unpack's mask ``[P, recv_rows]`` on the device."""
        return self._tables[7 if self.hier_schedule is not None else 3]

    def _scale_channel(self, scales: torch.Tensor) -> torch.Tensor:
        """A codec's ``[P, send_rows, 1]`` scales through the epoch's own
        exchange, packed and unpacked by the reference gathers (the
        hierarchy's stage 2 by ``stage2_leader_ppermute``): ``[P,
        recv_rows, 1]``, zero on padding rows.  Differentiable, as the JAX
        package's side channel is."""
        t = self._tables

        def fn(s: torch.Tensor) -> torch.Tensor:
            if self.hier_schedule is not None:
                buckets = variants.hierarchy_exchange_combined(
                    s, t[:6], self.hier_schedule, stage2=self._ref_stage2)
                return variants.unpack_rows(buckets, t[6], t[7])
            return variants.unpack_rows(
                self._exchange(variants.pack_rows(s, t[0], t[1])), t[2], t[3])

        return self._linear(fn, scales, 1, False)

    def _codec_epoch(self, x: torch.Tensor, unpack: Callable):
        """The codec'd epoch body: encode every send row, pack, exchange and
        unpack the wire rows (``unpack`` zeroing padding), then decode.
        Returns ``[P, recv_rows, *F]`` in the plan's dtype and the unpack
        mask.  Autograd follows the JAX package's transposes: a cast's is
        the reverse cast (bf16 cotangents move as bf16), int8's ``round``
        gives zero, and the inlined scale lanes are a bitcast, which
        carries none."""
        p, s, r, f = self.p, self.send_rows, self.recv_rows, self.spec.feature_shape
        k = self.inline_lanes
        wire, scales = self.codec.encode(x.reshape((p * s,) + f))
        if k:
            wire, scales = wirecodec.inline_rows(wire, scales, k), None
        out = self._move(wire.reshape((p, s) + tuple(wire.shape[1:])), unpack)
        out = out.reshape((p * r,) + tuple(out.shape[2:]))
        sc_out = None
        if k:
            out, sc_out = wirecodec.split_rows(out, k)
        elif scales is not None:
            sc_out = self._scale_channel(scales.reshape(p, s, 1)).reshape(
                p * r, 1)
        return (self.codec.decode(out, sc_out, self.dtype).reshape((p, r) + f),
                self._unpack_valid)

    def _epoch(self, sendbuf: torch.Tensor, win: torch.Tensor) -> None:
        x = self._send_view(sendbuf, (self.global_send_shape,))
        view = win.view((self.p, self.recv_rows) + self.spec.feature_shape)
        if self.spec.variant == "ragged":
            variants.ragged_exchange(x, view, *self._tables,
                                     runs=self.run_tables.get("ragged"))
            return
        if self.spec.collective != "alltoallv":
            _write_through(view, self._pattern_epoch(x, *self._tables),
                           self._tables[3])
            return
        if self.codec is not None:
            _write_through(view, *self._codec_epoch(x, self._unpack))
            return
        buckets, rsrc, rvalid = self._buckets(x)
        # Write-through into the window: the unpack stores the valid rows
        # straight into the slot, in place, and skips the invalid ones, so
        # padding keeps stale window bytes (real RMA semantics, and the
        # JAX plan's where(valid, out, window) on its donated buffer).
        self._unpack(buckets, rsrc, rvalid, out=view)

    # -- embedded form --------------------------------------------------------
    def embed(self, groups: int = 1) -> Callable:
        """The epoch body for a host program that owns its buffers.

        Returns ``fn(x) -> recv``: ``x`` is every rank's ragged send buffer
        ``[P, send_rows, *F]`` (or the global ``[P*send_rows, *F]``) and the
        result is the ragged recv buffer ``[P, recv_rows, *F]``, a fresh
        tensor whose invalid padding rows are zero: an embedded epoch has no
        window to write through.  Uniform identity patterns
        (``self.identity_maps``) skip both gathers and upload no tables: the
        epoch is the bare exchange (with the codec's encode, the scales
        inlined where they fit, and decode).  ``variant="ragged"`` (it puts
        into the plan-owned window) and ``baked_metadata=False`` (no tables
        to embed) raise, as in the JAX package.

        ``groups`` runs that many independent copies of the epoch at once,
        on ``[groups*P, send_rows, *F]``: the replicas of the plan's axis
        along the other axes of a mesh (a data axis), as the JAX package's
        embedded epoch runs once per such replica under ``shard_map``.  The
        fence's K2 and the hierarchy's K1, K2 and K5 take every group in one
        launch; the lock takes one K4 epoch per group.  The identity bodies
        and the hierarchy take ``groups``; other table-driven bodies raise.

        Autograd gives the JAX package's ``jax.vjp`` of the same body.
        The identity alltoallv epoch is the bare exchange, its own
        transpose, so its backward is the same exchange on the cotangent
        (K2 or K4 again on a card); so is the hierarchy's epoch on a pattern
        whose counts all equal the capacity with no padding row
        (``self.uniform_full``: it moves the rows as the flat all-to-all
        does; K1, K2 and K5 again).  The other table-driven alltoallv
        bodies (the flat ``jnp`` fence and lock, the hierarchy's ``jnp`` and
        ``pallas``) take the transposed epoch (``_transposed_epoch``): the
        flat alltoallv of the transposed counts, from the inverse tables.
        The flat ``pallas`` and ``fused`` bodies and the hierarchy's
        ``fused`` body raise ``NotImplementedError`` in their backward, as
        ``jax.vjp`` does on their Pallas kernels.  The allgatherv's backward
        is the reduce-scatter over the same counts and the other way round
        (``_pattern_transpose``).  Under a codec the encode and decode
        differentiate as JAX's do: a cast's transpose is the reverse cast,
        int8's ``round`` gives zero (the body then returns a zero gradient,
        not none) and the inlined scale lanes, a bitcast, carry none.
        """
        groups = int(groups)
        if groups in self._embedded:
            return self._embedded[groups]
        spec = self.spec
        if spec.variant == "ragged":
            raise ValueError("variant='ragged' puts into the plan-owned "
                             "window and cannot be embedded")
        if not spec.baked_metadata:
            raise ValueError("embed() requires baked_metadata=True (the "
                             "A/B in-graph mode has no tables to embed)")
        if groups < 1 or (groups > 1 and (
                spec.collective != "alltoallv" or not self.identity_maps
                and (self.hier_schedule is None or self.codec is not None))):
            raise ValueError(
                f"embed(groups={groups}): groups > 1 takes the alltoallv "
                f"identity bodies and the hierarchy without a codec, not "
                f"this {spec.collective} {spec.variant} plan")
        gp = groups * self.p
        shapes = ((gp * self.send_rows,) + spec.feature_shape,
                  (gp, self.send_rows) + spec.feature_shape)
        codec = self.codec

        if spec.collective != "alltoallv":
            if self.identity_maps:
                move = self.pattern.build_exchange(self)
            else:
                self.compile()

                def move(x: torch.Tensor) -> torch.Tensor:
                    return self._pattern_epoch(x, *self._tables)

            def body(x: torch.Tensor) -> torch.Tensor:
                return variants.linear_exchange(move, self._pattern_transpose,
                                                x)
        elif self.identity_maps:
            # The ragged layout IS the bucketed layout, so pack_impl is moot.
            def bare(x: torch.Tensor) -> torch.Tensor:
                return variants.self_adjoint_exchange(
                    partial(self._exchange, groups=groups), x)

            def body(x: torch.Tensor) -> torch.Tensor:
                if codec is None:
                    return bare(x)
                s, f = self.send_rows, spec.feature_shape
                wire, scales = codec.encode(x.reshape((gp * s,) + f))
                k = wirecodec.inline_lanes(wire, scales)
                if k:
                    moved = bare(wirecodec.inline_rows(wire, scales, k)
                                 .reshape(gp, s, -1))
                    out, sc_out = wirecodec.split_rows(
                        moved.reshape(gp * s, -1), k)
                else:
                    out = bare(wire.reshape((gp, s) + tuple(wire.shape[1:])))
                    out = out.reshape((gp * s,) + tuple(out.shape[2:]))
                    sc_out = (bare(scales.reshape(gp, s, 1)).reshape(gp * s, 1)
                              if scales is not None else None)
                return codec.decode(out, sc_out, self.dtype).reshape(
                    (gp, s) + f)
        else:
            self.compile()
            # The hierarchy's final unpack is the reference gather, as in
            # the JAX plan's embedded form.
            unpack = (variants.unpack_rows if self.hier_schedule is not None
                      else self._unpack)

            def body(x: torch.Tensor) -> torch.Tensor:
                if codec is not None:
                    return self._codec_epoch(x, unpack)[0]
                return self._move(x, unpack, groups)

        def embedded(x: torch.Tensor) -> torch.Tensor:
            xv = self._send_view(x, shapes)
            return variants.zero_gradient(body(xv), xv)

        self._embedded[groups] = embedded
        return embedded

    # -- START / WAIT / FREE ----------------------------------------------------
    def _start(self, sendbuf: torch.Tensor, slot: int) -> torch.Tensor:
        self.compile()
        dev = self.mesh.device
        win = self.window.materialize(self.global_recv_shape, dev, slot=slot)
        t0 = time.perf_counter()
        self._epoch(sendbuf, win)
        if self.record_starts:
            t1 = time.perf_counter()
            EXEC_TELEMETRY.record(self._digest, t1 - t0)
            if TRACER.enabled:
                TRACER.emit_span("epoch", "execute", t0, t1,
                                 self._epoch_span_args)
        self._stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                        else None)
        self.starts += 1
        return win

    def start(self, sendbuf: torch.Tensor) -> torch.Tensor:
        """Launch one epoch; returns the window slot it writes (the JAX
        plan returns its donated window the same way)."""
        return self._start(sendbuf, 0)

    def start_pipelined(self, sendbuf: torch.Tensor, depth: int = 2) -> torch.Tensor:
        """Launch one epoch against the multi-slot window.

        Epochs rotate through ``depth`` window slots, so epoch k+1 never
        writes the slot holding epoch k's output.  Callers must not read an
        epoch's output after ``depth`` further ``start_pipelined`` calls
        (its slot has been recycled — the RMA exposure-epoch rule).
        """
        return self._start(sendbuf, self.starts % depth)

    def wait(self, recvbuf: torch.Tensor) -> torch.Tensor:
        """Close the epoch: synchronise the stream the last START ran on."""
        if self._stream is not None:
            self._stream.synchronize()
        return recvbuf

    def record_epoch(self, seconds: float, t_end: "float | None" = None) -> None:
        """Record one externally timed epoch into this plan's telemetry
        ring.  The path for consumers whose epochs run inside a host
        program (``embed()`` bodies cannot self-time) or who want
        end-to-end ``start``+``wait`` wall time instead of dispatch time.

        ``t_end`` anchors the emitted trace span's end (perf_counter
        seconds).  Callers that also emit their own enclosing span must
        pass the timestamp their window measurement straddles, so the
        backdated epoch span nests cleanly inside the caller's span."""
        EXEC_TELEMETRY.record(self._digest, float(seconds))
        if TRACER.enabled:
            t1 = time.perf_counter() if t_end is None else float(t_end)
            TRACER.emit_span("epoch", "execute", t1 - float(seconds), t1,
                             self._epoch_span_args)

    def record_epoch_ranks(self, seconds_by_rank) -> None:
        """Per-rank epoch times into the ``(digest, rank)`` rank rings.
        Accepts a mapping ``{rank: seconds}`` or a dense sequence indexed
        by rank."""
        items = (seconds_by_rank.items()
                 if hasattr(seconds_by_rank, "items")
                 else enumerate(seconds_by_rank))
        for rank, s in items:
            EXEC_TELEMETRY.record_rank(self._digest, int(rank), float(s))

    def rank_summaries(self) -> dict[int, dict]:
        """Per-rank ring summaries for this plan, keyed by rank."""
        return EXEC_TELEMETRY.rank_summary(self._digest)

    @property
    def epoch_ring(self):
        """This plan's EXECUTE telemetry ring (``core._exec_stats``)."""
        return EXEC_TELEMETRY.ring(self._digest)

    def free(self) -> None:
        self._tables = self._stage2 = self._ref_stage2 = None
        self._embedded, self._grouped_hier = {}, {}
        self._pattern_epoch = None
        self._pack = self._packs = self._unpack = None
        self.run_tables = {}
        self.window.release()

    # -- reporting ----------------------------------------------------------
    def metadata_summary(self) -> dict:
        return {
            "collective": self.spec.collective,
            "variant": self.spec.variant,
            "p": self.p,
            "capacity_rows": self.capacity,
            "send_rows": self.send_rows,
            "recv_rows": self.recv_rows,
            "payload_bytes_per_rank": int(self.send_counts.sum(axis=1).max()) * self.row_bytes,
            "padded_bytes_per_rank": self.p * self.capacity * self.row_bytes,
            "total_recv_bytes": self.signature.total_recv_bytes,
            "init_host_seconds": self.init_host_seconds,
            "init_compile_seconds": self.init_compile_seconds,
            "init_run_table_seconds": self.init_run_table_seconds,
            "window_generation": self.window.generation,
            "baked_metadata": self.spec.baked_metadata,
            "pack_impl": self.spec.pack_impl,
            "codec": self.spec.codec,
            "warm_loaded": self.warm_loaded,
            "identity_maps": self.identity_maps,
            "lock_rounds_active": self.lock_rounds_active,
            "lock_rounds_total": self.lock_rounds_total,
            "hierarchy_remote_needed": self.hierarchy_remote_needed,
            # Inter-group messages per epoch (leader-combined hierarchy):
            # O((P/g)^2); the flat fence epoch posts P*(P-1).
            "cross_group_puts": self.cross_group_puts,
        }


def _write_through(win: torch.Tensor, out: torch.Tensor,
                   valid: torch.Tensor) -> None:
    """Store the valid rows of ``out [P, R, *F]`` into ``win`` in place;
    invalid rows keep the window's stale bytes (the JAX plan's
    ``where(valid, out, window)`` on its donated buffer)."""
    mask = valid.reshape(valid.shape + (1,) * (out.dim() - 2))
    win.copy_(torch.where(mask, out, win))


# What a process-mesh plan does not take yet, and where ROADMAP.md lists it.
PROCESS_MESH_ITEM = "ROADMAP.md queue 1 item 3 (multi-process transport)"


def check_process_spec(spec: ExchangeSpec) -> None:
    """Raise ``NotImplementedError`` for what a process-mesh plan does not
    take: the flat alltoallv fence and lock over one axis, identity rows."""
    what = None
    if spec.collective != "alltoallv":
        what = f"the {spec.collective} family"
    elif spec.variant not in ("fence", "lock"):
        what = f"variant {spec.variant!r}"
    elif len(spec.axis) != 1:
        what = f"an exchange over axes {spec.axis}"
    elif spec.codec != "identity":
        what = f"wire codec {spec.codec!r}"
    if what is not None:
        raise NotImplementedError(
            f"{what} over a process mesh (one process per rank) is not "
            f"ported yet: {PROCESS_MESH_ITEM}")


class ProcessExchangePlan(ExchangePlan):
    """The persistent plan with one process per rank
    (``launch.mesh.ProcessMesh``): the flat alltoallv, fence (``pack_impl``
    jnp, pallas or fused) or lock (ring or pairwise).

    INIT is collective.  ``PlanCache.get`` first all-gathers a digest of the
    count matrix and of the signature and raises on every rank if they
    differ; every rank then bakes the same global tables (as the JAX
    package's INIT does) and ``compile()`` uploads only this rank's rows,
    bakes their run tables on a card, and registers the window's slot 0
    (``core.window.SharedWindow``; ``init_register_seconds``).  START takes
    this rank's ``[send_rows, *F]`` shard and returns its ``[recv_rows,
    *F]`` receive buffer (JAX's addressable shard): the pack (K1 or the
    reference gather), the peer exchange into every rank's window (K2 or
    K4; K3 with the pack fused in) with its flags, then the unpack of this
    rank's window, written through into the receive buffer.  WAIT waits
    for this rank's stream and names a peer whose flag timed out.
    FREE is collective.  ``start_pipelined`` registers each further slot at
    its first use.  The hierarchy, ragged, codecs, the other families,
    ``variant="auto"`` and ``embed()`` raise ``NotImplementedError``."""

    def __init__(self, spec: ExchangeSpec, mesh,
                 window_cache: WindowCache | None = None, warm=None):
        check_process_spec(spec)
        self.rank = mesh.rank
        self.init_register_seconds = 0.0
        super().__init__(spec, mesh, window_cache, warm)

    def _acquire_window(self):
        return self._window_cache.get(self.recv_rows, self.spec.feature_shape,
                                      self.dtype, mesh=self.mesh)

    @property
    def global_send_shape(self) -> tuple[int, ...]:
        """This rank's send shard."""
        return (self.send_rows,) + self.spec.feature_shape

    @property
    def global_recv_shape(self) -> tuple[int, ...]:
        """This rank's receive buffer."""
        return (self.recv_rows,) + self.spec.feature_shape

    @property
    def exposed_bytes(self) -> int:
        """Bytes of one rank's window: its P buckets of C rows."""
        return self.p * self.capacity * self.row_bytes

    def kernels(self) -> tuple:
        """The hand-written kernels this rank's epoch launches on a card:
        the peer K2 or K4 (each its whole epoch, flags included), or the
        peer K3 between two signal kernels; K1 for the kernel packs."""
        spec, rb = self.spec, self.row_bytes
        k1 = gather_rows.cuda_kernel(rb, runs=spec.baked_metadata)
        xk = (a2a_fence.FENCE_PEER if spec.variant == "fence"
              else a2a_lock.PEER)
        if spec.pack_impl == "fused":
            return (a2a_fence.FUSED_PEER if a2a_fence.fused_kernel_choice(
                "cuda", rb, 0) == "bulk" else a2a_fence.FUSED_PEER_WARP, k1,
                    rma_signal.SIGNAL)
        if spec.pack_impl == "pallas":
            return (k1, xk)
        return (xk,)

    def _compile_impl(self) -> None:
        spec, dev, me = self.spec, self.mesh.device, self.rank
        rows = tuple(np.ascontiguousarray(np.asarray(t)[me:me + 1])
                     for t in self._table_host)
        self._tables = tuple(
            torch.tensor(t, device=dev) if spec.baked_metadata
            else torch.tensor(t, dtype=torch.int32, device=dev) for t in rows)
        runs = {}
        if bakes_run_tables(dev, self.row_bytes):
            t1 = time.perf_counter()
            t = self._tables
            runs = {name: gather_rows.bake_runs(
                        t[i], t[i + 1], self.row_bytes, split,
                        host=(rows[i], rows[i + 1]))
                    for name, (i, split) in self._run_sources().items()}
            self.init_run_table_seconds = time.perf_counter() - t1
        self.run_tables = runs
        self._unpack = (partial(kops.unpack, runs=runs.get("unpack"))
                        if spec.pack_impl != "jnp" else variants.unpack_rows)
        self._pack = (partial(kops.pack, runs=runs.get("pack"))
                      if spec.pack_impl == "pallas" else variants.pack_rows)
        if dev.type == "cuda":
            for k in self.kernels():
                k._load()
        t1 = time.perf_counter()
        self.window.slot(0, self.exposed_bytes)
        self.init_register_seconds = time.perf_counter() - t1

    def _send_view(self, sendbuf: torch.Tensor, shapes=None) -> torch.Tensor:
        shard = self.global_send_shape
        if (tuple(sendbuf.shape) not in (shard, (1,) + shard)
                or sendbuf.dtype != self.dtype
                or sendbuf.device != self.mesh.device):
            raise ValueError(
                f"rank {self.rank}'s send buffer must be {shard} {self.dtype} "
                f"on {self.mesh.device}, got {tuple(sendbuf.shape)} "
                f"{sendbuf.dtype} on {sendbuf.device}")
        return sendbuf.reshape((1,) + shard)

    def _epoch(self, sendbuf: torch.Tensor, slot) -> None:
        x = self._send_view(sendbuf)
        p, cap, f = self.p, self.capacity, self.spec.feature_shape
        win = slot.win
        if self.spec.baked_metadata:
            src, valid, rsrc, rvalid = self._tables
        else:
            sc, sd, rc, rd = self._tables
            src, valid = variants.pack_index_map_in_graph(sc, sd, p, cap)
            rsrc, rvalid = variants.unpack_index_map_in_graph(
                rc, rd, p, cap, self.recv_rows)
        if self.spec.pack_impl == "fused":
            kops.fused_pack_alltoallv_peer(x[0], src[0], valid[0], win,
                                           capacity=cap)
        else:
            packed = self._pack(x, src, valid)[0]
            if self.spec.variant == "fence":
                variants.fence_exchange(packed, p, cap, window=win)
            else:
                variants.lock_exchange(packed, p, cap, self.round_capacities,
                                       self.spec.lock_schedule, window=win)
        buckets = win.view(p * cap, f, self.dtype).unsqueeze(0)
        self._unpack(buckets, rsrc, rvalid, out=slot.recv.unsqueeze(0))

    def _start(self, sendbuf: torch.Tensor, slot: int) -> torch.Tensor:
        self.compile()
        dev = self.mesh.device
        ws = self.window.slot(slot, self.exposed_bytes)
        t0 = time.perf_counter()
        try:
            self._epoch(sendbuf, ws)
        except RuntimeError as exc:
            self._raise_flag_timeout(exc)
        if self.record_starts:
            t1 = time.perf_counter()
            EXEC_TELEMETRY.record(self._digest, t1 - t0)
            if TRACER.enabled:
                TRACER.emit_span("epoch", "execute", t0, t1,
                                 self._epoch_span_args)
        self._stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                        else None)
        self.starts += 1
        return ws.recv

    def _flag_error(self) -> RuntimeError | None:
        """The flag wait that timed out on the card, with its rank, epoch
        and flag, if a kernel of this plan's windows recorded one."""
        for slot in list(self.window._slots.values()):
            err = slot.win.flag_error()
            if err is not None:
                return err
        return None

    def _raise_flag_timeout(self, exc: RuntimeError) -> None:
        """Raise the recorded flag timeout in place of the CUDA error
        ``exc`` it caused, else ``exc``.  A trap's error comes with the next
        CUDA call: WAIT's, or a launch of this epoch (a kernel's first
        launch loads its module, which waits for the running kernels)."""
        err = self._flag_error()
        if err is None:
            raise exc
        raise err from exc

    def wait(self, recvbuf: torch.Tensor) -> torch.Tensor:
        """Close the epoch on this rank: wait for its stream.  A wait on a
        peer's flag that timed out on the card is raised with its rank,
        epoch and flag.  The stream is polled beside the windows' error
        records, since a trapped grid need not end: on an H100 one rank's
        peer K4 ran on after its timed-out wait had trapped."""
        if self._stream is None:
            return recvbuf
        spins = 0
        while True:
            try:
                if self._stream.query():
                    return recvbuf
            except RuntimeError as exc:
                self._raise_flag_timeout(exc)
            err = self._flag_error()
            if err is not None:
                raise err
            spins += 1
            time.sleep(0 if spins < 100 else 1e-4)

    def embed(self, groups: int = 1) -> Callable:
        raise NotImplementedError(
            f"embed() over a process mesh is not ported yet: "
            f"{PROCESS_MESH_ITEM}")

    def metadata_summary(self) -> dict:
        out = super().metadata_summary()
        out.update(rank=self.rank, init_register_seconds=self.init_register_seconds,
                   exposed_bytes_per_rank=self.exposed_bytes)
        return out


class PlanCache:
    """Cache of plans (persistent requests) with statistics, keyed by the
    pattern signature and the mesh's device: a plan holds its tables and
    window on one device, so meshes of one shape on two devices (the card
    and the CPU) must not share it."""

    def __init__(self, window_cache: WindowCache | None = None):
        self._plans: dict[tuple, ExchangePlan] = {}
        # variant="auto" decisions (core.autotune), keyed like the plans by
        # the decision signature and the mesh's device, so a winner measured
        # on the CPU's plain versions is never replayed on the card:
        # {"variant", "codec", "times", "breakeven"[, "codec_fits"]}.
        self.auto_choices: dict[tuple, dict] = {}
        self.window_cache = window_cache if window_cache is not None else WindowCache()
        self.hits = 0
        self.misses = 0

    def get(self, spec: ExchangeSpec, mesh, store=None) -> ExchangePlan:
        """Fetch-or-build.  ``store`` (a ``repro_torch.planstore.PlanStore``,
        duck-typed) is the disk tier behind this in-memory one: a miss here
        consults it, for the mesh's device, for a warm artifact before
        baking, and a cold build publishes its artifacts back for the next
        process (best-effort: a full or read-only disk changes nothing)."""
        sig = signature(spec, mesh)
        process = getattr(mesh, "is_process_mesh", False)
        if process:
            # A collective INIT: every rank must pass the same exchange.
            mesh.agree({"counts": md.counts_digest(spec.send_counts),
                        "signature": sig.digest},
                       "the exchange (count matrix and signature digests)")
        key = (sig, mesh.device)
        plan = self._plans.get(key)
        if plan is not None:
            self.hits += 1
            return plan
        self.misses += 1
        warm = store.get(sig, mesh.device) if store is not None else None
        cls = ProcessExchangePlan if process else ExchangePlan
        try:
            plan = cls(spec, mesh, window_cache=self.window_cache, warm=warm)
        except WarmStartError:
            # Stale-but-colliding artifact: cold INIT, never wrong tables.
            INIT_STATS.bump("store_invalid")
            plan = cls(spec, mesh, window_cache=self.window_cache)
        if store is not None and not plan.warm_loaded:
            try:
                store.put_plan(sig, plan, mesh.device)
            except OSError:
                pass                      # full/read-only disk: store stays best-effort
        self._plans[key] = plan
        return plan

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses, "live": len(self._plans),
                "auto_choices": len(self.auto_choices),
                "window": self.window_cache.stats}


# The founding collective's names, as in the JAX package.
AlltoallvSpec = ExchangeSpec
AlltoallvPlan = ExchangePlan
