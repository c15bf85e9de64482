"""Mixture-of-Experts layer with persistent-alltoallv expert dispatch (port
of ``repro.models.moe``).

Expert-parallel dispatch and combine are an alltoallv over the expert axis.
The dispatch path is selectable, as in the JAX package:

  persistent_a2a     the paper's technique: at layer build (INIT) a real
                     ``core.AlltoallvPlan`` is built for the frozen
                     capacity-bucketed pattern, and its embedded form
                     (``plan.embed()``) runs every exchange.  The pattern is
                     uniform, so the embedded epoch is the identity fast
                     path: one fence (K2) or lock (K4) exchange per hop.
  nonpersistent_a2a  the same data path, re-deriving the per-peer counts and
                     displacements on the device every call.
  gspmd              all tokens routed at once into one ``[E, C*EP, D]``
                     bucket tensor and the experts applied to it: the
                     exchange-free reference.

The JAX package runs the a2a paths per shard under ``shard_map``.  Here
every device of the mesh is a virtual rank on one device
(``launch.mesh.VirtualMesh``), and ``_a2a_shard_body`` is one body batched
over all of them, ``[n_dp, ep]``: ``n_dp`` data shards (the ways the
``batch`` rule splits the tokens, ``batch_ways``) times the ``ep`` ranks of
the EP axis, or of the linearized ``(outer, inner)`` pair under
hierarchical EP (``HIER_EP_RULES``: ``("pod", "model")``, pod-major).  Data
shard ``r`` owns rows ``[r*T/n_dp, (r+1)*T/n_dp)`` of the tokens, padded
per shard to ``[ep, t_loc, D]``; each rank's chunk is routed, scattered
into its ``[E*cap, D]`` buckets and exchanged as ``[n_dp*ep, ep*e_loc*ck,
D]``: ``n_dp`` independent EP groups, one K2 launch for all of them
(``embed(groups=n_dp)``).  The expert FFN's gate and up products are each
ONE launch of K6 (``ops.fused_unpack_matmul``) over all ``E = ep*e_loc``
experts and every data shard's rows, reading straight from the receive
buffers through the regroup table; the down product is ``torch.bmm``, as
the JAX package leaves its einsum to XLA.  The aux losses are the mean
over every rank (JAX's ``pmean`` over the mesh axes).

Routing ranks each entry within its expert among the VALID entries only.
The JAX package ranks padding entries too (``repro/models/moe.py:295-304``),
which pushes valid entries of higher experts past their capacity; without
padding the two agree exactly (ROADMAP.md queue 3).

``overlap_chunks > 1`` splits the capacity axis into chunks and enqueues
chunk c+1's dispatch before chunk c's FFN, as the JAX package does.  On a
card the dispatches run on a second CUDA stream, ordered by events, so
chunk c+1's exchange overlaps chunk c's K6, ``bmm`` and combine on the
current stream (autograd runs each backward op on its forward's stream);
on the CPU the same order runs on one stream.  Any depth gives depth 1's
output, aux losses and router and input gradients bit for bit (the chunks
partition the capacity axis); an expert weight's gradient is then a sum
of per-chunk products, equal to depth 1's within the rounding of that
order.

A ``wire_codec`` runs FUSED, as in the JAX package: token rows are encoded
once, before the capacity scatter, with the per-row scales inlined as extra
wire lanes, so the scatter, both exchanges (K2 on wire rows) and the FFN's
gathers move wire rows; the expert side splits the lanes off and K6 reads
the rows pre-scaled; the combine folds the dequant scale into the combine
weight.  The backing plan is a byte mover at wire width.
Autograd: the body is differentiable, as the JAX package's is under
``jax.grad``.  Both exchanges go through the self-adjoint embedded epoch,
whose backward is the same exchange on the cotangent (K2 or K4 again on a
card); K6's backward is the plain transpose.  Identity rows move as
values.  Wire rows move as raw bits with JAX's transposes as their
backward (``_WireScatter``, ``_WireGather``): a cast's transpose is the
reverse cast, so bf16 and fp8 cotangents move as wire rows; int8's
``round`` and the scale lanes' bitcast carry no gradient, so under int8
no expert weight gets one.  JAX's fp8 expert gradients are NaN (its
encode's clamp, ROADMAP.md queue 3); the port's clamp transposes as a
select and its gradient is finite.
``a2a_variant="fence_hierarchy"`` over an EP axis
pair runs the backing plan's leader-combined hierarchy epoch on its tables
(``pack_impl`` "jnp": K2 for hops 1 and 3; "pallas": K1 packs too;
"fused": K1, K2 and K5); on the uniform MoE pattern it moves the rows as
the flat all-to-all does, so its backward is the same epoch on the
cotangent.
``a2a_variant="auto"`` resolves through ``alltoallv_init(...,
variant="auto", embeddable=True)`` at INIT: the measured winner (fence or
lock) becomes the layer's variant.  ``store=`` (``repro_torch.planstore``)
goes through to that INIT, so the backing plan and its auto decision
warm-start from an earlier process.  Shared experts (``n_shared_experts``,
DeepSeek-style) are one dense SwiGLU of ``n_shared_experts * d_expert``
hidden units on every token, in the working dtype, added to the routed
output, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import MoEConfig
from ..core import variants as core_variants
from ..kernels import ops as kops
from ..parallel import wirecodec
from ..parallel.sharding import (ScopedFactory, batch_ways, current_mesh,
                                 normal_init, rule_axes)

# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_moe(f: ScopedFactory, d_model: int, moe: MoEConfig) -> None:
    std = d_model ** -0.5
    f.param("router", (d_model, moe.n_experts), ("embed", None), normal_init(std))
    f.param("w_gate", (moe.n_experts, d_model, moe.d_expert),
            ("experts", "embed", "expert_ff"), normal_init(std))
    f.param("w_up", (moe.n_experts, d_model, moe.d_expert),
            ("experts", "embed", "expert_ff"), normal_init(std))
    f.param("w_down", (moe.n_experts, moe.d_expert, d_model),
            ("experts", "expert_ff", "embed"), normal_init(moe.d_expert ** -0.5))
    if moe.n_shared_experts:
        d_sh = moe.d_expert * moe.n_shared_experts
        f.param("sh_gate", (d_model, d_sh), ("embed", "ff"), normal_init(std))
        f.param("sh_up", (d_model, d_sh), ("embed", "ff"), normal_init(std))
        f.param("sh_down", (d_sh, d_model), ("ff", "embed"),
                normal_init(d_sh ** -0.5))


# ---------------------------------------------------------------------------
# Kept-entry count (instrumentation)
# ---------------------------------------------------------------------------

_KEPT: list | None = None
_PER_EXPERT = False


@contextlib.contextmanager
def count_kept(per_expert: bool = False):
    """Collect the number of routing entries each MoE call keeps (after
    capacity), one int per call, in call order; with ``per_expert``, a
    numpy ``[E]`` array of each expert's kept entries per call (an expert
    that keeps none gets no gradient).  Each count synchronises with the
    device, so this is for checks, not for timed runs."""
    global _KEPT, _PER_EXPERT
    old, _KEPT = (_KEPT, _PER_EXPERT), []
    _PER_EXPERT = per_expert
    try:
        yield _KEPT
    finally:
        _KEPT, _PER_EXPERT = old


def _record_kept(keep: torch.Tensor, slot: torch.Tensor, capacity: int,
                 n_experts: int) -> None:
    if _KEPT is None:
        return
    if _PER_EXPERT:
        expert = torch.div(slot[keep], capacity, rounding_mode="floor")
        _KEPT.append(torch.bincount(expert, minlength=n_experts).cpu().numpy())
    else:
        _KEPT.append(int(keep.sum().item()))


# ---------------------------------------------------------------------------
# Persistent dispatch plan (the MPIX_Request analogue for the MoE layer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEDispatchPlan:
    """Frozen INIT-time metadata for one MoE layer's alltoallv.

    With ``a2a`` set (the plan-backed form) the exchange runs through the
    embedded epoch of a real ``core.AlltoallvPlan``; ``a2a is None`` keeps
    the table-free uniform exchange.
    """

    n_experts: int
    top_k: int
    ep_size: int            # ranks along the expert axis (or axis pair)
    e_local: int            # experts per rank
    tokens_per_shard: int   # padded token chunk per EP rank (T_loc)
    capacity: int           # per-(chunk, expert) slot capacity C
    variant: str            # fence | lock | fence_hierarchy
    # EP mesh axis: a name, a linearized (outer, inner) pair (hierarchical
    # EP), or None (no EP axis in the mesh).
    axis: str | tuple[str, str] | None
    hier_axes: tuple[str, str] | None = None
    overlap_chunks: int = 1
    # Wire codec of the dispatch/combine exchanges (parallel.wirecodec), run
    # fused: the MoE body encodes and decodes, the backing plan moves bytes.
    wire_codec: str = "identity"
    a2a: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def peer_rows(self) -> int:
        return self.e_local * self.capacity

    @property
    def chunk_capacity(self) -> int:
        return self.capacity // self.overlap_chunks

    @property
    def chunk_peer_rows(self) -> int:
        return self.e_local * self.chunk_capacity

    @property
    def plan_backed(self) -> bool:
        return self.a2a is not None

    @property
    def codec(self) -> str:
        return self.wire_codec

    @staticmethod
    def build(moe: MoEConfig, n_tokens: int, mesh, tile: int = 8,
              hier_axes: tuple[str, str] | None = None, *,
              d_model: int | None = None, dtype=None,
              plan_backed: bool = True, store=None, cache=None,
              pack_impl: str = "jnp", autotune_iters: int = 8,
              overlap_chunks: int | None = None,
              hier_leader_perm=None) -> "MoEDispatchPlan":
        """Build the INIT-time dispatch plan for one layer geometry, with
        the JAX package's arithmetic: ``t_loc`` and the capacity are
        rounded up to ``tile`` rows, and the pipeline depth is the largest
        ``k <= overlap_chunks`` that splits the capacity into tile-aligned
        per-peer buckets.  ``n_tokens`` are the tokens of one data shard.
        The EP axis is whatever the active ``experts`` rule maps to: two
        axes of size > 1 there (``HIER_EP_RULES``) make it the linearized
        ``(outer, inner)`` pair, and ``hier_axes=(outer, inner)`` sets the
        pair outright; ``a2a_variant="fence_hierarchy"`` folds to
        ``fence`` only where there is no pair.  Mesh axes outside the EP
        axes may be larger than 1: they are data replicas of the plan.
        Passing ``d_model`` makes the dispatch plan-backed: an
        ``AlltoallvPlan`` for the uniform chunk pattern over the EP axis
        (or pair), through the plan cache (``cache``, default the
        process-wide one), built with ``pack_impl`` and, over a pair,
        ``hier_leader_perm``.  Its pattern is uniform, so the flat
        embedded epoch skips both gathers; the hierarchy's keeps its
        tables, where ``pack_impl`` picks the gathers.  Under a lossy
        ``moe.wire_codec`` (which needs ``moe.codec_tol``) the backing plan
        moves wire rows: ``d_model`` plus the inlined scale lanes, of the
        codec's wire dtype.  ``a2a_variant="auto"`` measures the embeddable
        candidates of that pattern (``autotune_iters`` calls per arm) and
        takes the winner's variant; it needs the plan-backed dispatch
        (``d_model``) wherever there is an EP exchange to tune.  ``store``
        is the backing plan's plan store (``alltoallv_init``'s: None for
        the process default, False for none)."""
        if hier_axes is not None and mesh is not None \
                and all(a in mesh.axis_names for a in hier_axes):
            hier_axes = tuple(hier_axes)
            axis: str | tuple[str, str] | None = hier_axes
        else:
            ep_axes = rule_axes("experts", mesh)
            hier_axes = tuple(ep_axes[:2]) if len(ep_axes) >= 2 else None
            axis = hier_axes or (ep_axes[0] if ep_axes else None)
        ep = math.prod(mesh.axis_sizes(axis)) if axis else 1
        if moe.n_experts % ep:
            raise ValueError(f"{moe.n_experts} experts not divisible by EP={ep}")
        t_loc = max(-(-n_tokens // ep), tile)
        t_loc = -(-t_loc // tile) * tile
        cap = max(int(math.ceil(t_loc * moe.top_k * moe.capacity_factor
                                / moe.n_experts)), tile)
        cap = -(-cap // tile) * tile

        k_req = max(int(overlap_chunks if overlap_chunks is not None
                        else moe.overlap_chunks), 1)
        e_loc = moe.n_experts // ep
        k = max(kk for kk in range(1, min(k_req, cap) + 1)
                if cap % kk == 0 and (e_loc * (cap // kk)) % tile == 0)

        variant = moe.a2a_variant
        if variant == "fence_hierarchy" and hier_axes is None:
            variant = "fence"          # no (outer, inner) pair to group over
        if hier_axes is None:
            hier_leader_perm = None    # leadership needs the grouped exchange
        if variant not in ("fence", "lock", "fence_hierarchy", "auto"):
            raise ValueError(f"unknown a2a_variant {moe.a2a_variant!r}")
        # Lossy codecs are opt-in via an explicit tolerance, for every
        # dispatch impl (the fused path hands the plan pre-encoded rows).
        codec = wirecodec.require(moe.wire_codec, moe.codec_tol)
        a2a = None
        if (plan_backed and d_model is not None and axis is not None
                and ep > 1 and moe.dispatch == "persistent_a2a"):
            from ..core import api as core_api
            chunk_rows = e_loc * (cap // k)
            counts = np.full((ep, ep), chunk_rows, np.int64)
            wire_dt = (codec.wire_dtype if codec.wire_dtype is not None
                       else dtype if dtype is not None else torch.float32)
            a2a = core_api.alltoallv_init(
                counts, (int(d_model) + codec.scale_lanes,), wire_dt,
                mesh, axis=axis, variant=variant, tile_rows=tile,
                pack_impl=pack_impl, cache=cache, store=store,
                autotune_iters=autotune_iters, embeddable=True,
                hier_leader_perm=hier_leader_perm)
            variant = a2a.spec.variant   # "auto" resolved to the winner
        elif variant == "auto":
            if (moe.dispatch == "persistent_a2a" and axis is not None
                    and ep > 1):
                raise ValueError(
                    "a2a_variant='auto' needs the plan-backed dispatch "
                    "(build with d_model=... so the autotuner has a "
                    "pattern to measure)")
            # No EP exchange to tune (ep == 1 / gspmd / nonpersistent):
            # resolve to the dense-uniform default instead of failing.
            variant = "fence"
        return MoEDispatchPlan(
            n_experts=moe.n_experts, top_k=moe.top_k, ep_size=ep,
            e_local=e_loc, tokens_per_shard=t_loc, capacity=cap,
            variant=variant, axis=axis, hier_axes=hier_axes,
            overlap_chunks=k, wire_codec=moe.wire_codec, a2a=a2a)


# ---------------------------------------------------------------------------
# Routing (top-k with capacity) — shared by all dispatch impls
# ---------------------------------------------------------------------------


def _route(chunk, router_w, valid, k, n_experts, capacity):
    """Route ``chunk [..., T, D]`` (leading dims: independent ranks) with
    ``valid [..., T]``.  Returns (slot [..., T*k], keep [..., T*k], weight
    [..., T*k], counts [..., E] of valid entries, aux (lb [...], z [...])).

    Each valid entry's slot position is its rank among the valid entries
    of its expert, in token order; padding entries are ranked after every
    valid one and never kept.
    """
    t = chunk.shape[-2]
    logits = (chunk @ router_w).float()                        # [..., T, E]
    logits = torch.where(valid[..., None], logits, -1e9)
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower expert index, as lax.top_k breaks them
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :k], idx[..., :k]
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    w = w * valid[..., None]

    lead = chunk.shape[:-2]
    flat_e = idx.reshape(lead + (t * k,))
    flat_valid = valid.repeat_interleave(k, dim=-1)
    # Rank within expert: padding entries go to a virtual expert E, so they
    # sort after every valid entry and shift no valid position.
    key = torch.where(flat_valid, flat_e, n_experts)
    sort_ix = torch.sort(key, dim=-1, stable=True).indices
    counts_all = F.one_hot(key, n_experts + 1).sum(-2)         # [..., E+1]
    starts = counts_all.cumsum(-1) - counts_all
    pos_sorted = (torch.arange(t * k, device=chunk.device)
                  - starts.gather(-1, key.gather(-1, sort_ix)))
    pos = torch.empty_like(pos_sorted).scatter_(-1, sort_ix, pos_sorted)
    keep = (pos < capacity) & flat_valid
    slot = torch.where(keep, flat_e * capacity + pos, n_experts * capacity)
    counts = counts_all[..., :n_experts]

    # aux losses (Switch): E * sum_e f_e * p_e ; router z-loss
    validf = valid.float()
    nvalid = validf.sum(-1).clamp(min=1.0)
    top1 = F.one_hot(idx[..., 0], n_experts).float()
    f_e = (top1 * validf[..., None]).sum(-2) / nvalid[..., None]
    p_e = (probs * validf[..., None]).sum(-2) / nvalid[..., None]
    lb = n_experts * (f_e * p_e).sum(-1)
    lse = torch.where(valid, torch.logsumexp(logits, dim=-1), 0.0)
    z = lse.square().sum(-1) / nvalid
    return slot, keep, w.reshape(lead + (t * k,)), counts, (lb, z)


# Integer dtypes of each width: wire rows are scattered and gathered as raw
# bits, so no arithmetic touches an encoded byte or an inlined scale lane.
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _scatter_bits(rows, slot, k, n_rows):
    """Wire rows ``[..., T, W]`` into their bucket slots ``[..., n_rows, W]``
    as raw bits, each row ``k`` times (``slot [..., T*k]``).  Kept entries
    own distinct slots and dropped ones all land in the overflow rows,
    which are sliced off, so a store is exact where the add of
    ``_scatter_buckets`` would round -0.0 and NaN bytes."""
    lead, w = rows.shape[:-2], rows.shape[-1]
    bits = rows.view(_BITS[rows.element_size()])
    if k > 1:
        bits = bits.repeat_interleave(k, dim=-2)
    buckets = bits.new_zeros(lead + (n_rows + 8, w))
    buckets.scatter_(-2, slot[..., None].expand(bits.shape), bits)
    return buckets[..., :n_rows, :].view(rows.dtype)


def _gather_bits(buckets, slot):
    """``buckets [..., n_rows, W]`` read at ``slot [..., N]`` as raw bits;
    the overflow slots of dropped entries read zeros: ``[..., N, W]``."""
    lead, w = buckets.shape[:-2], buckets.shape[-1]
    bits = buckets.view(_BITS[buckets.element_size()])
    padded = torch.cat([bits, bits.new_zeros(lead + (8, w))], dim=-2)
    return padded.gather(-2, slot[..., None].expand(slot.shape + (w,))).view(
        buckets.dtype)


class _WireScatter(torch.autograd.Function):
    """``_scatter_bits`` with the JAX package's gradient: the transpose of
    its ``repeat`` and ``.at[slot].add``.  Each entry reads its slot's
    cotangent (a dropped entry the zero overflow), and a token sums its
    ``k`` entries in float32, rounded once to the wire dtype, as XLA's
    reduction of the wire dtype does."""

    @staticmethod
    def forward(ctx, rows, slot, k, n_rows):
        ctx.save_for_backward(slot)
        ctx.k = k
        return _scatter_bits(rows, slot, k, n_rows)

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        ent = _gather_bits(g.contiguous(), slot)
        if ctx.k > 1:
            lead, w = ent.shape[:-2], ent.shape[-1]
            ent = ent.float().view(lead + (-1, ctx.k, w)).sum(-2).to(g.dtype)
        return ent, None, None, None


class _WireGather(torch.autograd.Function):
    """``_gather_bits`` with the JAX package's gradient: the cotangent of
    each kept entry stored back into its slot (kept entries own distinct
    slots, so the scatter-add into zeros is a store)."""

    @staticmethod
    def forward(ctx, buckets, slot):
        ctx.save_for_backward(slot)
        ctx.n_rows = buckets.shape[-2]
        return _gather_bits(buckets, slot)

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        return _scatter_bits(g.contiguous(), slot, 1, ctx.n_rows), None


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the cotangent through ``dtype``:
    the transpose of a cast from ``dtype``, kept per consumer so that two
    consumers' rounded cotangents add as the JAX package's do."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def _scatter_wire(rows, slot, k, n_rows):
    """``_scatter_bits``, differentiable where ``rows`` are tracked."""
    if core_variants.tracked(rows):
        return _WireScatter.apply(rows, slot, k, n_rows)
    return _scatter_bits(rows, slot, k, n_rows)


def _gather_wire(buckets, slot):
    """``_gather_bits``, differentiable where ``buckets`` are tracked."""
    if core_variants.tracked(buckets):
        return _WireGather.apply(buckets, slot)
    return _gather_bits(buckets, slot)


def _scatter_buckets(chunk, slot, keep, k, n_rows, d):
    """Pack dispatch entries into bucket rows (overflow rows sliced off).
    ``chunk [..., T, D]``, ``slot``/``keep [..., T*k]`` -> ``[..., n_rows, D]``."""
    lead = chunk.shape[:-2]
    src = chunk.repeat_interleave(k, dim=-2)                   # [..., T*k, D]
    src = src * keep[..., None].to(chunk.dtype)
    buckets = chunk.new_zeros(lead + (n_rows + 8, d))
    buckets.scatter_add_(-2, slot[..., None].expand(src.shape), src)
    return buckets[..., :n_rows, :]


def _expert_ffn(h, w_gate, w_up, w_down):
    """h: [E, C*, D]; weights: [E, D, F], [E, F, D]."""
    g = torch.bmm(h, w_gate.to(h.dtype))
    u = torch.bmm(h, w_up.to(h.dtype))
    return torch.bmm(F.silu(g) * u, w_down.to(h.dtype))


# ---------------------------------------------------------------------------
# Dispatch implementations
# ---------------------------------------------------------------------------


def _shard_exchange_fn(plan: MoEDispatchPlan, groups: int = 1):
    """The per-chunk exchange ``[groups*EP, EP*chunk_peer_rows, D]`` -> same
    layout, over ``groups`` independent EP groups (the data shards): the
    backing plan's embedded epoch, or the table-free uniform exchange.
    None when there is no EP axis (local FFN only)."""
    if plan.axis is None or plan.ep_size == 1:
        return None
    if plan.a2a is not None:
        return plan.a2a.embed(groups)
    if isinstance(plan.axis, tuple):
        sizes = current_mesh().axis_sizes(plan.axis)
    else:
        sizes = (plan.ep_size,)

    def bare(b):
        return core_variants.uniform_bucketed_exchange(
            b, plan.variant, plan.chunk_peer_rows, sizes, groups=groups)

    return lambda b: core_variants.self_adjoint_exchange(bare, b)


@functools.lru_cache(maxsize=64)
def _ffn_tables(ep: int, e_loc: int, ck: int, device: torch.device,
                n_dp: int = 1):
    """K6's row table ``[ep*e_loc, n_dp*ep*ck]`` int32 and its all-true
    mask, made once per chunk geometry and device.

    The JAX package's receive-side regroup table addresses local expert
    j's FFN rows, in [peer-major, slot-minor] order, in one rank's
    exchanged chunk buffer (``[ep, e_loc, ck, D]`` row-major).  Global
    expert ``m*e_loc + j`` reads rank m's buffer in every data shard:
    rank ``(r, m)``'s rows are offset by ``(r*ep + m)*ep*e_loc*ck`` and
    data shard r's take columns ``[r*ep*ck, (r+1)*ep*ck)``, so one K6
    launch covers every expert of every rank of every data shard.
    """
    regroup_idx = ((np.arange(ep)[:, None] * (e_loc * ck)
                    + np.arange(ck)[None, :])[None]
                   + (np.arange(e_loc) * ck)[:, None, None]
                   ).reshape(e_loc, ep * ck)
    rank_base = ((np.arange(n_dp)[None, :] * ep + np.arange(ep)[:, None])
                 * (ep * e_loc * ck))                           # [m, r]
    idx = (rank_base[:, None, :, None] + regroup_idx[None, :, None, :]
           ).reshape(ep * e_loc, n_dp * ep * ck)
    idx = torch.from_numpy(idx.astype(np.int32)).to(device)
    return idx, torch.ones(idx.shape, dtype=torch.bool, device=device)


_SIDE_STREAMS: dict = {}


def _side_stream(dev: torch.device):
    """The stream the pipelined dispatches of ``overlap_chunks > 1`` run
    on, one per device."""
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _SIDE_STREAMS[dev]


def _pipelined(dispatch, dev: torch.device, src: torch.Tensor):
    """``(enqueue, take)`` for the chunk pipeline.  On a card ``enqueue(c)``
    enqueues ``dispatch(c)`` on the side stream once ``src`` (written on
    the current stream) is ready, and ``take`` makes the current stream
    wait for that dispatch alone, with the caching allocator told which
    stream uses which buffer; elsewhere both are plain calls."""
    if dev.type != "cuda":
        return dispatch, lambda t: t
    main, side = torch.cuda.current_stream(dev), _side_stream(dev)
    ready = torch.cuda.Event()
    ready.record(main)
    src.record_stream(side)

    def enqueue(c):
        side.wait_event(ready)
        with torch.cuda.stream(side):
            out = dispatch(c)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def take(item):
        out, done = item
        main.wait_event(done)
        out.record_stream(main)
        return out

    return enqueue, take


def _a2a_shard_body(tokens, router_w, w_gate, w_up, w_down,
                    *, plan: MoEDispatchPlan, persistent: bool,
                    n_dp: int = 1):
    """Route -> pack -> a2a -> ffn -> a2a -> combine, batched over every
    rank of the mesh, ``[n_dp, EP]``.  ``tokens [T, D]`` are all tokens;
    data shard r owns rows ``[r*T/n_dp, (r+1)*T/n_dp)`` and its EP rank m
    takes chunk m of the shard's padded ``[EP, t_loc, D]`` view (m
    linearized pod-major over a hierarchical pair).  Returns (y [T, D],
    aux [2] averaged over every rank)."""
    t_all, d = tokens.shape
    ep, e_loc, cap = plan.ep_size, plan.e_local, plan.capacity
    t_loc, k, n_exp = plan.tokens_per_shard, plan.top_k, plan.n_experts
    dev, ctype = tokens.device, tokens.dtype
    n_rank = n_dp * ep
    t_have = t_all // n_dp
    pad = ep * t_loc - t_have
    if t_all % n_dp or pad < 0:
        raise ValueError(f"{t_all} tokens over {n_dp} data shards do not fit "
                         f"the plan's {ep} x {t_loc} tokens per shard")

    chunks = F.pad(tokens.view(n_dp, t_have, d), (0, 0, 0, pad)
                   ).view(n_rank, t_loc, d)
    valid = (torch.arange(ep * t_loc, device=dev) < t_have).view(
        1, ep, t_loc).expand(n_dp, ep, t_loc).reshape(n_rank, t_loc)

    slot, keep, w, counts, (lb, z) = _route(chunks, router_w, valid, k,
                                            n_exp, cap)
    _record_kept(keep, slot, cap, n_exp)

    # Fused wire codec: token rows are encoded ONCE, before the capacity
    # scatter, so the scatter, both exchanges and the FFN gathers move wire
    # rows, with the per-row scales inlined as extra lanes (every hop keeps
    # row r's scale with row r).
    codec = wirecodec.get(plan.codec) if plan.codec != "identity" else None
    lanes = codec.scale_lanes if codec is not None else 0

    def to_wire(rows):
        """``[..., d]`` rows -> ``[..., d + lanes]`` wire rows."""
        if codec is None:
            return rows
        wire, sc = codec.encode(rows.reshape(-1, d))
        if lanes:
            wire = wirecodec.inline_rows(wire, sc, lanes)
        return wire.reshape(rows.shape[:-1] + (wire.shape[-1],))

    if codec is None:
        packed = _scatter_buckets(chunks, slot, keep, k, n_exp * cap, d)
    else:
        packed = _scatter_wire(to_wire(chunks), slot, k, n_exp * cap)
    dw = packed.shape[-1]

    if not persistent and plan.axis:
        # Non-persistent: re-derive the per-peer counts and displacements on
        # the device every call (the overhead persistence removes), folded
        # into the data path as a scale by one (a select by it under a
        # codec).
        per_peer = counts.view(n_dp, ep, ep, e_loc).sum(-1).int()
        rcounts = core_variants.exchange_counts_in_graph(per_peer)
        rdispls = core_variants.displacements_in_graph(rcounts)
        one = (rdispls[..., -1] >= 0).reshape(n_rank, 1, 1)
        if codec is None:
            packed = packed * one.to(packed.dtype)
        else:
            # A select: no arithmetic touches a wire byte.
            packed = torch.where(one, packed, torch.zeros(
                (), dtype=packed.dtype, device=dev))

    exchange = _shard_exchange_fn(plan, n_dp)
    n_chunks = plan.overlap_chunks if exchange is not None else 1
    ck = cap // n_chunks
    packed5 = packed.view(n_rank, ep, e_loc, cap, dw)

    ffn_idx, ffn_valid = _ffn_tables(ep, e_loc, ck, dev, n_dp)
    wg, wu, wd = w_gate.to(ctype), w_up.to(ctype), w_down.to(ctype)

    def dispatch_chunk(c):
        blk = packed5[:, :, :, c * ck:(c + 1) * ck].reshape(
            n_rank, ep * e_loc * ck, dw)
        return exchange(blk.contiguous()) if exchange is not None else blk

    def ffn_combine_chunk(xch):
        # Under a codec the receive buffer holds wire rows: the scale lanes
        # split off and K6 reads the rows pre-scaled.
        x2d, xsc = xch.reshape(n_rank * ep * e_loc * ck, dw), None
        if lanes:
            x2d, xsc = wirecodec.split_rows(x2d, lanes)
        xg = xu = x2d
        if (codec is not None and core_variants.tracked(x2d)
                and x2d.dtype != ctype):
            # One cast to the working dtype; each product's cotangent is
            # rounded to the wire dtype before the two add, as the JAX
            # package's two casts transpose.
            xw = x2d.to(ctype)
            xg, xu = (_RoundGrad.apply(xw, x2d.dtype) for _ in range(2))
        g = kops.fused_unpack_matmul(xg, ffn_idx, wg, ffn_valid,
                                     scales=xsc)        # [E, n_dp*ep*ck, F]
        u = kops.fused_unpack_matmul(xu, ffn_idx, wu, ffn_valid, scales=xsc)
        h = torch.bmm(F.silu(g) * u, wd)                # [E, n_dp*ep*ck, D]
        # [m, j, r, p, c] -> rank (r, m)'s send buffer, bucket p: [j, c]
        back = h.view(ep, e_loc, n_dp, ep, ck, d).permute(2, 0, 3, 1, 4, 5)
        back = to_wire(back.reshape(n_rank, ep * e_loc * ck, d))
        out = exchange(back) if exchange is not None else back
        return out.view(n_rank, ep, e_loc, ck, dw)

    # Software pipeline: chunk c+1's dispatch is enqueued before chunk c's
    # FFN (on a card, on the side stream).
    if n_chunks > 1:
        enqueue, take = _pipelined(dispatch_chunk, dev, packed)
    else:
        enqueue, take = dispatch_chunk, (lambda t: t)
    outs, pending = [], enqueue(0)
    for c in range(n_chunks):
        nxt = enqueue(c + 1) if c + 1 < n_chunks else None
        outs.append(ffn_combine_chunk(take(pending)))
        pending = nxt
    returned = (outs[0] if n_chunks == 1 else torch.cat(outs, dim=3)
                ).reshape(n_rank, ep * e_loc * cap, dw)

    # combine: gather each entry back out of the returned buckets; under a
    # codec the gather reads wire rows (as raw bits) and dequant follows it.
    if codec is None:
        padded = torch.cat([returned, returned.new_zeros((n_rank, 8, dw))],
                           dim=1)
        ent = padded.gather(1, slot[..., None].expand(-1, -1, dw))
    else:
        ent = _gather_wire(returned, slot)
    comb = keep.to(ctype) * w.to(ctype)
    if lanes:
        # Fold the per-row dequant scale into the combine weight: one
        # [T*k] product instead of a second full-width pass.
        eq, esc = wirecodec.split_rows(ent.reshape(-1, dw), lanes)
        ent = eq.to(ctype).reshape(n_rank, t_loc * k, d)
        comb = comb * esc.reshape(n_rank, t_loc * k).to(ctype)
    elif codec is not None:
        ent = codec.decode(ent, None, ctype)
    y = (ent * comb[..., None]).view(n_rank, t_loc, k, d).sum(2)
    # Each data shard keeps its first t_have rows (JAX's all_gather over
    # the EP axis, then [:t_have]).
    y = y.reshape(n_dp, ep * t_loc, d)[:, :t_have].reshape(t_all, d)
    aux = torch.stack([lb, z], dim=-1).mean(0)
    return y, aux


def _gspmd_dispatch(x2d, nvalid, params, moe: MoEConfig, plan: MoEDispatchPlan):
    """All tokens routed at once into ``[E, C*EP, D]`` buckets, experts
    applied to every bucket, entries gathered back."""
    t, d = x2d.shape
    e, cap_total = moe.n_experts, plan.capacity * plan.ep_size
    valid = torch.arange(t, device=x2d.device) < nvalid
    slot, keep, w, _, (lb, z) = _route(x2d, params["router"].to(x2d.dtype),
                                       valid, moe.top_k, e, cap_total)
    _record_kept(keep, slot, cap_total, e)
    buckets = _scatter_buckets(x2d, slot, keep, moe.top_k, e * cap_total, d)
    h = _expert_ffn(buckets.view(e, cap_total, d), params["w_gate"],
                    params["w_up"], params["w_down"])
    padded = torch.cat([h.reshape(e * cap_total, d), h.new_zeros((8, d))])
    out = padded[slot] * (keep.to(h.dtype) * w.to(h.dtype))[:, None]
    y = out.view(t, moe.top_k, d).sum(1)
    return y, torch.stack([lb, z])


# ---------------------------------------------------------------------------
# Public layer
# ---------------------------------------------------------------------------


def apply_moe(params: dict, x: torch.Tensor, moe: MoEConfig,
              plan: Optional[MoEDispatchPlan]) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (y [B, S, D], aux [lb_loss, z_loss])."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    mesh = current_mesh()

    if plan is None:
        dp = batch_ways(b * s, mesh)
        plan = MoEDispatchPlan.build(moe, max((b * s) // dp, 1), mesh,
                                     d_model=d, dtype=x2d.dtype)

    if moe.dispatch == "gspmd" or plan.axis is None or mesh is None:
        y, aux = _gspmd_dispatch(x2d, b * s, params, moe, plan)
    else:
        # Tokens shard like the batch: one data shard per way the active
        # rules split them (JAX's resolve(("batch", None), x2d.shape)).
        y, aux = _a2a_shard_body(
            x2d, params["router"].to(x2d.dtype), params["w_gate"],
            params["w_up"], params["w_down"], plan=plan,
            persistent=moe.dispatch == "persistent_a2a",
            n_dp=batch_ways(b * s, mesh))

    y = y.view(b, s, d)
    if moe.n_shared_experts:
        g = F.silu(x @ params["sh_gate"].to(x.dtype))
        u = x @ params["sh_up"].to(x.dtype)
        y = y + (g * u) @ params["sh_down"].to(x.dtype)
    return y, aux
