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

The JAX package runs the a2a paths per shard under ``shard_map``.  Here the
EP ranks are P virtual ranks on one device (``launch.mesh.VirtualMesh``),
and ``_a2a_shard_body`` is one body batched over them: the tokens are padded
to ``[P, t_loc, D]``, each rank's chunk is routed, scattered into its
``[E*cap, D]`` buckets and exchanged as ``[P, ep*e_loc*ck, D]``.  The
expert FFN's gate and up products are each ONE launch of K6
(``ops.fused_unpack_matmul``) over all ``E = P*e_loc`` experts, reading
straight from the receive buffers through the regroup table; the down
product is ``torch.bmm``, as the JAX package leaves its einsum to XLA.

Routing ranks each entry within its expert among the VALID entries only.
The JAX package ranks padding entries too (``repro/models/moe.py:295-304``),
which pushes valid entries of higher experts past their capacity; without
padding the two agree exactly (ROADMAP.md queue 3).

``overlap_chunks > 1`` splits the capacity axis and runs dispatch -> FFN ->
combine per chunk as a plain loop (bit-identical to depth 1); overlapping
the chunks on CUDA streams comes later.

A ``wire_codec`` runs FUSED, as in the JAX package: token rows are encoded
once, before the capacity scatter, with the per-row scales inlined as extra
wire lanes, so the scatter, both exchanges (K2 on wire rows) and the FFN's
gathers move wire rows; the expert side splits the lanes off and K6 reads
the rows pre-scaled; the combine folds the dequant scale into the combine
weight.  The backing plan is a byte mover at wire width.
Autograd: on the identity codec the body is differentiable, as the JAX
package's is under ``jax.grad``.  Rows move as values; both exchanges go
through the self-adjoint embedded epoch, whose backward is the same
exchange on the cotangent (K2 or K4 again on a card); K6's backward is the
plain transpose.  Under a codec the backward of the embedded epoch raises
(ROADMAP.md item 16a).
``a2a_variant="auto"`` resolves through ``alltoallv_init(...,
variant="auto", embeddable=True)`` at INIT: the measured winner (fence or
lock) becomes the layer's variant.  ``store=`` (``repro_torch.planstore``)
goes through to that INIT, so the backing plan and its auto decision
warm-start from an earlier process.  Not ported, each raising
``NotImplementedError`` naming its ROADMAP.md item: hierarchical EP (an
``(outer, inner)`` expert axis pair) and a data axis larger than 1.
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
from ..core.plan import not_ported
from ..kernels import ops as kops
from ..parallel import wirecodec
from ..parallel.sharding import (ScopedFactory, batch_ways, current_mesh,
                                 normal_init, rule_axes)

# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _check_shared(moe: MoEConfig) -> None:
    if moe.n_shared_experts:
        raise not_ported("shared experts in the MoE layer",
                         "item 6c, the other model families")


def init_moe(f: ScopedFactory, d_model: int, moe: MoEConfig) -> None:
    _check_shared(moe)
    std = d_model ** -0.5
    f.param("router", (d_model, moe.n_experts), ("embed", None), normal_init(std))
    f.param("w_gate", (moe.n_experts, d_model, moe.d_expert),
            ("experts", "embed", "expert_ff"), normal_init(std))
    f.param("w_up", (moe.n_experts, d_model, moe.d_expert),
            ("experts", "embed", "expert_ff"), normal_init(std))
    f.param("w_down", (moe.n_experts, moe.d_expert, d_model),
            ("experts", "expert_ff", "embed"), normal_init(moe.d_expert ** -0.5))


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
    ep_size: int            # ranks along the expert axis
    e_local: int            # experts per rank
    tokens_per_shard: int   # padded token chunk per EP rank (T_loc)
    capacity: int           # per-(chunk, expert) slot capacity C
    variant: str            # fence | lock
    axis: str | None        # EP mesh axis, or None (no EP axis in the mesh)
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
              autotune_iters: int = 8,
              overlap_chunks: int | None = None,
              hier_leader_perm=None) -> "MoEDispatchPlan":
        """Build the INIT-time dispatch plan for one layer geometry, with
        the JAX package's arithmetic: ``t_loc`` and the capacity are
        rounded up to ``tile`` rows, and the pipeline depth is the largest
        ``k <= overlap_chunks`` that splits the capacity into tile-aligned
        per-peer buckets.  The EP axis is whatever the active ``experts``
        rule maps to.  Passing ``d_model`` makes the dispatch plan-backed:
        an ``AlltoallvPlan`` for the uniform chunk pattern, through the
        plan cache (``cache``, default the process-wide one).  Its pattern
        is uniform, so the embedded epoch skips both gathers and the JAX
        build's ``pack_impl`` has nothing to choose.  Under a lossy
        ``moe.wire_codec`` (which needs ``moe.codec_tol``) the backing plan
        moves wire rows: ``d_model`` plus the inlined scale lanes, of the
        codec's wire dtype.  ``a2a_variant="auto"`` measures the embeddable
        candidates of that pattern (``autotune_iters`` calls per arm) and
        takes the winner's variant; it needs the plan-backed dispatch
        (``d_model``) wherever there is an EP exchange to tune.  ``store``
        is the backing plan's plan store (``alltoallv_init``'s: None for
        the process default, False for none)."""
        _check_shared(moe)
        ep_axes = rule_axes("experts", mesh)
        if hier_axes is not None or hier_leader_perm is not None or len(ep_axes) > 1:
            raise not_ported("hierarchical EP (fence_hierarchy over an "
                             "(outer, inner) expert axis pair)",
                             "item 6a, hierarchical EP in the MoE layer")
        if mesh is not None and any(int(mesh.shape[a]) > 1 for a in mesh.axis_names
                                    if a not in ep_axes):
            raise not_ported(f"an MoE layer on mesh {dict(mesh.shape)} (a data "
                             f"axis larger than 1)", "item 6b, data axis > 1")
        axis = ep_axes[0] if ep_axes else None
        ep = int(mesh.shape[axis]) if axis else 1
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
        if variant == "fence_hierarchy":
            variant = "fence"          # no (outer, inner) pair to group over
        if variant not in ("fence", "lock", "auto"):
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
                mesh, axis=axis, variant=variant, tile_rows=tile, cache=cache,
                store=store, autotune_iters=autotune_iters, embeddable=True)
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
            variant=variant, axis=axis, overlap_chunks=k,
            wire_codec=moe.wire_codec, a2a=a2a)


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


def _scatter_wire(rows, slot, k, n_rows):
    """Wire rows ``[..., T, W]`` into their bucket slots ``[..., n_rows, W]``
    as raw bits.  Kept entries own distinct slots and dropped ones all land
    in the overflow rows, which are sliced off, so a store is exact where
    the add of ``_scatter_buckets`` would round -0.0 and NaN bytes."""
    lead, w = rows.shape[:-2], rows.shape[-1]
    bits = rows.view(_BITS[rows.element_size()]).repeat_interleave(k, dim=-2)
    buckets = bits.new_zeros(lead + (n_rows + 8, w))
    buckets.scatter_(-2, slot[..., None].expand(bits.shape), bits)
    return buckets[..., :n_rows, :].view(rows.dtype)


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


def _shard_exchange_fn(plan: MoEDispatchPlan):
    """The per-chunk exchange ``[P, EP*chunk_peer_rows, D]`` -> same layout:
    the backing plan's embedded epoch, or the table-free uniform exchange.
    None when there is no EP axis (local FFN only)."""
    if plan.axis is None or plan.ep_size == 1:
        return None
    if plan.a2a is not None:
        return plan.a2a.embed()

    def bare(b):
        return core_variants.uniform_bucketed_exchange(
            b, plan.variant, plan.chunk_peer_rows, (plan.ep_size,))

    return lambda b: core_variants.self_adjoint_exchange(bare, b)


@functools.lru_cache(maxsize=64)
def _ffn_tables(ep: int, e_loc: int, ck: int, device: torch.device):
    """K6's row table ``[ep*e_loc, ep*ck]`` int32 and its all-true mask,
    made once per chunk geometry and device.

    The JAX package's receive-side regroup table addresses local expert
    j's FFN rows, in [peer-major, slot-minor] order, in one rank's
    exchanged chunk buffer (``[ep, e_loc, ck, D]`` row-major).  Global
    expert ``m*e_loc + j`` reads rank m's buffer, so its rows are offset by
    ``m*ep*e_loc*ck`` and one K6 launch covers every expert of every rank.
    """
    regroup_idx = ((np.arange(ep)[:, None] * (e_loc * ck)
                    + np.arange(ck)[None, :])[None]
                   + (np.arange(e_loc) * ck)[:, None, None]
                   ).reshape(e_loc, ep * ck)
    rank_base = np.arange(ep)[:, None, None] * (ep * e_loc * ck)
    idx = (rank_base + regroup_idx[None]).reshape(ep * e_loc, ep * ck)
    idx = torch.from_numpy(idx.astype(np.int32)).to(device)
    return idx, torch.ones(idx.shape, dtype=torch.bool, device=device)


def _a2a_shard_body(tokens, router_w, w_gate, w_up, w_down,
                    *, plan: MoEDispatchPlan, persistent: bool):
    """Route -> pack -> a2a -> ffn -> a2a -> combine, batched over the EP
    ranks.  ``tokens [T, D]`` are all tokens; rank m takes chunk m of the
    padded ``[EP, t_loc, D]`` view.  Returns (y [T, D], aux [2] averaged
    over the ranks)."""
    t_have, d = tokens.shape
    ep, e_loc, cap = plan.ep_size, plan.e_local, plan.capacity
    t_loc, k, n_exp = plan.tokens_per_shard, plan.top_k, plan.n_experts
    dev, ctype = tokens.device, tokens.dtype

    pad = ep * t_loc - t_have
    chunks = F.pad(tokens, (0, 0, 0, pad)).view(ep, t_loc, d)
    valid = (torch.arange(ep * t_loc, device=dev) < t_have).view(ep, t_loc)

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
    bits = _BITS[packed.element_size()]

    if not persistent and plan.axis:
        # Non-persistent: re-derive the per-peer counts and displacements on
        # the device every call (the overhead persistence removes), folded
        # into the data path as a scale by one (of the raw bits under a
        # codec).
        per_peer = counts.view(ep, ep, e_loc).sum(-1).int()
        rcounts = core_variants.exchange_counts_in_graph(per_peer)
        rdispls = core_variants.displacements_in_graph(rcounts)
        one = (rdispls[:, -1] >= 0)[:, None, None]
        if codec is None:
            packed = packed * one.to(packed.dtype)
        else:
            packed = (packed.view(bits) * one.to(bits)).view(packed.dtype)

    exchange = _shard_exchange_fn(plan)
    n_chunks = plan.overlap_chunks if exchange is not None else 1
    ck = cap // n_chunks
    packed5 = packed.view(ep, ep, e_loc, cap, dw)

    ffn_idx, ffn_valid = _ffn_tables(ep, e_loc, ck, dev)
    wg, wu, wd = w_gate.to(ctype), w_up.to(ctype), w_down.to(ctype)

    def dispatch_chunk(c):
        blk = packed5[:, :, :, c * ck:(c + 1) * ck].reshape(ep, ep * e_loc * ck, dw)
        return exchange(blk.contiguous()) if exchange is not None else blk

    def ffn_combine_chunk(xch):
        # Under a codec the receive buffer holds wire rows: the scale lanes
        # split off and K6 reads the rows pre-scaled.
        x2d, xsc = xch.reshape(ep * ep * e_loc * ck, dw), None
        if lanes:
            x2d, xsc = wirecodec.split_rows(x2d, lanes)
        g = kops.fused_unpack_matmul(x2d, ffn_idx, wg, ffn_valid,
                                     scales=xsc)               # [E, ep*ck, F]
        u = kops.fused_unpack_matmul(x2d, ffn_idx, wu, ffn_valid, scales=xsc)
        h = torch.bmm(F.silu(g) * u, wd)                       # [E, ep*ck, D]
        back = h.view(ep, e_loc, ep, ck, d).transpose(1, 2)
        back = to_wire(back.reshape(ep, ep * e_loc * ck, d))
        out = exchange(back) if exchange is not None else back
        return out.view(ep, ep, e_loc, ck, dw)

    # Identity rows move as values, so autograd follows them; wire rows
    # move as raw bits (no arithmetic may touch an encoded byte).
    def as_moved(t):
        return t if codec is None else t.view(bits)

    def from_moved(t):
        return t if codec is None else t.view(packed.dtype)

    outs = [ffn_combine_chunk(dispatch_chunk(c)) for c in range(n_chunks)]
    returned = (outs[0] if n_chunks == 1
                else from_moved(torch.cat([as_moved(o) for o in outs], dim=3))
                ).reshape(ep, ep * e_loc * cap, dw)

    # combine: gather each entry back out of the returned buckets; under a
    # codec the gather reads wire rows (as raw bits) and dequant follows it.
    moved = as_moved(returned)
    padded = torch.cat([moved, moved.new_zeros((ep, 8, dw))], dim=1)
    ent = from_moved(padded.gather(1, slot[..., None].expand(-1, -1, dw)))
    comb = keep.to(ctype) * w.to(ctype)
    if lanes:
        # Fold the per-row dequant scale into the combine weight: one
        # [T*k] product instead of a second full-width pass.
        eq, esc = wirecodec.split_rows(ent.reshape(-1, dw), lanes)
        ent = eq.to(ctype).reshape(ep, t_loc * k, d)
        comb = comb * esc.reshape(ep, t_loc * k).to(ctype)
    elif codec is not None:
        ent = codec.decode(ent, None, ctype)
    y = (ent * comb[..., None]).view(ep, t_loc, k, d).sum(2)
    y = y.reshape(ep * t_loc, d)[:t_have]
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
        y, aux = _a2a_shard_body(
            x2d, params["router"].to(x2d.dtype), params["w_gate"],
            params["w_up"], params["w_down"], plan=plan,
            persistent=moe.dispatch == "persistent_a2a")

    return y.view(b, s, d), aux
