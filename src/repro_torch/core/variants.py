"""Exchange bodies of the persistent alltoallv engine (port of
``repro.core.variants``: fence, lock and the local pack/unpack).

The JAX package runs these per shard inside ``shard_map``.  The port runs
P virtual ranks on one device, so every function takes the global view
with a leading rank dimension: send buffers ``[P, S, *F]``, bucketed
layouts ``[P, P*C, *F]``, index tables ``[P, N]``.

  fence  one epoch in which every bucket moves at once: the hand-written
         fence kernel (K2), the analogue of the ``MPI_Win_fence`` pair
         bracketing all puts.
  lock   (P-1) serialised pairwise rounds (ring or XOR pairwise schedule),
         each shrunk to its round capacity and elided when empty: the lock
         kernel (K4), one clustered launch per epoch whose clusters meet at
         a barrier after each round (16-byte rows on aligned bases; other
         rows take one launch per active round).
  fence_hierarchy
         the leader-combined three-hop exchange over an (outer, inner) rank
         grid, rank ``g = o * P_inner + q``: the inner all-to-alls of hops 1
         and 3 are one grouped fence launch (K2 with ``groups=P_outer``),
         hop 2 is ``stage2_leader_ppermute`` or the stage-2 kernel (K5).

``pack_rows`` / ``unpack_rows`` are the ``pack_impl="jnp"`` gathers
(``index_select`` plus a mask, as the JAX package's are ``jnp.take`` plus a
mask); ``pack_impl`` "pallas" and "fused" take the gather kernel (K1) in
``repro_torch.kernels.ops`` instead, for the hierarchy's stage-1 and
stage-3 packs too.

  ragged the JAX package's ``lax.ragged_all_to_all`` straight into the
         window at ``put_displs``: no capacity padding.  On one device it
         is one flat gather (``ragged_tables``, baked at INIT) in
         write-through mode, K1 from its run table, over the send buffers
         and the window viewed as ``[1, P*rows, *F]``.

``fence_exchange`` and ``lock_exchange`` also take a ``window``: over a
``launch.mesh.ProcessMesh`` (one process per rank) they take this rank's
``[P*C, *F]`` alone and put its buckets into every rank's window (the peer
forms of K2 and K4), returning nothing.

Each exchange reports itself to an active step counter
(``roofline.trace``): the bucket exchanges, the inner all-to-alls and the
ragged epoch as ``all-to-all``, the hierarchy's leader hop as
``collective-permute``, with the result bytes per rank.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels.gather_rows import gather_rows
from ..roofline.trace import per_rank_bytes, report_collective


# ---------------------------------------------------------------------------
# Local pack / unpack (the "jnp" path; the kernel path lives in kernels.ops)
# ---------------------------------------------------------------------------


def _take_rows(x: torch.Tensor, src_idx: torch.Tensor) -> torch.Tensor:
    p, s = x.shape[:2]
    offs = torch.arange(p, device=x.device, dtype=torch.int64).unsqueeze(1) * s
    flat = x.reshape((p * s,) + tuple(x.shape[2:]))
    rows = flat.index_select(0, (src_idx.long() + offs).reshape(-1))
    return rows.reshape(tuple(src_idx.shape) + tuple(x.shape[2:]))


def pack_rows(x: torch.Tensor, src_idx: torch.Tensor, valid: torch.Tensor,
              x2: torch.Tensor | None = None) -> torch.Tensor:
    """Gather ragged send rows into the bucketed layout.

    x:       [P, S, *F]   ragged send buffers (padded to the max over ranks)
    src_idx: [P, P*C]     gather map (constant under a persistent plan)
    valid:   [P, P*C]     padding mask
    x2:      [P, S2, *F]  a second source, concatenated after ``x``
    """
    if x2 is not None:
        x = torch.cat([x, x2], dim=1)
    out = _take_rows(x, src_idx)
    mask = valid.reshape(valid.shape + (1,) * (out.dim() - 2))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


def unpack_rows(buckets: torch.Tensor, src_idx: torch.Tensor,
                valid: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Gather the bucketed recv layout back into the ragged recv buffers.
    Given ``out``, only valid rows are written into it (write-through)."""
    rows = _take_rows(buckets, src_idx)
    mask = valid.reshape(valid.shape + (1,) * (rows.dim() - 2))
    if out is None:
        return torch.where(mask, rows, torch.zeros((), dtype=rows.dtype,
                                                   device=rows.device))
    out.copy_(torch.where(mask, rows, out))
    return out


# ---------------------------------------------------------------------------
# Fence: one epoch, every bucket in flight
# ---------------------------------------------------------------------------


def fence_exchange(packed: torch.Tensor, p: int, capacity: int,
                   groups: int = 1, window=None) -> torch.Tensor | None:
    """[P, P*C, *F] -> [P, P*C, *F]; output bucket j of rank i holds rank
    j's data for i.  ``groups`` independent exchanges of P ranks each
    (``[groups*P, P*C, *F]``) take one launch.

    The process-mesh form: given ``window`` (a ``rma_signal.PeerWindow``),
    ``packed`` is this rank's ``[P*C, *F]`` and bucket j lands in rank j's
    window at rows ``[me*C, (me+1)*C)``; it returns nothing."""
    if window is not None:
        report_collective("all-to-all", packed.numel() * packed.element_size(),
                          p)
        kops.rma_alltoallv_peer(packed, window, variant="fence",
                                capacity=capacity)
        return None
    report_collective("all-to-all", per_rank_bytes(packed), p)
    return kops.rma_alltoallv(packed, variant="fence", p=p, capacity=capacity,
                              groups=groups)


# ---------------------------------------------------------------------------
# Lock: per-target pairwise epochs
# ---------------------------------------------------------------------------


def lock_exchange(
    packed: torch.Tensor,
    p: int,
    capacity: int,
    round_capacities: Sequence[int] | None,
    schedule: str = "ring",
    window=None,
) -> torch.Tensor | None:
    """(P-1) serialized pairwise rounds; round r moves bucket (i -> i+r).

    ``round_capacities[r]`` lets a *persistent* plan shrink each round to the
    largest message actually exchanged in it — metadata a non-persistent call
    cannot exploit (it passes None: every round at the global capacity).  A
    round capacity of 0 means the round carries no data on any rank, and the
    persistent schedule elides it: no barrier, no launch.  Rows of a received
    bucket above its round capacity are zero.  On CUDA the kernel
    ``kernels.a2a_lock.kernel_for`` names runs the epoch.

    The process-mesh form: given ``window`` (a ``rma_signal.PeerWindow``),
    ``packed`` is this rank's ``[P*C, *F]``; round r puts its bucket into
    its target's window and waits for its own source's, and it returns
    nothing.  Rows of a received bucket above its round capacity keep the
    window's bytes.
    """
    if window is not None:
        report_collective("all-to-all", packed.numel() * packed.element_size(),
                          p)
        kops.rma_alltoallv_peer(packed, window, variant="lock",
                                capacity=capacity,
                                round_capacities=round_capacities,
                                schedule=schedule)
        return None
    report_collective("all-to-all", per_rank_bytes(packed), p)
    return kops.rma_alltoallv(packed, variant="lock", p=p, capacity=capacity,
                              round_capacities=round_capacities,
                              schedule=schedule)


# ---------------------------------------------------------------------------
# Fence-hierarchy: leader-combined three-hop exchange (message combining)
# ---------------------------------------------------------------------------


def inner_all_to_all(t: torch.Tensor, p_outer: int, p_inner: int,
                     capacity: int) -> torch.Tensor:
    """The JAX package's ``lax.all_to_all(..., tiled=True)`` over the inner
    axis, for every group at once: ``t [P, P_inner*C, *F]``, rank
    ``(o, q)``'s chunk ``j`` lands at ``(o, j)`` as chunk ``q``.  One K2
    launch with ``groups=P_outer``."""
    report_collective("all-to-all", per_rank_bytes(t), p_inner)
    return kops.rma_alltoallv(t, variant="fence", p=p_inner, capacity=capacity,
                              groups=p_outer)


def stage2_leader_ppermute(s1_recv: torch.Tensor, s2_src: torch.Tensor,
                           s2_valid: torch.Tensor, schedule,
                           s2_from: torch.Tensor) -> torch.Tensor:
    """Inter-group leader epoch: the slabs, then one rank-dimension
    ``index_select`` per active macro-round.

    ``s1_recv [P, S1, *F]``, ``s2_src``/``s2_valid [P, total_s2]``;
    returns the stage-2 recv buffers ``[P, total_s2, *F]``.  Round ``m``
    moves slab rows ``[s2_offs[m], s2_offs[m] + s2_caps[m])`` along the
    slab-filtered ``schedule.round_perms[m]``; a rank outside that
    permutation receives zeros, as from ``ppermute``.  ``s2_from`` is the
    device copy of ``metadata.hier_stage2_from(schedule)``, the same
    permutations as a ``[P, n_macro]`` table (-1: no sender).
    """
    s2_send = pack_rows(s1_recv, s2_src, s2_valid)
    p = s2_send.shape[0]
    # Rank P of ``ext`` is all zeros: the source of every rank that
    # receives nothing in a round.
    ext = torch.cat([s2_send, s2_send.new_zeros((1,) + s2_send.shape[1:])])
    src = torch.where(s2_from < 0, p, s2_from).long()
    blocks = [ext[:, off:off + cap].index_select(0, src[:, m])
              for m, (cap, off) in enumerate(zip(schedule.s2_caps,
                                                 schedule.s2_offs))
              if cap > 0]
    return torch.cat(blocks, dim=1) if blocks else s2_send


def hierarchy_exchange_combined(
    x: torch.Tensor,
    tables: Sequence[torch.Tensor],
    schedule,
    stage2: Callable,
    packs: tuple[Callable, Callable] = (pack_rows, pack_rows),
    groups: int = 1,
) -> torch.Tensor:
    """Leader-combined hierarchical alltoallv body on the INIT-baked tables.

    ``x`` is every rank's ragged send buffer ``[P, send_rows, *F]``;
    ``tables`` the schedule's ``s1_src, s1_valid, s2_src, s2_valid, s3_src,
    s3_valid`` on the device.  Three hops:

      1. intra-group gather (``inner_all_to_all``): cross-group rows ship to
         the leaders of their target groups;
      2. inter-group leader exchange: ``stage2(s1_recv, s2_src, s2_valid)``,
         K5 for ``pack_impl="fused"``, else ``stage2_leader_ppermute``
         bound to the plan's tables;
      3. intra-group scatter (``inner_all_to_all``) of the stage-2 rows and
         the group-local rows, taken straight from the send buffer.

    ``groups`` independent exchanges of the schedule's P ranks run at once
    (``x [groups*P, send_rows, *F]``, ``tables`` tiled ``groups`` times with
    the rank numbers of ``stage2``'s own tables offset by group): every
    K2 launch covers every group.

    ``packs`` are the stage-1 and stage-3 gathers, called as
    ``pack(src, idx, valid)`` and, for stage 3 after stage 2,
    ``pack(s2_recv, idx, valid, x2=x)``: the stage-3 tables index the
    stage-2 rows and then the send buffer, read as two sources.  The
    default is the reference gather (``pack_rows``, which concatenates);
    ``pack_impl`` "pallas" and "fused" bind K1 with each table's run table.

    Returns the stage-3 recv layout ``[P, P_inner * s3_cap, *F]``, which the
    caller unpacks with the schedule's unpack tables.  An all-local pattern
    (``schedule.remote_needed`` False) skips hops 1-2.
    """
    s1_src, s1_valid, s2_src, s2_valid, s3_src, s3_valid = tables
    s1_pack, s3_pack = packs
    po, pi = schedule.p_outer * groups, schedule.p_inner
    if schedule.remote_needed:
        s1_recv = inner_all_to_all(s1_pack(x, s1_src, s1_valid), po, pi,
                                   schedule.s1_cap)
        s2_recv = stage2(s1_recv, s2_src, s2_valid)
        report_collective("collective-permute", per_rank_bytes(s2_recv), po)
        s3_send = s3_pack(s2_recv, s3_src, s3_valid, x2=x)
    else:
        # No row crosses a group boundary: total_s2 == 0 and the s3 tables
        # index straight into the send buffer.
        s3_send = s3_pack(x, s3_src, s3_valid)
    return inner_all_to_all(s3_send, po, pi, schedule.s3_cap)


def _zero_rank_select(t: torch.Tensor, src: np.ndarray) -> torch.Tensor:
    """``out[g] = t[src[g]]``, or zeros where ``src[g]`` is -1."""
    ext = torch.cat([t, t.new_zeros((1,) + t.shape[1:])])
    idx = torch.from_numpy(np.where(src < 0, t.shape[0], src)).to(t.device)
    return ext.index_select(0, idx)


def hierarchy_exchange(packed: torch.Tensor, p_outer: int, p_inner: int,
                       capacity: int, remote_needed: bool = True) -> torch.Tensor:
    """Leader-combined exchange for *uniform* bucket layouts (no tables).

    The table-free twin of ``hierarchy_exchange_combined`` for consumers
    whose per-peer buckets all share one capacity (MoE dispatch, Ulysses):
    ``packed [P, P*C, *F]``, bucket ``j`` of rank ``g`` holding its rows for
    rank ``j``; the result is the flat fence exchange of that layout.  In
    macro-round ``m`` inner rank ``q`` leads the group at ring offset
    ``d = m * P_inner + q + 1``; the intra-group gather hands it the group's
    buckets for that group, it exchanges one combined slab of
    ``P_inner^2 * C`` rows, and the intra-group scatter delivers.  Group-local
    buckets bypass hop 2; ``remote_needed=False`` skips hops 1-2 and leaves
    every remote bucket zero.
    """
    p, c = p_outer * p_inner, capacity
    f = tuple(packed.shape[2:])
    dev = packed.device
    blocks = packed.reshape((p, p_outer, p_inner, c) + f)       # [g, to, ti]
    outer = np.arange(p) // p_inner
    ranks = torch.arange(p, device=dev)
    local = blocks[ranks, torch.from_numpy(outer).to(dev)]       # [g, ti, C]
    n_macro = -(-(p_outer - 1) // p_inner) if p_outer > 1 else 0
    remote = remote_needed and n_macro > 0
    slots = n_macro * p_inner + 1 if remote else 1

    if remote:
        # --- hop 1: send1[g, q', m, ti] = my bucket for group o + d(m, q')
        d_tbl = (np.arange(n_macro)[None, :] * p_inner
                 + np.arange(p_inner)[:, None] + 1)              # [q', m]
        to = (outer[:, None, None] + d_tbl[None]) % p_outer      # [g, q', m]
        send1 = blocks[ranks[:, None, None], torch.from_numpy(to).to(dev)]
        ok = torch.from_numpy(d_tbl < p_outer).to(dev)
        send1 = torch.where(ok.reshape(ok.shape + (1,) * (send1.dim() - 3)),
                            send1, torch.zeros((), dtype=send1.dtype,
                                               device=dev))
        recv1 = inner_all_to_all(
            send1.reshape((p, p_inner * n_macro * p_inner * c) + f),
            p_outer, p_inner, n_macro * p_inner * c)
        recv1 = recv1.reshape((p, p_inner, n_macro, p_inner, c) + f)
        # recv1[g, sq, m, ti] = inner rank sq's bucket for g's owned groups.

        # --- hop 2: one combined slab per (source group, target group) ---
        slabs = []
        for m in range(n_macro):
            src = np.full(p, -1, np.int64)
            for g in range(p):
                d = m * p_inner + g % p_inner + 1
                if d < p_outer:
                    src[g] = ((outer[g] - d) % p_outer) * p_inner + g % p_inner
            slabs.append(_zero_rank_select(recv1[:, :, m], src))
        recv2 = torch.stack(slabs, dim=1)                        # [g, m, sq, ti]
        report_collective("collective-permute", per_rank_bytes(recv2), p_outer)

        # --- hop 3: intra-group scatter + local bypass -------------------
        remote_part = recv2.permute((0, 3, 1, 2) + tuple(range(4, recv2.dim())))
        send3 = torch.cat(
            [remote_part.reshape((p, p_inner, n_macro * p_inner, c) + f),
             local[:, :, None]], dim=2)                          # [g, ti, slot]
    else:
        send3 = local[:, :, None]
    recv3 = inner_all_to_all(send3.reshape((p, p_inner * slots * c) + f),
                             p_outer, p_inner, slots * c)
    # recv3[g, q, slot]: slot m*P_inner + sq holds the rows of rank
    # (so(m, q), sq); the last slot is local rank q's own bucket for g.
    flat = recv3.reshape((p, p_inner * slots, c) + f)

    # Reorder by source rank: ds = (o - so) % P_outer picks (leader, slot),
    # ds == 0 is the local bypass slot.
    if remote:
        lin_idx = np.zeros((p_outer, p_inner), np.int64)         # [ds, sq]
        for ds in range(p_outer):
            for sq in range(p_inner):
                if ds == 0:
                    lin_idx[ds, sq] = sq * slots + (slots - 1)
                else:
                    qq, mm = (ds - 1) % p_inner, (ds - 1) // p_inner
                    lin_idx[ds, sq] = qq * slots + mm * p_inner + sq
        by_ds = flat[:, torch.from_numpy(lin_idx.reshape(-1)).to(dev)]
    else:
        # Only ds == 0 carries data; every remote slot reads as zeros.
        by_ds = torch.cat([flat, flat.new_zeros(
            (p, (p_outer - 1) * p_inner, c) + f)], dim=1)
    by_ds = by_ds.reshape((p, p_outer, p_inner, c) + f)
    ds_of_so = (outer[:, None] - np.arange(p_outer)[None, :]) % p_outer
    out = by_ds[ranks[:, None], torch.from_numpy(ds_of_so).to(dev)]
    return out.reshape((p, p * c) + f)


def per_group(fn: Callable, x: torch.Tensor, groups: int) -> torch.Tensor:
    """``fn`` on each of ``groups`` blocks of ranks of ``x [groups*P, ...]``,
    the results stacked back in order: for exchanges with no ``groups`` of
    their own (one launch per group)."""
    if groups == 1:
        return fn(x)
    return torch.cat([fn(blk) for blk in x.chunk(groups)])


def uniform_bucketed_exchange(
    packed: torch.Tensor,
    variant: str,
    capacity: int,
    axis_sizes: Sequence[int],
    lock_schedule: str = "ring",
    groups: int = 1,
) -> torch.Tensor:
    """Table-free variant dispatch for *uniform* bucketed layouts
    ``[P, P*C, *F]``: the MoE and Ulysses exchanges with no INIT stage to
    amortize.  ``axis_sizes`` is ``(P,)``, or ``(P_outer, P_inner)`` for a
    grouped mesh (fence and lock then run over the linearized pair).
    ``groups`` independent exchanges (``[groups*P, P*C, *F]``, the data
    replicas of a mesh) run as one fence launch, or one lock or hierarchy
    exchange per group."""
    p = math.prod(int(s) for s in axis_sizes)
    if variant == "lock":
        return per_group(lambda b: lock_exchange(b, p, capacity, None,
                                                 lock_schedule),
                         packed, groups)
    if variant == "fence_hierarchy":
        if len(axis_sizes) != 2:
            raise ValueError("fence_hierarchy needs axis_sizes=(outer, inner)")
        return per_group(lambda b: hierarchy_exchange(
            b, int(axis_sizes[0]), int(axis_sizes[1]), capacity),
            packed, groups)
    if variant != "fence":
        raise ValueError(f"unknown uniform exchange variant {variant!r}")
    return fence_exchange(packed, p, capacity, groups)


# ---------------------------------------------------------------------------
# Autograd: the backward of an exchange
# ---------------------------------------------------------------------------


class _Linear(torch.autograd.Function):
    """A linear exchange ``fn`` whose backward is ``transpose``: the
    exchange the JAX package's transpose rules give for the same body.  A
    kernel's output carries no ``grad_fn``; this gives it one."""

    @staticmethod
    def forward(ctx, x, fn, transpose):
        ctx.transpose = transpose
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.transpose(g.contiguous()), None, None


class _NoTranspose(torch.autograd.Function):
    """An exchange whose JAX twin has no transpose: its backward raises
    the ``NotImplementedError`` that ``jax.vjp`` raises there."""

    @staticmethod
    def forward(ctx, x, fn, why):
        ctx.why = why
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(ctx.why)


class _ZeroGradient(torch.autograd.Function):
    """``y``, as a function of ``x`` whose gradient is zero."""

    @staticmethod
    def forward(ctx, y, x):
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.x_meta
        return None, torch.zeros(shape, dtype=dtype, device=device)


def tracked(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x`` here."""
    return torch.is_grad_enabled() and x.requires_grad


def linear_exchange(fn: Callable, transpose: Callable,
                    x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for a linear row move ``fn`` whose transpose is
    ``transpose``, differentiable: the backward runs ``transpose`` on the
    cotangent.  Without a gradient to track it is the bare call."""
    return _Linear.apply(x, fn, transpose) if tracked(x) else fn(x)


def self_adjoint_exchange(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for a self-transposing exchange ``fn``, differentiable.  A
    uniform bucketed all-to-all puts input bucket i of rank j into output
    bucket j of rank i: a permutation of rows that is its own inverse, so
    the cotangent goes back through the same exchange (the same kernel on
    a card: K2 for the fence, K4 for the lock, which moves the same
    rows)."""
    return linear_exchange(fn, fn, x)


def untransposable(fn: Callable, x: torch.Tensor, why: str) -> torch.Tensor:
    """``fn(x)``; where a gradient is tracked, its backward raises
    ``NotImplementedError(why)``, as ``jax.vjp`` of the JAX twin does,
    rather than let a kernel's output cut the gradient silently."""
    return _NoTranspose.apply(x, fn, why) if tracked(x) else fn(x)


def zero_gradient(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` joined to ``x`` with a zero gradient, where ``x`` is tracked
    and ``y`` lost the track on a path JAX differentiates to zero (the
    ``round`` of an int8 codec, a bitcast)."""
    if tracked(x) and not y.requires_grad:
        return _ZeroGradient.apply(y, x)
    return y


def invert_gather(src: np.ndarray, valid: np.ndarray,
                  n_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """The transpose of an injective row gather, as a gather.

    ``src``/``valid [P, N]``: output row t of rank i reads row ``src[i, t]``
    of a ``[P, n_rows]`` source where ``valid[i, t]``.  Returns the
    ``[P, n_rows]`` tables that read each source row back from the output
    row that took it; rows no output read are invalid (their cotangent is
    zero).  Raises if two valid outputs read one row."""
    src = np.asarray(src, np.int64)
    valid = np.asarray(valid, bool)
    p = src.shape[0]
    rank, t = np.nonzero(valid)
    flat = rank * n_rows + src[rank, t]
    if np.unique(flat).size != flat.size:
        raise ValueError("the gather reads a row twice: its transpose is "
                         "not a gather")
    inv = np.zeros(p * n_rows, np.int32)
    ok = np.zeros(p * n_rows, bool)
    inv[flat] = t
    ok[flat] = True
    return inv.reshape(p, n_rows), ok.reshape(p, n_rows)


# ---------------------------------------------------------------------------
# Ragged: true variable-size exchange, no capacity padding
# ---------------------------------------------------------------------------


def ragged_tables(send_counts: np.ndarray, sdispls: np.ndarray,
                  put_displs: np.ndarray, send_rows: int,
                  recv_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """The ragged exchange as one flat gather, ``idx``/``valid [1, P*R]``.

    Output row ``j*R + put_displs[i, j] + k`` (rank j's window) reads
    source row ``i*S + sdispls[i, j] + k`` (rank i's send buffer) for
    ``k < send_counts[i, j]``; every other output row is invalid and keeps
    the window's bytes.  ``S``/``R`` are ``send_rows``/``recv_rows``.
    """
    sc = np.asarray(send_counts, np.int64)
    p = sc.shape[0]
    if p * max(send_rows, recv_rows) > np.iinfo(np.int32).max:
        raise ValueError(f"the flat ragged gather over {p} ranks of "
                         f"{send_rows}/{recv_rows} rows exceeds int32")
    n = sc.reshape(-1)
    i, j = np.divmod(np.arange(p * p), p)
    out0 = j * recv_rows + np.asarray(put_displs, np.int64).reshape(-1)
    src0 = i * send_rows + np.asarray(sdispls, np.int64).reshape(-1)
    pair = np.repeat(np.arange(p * p), n)
    k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    idx = np.zeros(p * recv_rows, np.int32)
    valid = np.zeros(p * recv_rows, bool)
    idx[out0[pair] + k] = src0[pair] + k
    valid[out0[pair] + k] = True
    return idx[None], valid[None]


def ragged_exchange(x: torch.Tensor, window: torch.Tensor, idx: torch.Tensor,
                    valid: torch.Tensor, runs=None) -> torch.Tensor:
    """Every rank's ragged rows straight into the window, in place.

    ``x [P, S, *F]`` are the send buffers, ``window [P, R, *F]`` the
    plan's window slot, ``idx``/``valid`` the ``ragged_tables`` on the
    device and ``runs`` their run table.  Rows no sender puts keep the
    window's bytes, as a ``ragged_all_to_all`` into a donated window does.
    On CUDA, K1 from ``runs`` in write-through mode.
    """
    feat = tuple(x.shape[2:])
    report_collective("all-to-all", per_rank_bytes(window), window.shape[0])
    return gather_rows(x.reshape((1, -1) + feat), idx, valid,
                       out=window.view((1, -1) + feat), runs=runs)


# ---------------------------------------------------------------------------
# Metadata recomputed on the device (the *non-persistent* path pays this per
# call).  Persistent plans bake their index maps on host at INIT
# (metadata.baked_index_tables); these twins exist so baseline.py models
# the per-call cost honestly, and for baked_metadata=False plans.
# ---------------------------------------------------------------------------


def exchange_counts_in_graph(counts: torch.Tensor) -> torch.Tensor:
    """Every rank's send-count row -> its recv-count row: the INIT-time
    ``MPI_Alltoall(sendcounts)``.  Over virtual ranks it is a transpose
    (of each group's matrix, for ``[..., P, P]``)."""
    return counts.transpose(-2, -1).contiguous()


def pack_index_map_in_graph(
    counts_rows: torch.Tensor, displs_rows: torch.Tensor, p: int, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device twin of ``metadata.pack_index_map`` for every rank: [P, P*C]."""
    t = torch.arange(p * capacity, device=counts_rows.device)
    peer = t // capacity
    k = t % capacity
    cnt = counts_rows[:, peer]
    valid = k < cnt
    src = displs_rows[:, peer] + torch.minimum(k, (cnt - 1).clamp(min=0))
    return torch.where(valid, src, 0).to(torch.int32), valid


def unpack_index_map_in_graph(
    recv_counts_rows: torch.Tensor, rdispls_rows: torch.Tensor, p: int,
    capacity: int, out_rows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device twin of ``metadata.unpack_index_map``: [P, out_rows]."""
    m = torch.arange(out_rows, device=recv_counts_rows.device,
                     dtype=rdispls_rows.dtype)
    edges = torch.cat([rdispls_rows,
                       (rdispls_rows[:, -1] + recv_counts_rows[:, -1])[:, None]],
                      dim=1)
    queries = m.expand(recv_counts_rows.shape[0], out_rows).contiguous()
    peer = (torch.searchsorted(edges, queries, right=True) - 1).clamp(0, p - 1)
    within = m - rdispls_rows.gather(1, peer)
    valid = within < recv_counts_rows.gather(1, peer)
    src = peer * capacity + within.clamp(max=capacity - 1)
    return torch.where(valid, src, 0).to(torch.int32), valid


def displacements_in_graph(counts_rows: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum along each rank's row."""
    return torch.cumsum(counts_rows, dim=-1) - counts_rows
