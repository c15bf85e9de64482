"""INIT-phase metadata for persistent alltoallv plans (PyTorch port).

A copy of ``repro.core.metadata``, kept in the port because importing that
module runs ``repro/core/__init__.py``, which imports JAX.  The tables must
stay byte-equal to the JAX package's (``tests/test_torch_metadata.py``).
Two changes: ``PatternSignature.build`` also accepts torch dtypes and
spells them with their numpy names, so digests agree across the two
packages for equal specs; and ``hier_stage2_from`` / ``hier_row_rounds``
bake the two small tables the port's stage-2 kernel (K5) reads.

Everything here is what the paper's ``ALLTOALLV_RMA_*_INIT`` routines
compute once and cache in the persistent ``MPIX_Request``:

  * the recv-count matrix (the ``MPI_Alltoall(sendcounts)`` exchange — on a
    host-known pattern this is just the transpose),
  * send/recv displacements in row units (``sdispls``/``rdispls``),
  * remote put displacements (``put_displs`` — where my data lands inside each
    target's exposed window),
  * the capacity schedule that converts a ragged pattern into the statically
    shaped, tile-aligned layout XLA requires (global capacity for the fused
    fence collective, per-round capacities for the lock schedule — zero for
    rounds that carry no data anywhere, which the persistent plan elides —
    and the two-stage capacities for the hierarchical variant),
  * the sparsity analysis (``active_round_schedule``,
    ``hierarchy_is_all_local``) that lets a plan skip empty lock rounds and
    the outer-stage collective of an all-local hierarchical pattern,
  * all-rank pack/unpack gather index maps (``baked_index_tables``), dense
    ``[P, P*C]`` / ``[P, recv_rows]`` tables,
  * the leader-combined two-stage schedule (``hier_two_stage_schedule``)
    for the hierarchical variant: intra-group gather, per-group-pair
    combined slab capacities + slab-filtered round permutations (and the
    ``cross_group_puts`` message counter), intra-group scatter, and the
    final unpack — four more axis-sharded gather tables.

All of it is plain numpy: it runs on host once at INIT time.  The index
tables are uploaded once to the device as ``[P, P*C]`` / ``[P, recv_rows]``
tensors and handed to every START, so no index-map arithmetic remains in
the epoch hot path; the non-persistent baseline recomputes all of this on
the device every call via the ``*_in_graph`` twins in ``core.variants``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import numpy as np

# Capacity buckets are rounded up to multiples of this.  The value is the JAX
# package's (its minimal TPU tile height); the port keeps it so capacities,
# tables and digests agree row for row with the reference.
TILE_ROWS = 8


def _as_counts(counts: np.ndarray) -> np.ndarray:
    c = np.asarray(counts)
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise ValueError(f"counts must be square [P, P], got {c.shape}")
    if np.any(c < 0):
        raise ValueError("counts must be non-negative")
    return c.astype(np.int64)


def round_up(x: int, q: int) -> int:
    return int(-(-int(x) // q) * q)


def dtype_name(dtype) -> str:
    """Numpy spelling of a dtype given as a torch dtype, a numpy dtype or
    type, or a name: ``torch.bfloat16`` and ``"bfloat16"`` -> "bfloat16".
    Checks the type's module instead of importing torch, so this module
    stays plain numpy; bfloat16 is spelled out because numpy knows it only
    through ml_dtypes."""
    if type(dtype).__module__ == "torch":
        return str(dtype).rsplit(".", 1)[-1]
    if isinstance(dtype, str) and dtype == "bfloat16":
        return dtype
    return str(np.dtype(dtype))


def recv_counts(send_counts: np.ndarray) -> np.ndarray:
    """recv_counts[i, j] = rows rank i receives from rank j.

    The device-side equivalent is one int32 ``all_to_all`` at INIT time (the
    paper's ``MPI_Alltoall`` over counts); for a host-known pattern it is the
    transpose of the send matrix.
    """
    return _as_counts(send_counts).T.copy()


def displacements(counts: np.ndarray) -> np.ndarray:
    """Exclusive prefix sum per row: displs[i, j] = offset of peer j's block."""
    c = _as_counts(counts)
    return np.concatenate(
        [np.zeros((c.shape[0], 1), np.int64), np.cumsum(c, axis=1)[:, :-1]], axis=1
    )


def put_displacements(send_counts: np.ndarray) -> np.ndarray:
    """put_displs[i, j] = offset inside rank j's window where rank i's data lands.

    This is the metadata the paper obtains with ``MPI_Alltoall(rdispls)``:
    rank j's window is laid out in sender order, so rank i's block starts at
    rank j's rdispls[j, i].
    """
    rc = recv_counts(send_counts)
    rd = displacements(rc)
    return rd.T.copy()  # [sender i, target j]


def counts_digest(send_counts: np.ndarray) -> str:
    """A digest of the count matrix (shape and int64 values): what the
    ranks of a process mesh compare at INIT, each holding the global
    matrix."""
    c = np.ascontiguousarray(np.asarray(send_counts, np.int64))
    return hashlib.sha1(repr(c.shape).encode() + c.tobytes()).hexdigest()[:16]


def global_capacity(send_counts: np.ndarray, tile_rows: int = TILE_ROWS) -> int:
    """Capacity of one per-peer bucket for the fused (fence) layout."""
    c = _as_counts(send_counts)
    return max(round_up(int(c.max(initial=0)), tile_rows), tile_rows)


def ring_round_capacities(
    send_counts: np.ndarray, tile_rows: int = TILE_ROWS
) -> np.ndarray:
    """Per-round payload capacity for the lock (pairwise ring) schedule.

    Round r in [1, P) exchanges rank i -> rank (i + r) % P.  The round's
    shape must be uniform across ranks, so its capacity is the max count on
    that diagonal — the TPU expression of the paper's observation that one
    hot target gates the whole lock epoch.

    A round whose diagonal is *entirely empty* gets capacity 0: under a
    sparse (e.g. banded / neighborhood) pattern the persistent lock schedule
    elides that round completely — no ``ppermute``, no buffer update — which
    is where irregular-pattern speedups live (Träff's message combining,
    Collom's neighborhood collectives).
    """
    c = _as_counts(send_counts)
    p = c.shape[0]
    caps = np.zeros(p, np.int64)
    for r in range(1, p):
        diag = c[np.arange(p), (np.arange(p) + r) % p]
        m = int(diag.max(initial=0))
        caps[r] = 0 if m == 0 else max(round_up(m, tile_rows), tile_rows)
    return caps


def xor_round_capacities(
    send_counts: np.ndarray, tile_rows: int = TILE_ROWS
) -> np.ndarray:
    """Per-round capacities for the pairwise (XOR) lock schedule.

    Round r exchanges rank i -> rank i ^ r, so the gating diagonal is
    ``c[i, i ^ r]`` — distinct from the ring diagonal.  Empty rounds get
    capacity 0 (elided), same as ``ring_round_capacities``.
    """
    c = _as_counts(send_counts)
    p = c.shape[0]
    if p & (p - 1):
        raise ValueError("pairwise schedule requires power-of-two P")
    caps = np.zeros(p, np.int64)
    for r in range(1, p):
        diag = c[np.arange(p), np.arange(p) ^ r]
        m = int(diag.max(initial=0))
        caps[r] = 0 if m == 0 else max(round_up(m, tile_rows), tile_rows)
    return caps


def active_round_schedule(round_capacities: np.ndarray) -> np.ndarray:
    """Indices of lock rounds that actually carry data (capacity > 0)."""
    caps = np.asarray(round_capacities)
    return np.nonzero(caps[1:] > 0)[0] + 1


def hierarchy_is_all_local(send_counts: np.ndarray, p_outer: int, p_inner: int) -> bool:
    """True iff no row crosses an outer-group boundary (outer-major ranks).

    When every send stays within its own outer group, the hierarchical
    variant's remote stage (the outer-axis collective) moves only padding;
    a persistent plan detects this at INIT and skips the stage entirely.
    """
    c = _as_counts(send_counts)
    outer = np.arange(p_outer * p_inner) // p_inner
    cross = outer[:, None] != outer[None, :]
    return not bool(c[cross].any())


def hierarchy_shape(p: int, p_outer: int) -> tuple[int, int]:
    if p % p_outer != 0:
        raise ValueError(f"axis size {p} not divisible by outer factor {p_outer}")
    return p_outer, p // p_outer


def total_rows(counts_row: np.ndarray) -> int:
    return int(np.sum(counts_row))


def max_total_send(send_counts: np.ndarray) -> int:
    return int(_as_counts(send_counts).sum(axis=1).max(initial=0))


def max_total_recv(send_counts: np.ndarray) -> int:
    return int(_as_counts(send_counts).sum(axis=0).max(initial=0))


def pack_index_map(
    counts_row: np.ndarray, displs_row: np.ndarray, capacity: int
) -> tuple[np.ndarray, np.ndarray]:
    """Gather map ragged-send-buffer -> bucketed [P * capacity] layout.

    Returns (src_idx, valid) with src_idx[t] the source row feeding packed row
    t and valid[t] the padding mask.  With a frozen pattern both are numpy
    constants, so the persistent executable embeds them; the non-persistent
    path recomputes the same map from traced counts every call.
    """
    p = counts_row.shape[0]
    t = np.arange(p * capacity, dtype=np.int64)
    peer = t // capacity
    k = t % capacity
    cnt = counts_row[peer]
    valid = k < cnt
    src = displs_row[peer] + np.minimum(k, np.maximum(cnt - 1, 0))
    return np.where(valid, src, 0).astype(np.int32), valid


def unpack_index_map(
    recv_counts_row: np.ndarray,
    rdispls_row: np.ndarray,
    capacity: int,
    out_rows: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Gather map bucketed recv layout [P * capacity] -> ragged recv buffer."""
    p = recv_counts_row.shape[0]
    m = np.arange(out_rows, dtype=np.int64)
    # peer owning output row m: last j with rdispls[j] <= m (rows are laid out
    # in sender order, contiguously).
    edges = np.concatenate([rdispls_row, [rdispls_row[-1] + recv_counts_row[-1]]])
    peer = np.clip(np.searchsorted(edges, m, side="right") - 1, 0, p - 1)
    within = m - rdispls_row[peer]
    valid = within < recv_counts_row[peer]
    src = peer * capacity + np.minimum(within, capacity - 1)
    return np.where(valid, src, 0).astype(np.int32), valid


@dataclasses.dataclass(frozen=True)
class BakedIndexTables:
    """All-rank pack/unpack gather maps, fully materialized at INIT time.

    ``pack_src``/``pack_valid`` are ``[P, P * capacity]``; ``unpack_src``/
    ``unpack_valid`` are ``[P, recv_rows]``.  A persistent plan uploads
    these once, sharded over the communication axis, so each device holds
    exactly its own row (O(P*C) per device) — the per-epoch index-map
    *recomputation* (iota / division / searchsorted chains) that the
    in-graph twins in ``core.variants`` pay on every call disappears
    entirely.
    """

    pack_src: np.ndarray
    pack_valid: np.ndarray
    unpack_src: np.ndarray
    unpack_valid: np.ndarray


def baked_index_tables(
    send_counts: np.ndarray, capacity: int, recv_rows: int
) -> BakedIndexTables:
    """Precompute every rank's pack/unpack index maps as dense tables."""
    c = _as_counts(send_counts)
    p = c.shape[0]
    sd = displacements(c)
    rc = recv_counts(c)
    rd = displacements(rc)
    pack_src = np.zeros((p, p * capacity), np.int32)
    pack_valid = np.zeros((p, p * capacity), bool)
    unpack_src = np.zeros((p, recv_rows), np.int32)
    unpack_valid = np.zeros((p, recv_rows), bool)
    for i in range(p):
        pack_src[i], pack_valid[i] = pack_index_map(c[i], sd[i], capacity)
        unpack_src[i], unpack_valid[i] = unpack_index_map(
            rc[i], rd[i], capacity, recv_rows)
    return BakedIndexTables(pack_src, pack_valid, unpack_src, unpack_valid)


# ---------------------------------------------------------------------------
# Leader-combined two-stage hierarchy (Träff-style message combining)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HierSchedule:
    """INIT-baked schedule + index tables for the leader-combined hierarchy.

    The flat hierarchical exchange moves one slab per (rank, remote group):
    O(P * P_outer) cross-group messages, each padded to the global bucket
    capacity.  Message combining stages the exchange in three hops instead:

      stage 1  intra-group gather (inner-axis all_to_all): every rank ships
               its cross-group rows to the group *leader* responsible for the
               destination group.  Leadership is distributed round-robin over
               the inner axis so all ranks act as leaders in parallel: in
               macro-round ``m`` inner rank ``q`` owns the group at ring
               offset ``d = m * p_inner + q + 1``.
      stage 2  inter-group leader exchange: one combined slab per
               (source group, target group) pair — ``P_outer * (P_outer - 1)``
               cross-group messages total, i.e. O((P/g)^2) instead of
               O(P * P/g).  Slabs are ragged-packed (padding amortizes over
               the whole group pair, not per rank pair) and empty slabs are
               dropped from the round's permutation (sparsity elision);
               macro-rounds with no traffic anywhere are elided entirely.
      stage 3  intra-group scatter (inner-axis all_to_all): receiving leaders
               deliver slab rows to their final local destinations.  Purely
               group-local rows bypass stages 1-2 completely and enter here
               straight from the send buffer, so their staging overlaps the
               inter-group epoch (the paper's remote-first put ordering).

    All four gather maps (``s1`` pack, ``s2`` slab build, ``s3`` scatter
    build, final ``unpack``) are materialized per rank at INIT and uploaded
    axis-sharded exactly like ``BakedIndexTables``.  ``cross_group_puts`` is
    the instrumented message counter the tests assert on.
    """

    p_outer: int
    p_inner: int
    n_macro: int                      # macro rounds (ceil((P_outer-1)/P_inner))
    remote_needed: bool               # any row crosses a group boundary
    s1_cap: int                       # stage-1 bucket capacity (rows)
    s2_caps: tuple[int, ...]          # per-macro-round slab capacity (0 = elided)
    s2_offs: tuple[int, ...]          # row offset of each round's slab
    total_s2: int                     # sum of s2_caps
    s3_cap: int                       # stage-3 bucket capacity (rows)
    round_perms: tuple[tuple[tuple[int, int], ...], ...]  # per round, linearized
    cross_group_puts: int             # total inter-group messages per epoch
    # leader_perm[o][role] = inner rank of group o playing leader ``role``.
    # Identity reproduces the round-robin assignment above; a re-bake swaps
    # a degraded rank out of the carrying roles without touching geometry.
    leader_perm: tuple[tuple[int, ...], ...]
    # Per-rank gather tables, [P, width]; uploaded axis-sharded.
    s1_src: np.ndarray
    s1_valid: np.ndarray              # [P, p_inner * s1_cap]   from send buffer
    s2_src: np.ndarray
    s2_valid: np.ndarray              # [P, total_s2]           from stage-1 recv
    s3_src: np.ndarray
    s3_valid: np.ndarray              # [P, p_inner * s3_cap]   from concat(stage-2 recv, send buffer)
    unpack_src: np.ndarray
    unpack_valid: np.ndarray          # [P, recv_rows]          from stage-3 recv

    @property
    def tables(self) -> tuple[np.ndarray, ...]:
        return (self.s1_src, self.s1_valid, self.s2_src, self.s2_valid,
                self.s3_src, self.s3_valid, self.unpack_src, self.unpack_valid)


def hier_offset(m: int, q: int, p_inner: int) -> int:
    """Ring offset (in groups) that leader ``q`` serves in macro-round ``m``."""
    return m * p_inner + q + 1


def hier_leader_of(src_outer: int, dst_outer: int, p_outer: int,
                   p_inner: int) -> tuple[int, int]:
    """(macro_round, leader_role) that carries the (src -> dst) group slab.

    The second element is the leader *role*, not a physical inner rank: under
    a non-identity ``leader_perm`` the rank playing role ``r`` in group ``o``
    is ``leader_perm[o][r]``.  With the identity permutation (today's
    round-robin) role and rank coincide.
    """
    d = (dst_outer - src_outer) % p_outer
    if d == 0:
        raise ValueError("intra-group traffic has no inter-group leader")
    return (d - 1) // p_inner, (d - 1) % p_inner


def identity_leader_perm(p_outer: int, p_inner: int) -> tuple[tuple[int, ...], ...]:
    """The round-robin default: role ``r`` is played by inner rank ``r``."""
    return tuple(tuple(range(p_inner)) for _ in range(p_outer))


def normalize_leader_perm(
    leader_perm, p_outer: int, p_inner: int
) -> tuple[tuple[int, ...], ...]:
    """Validate and canonicalize a per-group leader permutation.

    ``leader_perm[o][role]`` names the inner rank of group ``o`` that plays
    leader ``role``; every row must be a permutation of ``range(p_inner)``.
    ``None`` means identity.
    """
    if leader_perm is None:
        return identity_leader_perm(p_outer, p_inner)
    perm = tuple(tuple(int(x) for x in row) for row in leader_perm)
    if len(perm) != p_outer or any(len(row) != p_inner for row in perm):
        raise ValueError(
            f"leader_perm must be [{p_outer}][{p_inner}], got "
            f"{[len(r) for r in perm] if perm else perm}")
    for o, row in enumerate(perm):
        if sorted(row) != list(range(p_inner)):
            raise ValueError(
                f"leader_perm[{o}]={row} is not a permutation of "
                f"range({p_inner})")
    return perm


def leader_perm_is_identity(leader_perm) -> bool:
    return leader_perm is None or all(
        tuple(row) == tuple(range(len(row))) for row in leader_perm)


def hier_two_stage_schedule(
    send_counts: np.ndarray,
    p_outer: int,
    p_inner: int,
    recv_rows: int,
    tile_rows: int = TILE_ROWS,
    leader_perm=None,
) -> HierSchedule:
    """Bake the full leader-combined schedule for a frozen pattern.

    Ranks are outer-major: global rank ``g = o * p_inner + q``.  Everything
    here is host-side numpy run once at INIT; the returned tables are the
    only per-rank state the epoch hot path touches.

    ``leader_perm`` remaps which physical inner rank plays each leader role
    per group (``leader_perm[o][role] -> inner rank``); ``None`` is the
    round-robin identity and reproduces the historical schedule exactly.
    Slab shapes, capacities, and ``cross_group_puts`` depend only on the
    cross-group traffic matrix, so they are invariant under the permutation —
    only *who* carries each slab changes.
    """
    c = _as_counts(send_counts)
    p = c.shape[0]
    if p != p_outer * p_inner:
        raise ValueError(f"{p} ranks != {p_outer} x {p_inner}")
    perm = normalize_leader_perm(leader_perm, p_outer, p_inner)
    # inv[o][rank] = role that inner rank plays in group o.
    inv = [[0] * p_inner for _ in range(p_outer)]
    for o, row in enumerate(perm):
        for role, rank in enumerate(row):
            inv[o][rank] = role
    sd = displacements(c)
    rc = recv_counts(c)
    rd = displacements(rc)
    n_macro = -(-(p_outer - 1) // p_inner) if p_outer > 1 else 0

    # Cross-group traffic matrix X[o, to] = rows group o sends group to.
    grp = np.arange(p) // p_inner
    x_mat = np.zeros((p_outer, p_outer), np.int64)
    for o in range(p_outer):
        for to in range(p_outer):
            x_mat[o, to] = c[np.ix_(grp == o, grp == to)].sum()
    cross = x_mat.copy()
    np.fill_diagonal(cross, 0)
    remote_needed = bool(cross.any())

    def valid_d(m: int, q: int) -> int | None:
        d = hier_offset(m, q, p_inner)
        return d if d < p_outer else None

    # --- stage-1 bucket layout: sender (o, sq) -> leader (o, q') ----------
    # Rows in bucket order: for m, for ti: the c[(o,sq), (to(m,q'), ti)] rows.
    # The inner all_to_all buckets are addressed by *physical* inner rank, so
    # the bucket for rank qp carries the rows of whatever role qp plays.
    def s1_bucket_rows(g: int, qp: int) -> list[int]:
        o = g // p_inner
        rows: list[int] = []
        for m in range(n_macro):
            d = valid_d(m, inv[o][qp])
            if d is None:
                continue
            to = (o + d) % p_outer
            for ti in range(p_inner):
                tgt = to * p_inner + ti
                rows.extend(range(int(sd[g, tgt]), int(sd[g, tgt] + c[g, tgt])))
        return rows

    b1 = np.zeros((p, p_inner), np.int64)
    for g in range(p):
        for qp in range(p_inner):
            b1[g, qp] = len(s1_bucket_rows(g, qp))
    s1_cap = 0
    if remote_needed:
        s1_cap = max(round_up(int(b1.max(initial=0)), tile_rows), tile_rows)

    s1_src = np.zeros((p, p_inner * s1_cap), np.int32)
    s1_valid = np.zeros((p, p_inner * s1_cap), bool)
    if remote_needed:
        for g in range(p):
            for qp in range(p_inner):
                rows = s1_bucket_rows(g, qp)
                off = qp * s1_cap
                s1_src[g, off:off + len(rows)] = rows
                s1_valid[g, off:off + len(rows)] = True

    # Offset of the (m, ti) block inside bucket (sq -> q') — needed to
    # address stage-1 recv rows when building stage-2 slabs.
    def s1_block_off(g: int, qp: int, m_want: int, ti_want: int) -> int:
        o = g // p_inner
        off = 0
        for m in range(n_macro):
            d = valid_d(m, inv[o][qp])
            if d is None:
                continue
            to = (o + d) % p_outer
            for ti in range(p_inner):
                if m == m_want and ti == ti_want:
                    return off
                off += int(c[g, to * p_inner + ti])
        raise KeyError((g, qp, m_want, ti_want))

    # --- stage-2 slab capacities + permutations ---------------------------
    s2_caps = []
    round_perms = []
    for m in range(n_macro):
        cap_m = 0
        perm_m = []
        for o in range(p_outer):
            for q in range(p_inner):
                d = valid_d(m, q)
                if d is None:
                    continue
                to = (o + d) % p_outer
                if cross[o, to] == 0:
                    continue       # empty slab: dropped from the permutation
                cap_m = max(cap_m, int(cross[o, to]))
                perm_m.append((o * p_inner + perm[o][q],
                               to * p_inner + perm[to][q]))
        s2_caps.append(0 if cap_m == 0 else
                       max(round_up(cap_m, tile_rows), tile_rows))
        round_perms.append(tuple(perm_m))
    s2_offs = np.concatenate([[0], np.cumsum(s2_caps)]).astype(int)[:-1] \
        if s2_caps else np.zeros(0, int)
    total_s2 = int(np.sum(s2_caps)) if s2_caps else 0
    cross_group_puts = int(sum(len(pm) for pm in round_perms))

    # --- stage-2 gather: leader (o, q) builds slab m from stage-1 recv ----
    # Slab rows in order: for sq, for ti: c[(o,sq), (to,ti)] rows.  The
    # (sq -> q) bucket landed at stage-1 recv offset sq * s1_cap.
    s2_src = np.zeros((p, total_s2), np.int32)
    s2_valid = np.zeros((p, total_s2), bool)
    for g in range(p):
        o, q = g // p_inner, g % p_inner
        for m in range(n_macro):
            d = valid_d(m, inv[o][q])
            if d is None or s2_caps[m] == 0:
                continue
            to = (o + d) % p_outer
            if cross[o, to] == 0:
                continue
            pos = int(s2_offs[m])
            for sq in range(p_inner):
                gs = o * p_inner + sq
                for ti in range(p_inner):
                    n = int(c[gs, to * p_inner + ti])
                    if n == 0:
                        continue
                    base = sq * s1_cap + s1_block_off(gs, q, m, ti)
                    s2_src[g, pos:pos + n] = np.arange(base, base + n)
                    s2_valid[g, pos:pos + n] = True
                    pos += n

    # Offset of the (sq, ti) block inside the (so -> o) slab.
    def slab_block_off(so: int, o: int, sq_want: int, ti_want: int) -> int:
        off = 0
        for sq in range(p_inner):
            for ti in range(p_inner):
                if sq == sq_want and ti == ti_want:
                    return off
                off += int(c[so * p_inner + sq, o * p_inner + ti])
        raise KeyError((so, o, sq_want, ti_want))

    # --- stage-3 scatter: leader (o, q) -> local rank (o, ti) -------------
    # Bucket rows: for each valid macro-round (remote slab from so(m, q)),
    # for sq: the c[(so,sq), (o,ti)] rows out of the stage-2 recv buffer;
    # then the leader's own local rows c[(o,q), (o,ti)] straight from the
    # send buffer (index space: concat(stage-2 recv, send buffer)).
    def s3_bucket(g: int, ti: int) -> list[int]:
        o, q = g // p_inner, g % p_inner
        rows: list[int] = []
        for m in range(n_macro):
            d = valid_d(m, inv[o][q])
            if d is None or s2_caps[m] == 0:
                continue
            so = (o - d) % p_outer
            if cross[so, o] == 0:
                continue
            for sq in range(p_inner):
                n = int(c[so * p_inner + sq, o * p_inner + ti])
                base = int(s2_offs[m]) + slab_block_off(so, o, sq, ti)
                rows.extend(range(base, base + n))
        tgt = o * p_inner + ti
        n = int(c[g, tgt])
        rows.extend(range(total_s2 + int(sd[g, tgt]),
                          total_s2 + int(sd[g, tgt]) + n))
        return rows

    b3 = np.zeros((p, p_inner), np.int64)
    for g in range(p):
        for ti in range(p_inner):
            b3[g, ti] = len(s3_bucket(g, ti))
    s3_cap = max(round_up(int(b3.max(initial=0)), tile_rows), tile_rows)

    s3_src = np.zeros((p, p_inner * s3_cap), np.int32)
    s3_valid = np.zeros((p, p_inner * s3_cap), bool)
    for g in range(p):
        for ti in range(p_inner):
            rows = s3_bucket(g, ti)
            off = ti * s3_cap
            s3_src[g, off:off + len(rows)] = rows
            s3_valid[g, off:off + len(rows)] = True

    # Offset of source rank gs's rows inside the (q -> ti) stage-3 bucket.
    def s3_block_off(g_leader: int, ti: int, gs_want: int) -> int:
        o, q = g_leader // p_inner, g_leader % p_inner
        off = 0
        for m in range(n_macro):
            d = valid_d(m, inv[o][q])
            if d is None or s2_caps[m] == 0:
                continue
            so = (o - d) % p_outer
            if cross[so, o] == 0:
                continue
            for sq in range(p_inner):
                gs = so * p_inner + sq
                if gs == gs_want:
                    return off
                off += int(c[gs, o * p_inner + ti])
        if gs_want == g_leader:
            return off
        raise KeyError((g_leader, ti, gs_want))

    # --- final unpack: rank (o, ti) reorders stage-3 recv by source rank --
    unpack_src = np.zeros((p, recv_rows), np.int32)
    unpack_valid = np.zeros((p, recv_rows), bool)
    for gr in range(p):
        o, ti = gr // p_inner, gr % p_inner
        for gs in range(p):
            n = int(c[gs, gr])
            if n == 0:
                continue
            so, sq = gs // p_inner, gs % p_inner
            if so == o:
                q = sq                      # local rows ride their own rank's bucket
            else:
                _, role = hier_leader_of(so, o, p_outer, p_inner)
                q = perm[o][role]           # physical rank playing that role
            base = q * s3_cap + s3_block_off(o * p_inner + q, ti, gs)
            out = int(rd[gr, gs])
            unpack_src[gr, out:out + n] = np.arange(base, base + n)
            unpack_valid[gr, out:out + n] = True

    return HierSchedule(
        p_outer=p_outer, p_inner=p_inner, n_macro=n_macro,
        remote_needed=remote_needed,
        s1_cap=s1_cap, s2_caps=tuple(int(x) for x in s2_caps),
        s2_offs=tuple(int(x) for x in s2_offs), total_s2=total_s2,
        s3_cap=s3_cap, round_perms=tuple(round_perms),
        cross_group_puts=cross_group_puts, leader_perm=perm,
        s1_src=s1_src, s1_valid=s1_valid, s2_src=s2_src, s2_valid=s2_valid,
        s3_src=s3_src, s3_valid=s3_valid,
        unpack_src=unpack_src, unpack_valid=unpack_valid)


def hier_stage2_from(schedule: HierSchedule) -> np.ndarray:
    """``[P, n_macro]`` int32: the leader each rank receives macro-round
    ``m``'s slab from (``schedule.round_perms[m]``'s pair), or -1 where it
    receives none.  K5 reads it in place of the per-round permutations."""
    p = schedule.p_outer * schedule.p_inner
    src = np.full((p, schedule.n_macro), -1, np.int32)
    for m, perm in enumerate(schedule.round_perms):
        for s, d in perm:
            src[d, m] = s
    return src


def hier_row_rounds(schedule: HierSchedule) -> np.ndarray:
    """``[total_s2]`` int16: the macro-round whose slab holds each stage-2
    row (rounds of capacity 0 hold none)."""
    if schedule.n_macro > np.iinfo(np.int16).max:
        raise ValueError(f"{schedule.n_macro} macro-rounds overflow int16")
    return np.repeat(np.arange(schedule.n_macro, dtype=np.int16),
                     np.asarray(schedule.s2_caps, np.int64))


@dataclasses.dataclass(frozen=True)
class PatternSignature:
    """Hashable identity of a communication pattern (the plan-cache key).

    Mirrors the paper's window-reuse rule: a plan (and its window) is reused
    while the pattern — and hence ``total_recv_bytes`` — is unchanged; any
    change in counts/shape/dtype forces re-INIT.
    """

    digest: str
    p: int
    feature_shape: tuple[int, ...]
    dtype: str
    variant: str
    axis: tuple[str, ...]
    total_recv_bytes: int
    # Mesh factorization, kept as an explicit field (not only inside the
    # digest) so the plan store can key and validate entries on it.
    axis_sizes: tuple[int, ...] = ()
    # Wire codec, an explicit field for the same reason: a plan persisted
    # with an int8 wire must never warm-start an identity INIT.
    codec: str = "identity"
    # Per-group leader permutation for the hierarchical variant; () means
    # identity (round-robin).  Explicit so rebaked schedules never alias the
    # round-robin artifact in the store.
    hier_leader_perm: tuple[tuple[int, ...], ...] = ()
    # Exchange pattern family (core.patterns).  "alltoallv" is the founding
    # collective and keys exactly as before this dimension existed; other
    # families (allgatherv, reduce_scatter) perturb the digest so their
    # plans and artifacts never alias an alltoallv entry.
    collective: str = "alltoallv"

    @staticmethod
    def build(
        send_counts: np.ndarray,
        feature_shape: Sequence[int],
        dtype,
        variant: str,
        axis: Sequence[str],
        row_bytes: int,
        lock_schedule: str = "ring",
        tile_rows: int = TILE_ROWS,
        pack_impl: str = "jnp",
        baked_metadata: bool = True,
        axis_sizes: Sequence[int] = (),
        codec: str = "identity",
        hier_leader_perm: Sequence[Sequence[int]] = (),
        collective: str = "alltoallv",
    ) -> "PatternSignature":
        # Every spec field that changes the compiled executable must land in
        # the digest: two specs differing only in lock_schedule / tile_rows /
        # pack_impl / baked_metadata compile different START programs and
        # must not share one cached plan.  axis_sizes distinguishes mesh
        # factorizations that share axis *names* — a (2, 4) and a (4, 2)
        # grouped mesh bake entirely different two-stage schedules.
        c = _as_counts(send_counts)
        # Canonical dtype spelling: torch.float32, np.float32, "float32" and
        # np.dtype("float32") must key identically, and equal to the JAX
        # package's digest for the same spec.
        dtype_str = dtype_name(dtype)
        h = hashlib.sha1()
        h.update(c.tobytes())
        h.update(str((tuple(feature_shape), dtype_str, variant, tuple(axis),
                      lock_schedule, int(tile_rows), pack_impl,
                      bool(baked_metadata),
                      tuple(int(s) for s in axis_sizes))).encode())
        if codec != "identity":
            # Conditional so identity digests are byte-identical to the
            # pre-codec era — an identity plan keys (and warm-starts)
            # exactly as before this dimension existed.
            h.update(("codec:" + codec).encode())
        lp = tuple(tuple(int(x) for x in row) for row in hier_leader_perm)
        if lp and not leader_perm_is_identity(lp):
            # Same conditional rule as codec: only a non-identity leader
            # permutation perturbs the digest, so round-robin plans keep
            # their historical keys while rebaked schedules never alias.
            h.update(("leader_perm:" + repr(lp)).encode())
        else:
            lp = ()
        if collective != "alltoallv":
            # Conditional for the same reason again: alltoallv digests are
            # byte-identical to the pre-patterns era, so every stored
            # alltoallv artifact keeps warm-starting without a re-bake.
            h.update(("collective:" + collective).encode())
        return PatternSignature(
            digest=h.hexdigest()[:16],
            p=c.shape[0],
            feature_shape=tuple(int(s) for s in feature_shape),
            dtype=dtype_str,
            variant=variant,
            axis=tuple(axis),
            total_recv_bytes=int(c.sum()) * row_bytes,
            axis_sizes=tuple(int(s) for s in axis_sizes),
            codec=codec,
            hier_leader_perm=lp,
            collective=collective,
        )
