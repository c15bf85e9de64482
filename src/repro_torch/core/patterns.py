"""Exchange patterns: the collective-agnostic core of a persistent plan (port
of ``repro.core.patterns``).

Any collective whose communication pattern is frozen can bake its metadata
once and replay it every epoch.  An ``ExchangePattern`` holds what varies
between collective families:

  * count derivation: how the user-facing counts (a ``[P, P]`` matrix for
    alltoallv, a ``[P]`` vector for allgatherv / reduce-scatter) expand into
    the square send-count matrix the shared machinery consumes,
  * buffer geometry: which side of the exchange is ragged per rank,
  * pack/unpack table baking, with reduce-scatter's reduction fused into the
    exchange,
  * identity-map detection (the uniform tile-aligned fast path),
  * the numpy oracle the tests compare against,
  * the variants that can implement the pattern.

``ExchangePlan`` (core.plan) holds one pattern and takes its geometry,
tables and identity detection from it.  The port runs P virtual ranks on
one device, so the exchanges take the global view with a leading rank
dimension: allgatherv's own buckets ``[P, C, *F]`` become ``[P, P*C, *F]``;
reduce-scatter's bucketed ``[P, P*C, *F]`` becomes ``[P, C, *F]``.

  allgatherv      fence: every rank's bucket replicated into every rank
                  (the JAX package's ``lax.all_gather``; plain tensor ops);
                  lock: a ring of P-1 bucket copies; fence_hierarchy: an
                  inner gather, then an outer one, over the (outer, inner)
                  grid (outer-major ranks, so the result is in global order).
  reduce_scatter  fence: the fence epoch (``variants.fence_exchange``, K2 on
                  a card), then a sum of the P contributions in rank order;
                  lock: ring accumulation in the JAX order, rank i adding the
                  bucket of rank i - r in round r.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..kernels import ops as kops
from ..roofline.trace import per_rank_bytes, report_collective
from . import metadata as md
from . import variants

COLLECTIVES = ("alltoallv", "allgatherv", "reduce_scatter")


def _counts_vector(counts, p_hint: int | None = None) -> np.ndarray:
    c = np.asarray(counts, np.int64)
    if c.ndim != 1:
        raise ValueError(f"counts must be a [P] vector, got shape {c.shape}")
    if np.any(c < 0):
        raise ValueError("counts must be non-negative")
    if p_hint is not None and c.shape[0] != p_hint:
        raise ValueError(f"counts length {c.shape[0]} != P {p_hint}")
    return c


class ExchangePattern:
    """One collective family's pattern-specific pieces.

    Concrete patterns are stateless singletons; ``get(name)`` resolves them.
    Every method takes the *expanded* square count matrix ``sc``.
    """

    name: str = ""
    #: variants that can implement this pattern
    supported_variants: tuple[str, ...] = ()
    #: whether non-identity wire codecs are meaningful for this pattern
    supports_codec: bool = False

    def expand_counts(self, counts) -> np.ndarray:
        raise NotImplementedError

    def validate_matrix(self, sc: np.ndarray) -> None:
        """Cheap structural check that ``sc`` is derivable for this family."""

    def send_rows(self, sc: np.ndarray, tile_rows: int) -> int:
        raise NotImplementedError

    def recv_rows(self, sc: np.ndarray, tile_rows: int) -> int:
        raise NotImplementedError

    def bake_tables(self, sc: np.ndarray, capacity: int,
                    recv_rows: int) -> md.BakedIndexTables:
        raise NotImplementedError

    def table_shapes(self, p: int, capacity: int, recv_rows: int
                     ) -> tuple[tuple[int, int], tuple[int, int]]:
        """Expected (pack_src, unpack_src) shapes: warm-start validation."""
        raise NotImplementedError

    def identity_maps(self, sc: np.ndarray, capacity: int,
                      send_rows: int, recv_rows: int) -> bool:
        raise NotImplementedError

    def reference(self, sendbufs: np.ndarray, counts,
                  recv_rows: int) -> np.ndarray:
        """Numpy oracle on the global view; ``counts`` in user-facing form."""
        raise NotImplementedError

    def build_exchange(self, plan) -> Callable:
        """The bare move for this pattern (variant-dispatched), over every
        rank at once.  Also the whole epoch on the identity fast path.
        Only non-alltoallv patterns provide it: the alltoallv body lives
        in ``ExchangePlan`` itself."""
        raise NotImplementedError

    def build_epoch(self, plan) -> Callable:
        """``fn(x, psrc, pvalid, rsrc, rvalid) -> out``: pack ->
        ``build_exchange`` -> unpack.  Invalid output rows are zero; the
        caller owns the window write-through."""
        exchange = self.build_exchange(plan)

        def epoch(x, psrc, pvalid, rsrc, rvalid):
            moved = exchange(variants.pack_rows(x, psrc, pvalid))
            return variants.unpack_rows(moved, rsrc, rvalid)

        return epoch


class AlltoallvPattern(ExchangePattern):
    """The founding collective: counts are already the square matrix."""

    name = "alltoallv"
    supported_variants = ("fence", "lock", "fence_hierarchy", "ragged")
    supports_codec = True

    def expand_counts(self, counts) -> np.ndarray:
        return md._as_counts(counts)

    def send_rows(self, sc, tile_rows):
        return max(md.round_up(md.max_total_send(sc), tile_rows), tile_rows)

    def recv_rows(self, sc, tile_rows):
        return max(md.round_up(md.max_total_recv(sc), tile_rows), tile_rows)

    def bake_tables(self, sc, capacity, recv_rows):
        return md.baked_index_tables(sc, capacity, recv_rows)

    def table_shapes(self, p, capacity, recv_rows):
        return (p, p * capacity), (p, recv_rows)

    def identity_maps(self, sc, capacity, send_rows, recv_rows):
        return bool(sc.size > 0 and (sc == capacity).all()
                    and send_rows == sc.shape[0] * capacity
                    and recv_rows == sc.shape[0] * capacity)

    def reference(self, sendbufs, counts, recv_rows):
        from . import reference
        return reference.alltoallv_global(sendbufs, counts, recv_rows)


class AllgathervPattern(ExchangePattern):
    """Everyone receives the concatenation of every rank's contribution.

    ``counts[i]`` = rows rank i contributes; the send matrix is row-constant
    (``sc[i, j] = counts[i]``) but each contribution moves once per target:
    pack gathers the own ``[C, *F]`` bucket, the exchange replicates it, and
    the result is the alltoallv fence bucket layout, so the standard unpack
    tables apply.
    """

    name = "allgatherv"
    supported_variants = ("fence", "lock", "fence_hierarchy")
    supports_codec = False

    def expand_counts(self, counts) -> np.ndarray:
        c = _counts_vector(counts)
        return np.repeat(c[:, None], c.shape[0], axis=1)

    def validate_matrix(self, sc) -> None:
        if sc.size and not (sc == sc[:, :1]).all():
            raise ValueError("allgatherv count matrix must be row-constant "
                             "(sc[i, j] = counts[i])")

    def send_rows(self, sc, tile_rows):
        # The send buffer holds ONE contribution, not P buckets.
        return md.global_capacity(sc, tile_rows)

    def recv_rows(self, sc, tile_rows):
        return max(md.round_up(md.max_total_recv(sc), tile_rows), tile_rows)

    def bake_tables(self, sc, capacity, recv_rows):
        p = sc.shape[0]
        c_vec = sc[:, 0] if sc.size else np.zeros(p, np.int64)
        k = np.arange(capacity, dtype=np.int64)
        pack_valid = k[None, :] < c_vec[:, None]           # [P, C]
        pack_src = np.where(pack_valid, k[None, :], 0).astype(np.int32)
        rc = md.recv_counts(sc)
        rd = md.displacements(rc)
        unpack_src = np.zeros((p, recv_rows), np.int32)
        unpack_valid = np.zeros((p, recv_rows), bool)
        for i in range(p):
            unpack_src[i], unpack_valid[i] = md.unpack_index_map(
                rc[i], rd[i], capacity, recv_rows)
        return md.BakedIndexTables(pack_src, pack_valid,
                                   unpack_src, unpack_valid)

    def table_shapes(self, p, capacity, recv_rows):
        return (p, capacity), (p, recv_rows)

    def identity_maps(self, sc, capacity, send_rows, recv_rows):
        return bool(sc.size > 0 and (sc == capacity).all()
                    and send_rows == capacity
                    and recv_rows == sc.shape[0] * capacity)

    def reference(self, sendbufs, counts, recv_rows):
        bufs = np.asarray(sendbufs)
        c = _counts_vector(counts, bufs.shape[0])
        p = c.shape[0]
        out = np.zeros((p, recv_rows) + bufs.shape[2:], bufs.dtype)
        off = 0
        for i in range(p):
            n = int(c[i])
            out[:, off:off + n] = bufs[i, :n][None]
            off += n
        return out

    def build_exchange(self, plan) -> Callable:
        """``fn(own [P, C, *F]) -> buckets [P, P*C, *F]`` in global order."""
        spec = plan.spec
        p, cap = plan.p, plan.capacity

        def exchange(own):
            f = tuple(own.shape[2:])
            report_collective("all-gather", p * per_rank_bytes(own), p)
            if spec.variant == "fence_hierarchy":
                # Inner gather within each group, then outer gather across
                # groups: outer-major ranks, so the result is global order.
                po, pi = plan.p_outer, plan.p_inner
                inner = own.reshape((po, 1, pi * cap) + f).expand(
                    (po, pi, pi * cap) + f).contiguous()
                outer = inner.transpose(0, 1).reshape((1, pi, p * cap) + f)
                return outer.expand((po, pi, p * cap) + f).reshape(
                    (p, p * cap) + f).contiguous()
            if spec.variant == "fence":
                return own.reshape((1, p * cap) + f).expand(
                    (p, p * cap) + f).contiguous()
            # lock: a ring of P-1 bucket copies; in round r rank i receives
            # the bucket of rank i - r.
            buckets = own.new_zeros((p, p, cap) + f)
            ranks = torch.arange(p, device=own.device)
            buckets[ranks, ranks] = own
            for r in range(1, p):
                src = (ranks - r) % p
                buckets[ranks, src] = own[src]
            return buckets.reshape((p, p * cap) + f)

        return exchange


class ReduceScatterPattern(ExchangePattern):
    """Each destination receives the element-wise SUM of its blocks.

    ``counts[j]`` = rows destined for rank j; the send matrix is column-
    constant (``sc[i, j] = counts[j]``) and the standard pack tables apply.
    The P received buckets are summed (pack masking zeroed invalid rows, so
    the sum is exact) and the unpack keeps this rank's valid rows.  The
    leader-combined hierarchy and wire codecs are forbidden.
    """

    name = "reduce_scatter"
    supported_variants = ("fence", "lock")
    supports_codec = False

    def expand_counts(self, counts) -> np.ndarray:
        c = _counts_vector(counts)
        return np.repeat(c[None, :], c.shape[0], axis=0)

    def validate_matrix(self, sc) -> None:
        if sc.size and not (sc == sc[:1, :]).all():
            raise ValueError("reduce_scatter count matrix must be column-"
                             "constant (sc[i, j] = counts[j])")

    def send_rows(self, sc, tile_rows):
        return max(md.round_up(md.max_total_send(sc), tile_rows), tile_rows)

    def recv_rows(self, sc, tile_rows):
        # The recv buffer holds ONE reduced bucket, not P.
        return md.global_capacity(sc, tile_rows)

    def bake_tables(self, sc, capacity, recv_rows):
        p = sc.shape[0]
        c_vec = sc[0, :] if sc.size else np.zeros(p, np.int64)
        sd = md.displacements(sc)
        pack_src = np.zeros((p, p * capacity), np.int32)
        pack_valid = np.zeros((p, p * capacity), bool)
        for i in range(p):
            pack_src[i], pack_valid[i] = md.pack_index_map(
                sc[i], sd[i], capacity)
        k = np.arange(recv_rows, dtype=np.int64)
        unpack_valid = k[None, :] < c_vec[:, None]          # [P, recv_rows]
        unpack_src = np.where(unpack_valid, k[None, :], 0).astype(np.int32)
        return md.BakedIndexTables(pack_src, pack_valid,
                                   unpack_src, unpack_valid)

    def table_shapes(self, p, capacity, recv_rows):
        return (p, p * capacity), (p, recv_rows)

    def identity_maps(self, sc, capacity, send_rows, recv_rows):
        return bool(sc.size > 0 and (sc == capacity).all()
                    and send_rows == sc.shape[0] * capacity
                    and recv_rows == capacity)

    def reference(self, sendbufs, counts, recv_rows):
        bufs = np.asarray(sendbufs)
        c = _counts_vector(counts, bufs.shape[0])
        p = c.shape[0]
        sd = np.concatenate([[0], np.cumsum(c)[:-1]])
        out = np.zeros((p, recv_rows) + bufs.shape[2:], bufs.dtype)
        for j in range(p):
            n = int(c[j])
            if n == 0:
                continue
            out[j, :n] = bufs[:, sd[j]:sd[j] + n].sum(axis=0)
        return out

    def build_exchange(self, plan) -> Callable:
        """``fn(packed [P, P*C, *F]) -> summed [P, C, *F]``: the exchange and
        the reduction over the P received contributions."""
        spec = plan.spec
        p, cap = plan.p, plan.capacity

        def exchange(packed):
            f = tuple(packed.shape[2:])
            report_collective("reduce-scatter", per_rank_bytes(packed) // p, p)
            if spec.variant == "fence":
                # buckets[i, s] holds rank s's block for i: sum in rank order
                # (the bucket exchange itself, K2, reports no all-to-all).
                buckets = kops.rma_alltoallv(
                    packed, variant="fence", p=p, capacity=cap).view(
                    (p, p, cap) + f)
                acc = buckets[:, 0]
                for s in range(1, p):
                    acc = acc + buckets[:, s]
                return acc
            # lock: ring accumulation; round r ships rank i's bucket for
            # i + r and adds the bucket arriving from i - r.
            blocks = packed.view((p, p, cap) + f)
            ranks = torch.arange(p, device=packed.device)
            acc = blocks[ranks, ranks]
            for r in range(1, p):
                acc = acc + blocks[(ranks - r) % p, ranks]
            return acc

        return exchange


_PATTERNS: dict[str, ExchangePattern] = {
    p.name: p for p in (AlltoallvPattern(), AllgathervPattern(),
                        ReduceScatterPattern())
}


def get(name: str) -> ExchangePattern:
    try:
        return _PATTERNS[name]
    except KeyError:
        raise ValueError(
            f"unknown collective {name!r}; have {sorted(_PATTERNS)}") from None


def as_matrix(collective: str, counts) -> np.ndarray:
    """User-facing counts -> the expanded square ``[P, P]`` matrix.

    Accepts the family's natural form (a ``[P]`` vector for allgatherv /
    reduce_scatter) or an already-expanded matrix, which is validated
    against the family."""
    pat = get(collective)
    c = np.asarray(counts)
    if c.ndim == 2:
        m = md._as_counts(c)
        pat.validate_matrix(m)
        return m
    return pat.expand_counts(c)
