"""Leader election for the hierarchical exchange: health-weighted re-bake
(port of ``repro.runtime.leader``).

The leader-combined hierarchy concentrates all cross-group traffic on a
few per-group leader roles (``core.metadata.hier_two_stage_schedule``).
Leadership is INIT-baked, round-robin over the inner axis by default, so a
rank that degrades at runtime keeps carrying combined slabs every
macro-round and taxes every group pair it leads.

This module turns leadership into a modeled decision:

* ``rank_health``: per-rank slowdown factors from the observed per-rank
  epoch rings (``EXEC_TELEMETRY.rank_rings``, fed by the train loop's rank
  probe).  1.0 is nominal; 3.0 means that rank's epochs run 3x the
  across-rank median.
* ``role_carry``: rows each leader *role* of each group carries per epoch
  (send + receive slabs), from the cross-group traffic matrix.  Role carry
  is a pure function of the pattern: under sparse patterns (or
  ``p_outer <= p_inner``) some roles carry nothing, which is exactly the
  slack a re-bake exploits.
* ``choose_leader_perm``: per-group assignment of roles to physical inner
  ranks: heaviest roles go to healthiest ranks, degraded (or excluded)
  ranks are demoted toward carry-free roles.  Uniform health yields the
  identity permutation, so the default schedule is unchanged.
* ``permutation_cost``: the modeled epoch bottleneck, max over ranks of
  ``carry(role(rank)) * health(rank)``; ``ReplanManager`` uses it to skip
  re-bakes that cannot help (no carry-free role to hide a slow rank in).

Everything here is host-side numpy over telemetry summaries: no
measurement bursts, no device work.  The schedule bake the chosen
permutation feeds (``hier_two_stage_schedule(leader_perm=...)``) is the
only cost a leader re-bake pays.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core import metadata as md
from ..core._exec_stats import EXEC_TELEMETRY


def rank_health(digest: str, p: int) -> np.ndarray:
    """Per-rank slowdown factors from the plan's rank rings.

    health[r] = rank r's p50 epoch time over the across-rank median p50;
    ranks with no samples get 1.0 (no evidence is not a demotion).  With
    fewer than two sampled ranks there is no median to anchor on and the
    result is all-ones.
    """
    health = np.ones(p, np.float64)
    per_rank = {r: s["p50_s"]
                for r, s in EXEC_TELEMETRY.rank_summary(digest).items()
                if s.get("count") and 0 <= r < p}
    if len(per_rank) < 2:
        return health
    med = float(np.median(list(per_rank.values())))
    if med <= 0.0:
        return health
    for r, p50 in per_rank.items():
        health[r] = max(p50 / med, 1e-9)
    return health


def role_carry(send_counts: np.ndarray, p_outer: int,
               p_inner: int) -> np.ndarray:
    """Rows role ``q`` of group ``o`` carries per epoch, ``[p_outer, p_inner]``.

    A role carries the slabs it sends (group o -> to at its ring offsets)
    plus the slabs it receives (so -> o at the same offsets): both sides
    serialize on that rank in stages 2/3.  Offsets past ``p_outer`` (and
    empty slabs) contribute nothing, so the matrix directly exposes
    carry-free roles a demotion can use.
    """
    c = np.asarray(send_counts, np.int64)
    p = p_outer * p_inner
    if c.shape != (p, p):
        raise ValueError(f"counts {c.shape} != ({p}, {p})")
    grp = np.arange(p) // p_inner
    cross = np.zeros((p_outer, p_outer), np.int64)
    for o in range(p_outer):
        for to in range(p_outer):
            if o != to:
                cross[o, to] = c[np.ix_(grp == o, grp == to)].sum()
    n_macro = -(-(p_outer - 1) // p_inner) if p_outer > 1 else 0
    carry = np.zeros((p_outer, p_inner), np.int64)
    for o in range(p_outer):
        for q in range(p_inner):
            for m in range(n_macro):
                d = md.hier_offset(m, q, p_inner)
                if d >= p_outer:
                    continue
                carry[o, q] += cross[o, (o + d) % p_outer]      # sends
                carry[o, q] += cross[(o - d) % p_outer, o]      # receives
    return carry


def permutation_cost(send_counts: np.ndarray, p_outer: int, p_inner: int,
                     leader_perm, health: np.ndarray) -> float:
    """Modeled epoch bottleneck of one leader assignment.

    The inter-group epoch is gated by its slowest carrier: cost is the max
    over ranks of ``carry[o, role(rank)] * health[rank]``.  Row units:
    only relative comparisons between permutations are meaningful.
    """
    perm = md.normalize_leader_perm(leader_perm, p_outer, p_inner)
    carry = role_carry(send_counts, p_outer, p_inner)
    h = np.asarray(health, np.float64).reshape(p_outer, p_inner)
    cost = 0.0
    for o in range(p_outer):
        for role in range(p_inner):
            rank = perm[o][role]
            cost = max(cost, float(carry[o, role]) * float(h[o, rank]))
    return cost


def choose_leader_perm(
    send_counts: np.ndarray,
    p_outer: int,
    p_inner: int,
    health: np.ndarray | None = None,
    exclude: Sequence[int] = (),
) -> tuple[tuple[int, ...], ...]:
    """Health-weighted role assignment, one permutation row per group.

    Per group, roles sorted by descending carry are matched to inner ranks
    sorted by ascending (excluded, health, rank): the heaviest slab work
    lands on the healthiest rank, and an excluded rank (``exclude`` holds
    *global* rank ids, e.g. ``SkewReport.worst_rank``) only gets a carrying
    role when every carry-free role is already taken.  Ties break toward
    the identity assignment, so uniform health returns identity and the
    digest (and schedule) are unchanged.
    """
    carry = role_carry(send_counts, p_outer, p_inner)
    p = p_outer * p_inner
    h = (np.ones(p, np.float64) if health is None
         else np.asarray(health, np.float64))
    if h.shape != (p,):
        raise ValueError(f"health must be [{p}], got {h.shape}")
    excluded = {int(r) for r in exclude}
    perm = []
    for o in range(p_outer):
        # Heaviest role first, each picking the best remaining rank:
        # healthy before excluded, then lowest health factor, then the
        # role's own rank, so uniform health (and no exclusions) is the
        # identity fixed point and the digest stays unchanged.
        roles = sorted(range(p_inner), key=lambda q: (-int(carry[o, q]), q))
        avail = set(range(p_inner))
        row = [0] * p_inner
        for role in roles:
            rank = min(avail, key=lambda r: (
                int(o * p_inner + r in excluded),
                float(h[o * p_inner + r]), r != role, r))
            row[role] = rank
            avail.remove(rank)
        perm.append(tuple(row))
    return tuple(perm)
