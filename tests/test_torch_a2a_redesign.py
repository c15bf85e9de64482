"""The redesigned K4 (one clustered launch per lock epoch) and K3 (bulk-copy
gather) on the CPU: their kernel-choice rules and launch plans.

Neither kernel runs here (``chip_smoke.py`` holds both against their plain
versions and the kernels they replaced on the card).  The wrappers decide in
plain Python what the kernels compute: the rules ``a2a_lock.kernel_choice``
and ``a2a_fence.fused_kernel_choice``, K4's cluster size and round table,
K3's tile height.  The launch plans the CUDA loops build from them are
written out below as this module's oracles: the byte ranges K4's CTAs split
each bucket into (``lock_cluster_ranges``, as ``bulk::split`` and ``Stream``
in the ``.cu`` source), K3's tiles and the runs of consecutive source rows
each tile's bulk loads cover (``fused_tiles``, ``tile_runs``, as the
kernel's cursor and its shuffle and ballot).  Each plan is enacted in numpy
over raw bytes and compared bit for bit with the JAX package's oracles
(``repro.kernels.ref``: the pack gather, then the bucketed exchange, with
each received lock bucket cut to its round's capacity) and with the port's
plain version, over P in {2, 4, 8, 64}, ring and pairwise schedules,
banded, skewed and all-local counts and small row widths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.core import PlanCache, alltoallv_init
from repro_torch.core import metadata as md
from repro_torch.kernels import a2a_fence, a2a_lock
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.testing.patterns import (banded_counts, hugetrace_like_counts,
                                          random_counts)

BASE = 0x7F00_0000_0000  # a 256-byte aligned device address
# cudaOccupancyMaxActiveClusters for the cluster kernel on an H100 (one CTA
# per SM), by cluster size.
H100_ACTIVE = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


def counts_for(pattern: str, p: int) -> np.ndarray:
    if pattern == "banded":
        return banded_counts(p)
    if pattern == "skewed":
        return (hugetrace_like_counts(p, 3) if p >= 8
                else random_counts(p, 5, 9))
    return np.diag(np.arange(1, p + 1))  # all-local


CASES = [(p, pattern) for p in (2, 4, 8, 64)
         for pattern in ("banded", "skewed", "all-local")]


# --------------------------------------------------------------------------
# The kernels' launch plans, written out
# --------------------------------------------------------------------------


def schedule_phase(sched, ph: int) -> list[tuple[int, int]]:
    """Phase ``ph`` of a ``LockSchedule`` table, ``(round, capacity)``."""
    n, t = sched.n_entries, sched.table
    return [(int(t[e]), int(t[n + e]))
            for e in range(t[2 * n + ph], t[2 * n + ph + 1])]


def split16(nbytes: int, parts: int, part: int) -> tuple[int, int]:
    """The byte range ``[lo, hi)`` of ``nbytes`` (a multiple of 16) that CTA
    ``part`` of ``parts`` takes: an even split in 16-byte units
    (``bulk::split``)."""
    units = nbytes // 16
    return units * part // parts * 16, units * (part + 1) // parts * 16


def lock_cluster_ranges(p, capacity, row_width, sched, cluster,
                        pairwise=False) -> list[dict]:
    """Every byte range the cluster kernel moves, in its order: for each
    origin rank (cluster), phase, CTA of the cluster and entry of the phase,
    the copy ``packed[src : src + copy] -> out[dst : dst + copy]`` and the
    zero rows ``out[zero_dst : zero_dst + zero]``, as flat byte offsets."""
    bucket = capacity * row_width
    ranges = []
    for i in range(p):
        for ph in range(sched.n_phases):
            for c in range(cluster):
                for r, cap in schedule_phase(sched, ph):
                    tgt = (i ^ r) if pairwise else (i + r) % p
                    lo, hi = split16(cap * row_width, cluster, c)
                    zlo, zhi = split16(bucket - cap * row_width, cluster, c)
                    base = (tgt * p + i) * bucket
                    ranges.append({
                        "rank": i, "phase": ph, "cta": c, "round": r,
                        "src": (i * p + tgt) * bucket + lo, "dst": base + lo,
                        "copy": hi - lo,
                        "zero_dst": base + cap * row_width + zlo,
                        "zero": zhi - zlo})
    return ranges


def fused_tiles(p, capacity, row_width) -> list[tuple[int, int, int, int]]:
    """The bulk kernel's output tiles in order, ``(tgt, src, k0, rows)``:
    rows ``k0 .. k0 + rows`` of bucket ``(tgt, src)``, contiguous in
    ``out[tgt]`` from row ``src * C + k0``.  Block ``b`` of a grid of ``g``
    takes tiles ``b, b + g, ...`` (one tile per block below 2^24 tiles)."""
    t = a2a_fence.fused_tile_rows(row_width)
    return [(tgt, src, k0, min(t, capacity - k0))
            for tgt in range(p) for src in range(p)
            for k0 in range(0, capacity, t)]


def tile_runs(src_idx, valid) -> list[tuple[int, int, int]]:
    """The bulk loads of one tile, ``(row, source row, length)``: runs of
    valid rows whose source indices are consecutive (a row starts a run
    unless it continues the valid row before it)."""
    runs = []
    for j, (s, v) in enumerate(zip(src_idx, valid)):
        if not v:
            continue
        if runs and runs[-1][0] + runs[-1][2] == j and runs[-1][1] + runs[-1][2] == s:
            runs[-1] = (runs[-1][0], runs[-1][1], runs[-1][2] + 1)
        else:
            runs.append((j, int(s), 1))
    return runs


# --------------------------------------------------------------------------
# The rules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("device,width,addr,want", [
    ("cpu", 1024, BASE, "plain"),
    ("cpu", 60, BASE + 4, "plain"),
    ("cuda", 1024, BASE, "cluster"),
    ("cuda", 16, BASE + 16, "cluster"),
    ("cuda", 4096, BASE, "cluster"),
    ("cuda", 60, BASE, "step"),
    ("cuda", 1024, BASE + 4, "step"),
    ("cuda", 400, BASE + 8, "step"),
])
def test_lock_rule(device, width, addr, want):
    assert a2a_lock.kernel_choice(device, width, addr) == want


@pytest.mark.parametrize("device,width,addr,want", [
    ("cpu", 1024, BASE, "plain"),
    ("cuda", 1024, BASE, "bulk"),
    ("cuda", 400, BASE, "bulk"),
    ("cuda", 16, BASE, "bulk"),
    ("cuda", 32768, BASE, "bulk"),
    ("cuda", 60, BASE, "warp"),
    ("cuda", 1024, BASE + 4, "warp"),
    ("cuda", 32784, BASE, "warp"),
    ("cuda", 0, BASE, "warp"),
])
def test_fused_rule(device, width, addr, want):
    assert a2a_fence.fused_kernel_choice(device, width, addr) == want


@pytest.mark.parametrize("feature,dtype,lock,fused", [
    ((256,), "float32", "a2a_lock_cluster", "a2a_fence_fused_bulk"),
    ((2048,), "bfloat16", "a2a_lock_cluster", "a2a_fence_fused_bulk"),
    ((3, 5), "float32", "a2a_lock", "a2a_fence_fused"),
])
def test_plans_name_the_rule_kernels(feature, dtype, lock, fused):
    """A plan names the K3/K4 counter the rule gives its row width; CPU
    tensors take the plain versions."""
    mesh = VirtualMesh((4,), ("x",), device="cpu")
    counts = banded_counts(4)
    names = {}
    for variant, impl in (("lock", "pallas"), ("fence", "fused")):
        plan = alltoallv_init(counts, feature, dtype, mesh, axis="x",
                              variant=variant, pack_impl=impl, cache=PlanCache())
        names[variant] = {k.name for k in plan.kernels()}
    assert lock in names["lock"] and fused in names["fence"]
    x = torch.zeros((4, 8, 16))
    assert a2a_lock.kernel_for(x) == "plain"
    assert a2a_fence.fused_kernel_for(x) == "plain"


# --------------------------------------------------------------------------
# K4: one cluster per origin rank, one launch per epoch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("p,active,want", [
    (8, H100_ACTIVE, 8), (64, H100_ACTIVE, 2), (4, H100_ACTIVE, 16),
    (16, H100_ACTIVE, 4), (128, H100_ACTIVE, 1), (256, H100_ACTIVE, 1),
    (8, {1: 264, 2: 132, 4: 62, 8: 30, 16: 14}, 16),
    (64, {1: 264, 2: 132, 4: 62, 8: 30, 16: 14}, 2),
])
def test_lock_cluster_size(p, active, want):
    """The largest cluster for which every origin rank's cluster is resident
    at once: 8 CTAs at P=8, 2 at P=64 on an H100."""
    assert a2a_lock.lock_cluster_size(p, active) == want


def lock_case(p, pattern, sched, width):
    counts = counts_for(pattern, p)
    cap = md.global_capacity(counts)
    caps = (md.xor_round_capacities(counts) if sched == "pairwise"
            else md.ring_round_capacities(counts))
    packed = np.random.default_rng(p).integers(
        0, 256, (p, p * cap, width), dtype=np.uint8)
    return counts, cap, caps, packed


def enact_lock(ranges, packed, cap, width):
    """The cluster kernel's ranges applied to raw bytes; also counts how
    often each destination byte is written."""
    p = packed.shape[0]
    src = packed.reshape(-1)
    out = np.full(p * p * cap * width, 0xAB, np.uint8)
    writes = np.zeros(out.size, np.int32)
    for r in ranges:
        out[r["dst"]:r["dst"] + r["copy"]] = src[r["src"]:r["src"] + r["copy"]]
        out[r["zero_dst"]:r["zero_dst"] + r["zero"]] = 0
        writes[r["dst"]:r["dst"] + r["copy"]] += 1
        writes[r["zero_dst"]:r["zero_dst"] + r["zero"]] += 1
    return out.reshape(packed.shape), writes


@pytest.mark.parametrize("sched", ["ring", "pairwise"])
@pytest.mark.parametrize("p,pattern", CASES)
def test_lock_cluster_plan_matches_oracles(p, pattern, sched):
    """Every byte of every bucket written exactly once, in 16-byte aligned
    pieces, one cluster per origin rank and one phase per active round; the
    result equals the bucketed-exchange oracle cut to the round capacities
    and the port's plain version, bit for bit."""
    width = 32
    counts, cap, caps, packed = lock_case(p, pattern, sched, width)
    sched_t = a2a_lock.lock_schedule(p, cap, a2a_lock.caps_key(caps), sched)
    steps = a2a_lock.lock_steps(p, cap, caps, sched)
    assert sched_t.n_phases == len(steps) == max(
        1, md.active_round_schedule(caps).size)
    assert [schedule_phase(sched_t, ph) for ph in range(sched_t.n_phases)] == steps
    cluster = a2a_lock.lock_cluster_size(p, H100_ACTIVE)
    ranges = lock_cluster_ranges(p, cap, width, sched_t, cluster,
                                 pairwise=sched == "pairwise")
    assert {r["rank"] for r in ranges} == set(range(p))
    assert {r["cta"] for r in ranges} == set(range(cluster))
    for r in ranges:
        for key in ("src", "dst", "copy", "zero_dst", "zero"):
            assert r[key] % 16 == 0, (key, r)
    got, writes = enact_lock(ranges, packed, cap, width)
    assert (writes == 1).all()

    want = jax_ref.a2a_bucketed_ref(packed, p, cap)
    for i in range(p):
        for j in range(p):
            r = (i ^ j) if sched == "pairwise" else (i - j) % p
            keep = cap if r == 0 else min(int(caps[r]), cap)
            want[i, j * cap + keep:(j + 1) * cap] = 0
    np.testing.assert_array_equal(got, want)
    plain = a2a_lock.rma_alltoallv_lock_plain(torch.from_numpy(packed), p, cap,
                                              caps, sched)
    np.testing.assert_array_equal(got, plain.numpy())


def test_lock_schedule_is_built_once():
    """The round table is memoised per schedule, read-only, and folds the
    local and elided rounds into phase 0."""
    caps = md.ring_round_capacities(banded_counts(8))
    key = a2a_lock.caps_key(caps)
    a = a2a_lock.lock_schedule(8, 16, key, "ring")
    assert a2a_lock.lock_schedule(8, 16, a2a_lock.caps_key(list(caps)), "ring") is a
    assert not a.table.flags.writeable
    assert a.table.dtype == np.int32
    assert schedule_phase(a, 0)[0] == (0, 16)
    assert sorted(r for ph in range(a.n_phases)
                  for r, _ in schedule_phase(a, ph)) == list(range(8))
    assert a.table[-1] == a.n_entries == 8


# --------------------------------------------------------------------------
# K3: tiles inside one bucket, one bulk load per run
# --------------------------------------------------------------------------


@pytest.mark.parametrize("width,rows", [(1024, 8), (4096, 2), (16, 32),
                                        (400, 20), (800, 10), (16384, 1),
                                        (32768, 1)])
def test_fused_tile_rows(width, rows):
    """About 8 KiB of rows per tile (1 KiB f32 rows: 8; 4 KiB bf16 F=2048
    rows: 2), at most 32 rows (one table word per lane), at least one."""
    assert a2a_fence.fused_tile_rows(width) == rows


@pytest.mark.parametrize("src,valid,want", [
    ([3, 4, 5, 0, 9, 10], [1, 1, 1, 0, 1, 1], [(0, 3, 3), (4, 9, 2)]),
    ([7, 8, 9, 10], [1, 1, 1, 1], [(0, 7, 4)]),
    ([5, 4, 3], [1, 1, 1], [(0, 5, 1), (1, 4, 1), (2, 3, 1)]),
    ([2, 2, 3], [1, 1, 1], [(0, 2, 1), (1, 2, 2)]),
    ([1, 2, 3, 4], [1, 1, 0, 1], [(0, 1, 2), (3, 4, 1)]),
    ([0, 0, 0], [0, 0, 0], []),
    ([6, 0, 8], [1, 0, 1], [(0, 6, 1), (2, 8, 1)]),
])
def test_tile_runs_merge_exactly_consecutive_rows(src, valid, want):
    assert tile_runs(src, valid) == want


def fused_case(p, pattern, width):
    counts = counts_for(pattern, p)
    cap = md.global_capacity(counts)
    send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
    recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
    t = md.baked_index_tables(counts, cap, recv_rows)
    x = np.random.default_rng(p + 1).standard_normal(
        (p, send_rows, width // 4)).astype(np.float32)
    x[:, 0] = np.nan  # the invalid entries' source row
    return cap, t, x


@pytest.mark.parametrize("p,pattern", CASES)
def test_fused_bulk_plan_matches_oracles(p, pattern):
    """The tiles cover every output row once, each inside one bucket; the
    runs of each tile, copied as whole byte ranges with every other row
    zero, give the JAX pack oracle followed by the bucketed exchange, and
    the port's plain version, bit for bit."""
    width = 64 if p == 64 else 48
    cap, t, x = fused_case(p, pattern, width)
    rows_t = a2a_fence.fused_tile_rows(width)
    tiles = fused_tiles(p, cap, width)
    xb = x.view(np.uint8).reshape(p, x.shape[1], width)
    got = np.full((p, p * cap, width), 0xAB, np.uint8)
    covered = np.zeros((p, p * cap), np.int32)
    for tgt, src, k0, rows in tiles:
        assert 0 < rows <= rows_t and k0 % rows_t == 0 and k0 + rows <= cap
        o = src * cap + k0
        covered[tgt, o:o + rows] += 1
        got[tgt, o:o + rows] = 0
        t0 = tgt * cap + k0
        runs = tile_runs(t.pack_src[src, t0:t0 + rows],
                         t.pack_valid[src, t0:t0 + rows])
        n_run_rows = 0
        for j0, s0, n in runs:
            got[tgt, o + j0:o + j0 + n] = xb[src, s0:s0 + n]
            n_run_rows += n
        assert n_run_rows == int(t.pack_valid[src, t0:t0 + rows].sum())
    assert (covered == 1).all()
    got = got.view(np.float32).reshape(p, p * cap, width // 4)

    packed = np.stack([np.asarray(jax_ref.pack_ref(
        jnp.asarray(x[i]), jnp.asarray(t.pack_src[i]),
        jnp.asarray(t.pack_valid[i]))) for i in range(p)])
    want = jax_ref.a2a_bucketed_ref(packed, p, cap)
    valid_out = np.stack([t.pack_valid[:, tgt * cap:(tgt + 1) * cap].reshape(-1)
                          for tgt in range(p)])
    np.testing.assert_array_equal(got[valid_out].view(np.uint32),
                                  want[valid_out].view(np.uint32))
    # invalid rows: +0.0 by selection (the Pallas kernel multiplies)
    assert not got[~valid_out].view(np.uint32).any()
    plain = a2a_fence.rma_alltoallv_fence_fused_plain(
        torch.from_numpy(x), torch.from_numpy(t.pack_src),
        torch.from_numpy(t.pack_valid), p, cap)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  plain.numpy().view(np.uint32))


# --------------------------------------------------------------------------
# K4 beyond 256 ranks
# --------------------------------------------------------------------------


def sparse_ring_counts(p: int, rounds=(1, 7)) -> np.ndarray:
    """Local rows everywhere and traffic in the given ring rounds only:
    every other round is elided, so the first phase carries round 0, the
    elided rounds and the first active round (p + 1 - len(rounds)
    entries)."""
    ranks = np.arange(p)
    counts = np.diag(np.full(p, 3))
    for r, c in zip(rounds, (2, 5, 1)):
        counts[ranks, (ranks + r) % p] = c
    return counts


@pytest.mark.parametrize("p", [257, 300])
def test_lock_over_256_ranks_matches_oracle(p):
    """The lock epoch on the CPU at P > 256 with a first phase of more than
    256 entries equals the JAX package's bucketed-exchange oracle with each
    received bucket cut to its round's capacity (elided buckets zero)."""
    counts = sparse_ring_counts(p, (p - 3,) if p == 257 else (1, 7, p - 3))
    cap = md.global_capacity(counts)
    caps = md.ring_round_capacities(counts)
    steps = a2a_lock.lock_steps(p, cap, caps, "ring")
    assert len(steps[0]) > a2a_lock.MAX_STEP_ROUNDS
    packed = np.random.default_rng(p).integers(
        0, 256, (p, p * cap, 4), dtype=np.uint8)
    want = jax_ref.a2a_bucketed_ref(packed, p, cap)
    for i in range(p):
        for j in range(p):
            r = (i - j) % p
            keep = cap if r == 0 else min(int(caps[r]), cap)
            want[i, j * cap + keep:(j + 1) * cap] = 0
    got = a2a_lock.rma_alltoallv_lock(torch.from_numpy(packed), p, cap, caps,
                                      "ring")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p,caps", [
    (300, "sparse"), (300, None), (257, "sparse"), (8, "sparse"),
    (600, "sparse"),
])
def test_step_launches_cut_long_phases_in_order(p, caps):
    """No launch of the step kernel carries more than MAX_STEP_ROUNDS
    entries; the launches keep the entries in their order, and only a
    phase longer than that is cut."""
    cap = 8
    rcaps = (md.ring_round_capacities(sparse_ring_counts(p))
             if caps == "sparse" else None)
    steps = a2a_lock.lock_steps(p, cap, rcaps, "ring")
    launches = a2a_lock.step_launches(steps)
    assert all(0 < len(x) <= a2a_lock.MAX_STEP_ROUNDS for x in launches)
    assert [e for x in launches for e in x] == [e for s in steps for e in s]
    want = sum(-(-len(s) // a2a_lock.MAX_STEP_ROUNDS) for s in steps)
    assert len(launches) == want
    assert (len(launches) > len(steps)) == any(
        len(s) > a2a_lock.MAX_STEP_ROUNDS for s in steps)


def test_cluster_schedule_at_300_ranks():
    """The cluster kernel's round table at P=300 builds without a cap: one
    CTA per cluster on an H100, every round once, phase 0 holding the local
    and the elided rounds."""
    p = 300
    caps = md.ring_round_capacities(sparse_ring_counts(p))
    cap = md.global_capacity(sparse_ring_counts(p))
    sched = a2a_lock.lock_schedule(p, cap, a2a_lock.caps_key(caps), "ring")
    assert sched.n_entries == p and sched.n_phases == 2
    assert len(schedule_phase(sched, 0)) == p - 1
    assert sorted(r for ph in range(sched.n_phases)
                  for r, _ in schedule_phase(sched, ph)) == list(range(p))
    assert a2a_lock.lock_cluster_size(p, H100_ACTIVE) == 1


@pytest.mark.parametrize("pack_impl", ["jnp", "pallas"])
def test_lock_plan_over_256_ranks_matches_reference(pack_impl):
    """A persistent lock plan at P=300 on the CPU (INIT, pack, the lock
    epoch, write-through unpack) equals the JAX package's alltoallv oracle
    on every valid row."""
    from repro.core import reference as jax_reference

    p = 300
    counts = sparse_ring_counts(p, (1, 7, p - 3))
    plan = alltoallv_init(counts, (4,), "float32",
                          VirtualMesh((p,), ("x",), device="cpu"), axis="x",
                          variant="lock", pack_impl=pack_impl,
                          cache=PlanCache())
    bufs = jax_reference.make_testbufs(counts, (4,), np.float32, plan.send_rows)
    want = jax_reference.alltoallv_global(bufs, counts, plan.recv_rows)
    got = plan.wait(plan.start(torch.from_numpy(
        bufs.reshape(plan.global_send_shape)))).numpy().reshape(want.shape)
    rc = md.recv_counts(counts).sum(axis=1)
    for r in range(p):
        np.testing.assert_array_equal(got[r, :rc[r]].view(np.uint32),
                                      want[r, :rc[r]].view(np.uint32))
