"""K1's INIT-baked run tables and the hierarchy's packs through K1, on the CPU.

The run kernel does not run here (``chip_smoke.py`` holds it against the
plain version on the card).  What it computes is decided in numpy at INIT:
``gather_rows.gather_runs`` turns a constant gather table into chunks of
contiguous rows.  Expanding the chunks back into rows (``expand_runs``
below, as the kernel's loop over a chunk does) must give the table's index
on every valid entry and zero on exactly the invalid ones; the chunks must
cover the output once, in order, each within the chunk size.  Then the
kernel rule on plain values, the kernels plans name, and the port's
hierarchy packs (stage 1, and stage 3 from two sources) against the JAX
package's ``pack_rows`` and its Pallas ``gather_rows`` (interpreted) on the
same seeded tables: valid rows bit for bit, invalid rows +0.0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import variants as jax_variants
from repro.kernels import ops as jax_ops
from repro_torch.core import PlanCache, alltoallv_init
from repro_torch.core import metadata as md
from repro_torch.core import plan as plan_mod
from repro_torch.kernels import gather_rows, ops
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.testing.patterns import (banded_counts, hugetrace_like_counts,
                                          random_counts)

G = gather_rows
BASE = 0x7F00_0000_0000  # a 256-byte aligned device address


def expand_runs(table: np.ndarray, p: int, n: int, split: int | None = None):
    """The gather a run table describes, row by row: ``(idx, valid,
    writes)``, the index in the two sources' joint numbering, the mask, and
    how often each output row is written."""
    idx = np.full((p, n), -1, np.int64)
    valid = np.zeros((p, n), bool)
    writes = np.zeros((p, n), np.int32)
    for rank, t0, source, s0, rows in table.astype(np.int64):
        writes[rank, t0:t0 + rows] += 1
        if source != G.ZEROS:
            base = s0 + (split if source == G.FROM_X2 else 0)
            idx[rank, t0:t0 + rows] = base + np.arange(rows)
            valid[rank, t0:t0 + rows] = True
    return idx, valid, writes


def check_runs(idx, valid, row_width, split=None, chunk_bytes=G.RUN_CHUNK_BYTES):
    """``gather_runs`` of the table, checked against the table; returns it."""
    table = G.gather_runs(idx, valid, row_width, split, chunk_bytes)
    p, n = np.shape(idx)
    assert table.dtype == np.int32 and table.shape[1] == 5
    got_idx, got_valid, writes = expand_runs(table, p, n, split)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got_valid, valid)
    np.testing.assert_array_equal(got_idx[valid], np.asarray(idx)[valid])
    # output order, every chunk within the size and inside one source
    flat = table[:, G.RANK].astype(np.int64) * n + table[:, G.OUT_ROW]
    assert (np.diff(flat) > 0).all()
    most = max(1, chunk_bytes // row_width) if chunk_bytes else n
    assert (table[:, G.ROWS] >= 1).all() and (table[:, G.ROWS] <= most).all()
    if split is not None:
        last = table[:, G.SRC_ROW] + table[:, G.ROWS]
        assert (last[table[:, G.SOURCE] == G.FROM_X] <= split).all()
    # maximal: a chunk the next one continues was cut at the size
    nxt = table[1:]
    cont = ((nxt[:, G.RANK] == table[:-1, G.RANK])
            & (nxt[:, G.SOURCE] == table[:-1, G.SOURCE])
            & ((nxt[:, G.SOURCE] == G.ZEROS)
               | (nxt[:, G.SRC_ROW] == table[:-1, G.SRC_ROW] + table[:-1, G.ROWS])))
    assert (table[:-1, G.ROWS][cont] == most).all()
    return table


# --------------------------------------------------------------------------
# gather_runs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,idx,valid,want", [
    ("one run", [[4, 5, 6, 7]], [[1, 1, 1, 1]], [[0, 0, 0, 4, 4]]),
    ("repeated", [[2, 2, 3, 3]], [[1, 1, 1, 1]],
     [[0, 0, 0, 2, 1], [0, 1, 0, 2, 2], [0, 3, 0, 3, 1]]),
    ("descending", [[5, 4, 3]], [[1, 1, 1]],
     [[0, 0, 0, 5, 1], [0, 1, 0, 4, 1], [0, 2, 0, 3, 1]]),
    ("all invalid", [[9, 9, 9], [0, 1, 2]], [[0, 0, 0], [0, 0, 0]],
     [[0, 0, 2, 0, 3], [1, 0, 2, 0, 3]]),
    ("padding", [[0, 1, 0, 2, 3]], [[1, 1, 0, 1, 1]],
     [[0, 0, 0, 0, 2], [0, 2, 2, 0, 1], [0, 3, 0, 2, 2]]),
    ("ranks split runs", [[6, 7], [8, 9]], [[1, 1], [1, 1]],
     [[0, 0, 0, 6, 2], [1, 0, 0, 8, 2]]),
])
def test_gather_runs_tables(name, idx, valid, want):
    idx, valid = np.array(idx), np.array(valid, bool)
    table = check_runs(idx, valid, 16)
    np.testing.assert_array_equal(table, np.array(want, np.int32))


def test_two_sources_cut_at_the_split():
    """Indices 3, 4 read x and 5, 6 (x2 rows 0, 1): two chunks, not one."""
    idx = np.array([[3, 4, 5, 6, 0, 1]])
    valid = np.array([[1, 1, 1, 1, 0, 1]], bool)
    table = check_runs(idx, valid, 32, split=5)
    np.testing.assert_array_equal(table, np.array(
        [[0, 0, 0, 3, 2], [0, 2, 1, 0, 2], [0, 4, 2, 0, 1], [0, 5, 0, 1, 1]],
        np.int32))


@pytest.mark.parametrize("row_width,chunk_bytes,rows", [
    (1024, 16384, [16] * 4 + [6]), (4096, 16384, [4] * 17 + [2]),
    (32768, 16384, [1] * 70), (16, 64, [4] * 17 + [2]),
    (1024, None, [70]),
])
def test_runs_cut_at_the_chunk_size(row_width, chunk_bytes, rows):
    idx = np.arange(100, 170)[None]
    table = check_runs(idx, np.ones_like(idx, bool), row_width,
                       chunk_bytes=chunk_bytes)
    assert table[:, G.ROWS].tolist() == rows


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("two", [False, True])
def test_random_tables_expand_back(seed, two):
    """Random indices with half the rows continuing a run, random padding,
    a whole invalid rank, many chunk sizes and row widths."""
    rng = np.random.default_rng(seed)
    p, n, s = 4, 300, 120
    idx = rng.integers(0, s, (p, n))
    run = rng.random((p, n)) < 0.6
    for t in range(1, n):
        idx[:, t] = np.where(run[:, t], (idx[:, t - 1] + 1) % s, idx[:, t])
    valid = rng.random((p, n)) < 0.8
    valid[2] = False
    width = int(rng.choice([16, 48, 1024, 4096]))
    chunk = int(rng.choice([64, 1024, 16384]))
    check_runs(idx, valid, width, split=s // 2 if two else None,
               chunk_bytes=chunk)


def test_config_a_tables_are_one_run_per_rank():
    """At A (P=8 dense, 1024 rows per pair) every bucket of the pack and of
    the unpack lies inside one run before cutting; the runs continue across
    buckets, so each rank is one run.  Cut at 16 KiB, 1 KiB rows give
    chunks of 16 rows, 64 per bucket."""
    counts = np.full((8, 8), 1024)
    cap = md.global_capacity(counts)
    t = md.baked_index_tables(counts, cap, 8 * cap)
    for idx, valid in ((t.pack_src, t.pack_valid),
                       (t.unpack_src, t.unpack_valid)):
        uncut = check_runs(idx, valid, 1024, chunk_bytes=None)
        assert uncut[:, G.ROWS].tolist() == [8 * cap] * 8
        assert (uncut[:, G.SOURCE] == G.FROM_X).all()
        cut = check_runs(idx, valid, 1024)
        assert cut.shape[0] == 8 * 8 * 64 and (cut[:, G.ROWS] == 16).all()


@pytest.mark.parametrize("p,counts", [
    (8, banded_counts(8)), (8, random_counts(8, 2, 9)),
    (64, hugetrace_like_counts(64, 3)),
])
def test_plan_tables_expand_back(p, counts):
    """The flat plan's pack and unpack tables at the chunk size."""
    cap = md.global_capacity(counts)
    recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
    t = md.baked_index_tables(counts, cap, recv_rows)
    check_runs(t.pack_src, t.pack_valid, 64)
    check_runs(t.unpack_src, t.unpack_valid, 64)


# --------------------------------------------------------------------------
# The rule and the kernels plans name
# --------------------------------------------------------------------------


@pytest.mark.parametrize("device,width,addrs,runs,want", [
    ("cpu", 1024, (BASE,), True, "plain"),
    ("cpu", 60, (BASE + 4,), False, "plain"),
    ("cuda", 1024, (BASE, BASE + 4096), True, "runs"),
    ("cuda", 16, (BASE + 16,), True, "runs"),
    ("cuda", 32768, (BASE, BASE, BASE), True, "runs"),
    ("cuda", 1024, (BASE,), False, "warp"),
    ("cuda", 60, (BASE,), True, "warp"),
    ("cuda", 1024, (BASE + 4,), True, "warp"),
    ("cuda", 1024, (BASE, BASE + 8), True, "warp"),
    ("cuda", 1024, (BASE, BASE, BASE + 4), True, "warp"),
    ("cuda", 0, (BASE,), True, "warp"),
])
def test_kernel_rule(device, width, addrs, runs, want):
    assert G.kernel_choice(device, width, addrs, runs) == want


def k1_names(plan) -> set:
    return {k.name for k in plan.kernels()} & {G.KERNEL.name, G.RUNS.name}


@pytest.mark.parametrize("feature,dtype,k1", [
    ((256,), "float32", "gather_rows_runs"),
    ((4,), "float32", "gather_rows_runs"),
    ((3, 5), "float32", "gather_rows"),
])
@pytest.mark.parametrize("variant,mesh,impl", [
    ("fence", (4,), "jnp"), ("fence", (4,), "pallas"), ("fence", (4,), "fused"),
    ("lock", (4,), "pallas"), ("fence_hierarchy", (2, 2), "jnp"),
    ("fence_hierarchy", (2, 2), "pallas"), ("fence_hierarchy", (2, 2), "fused"),
])
def test_plans_name_k1(feature, dtype, k1, variant, mesh, impl):
    """Baked plans name the run kernel for 16-byte rows and the warp kernel
    for others; "jnp" plans launch no K1; the epoch on the CPU runs."""
    axis = ("x",) if len(mesh) == 1 else ("o", "i")
    vm = VirtualMesh(mesh, axis, device="cpu")
    plan = alltoallv_init(banded_counts(4), feature, dtype, vm,
                          axis=axis[0] if len(mesh) == 1 else axis,
                          variant=variant, pack_impl=impl, cache=PlanCache())
    assert k1_names(plan) == (set() if impl == "jnp" else {k1})
    x = torch.ones(plan.global_send_shape, dtype=getattr(torch, dtype))
    plan.wait(plan.start(x))
    assert plan.init_run_table_seconds >= 0.0


def test_cpu_plans_bake_no_run_tables():
    """Run tables are baked only where a card's K1 reads them: a CPU plan
    takes the plain version and holds none, though it names the tables a
    card would bake."""
    plan = alltoallv_init(banded_counts(4), (256,), "float32",
                          VirtualMesh((2, 2), ("o", "i"), device="cpu"),
                          axis=("o", "i"), variant="fence_hierarchy",
                          pack_impl="fused", cache=PlanCache()).compile()
    assert plan.run_tables == {} and plan.init_run_table_seconds == 0.0
    assert set(plan._run_sources()) == {"s1", "s3", "unpack"}


@pytest.mark.parametrize("variant,mesh,impl,local", [
    ("fence", (8,), "pallas", False), ("fence", (8,), "fused", False),
    ("lock", (8,), "pallas", False),
    ("fence_hierarchy", (2, 4), "pallas", False),
    ("fence_hierarchy", (4, 2), "fused", False),
    ("fence_hierarchy", (2, 4), "fused", True),
])
def test_plans_bind_their_run_tables(monkeypatch, variant, mesh, impl, local):
    """With run tables baked as on a card, every gather of the epoch and of
    ``embed()`` passes them beside the tables and sources they were baked
    for (the wrapper refuses any other), and the results equal the "jnp"
    plan's, which gathers without K1."""
    monkeypatch.setattr(plan_mod, "bakes_run_tables", lambda dev, rb: True)
    p = int(np.prod(mesh))
    counts = random_counts(p, 3, 9)
    if local:       # every row stays inside its group of mesh[1] ranks
        group = np.arange(p) // mesh[1]
        counts = counts * (group[:, None] == group[None, :])
    axis = ("x",) if len(mesh) == 1 else ("o", "i")
    vm = VirtualMesh(mesh, axis, device="cpu")
    rng = np.random.default_rng(p)
    outs = {}
    for pack_impl in (impl, "jnp"):
        plan = alltoallv_init(counts, (4,), "float32", vm,
                              axis=axis[0] if len(mesh) == 1 else axis,
                              variant=variant, pack_impl=pack_impl,
                              cache=PlanCache()).compile()
        if pack_impl == impl:
            want = set(plan._run_sources())
            assert want and set(plan.run_tables) == want
            assert ("s1" in want) == (variant == "fence_hierarchy" and not local)
            x = torch.from_numpy(rng.standard_normal(
                plan.global_send_shape).astype(np.float32))
        outs[pack_impl] = (plan.wait(plan.start(x)).clone(), plan.embed()(x))
    for got, want in zip(outs[impl], outs["jnp"]):
        assert torch.equal(got, want)


def test_unbaked_pallas_plan_names_the_warp_kernel():
    plan = alltoallv_init(banded_counts(4), (256,), "float32",
                          VirtualMesh((4,), ("x",), device="cpu"), axis="x",
                          pack_impl="pallas", baked_metadata=False,
                          cache=PlanCache())
    assert k1_names(plan) == {"gather_rows"}


# --------------------------------------------------------------------------
# The hierarchy's packs against the JAX package
# --------------------------------------------------------------------------


def jax_pack_per_rank(x: np.ndarray, idx: np.ndarray, valid: np.ndarray,
                      pallas: bool) -> np.ndarray:
    rows = []
    for r in range(x.shape[0]):
        args = (jnp.asarray(x[r]), jnp.asarray(idx[r]))
        rows.append(np.asarray(
            jax_ops.pack(*args, jnp.asarray(valid[r], jnp.int32)) if pallas
            else jax_variants.pack_rows(*args, jnp.asarray(valid[r]))))
    return np.stack(rows)


def assert_pack_equal(got: torch.Tensor, want: np.ndarray, valid: np.ndarray):
    got = got.numpy()
    np.testing.assert_array_equal(got[valid].view(np.uint32),
                                  want[valid].view(np.uint32))
    assert not got[~valid].view(np.uint32).any()   # +0.0 by selection
    np.testing.assert_array_equal(want[~valid], 0)  # the Pallas gather: +-0.0


@pytest.mark.parametrize("po,pi,pattern", [
    (2, 4, "random"), (4, 2, "random"), (4, 2, "banded"),
])
def test_hier_packs_match_jax(po, pi, pattern):
    """The stage-1 pack of the send buffer and the stage-3 pack of the
    stage-2 rows and the send buffer as two sources, through the port's
    K1 wrapper with the baked run tables (its plain version here), against
    JAX's ``pack_rows`` and the interpreted Pallas gather on the
    concatenation, per rank."""
    p, width = po * pi, 8
    counts = (random_counts(p, po + pi, 9) if pattern == "random"
              else banded_counts(p))
    recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
    send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
    s = md.hier_two_stage_schedule(counts, po, pi, recv_rows)
    assert s.remote_needed and s.total_s2 > 0
    rng = np.random.default_rng(p)
    x = rng.standard_normal((p, send_rows, width)).astype(np.float32)
    s2 = rng.standard_normal((p, s.total_s2, width)).astype(np.float32)
    rb = width * 4
    cases = [("s1", x, None, s.s1_src, s.s1_valid, None),
             ("s3", s2, x, s.s3_src, s.s3_valid, s.total_s2)]
    for name, src, src2, idx, valid, split in cases:
        ti, tv = torch.from_numpy(idx), torch.from_numpy(valid)
        got = ops.pack(torch.from_numpy(src), ti, tv,
                       x2=None if src2 is None else torch.from_numpy(src2),
                       runs=G.bake_runs(ti, tv, rb, split))
        joint = src if src2 is None else np.concatenate([src, src2], axis=1)
        for pallas in (False, True):
            assert_pack_equal(got, jax_pack_per_rank(joint, idx, valid, pallas),
                              valid)
        check_runs(idx, valid, rb, split)


# --------------------------------------------------------------------------
# A run table is bound to its tables and sources
# --------------------------------------------------------------------------


def bound_case():
    """A two-source gather, its tables and its baked run table."""
    idx = torch.tensor([[3, 4, 5, 6, 0, 1], [0, 1, 2, 5, 5, 6]], dtype=torch.int32)
    valid = torch.tensor([[1, 1, 1, 1, 0, 1], [1, 1, 0, 1, 1, 1]], dtype=torch.bool)
    x = torch.arange(2 * 5 * 4, dtype=torch.float32).reshape(2, 5, 4)
    x2 = -torch.arange(2 * 2 * 4, dtype=torch.float32).reshape(2, 2, 4)
    return x, x2, idx, valid, G.bake_runs(idx, valid, 16, split=5)


def test_bake_runs_records_its_reach():
    x, x2, idx, valid, runs = bound_case()
    assert (runs.split, runs.x_rows, runs.x2_rows) == (5, 5, 2)
    assert runs.idx is idx and runs.valid is valid
    got = G.gather_rows(x, idx, valid, x2=x2, runs=runs)
    want = G.gather_rows_plain(torch.cat([x, x2], dim=1), idx, valid)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [
    "other idx", "other valid", "no x2", "x too long", "x2 too short",
    "one source table",
])
def test_mismatched_run_table_is_refused(case):
    """A run table passed beside other tables, or over sources that do not
    match its chunks, is refused before any gather (on the CPU too)."""
    x, x2, idx, valid, runs = bound_case()
    kw = {"x2": x2, "runs": runs}
    if case == "other idx":
        idx = idx.clone()
    elif case == "other valid":
        valid = valid.clone()
    elif case == "no x2":
        kw["x2"] = None
    elif case == "x too long":          # moves the split
        x = torch.cat([x, x[:, :1]], dim=1)
    elif case == "x2 too short":
        kw["x2"] = x2[:, :1]
    else:
        kw["runs"] = G.bake_runs(idx, valid, 16)   # read as one source
    with pytest.raises(ValueError, match="runs"):
        G.gather_rows(x, idx, valid, **kw)


def test_single_source_reach_is_checked():
    idx = torch.tensor([[0, 1, 7]], dtype=torch.int32)
    valid = torch.ones((1, 3), dtype=torch.bool)
    runs = G.bake_runs(idx, valid, 16)
    assert runs.x_rows == 8
    with pytest.raises(ValueError, match="runs reads 8 rows of x"):
        G.gather_rows(torch.zeros((1, 7, 4)), idx, valid, runs=runs)


@pytest.mark.parametrize("host", ["wrong shape", "negative index"])
def test_bake_runs_refuses_a_table_that_does_not_cover(host):
    idx = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    valid = torch.ones((1, 3), dtype=torch.bool)
    if host == "wrong shape":
        tables = (np.array([[0, 1]]), np.ones((1, 2), bool))
        match = "does not cover"
    else:
        tables = (np.array([[0, -1, 2]]), np.ones((1, 3), bool))
        match = "source rows >= 0"
    with pytest.raises(ValueError, match=match):
        G.bake_runs(idx, valid, 16, host=tables)
