"""The port's leader-combined hierarchy and ``embed()`` against the JAX
package.

One JAX subprocess (``tests/_torch_parity_jax_hier.py``, 8 host devices)
runs the reference plans, ``variants.stage2_leader_ppermute``, the
interpreted Pallas stage-2 kernel (once), the embedded epochs and the
table-free ``hierarchy_exchange``; the port runs the same arrays on
``VirtualMesh(..., device="cpu")``, where every kernel takes its plain
version.  Tolerance: bit for bit, since every function here only moves
rows; recv buffers on their valid rows (a standalone epoch keeps stale
window bytes in its padding), stage 2 and ``hierarchy_exchange`` on every
row.  Each test names the dist case of ``repro.testing.dist_cases`` it
mirrors.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity_jax_hier as parity
from repro.core import metadata as jax_md
from repro_torch.core import (INIT_STATS, PlanCache, WarmStartError,
                              alltoallv_init, metadata as md, reference, variants)
from repro_torch.core.plan import ExchangePlan, ExchangeSpec
from repro_torch.kernels import _build, a2a_fence, a2a_hier, ops
from repro_torch.launch.mesh import VirtualMesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = parity.P
FEATURE = parity.FEATURE


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_hier_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_parity_jax_hier.py"),
         str(out)], capture_output=True, text=True, timeout=600, env=env,
        cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def grid_mesh(mesh):
    return VirtualMesh(mesh, ("o", "i"), device="cpu")


def hier_plan(counts, mesh, pack_impl="jnp", leader_perm=None, **kw):
    return alltoallv_init(counts, FEATURE, torch.float32, grid_mesh(mesh),
                          axis=("o", "i"), variant="fence_hierarchy",
                          pack_impl=pack_impl, hier_leader_perm=leader_perm,
                          cache=PlanCache(), **kw)


def assert_valid_rows_equal(got, want, counts):
    """Valid rows bit for bit (``view(uint8)``: -0.0 and NaN count)."""
    p = counts.shape[0]
    elems = int(np.prod(FEATURE))
    rc = md.recv_counts(counts)
    got, want = np.asarray(got).reshape(p, -1), np.asarray(want).reshape(p, -1)
    for r in range(p):
        n = int(rc[r].sum()) * elems
        np.testing.assert_array_equal(got[r, :n].view(np.uint8),
                                      want[r, :n].view(np.uint8))


def oracle(counts, x):
    send_rows, recv_rows = parity.geometry(counts)
    bufs = x.reshape((P, send_rows) + FEATURE)
    return reference.alltoallv_global(bufs, counts, recv_rows)


def assert_summary(plan, ref, key):
    summary = json.loads(str(ref[f"{key}/summary"]))
    mine = plan.metadata_summary()
    for k in parity.SUMMARY_KEYS:
        assert mine[k] == summary[k], k
    assert plan.signature.digest == summary["digest"]


# ---------------------------------------------------------------------------
# fence_hierarchy plans (hier_combined_parity, hierarchy_local_elision)
# ---------------------------------------------------------------------------

PORT_HIER_CASES = [(pat, mesh, impl) for mesh in parity.MESHES
                   for pat in parity.HIER_PATTERNS
                   for impl in ("jnp", "pallas", "fused")]


@pytest.mark.parametrize("case", PORT_HIER_CASES, ids=parity.case_id)
def test_hier_plan_matches_jax(jax_ref, case):
    """The port's fence_hierarchy plan == the JAX plan of the same
    pack_impl (the ``jnp`` one for ``fused``, whose interpreted kernel runs
    once, below), the flat fence plan and the oracle on valid rows, with
    capacity, recv rows, remote_needed, cross_group_puts and digest
    (hier_combined_parity, hierarchy_local_elision)."""
    name, mesh, impl = case
    counts = parity.pattern_counts(name)
    x = jax_ref[f"{name}/x"]
    plan = hier_plan(counts, mesh, impl)
    got = plan.wait(plan.start(torch.from_numpy(x))).numpy()
    ref_key = parity.case_id((name, mesh, "jnp" if impl == "fused" else impl))
    assert got.shape == jax_ref[f"{ref_key}/out"].shape
    assert_valid_rows_equal(got, jax_ref[f"{ref_key}/out"], counts)
    assert_valid_rows_equal(got, jax_ref[f"flat/{name}/out"], counts)
    assert_valid_rows_equal(got, oracle(counts, x), counts)
    if impl != "fused":
        assert_summary(plan, jax_ref, ref_key)
    p_outer = mesh[0]
    assert plan.cross_group_puts <= p_outer * (p_outer - 1)
    if name == "dense":
        assert plan.cross_group_puts == p_outer * (p_outer - 1)


@pytest.mark.parametrize("name", parity.HIER_PATTERNS)
def test_flat_fence_on_grid_matches_jax(jax_ref, name):
    """The flat fence plan over the linearized ("o", "i") pair, which
    hier_combined_parity holds the hierarchy against."""
    counts = parity.pattern_counts(name)
    plan = alltoallv_init(counts, FEATURE, torch.float32,
                          grid_mesh(parity.MESHES[0]), axis=("o", "i"),
                          variant="fence", cache=PlanCache())
    got = plan.wait(plan.start(torch.from_numpy(jax_ref[f"{name}/x"]))).numpy()
    assert_valid_rows_equal(got, jax_ref[f"flat/{name}/out"], counts)
    assert_summary(plan, jax_ref, f"flat/{name}")


STAGE2_CASES = ([(name, mesh, None) for name in parity.HIER_PATTERNS
                 if name != "local" for mesh in parity.MESHES]
                + [("dense", mesh, lp) for mesh in parity.MESHES
                   for lp in parity.LEADER_PERMS])


@pytest.mark.parametrize(
    "case", STAGE2_CASES,
    ids=lambda c: "-".join([c[0], parity.mesh_id(c[1])] + ([c[2]] if c[2] else [])))
def test_stage2_matches_jax_on_every_row(jax_ref, case):
    """variants.stage2_leader_ppermute and K5's plain version == the JAX
    package's stage2_leader_ppermute on every row, padding included (all
    three write +0.0 by selection), under identity and non-identity leader
    permutations."""
    name, mesh, lp_name = case
    counts = parity.pattern_counts(name)
    lp = parity.leader_perm(lp_name, mesh) if lp_name else None
    _, recv_rows = parity.geometry(counts)
    sched = md.hier_two_stage_schedule(counts, mesh[0], mesh[1], recv_rows,
                                       leader_perm=lp)
    s1 = torch.from_numpy(parity.stage2_input(name, mesh, mesh[1] * sched.s1_cap))
    src, valid = torch.from_numpy(sched.s2_src), torch.from_numpy(sched.s2_valid)
    key = f"stage2/{name}/{parity.mesh_id(mesh)}" + (f"/{lp_name}" if lp_name else "")
    want = jax_ref[key]
    s2_from = torch.from_numpy(md.hier_stage2_from(sched))
    row_round = torch.from_numpy(md.hier_row_rounds(sched))
    got_ref = variants.stage2_leader_ppermute(s1, src, valid, sched,
                                              s2_from).numpy()
    got_k5 = ops.fused_hier_leader_exchange(s1, src, valid, s2_from=s2_from,
                                            row_round=row_round).numpy()
    for got in (got_ref, got_k5):
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_fused_plan_matches_interpreted_pallas(jax_ref):
    """pack_impl="fused" (K5) == the JAX plan whose stage 2 is the Pallas
    kernel run interpreted, on valid rows (hier_combined_parity's fused
    plan, run on mesh (4, 2): see tests/_torch_parity_jax_hier.py)."""
    name, mesh, impl = parity.FUSED_CASE
    counts = parity.pattern_counts(name)
    plan = hier_plan(counts, mesh, impl)
    before = a2a_hier.HIER.plain_calls
    got = plan.wait(plan.start(torch.from_numpy(jax_ref[f"{name}/x"]))).numpy()
    assert a2a_hier.HIER.plain_calls == before + 1
    assert_valid_rows_equal(got, jax_ref[f"{parity.case_id(parity.FUSED_CASE)}/out"],
                            counts)
    assert_summary(plan, jax_ref, parity.case_id(parity.FUSED_CASE))


@pytest.mark.parametrize("impl", ["jnp", "pallas", "fused"])
@pytest.mark.parametrize("lp_name", parity.LEADER_PERMS)
@pytest.mark.parametrize("mesh", parity.MESHES, ids=parity.mesh_id)
def test_leader_perm_plans_match_jax_jnp_plan(jax_ref, mesh, lp_name, impl):
    """Under a non-identity hier_leader_perm every port plan, the fused one
    included, == the JAX jnp plan and the oracle, and the digest == the
    JAX package's.  The JAX fused plan is no reference here: its Pallas
    kernel picks the ring partner from the physical inner rank and ignores
    the leader permutation, so it gives wrong rows for these perms."""
    counts = parity.pattern_counts("dense")
    x = jax_ref["dense/x"]
    plan = hier_plan(counts, mesh, impl, parity.leader_perm(lp_name, mesh))
    assert plan.spec.hier_leader_perm is not None
    got = plan.wait(plan.start(torch.from_numpy(x))).numpy()
    key = f"perm/{lp_name}/{parity.mesh_id(mesh)}"
    assert_valid_rows_equal(got, jax_ref[f"{key}/out"], counts)
    assert_valid_rows_equal(got, oracle(counts, x), counts)
    if impl == "jnp":
        assert_summary(plan, jax_ref, key)


def test_all_local_pattern_skips_stage2(jax_ref):
    """hierarchy_local_elision: with no row crossing a group boundary the
    epoch skips hops 1-2 (no K5 call), and one crossing row brings them
    back."""
    local = parity.pattern_counts("local")
    plan = hier_plan(local, (2, 4), "fused")
    assert plan.hierarchy_remote_needed is False
    assert plan.metadata_summary()["cross_group_puts"] == 0
    before = _build.counts()
    got = plan.wait(plan.start(torch.from_numpy(jax_ref["local/x"]))).numpy()
    after = _build.counts()
    assert after["a2a_hier"]["plain_calls"] == before["a2a_hier"]["plain_calls"]
    assert after["a2a_fence"]["plain_calls"] == before["a2a_fence"]["plain_calls"] + 1
    assert_valid_rows_equal(got, oracle(local, jax_ref["local/x"]), local)
    crossing = hier_plan(parity.pattern_counts("local_x"), (2, 4), "fused")
    assert crossing.hierarchy_remote_needed is True
    before = a2a_hier.HIER.plain_calls
    crossing.start(torch.from_numpy(jax_ref["local_x/x"]))
    assert a2a_hier.HIER.plain_calls == before + 1


@pytest.mark.parametrize("pack_impl", ["jnp", "pallas", "fused"])
def test_hier_write_through_keeps_stale_padding(jax_ref, pack_impl):
    """A standalone hierarchy epoch writes only valid rows into the window,
    as the flat plans do."""
    counts = parity.pattern_counts("skewed")
    x = torch.from_numpy(jax_ref["skewed/x"])
    plan = hier_plan(counts, (4, 2), pack_impl)
    plan.wait(plan.start(x)).fill_(7.0)
    out = plan.wait(plan.start(x)).numpy().reshape(P, plan.recv_rows, *FEATURE)
    assert_valid_rows_equal(out, oracle(counts, jax_ref["skewed/x"]), counts)
    rc = md.recv_counts(counts)
    for r in range(P):
        assert (out[r, int(rc[r].sum()):] == 7.0).all()


def test_kernels_per_pack_impl():
    """The kernels each hierarchy plan launches on a card: K1 from the
    baked run tables (s1 pack, s3 pack, unpack) for "pallas" and "fused";
    the stages' K2 by its rule at the s1 and s3 capacities."""
    counts = parity.pattern_counts("dense")
    plans = {impl: hier_plan(counts, (2, 4), impl)
             for impl in ("jnp", "pallas", "fused")}
    names = {impl: [k.name for k in plan.kernels()]
             for impl, plan in plans.items()}
    sched = plans["jnp"].hier_schedule
    rb = int(np.prod(FEATURE)) * 4
    k2 = {a2a_fence.fence_cuda_kernel(rb, c).name
          for c in (sched.s1_cap, sched.s3_cap)}
    assert k2 == {a2a_fence.FENCE_BULK.name}
    fence = a2a_fence.FENCE_BULK.name
    assert names == {"jnp": [fence],
                     "pallas": [fence, "gather_rows_runs"],
                     "fused": [fence, "a2a_hier", "gather_rows_runs"]}


# ---------------------------------------------------------------------------
# embed() (embedded_plan_parity)
# ---------------------------------------------------------------------------

PORT_EMBED_CASES = list(parity.EMBED_CASES) + [("fence_hierarchy", "pallas"),
                                               ("fence_hierarchy", "fused")]


@pytest.mark.parametrize("variant,impl", PORT_EMBED_CASES,
                         ids=[f"{v}-{i}" for v, i in PORT_EMBED_CASES])
def test_embed_matches_jax(jax_ref, variant, impl):
    """plan.embed() == the JAX plan's embedded epoch on valid rows, zero on
    padding, and == the port's own start() on valid rows.  The hierarchy's
    pallas and fused embeds are held against the JAX jnp one."""
    counts = parity.pattern_counts("embed")
    x = torch.from_numpy(jax_ref["embed/x"])
    if variant == "fence_hierarchy":
        mesh, axis = grid_mesh((2, 4)), ("o", "i")
        want = jax_ref["embed/fence_hierarchy/jnp"]
    else:
        mesh, axis = VirtualMesh((P,), ("x",), device="cpu"), "x"
        want = jax_ref[f"embed/{variant}/{impl}"]
    plan = alltoallv_init(counts, FEATURE, torch.float32, mesh, axis=axis,
                          variant=variant, pack_impl=impl, cache=PlanCache())
    assert not plan.identity_maps
    got = plan.embed()(x.view((P, plan.send_rows) + FEATURE))
    assert tuple(got.shape) == (P, plan.recv_rows) + FEATURE
    assert_valid_rows_equal(got.numpy(), want, counts)
    assert_valid_rows_equal(got.numpy(), plan.wait(plan.start(x)).numpy(), counts)
    rc = md.recv_counts(counts)
    for r in range(P):
        pad = got[r, int(rc[r].sum()):].numpy()
        assert not pad.any() and not np.signbit(pad).any()


@pytest.mark.parametrize("variant", ["fence", "lock"])
def test_embed_identity_fast_path(variant):
    """A uniform all-equal pattern has identity maps: the embedded epoch is
    the bare exchange, with no gather and no table on the device."""
    cap = 8
    counts = np.full((P, P), cap, np.int64)
    plan = alltoallv_init(counts, FEATURE, torch.float32,
                          VirtualMesh((P,), ("x",), device="cpu"), axis="x",
                          variant=variant, pack_impl="pallas", cache=PlanCache())
    assert plan.identity_maps
    bufs = reference.make_testbufs(counts, FEATURE, np.float32, plan.send_rows)
    before = _build.counts()
    got = plan.embed()(torch.from_numpy(bufs))
    assert _build.counts()["gather_rows"] == before["gather_rows"]
    assert plan._tables is None
    want = reference.alltoallv_global(bufs, counts, plan.recv_rows)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The table-free hierarchy_exchange (uniform_bucketed_exchange)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remote", [True, False], ids=["remote", "all_local"])
@pytest.mark.parametrize("mesh", parity.MESHES, ids=parity.mesh_id)
def test_hierarchy_exchange_matches_jax(jax_ref, mesh, remote):
    """variants.hierarchy_exchange == the JAX package's inside shard_map, on
    every row; with the remote stage it is the flat fence exchange."""
    packed = torch.from_numpy(parity.uniform_input())
    cap = parity.UNIFORM_CAP
    got = variants.hierarchy_exchange(packed, mesh[0], mesh[1], cap,
                                      remote_needed=remote)
    want = jax_ref[f"uniform/{parity.mesh_id(mesh)}/{remote}"]
    np.testing.assert_array_equal(got.numpy().view(np.uint8), want.view(np.uint8))
    if remote:
        for variant in ("fence", "fence_hierarchy"):
            np.testing.assert_array_equal(
                variants.uniform_bucketed_exchange(packed, variant, cap,
                                                   mesh).numpy(), want)


# ---------------------------------------------------------------------------
# State carried across: warm start from the JAX package's schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lp_name", [None, "reversed"], ids=["identity", "reversed"])
def test_warm_start_from_jax_schedule(jax_ref, lp_name):
    """A HierSchedule baked by repro.core.metadata goes into the port's plan
    as ``warm=``: no bake, ``warm_loaded``, the same rows as a cold INIT."""
    mesh = (4, 2)
    counts = parity.pattern_counts("skewed")
    lp = parity.leader_perm(lp_name, mesh) if lp_name else None
    x = torch.from_numpy(jax_ref["skewed/x"])
    cold = hier_plan(counts, mesh, "fused", lp)

    class Artifact:
        hier_schedule = jax_md.hier_two_stage_schedule(
            counts, mesh[0], mesh[1], cold.recv_rows, leader_perm=lp)

    bakes = INIT_STATS.table_bakes
    warm = ExchangePlan(cold.spec, grid_mesh(mesh), warm=Artifact())
    assert warm.warm_loaded and warm.metadata_summary()["warm_loaded"]
    assert INIT_STATS.table_bakes == bakes
    got = warm.wait(warm.start(x)).numpy()
    np.testing.assert_array_equal(got, cold.wait(cold.start(x)).numpy())
    assert_valid_rows_equal(got, oracle(counts, jax_ref["skewed/x"]), counts)


@pytest.mark.parametrize("fault", ["geometry", "leader_perm"])
def test_warm_schedule_mismatch_falls_back_cold(jax_ref, fault):
    """A schedule of the wrong geometry or leader permutation raises
    WarmStartError, and PlanCache.get INITs cold instead."""
    counts = parity.pattern_counts("dense")
    spec = ExchangeSpec(send_counts=counts, feature_shape=FEATURE,
                        dtype=torch.float32, axis=("o", "i"),
                        variant="fence_hierarchy")
    cold = ExchangePlan(spec, grid_mesh((2, 4)))
    mesh, lp = ((4, 2), None) if fault == "geometry" else \
        ((2, 4), parity.leader_perm("rotated", (2, 4)))

    class Stale:
        hier_schedule = jax_md.hier_two_stage_schedule(
            counts, mesh[0], mesh[1], cold.recv_rows, leader_perm=lp)

    class StaleStore:
        """A plan store double whose entry for every pattern is ``Stale``."""

        def get(self, sig, device=None):
            return Stale()

        def put_plan(self, sig, plan, device=None):
            self.published = plan

    with pytest.raises(WarmStartError):
        ExchangePlan(spec, grid_mesh((2, 4)), warm=Stale())
    invalid = INIT_STATS.store_invalid
    store = StaleStore()
    plan = PlanCache().get(spec, grid_mesh((2, 4)), store=store)
    assert not plan.warm_loaded and INIT_STATS.store_invalid == invalid + 1
    assert store.published is plan         # the cold rebuild is published
    got = plan.wait(plan.start(torch.from_numpy(jax_ref["dense/x"]))).numpy()
    assert_valid_rows_equal(got, oracle(counts, jax_ref["dense/x"]), counts)


def test_signature_with_leader_perm_matches_jax():
    """PatternSignature of a fence_hierarchy spec with a leader permutation
    equals the JAX package's; the identity permutation keys as none."""
    counts = parity.pattern_counts("dense")
    lp = parity.leader_perm("reversed", (2, 4))
    plan = hier_plan(counts, (2, 4), "fused", lp)
    want = jax_md.PatternSignature.build(
        counts, FEATURE, np.float32, "fence_hierarchy", ("o", "i"), 16,
        pack_impl="fused", axis_sizes=(2, 4), hier_leader_perm=lp)
    assert plan.signature.digest == want.digest
    assert plan.signature.hier_leader_perm == want.hier_leader_perm
    ident = hier_plan(counts, (2, 4), "fused", parity.leader_perm(None, (2, 4)))
    assert ident.spec.hier_leader_perm is None
    assert ident.signature.digest == hier_plan(counts, (2, 4), "fused").signature.digest
    assert ident.signature.digest != plan.signature.digest


@pytest.mark.parametrize("kwargs,match", [
    ({"axis": "o"}, "needs axis=\\(outer, inner\\)"),
    ({"baked_metadata": False}, "requires baked_metadata"),
    ({"hier_leader_perm": ((0, 0, 1, 2),) * 2}, "not a permutation"),
])
def test_hier_spec_validation(kwargs, match):
    """ExchangeSpec keeps the JAX package's rules for fence_hierarchy."""
    args = {"axis": ("o", "i"), **kwargs}
    with pytest.raises(ValueError, match=match):
        alltoallv_init(parity.pattern_counts("dense"), FEATURE, torch.float32,
                       grid_mesh((2, 4)), variant="fence_hierarchy",
                       cache=PlanCache(), **args)
