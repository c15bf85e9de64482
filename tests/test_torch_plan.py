"""The port's persistent alltoallv plan against the JAX package, end to end.

One JAX subprocess (``tests/_torch_parity_jax.py``, 8 host devices) runs
the reference plans, the interpreted Pallas RMA kernels and
``variants.lock_exchange``; the port runs the same arrays on
``VirtualMesh(..., device="cpu")``, where every kernel takes its plain
version.  Tolerance: valid rows bit for bit, since every function of the
slice only moves rows; padding rows are compared by value where defined.
The port-only tests mirror the dist cases named in their docstrings.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity_jax as parity
from repro.core import metadata as jax_md
from repro_torch.core import (INIT_STATS, PlanCache, WarmStartError,
                              alltoallv_init, metadata as md, reference)
from repro_torch.core.baseline import make_nonpersistent
from repro_torch.core.plan import ExchangePlan, ExchangeSpec
from repro_torch.kernels import a2a_fence, a2a_lock
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.testing.patterns import banded_counts, random_counts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = parity.P


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_parity_jax.py"),
         str(out)], capture_output=True, text=True, timeout=600, env=env,
        cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def cpu_mesh(p=P):
    return VirtualMesh((p,), ("x",), device="cpu")


def assert_valid_rows_equal(got, want, counts, feature=(4,)):
    """Valid rows bit for bit (``view(uint8)``: -0.0 and NaN count).
    ``got``/``want`` may be global ``[P*rows, *F]`` or ``[P, rows, *F]``."""
    p = counts.shape[0]
    elems = int(np.prod(feature))
    rc = md.recv_counts(counts)
    got, want = got.reshape(p, -1), want.reshape(p, -1)
    for r in range(p):
        n = int(rc[r].sum()) * elems
        np.testing.assert_array_equal(got[r, :n].view(np.uint8),
                                      want[r, :n].view(np.uint8))


@pytest.mark.parametrize("case", parity.CASES, ids=parity.case_id)
def test_plan_matches_jax(jax_ref, case):
    """alltoallv_init(...).start() on the dist cases' patterns
    (alltoallv_variants, alltoallv_dtypes_and_features, sparse_lock_elision,
    fused_pack_fence, pallas_pack_in_plan)."""
    name, variant, pack_impl, sched = case
    _, feature, dtype = parity.PATTERNS[name]
    counts = parity.pattern_counts(name)
    x = torch.from_numpy(jax_ref[f"{name}/x"])
    plan = alltoallv_init(counts, feature, getattr(torch, dtype), cpu_mesh(),
                          axis="x", variant=variant, pack_impl=pack_impl,
                          lock_schedule=sched, cache=PlanCache())
    got = plan.wait(plan.start(x)).numpy()
    want = jax_ref[f"{parity.case_id(case)}/out"]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert_valid_rows_equal(got, want, counts, feature)
    summary = json.loads(str(jax_ref[f"{parity.case_id(case)}/summary"]))
    mine = plan.metadata_summary()
    for key in parity.SUMMARY_KEYS:
        assert mine[key] == summary[key], key
    assert plan.signature.digest == summary["digest"]


@pytest.mark.parametrize("variant", ["fence", "lock"])
def test_rma_alltoallv_matches_interpreted_pallas(jax_ref, variant):
    """ops.rma_alltoallv (Pallas, interpret mode) vs the port's K2/K4 plain
    versions, full capacity every round (dist case rma_kernels)."""
    packed = torch.from_numpy(jax_ref["rma/packed"])
    if variant == "fence":
        got = a2a_fence.rma_alltoallv_fence(packed, P, parity.RMA_CAP)
    else:
        got = a2a_lock.rma_alltoallv_lock(packed, P, parity.RMA_CAP)
    np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                  jax_ref[f"rma/{variant}"].view(np.uint8))


@pytest.mark.parametrize("sched", ["ring", "pairwise"])
def test_lock_exchange_matches_jax_buckets(jax_ref, sched):
    """variants.lock_exchange with elided rounds: every bucket row, padding
    included, equals the JAX package's."""
    from repro_torch.core import variants

    banded = parity.pattern_counts("banded")
    cap = md.global_capacity(banded)
    caps = (md.xor_round_capacities(banded) if sched == "pairwise"
            else md.ring_round_capacities(banded))
    assert md.active_round_schedule(caps).size < P - 1
    got = variants.lock_exchange(
        torch.from_numpy(jax_ref["lock_exchange/packed"]), P, cap, caps, sched)
    np.testing.assert_array_equal(got.numpy(), jax_ref[f"lock_exchange/{sched}"])


# ---------------------------------------------------------------------------
# The port's own cases
# ---------------------------------------------------------------------------


def setup_pattern(seed=0, max_count=13, p=P, feature=(4,)):
    counts = random_counts(p, seed, max_count)
    send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
    recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
    bufs = reference.make_testbufs(counts, feature, np.float32, send_rows)
    expect = reference.alltoallv_global(bufs, counts, recv_rows)
    x = torch.from_numpy(bufs.reshape((p * send_rows,) + feature))
    return counts, x, expect


def test_plan_and_window_reuse():
    """Plan cache hits, window reuse across epochs, re-INIT on size change
    (dist case plan_and_window_reuse)."""
    mesh = cpu_mesh()
    cache = PlanCache()
    counts = np.arange(P * P, dtype=np.int64).reshape(P, P) % 7 + 1
    plan1 = alltoallv_init(counts, (4,), torch.float32, mesh, axis="x", cache=cache)
    plan2 = alltoallv_init(counts, (4,), torch.float32, mesh, axis="x", cache=cache)
    assert plan1 is plan2 and cache.hits == 1 and cache.misses == 1

    x = torch.zeros(plan1.global_send_shape, dtype=torch.float32)
    g0 = plan1.window.generation
    outs = [plan1.wait(plan1.start(x)) for _ in range(3)]
    assert plan1.window.generation == max(g0, 1), "window must be reused"
    assert all(o.data_ptr() == outs[0].data_ptr() for o in outs)

    # same total_recv_bytes, different pattern -> new plan, same window obj
    plan3 = alltoallv_init(np.roll(counts, 1, axis=1), (4,), torch.float32,
                           mesh, axis="x", cache=cache)
    assert plan3 is not plan1
    assert plan3.window is plan1.window, "window cached by recv bytes"

    # changed sizes -> new window
    plan4 = alltoallv_init(counts * 2, (4,), torch.float32, mesh, axis="x",
                           cache=cache)
    assert plan4.window is not plan1.window
    plan1.free()
    assert plan1.window.buffer is None


def test_pipelined_epochs():
    """start_pipelined alternates window slots; every epoch's output is
    correct and slots really double-buffer (dist case pipelined_epochs)."""
    counts, x, expect = setup_pattern(seed=11)
    plan = alltoallv_init(counts, (4,), torch.float32, cpu_mesh(), axis="x",
                          pack_impl="pallas", cache=PlanCache())
    prev = plan.start_pipelined(x)
    for _ in range(3):
        cur = plan.start_pipelined(x)
        assert cur.data_ptr() != prev.data_ptr()
        assert_valid_rows_equal(plan.wait(prev).numpy(), expect, counts)
        prev = cur
    assert_valid_rows_equal(plan.wait(prev).numpy(), expect, counts)
    assert len(plan.window._slots) == 2, "double buffering must use 2 slots"
    plan._window_cache.free()
    assert not plan.window._slots, "free() releases every slot"


@pytest.mark.parametrize("pack_impl", ["jnp", "pallas", "fused"])
def test_stale_padding_preserved(pack_impl):
    """A standalone START writes only valid rows into the window: padding
    rows keep the bytes an earlier epoch left there."""
    counts, x, expect = setup_pattern(seed=2)
    plan = alltoallv_init(counts, (4,), torch.float32, cpu_mesh(), axis="x",
                          pack_impl=pack_impl, cache=PlanCache())
    win = plan.wait(plan.start(x))
    win.fill_(7.0)                       # stale bytes from "an earlier epoch"
    out = plan.wait(plan.start(x)).numpy().reshape(P, plan.recv_rows, 4)
    assert_valid_rows_equal(out, expect, counts)
    rc = md.recv_counts(counts)
    for r in range(P):
        assert (out[r, int(rc[r].sum()):] == 7.0).all()


@pytest.mark.parametrize("variant", ["fence", "lock"])
def test_warm_start_from_jax_tables(variant):
    """Tables baked by repro.core.metadata go into the port's plan as
    ``warm=``: no bake, ``warm_loaded``, and the same rows as a cold INIT."""
    counts, x, expect = setup_pattern(seed=4)
    spec = ExchangeSpec(send_counts=counts, feature_shape=(4,),
                        dtype=torch.float32, axis=("x",), variant=variant,
                        pack_impl="pallas")
    cold = ExchangePlan(spec, cpu_mesh())

    class Artifact:
        index_tables = jax_md.baked_index_tables(counts, cold.capacity,
                                                 cold.recv_rows)

    bakes = INIT_STATS.table_bakes
    warm = ExchangePlan(spec, cpu_mesh(), warm=Artifact())
    assert warm.warm_loaded and warm.metadata_summary()["warm_loaded"]
    assert INIT_STATS.table_bakes == bakes
    got_warm = warm.wait(warm.start(x)).numpy()
    assert_valid_rows_equal(got_warm, expect, counts)
    np.testing.assert_array_equal(got_warm, cold.wait(cold.start(x)).numpy())


def test_warm_start_mismatch_falls_back_cold():
    """PlanCache.get drops an artifact whose tables do not fit and INITs
    cold instead, never with the wrong tables."""
    counts, x, expect = setup_pattern(seed=6)

    class Stale:
        index_tables = jax_md.baked_index_tables(counts, 8, 8)

    spec = ExchangeSpec(send_counts=counts, feature_shape=(4,),
                        dtype=torch.float32, axis=("x",))
    with pytest.raises(WarmStartError):
        ExchangePlan(spec, cpu_mesh(), warm=Stale())
    class StaleStore:
        """A plan store double whose entry for every pattern is ``Stale``."""

        def get(self, sig, device=None):
            return Stale()

        def put_plan(self, sig, plan, device=None):
            self.published = plan

    invalid = INIT_STATS.store_invalid
    store = StaleStore()
    plan = PlanCache().get(spec, cpu_mesh(), store=store)
    assert not plan.warm_loaded and INIT_STATS.store_invalid == invalid + 1
    assert store.published is plan         # the cold rebuild is published
    assert_valid_rows_equal(plan.wait(plan.start(x)).numpy(), expect, counts)


@pytest.mark.parametrize("variant,counts", [
    ("fence", random_counts(P)), ("lock", random_counts(P)),
    ("lock", banded_counts(P))], ids=["fence", "lock", "lock-banded"])
def test_baseline_and_in_graph_maps_match_oracle(variant, counts):
    """The non-persistent baseline (maps recomputed on the device every
    call) and a baked_metadata=False plan match the oracle and the
    persistent plan (dist cases alltoallv_variants, sparse_lock_elision)."""
    send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
    recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
    bufs = reference.make_testbufs(counts, (4,), np.float32, send_rows)
    expect = reference.alltoallv_global(bufs, counts, recv_rows)
    x = torch.from_numpy(bufs.reshape(P * send_rows, 4))
    mesh = cpu_mesh()
    plan = alltoallv_init(counts, (4,), torch.float32, mesh, axis="x",
                          variant=variant, cache=PlanCache())
    persistent = plan.wait(plan.start(x)).numpy()
    exe = make_nonpersistent(mesh, axis="x", p=P, capacity=plan.capacity,
                             send_rows=send_rows, recv_rows=recv_rows,
                             feature_shape=(4,), dtype=torch.float32,
                             variant=variant)
    full = exe(x, torch.tensor(counts.reshape(-1), dtype=torch.int32)).numpy()
    in_graph = alltoallv_init(counts, (4,), torch.float32, mesh, axis="x",
                              variant=variant, baked_metadata=False,
                              cache=PlanCache())
    for got in (persistent, full, in_graph.wait(in_graph.start(x)).numpy()):
        assert_valid_rows_equal(got, expect, counts)


@pytest.mark.parametrize("kwargs,exc", [
    ({"variant": "auto", "store": object()}, AttributeError),
    ({"variant": "ragged", "axis": ("o", "i")}, ValueError),
    ({"variant": "fence_hierarchy", "axis": ("o", "i"), "codec": "int8"},
     ValueError),
    ({"codec": "int8", "error_tol": 0.1, "variant": "ragged"}, ValueError),
    ({"store": object()}, AttributeError),
    ({"variant": "bogus"}, ValueError),
    ({"pack_impl": "fused", "variant": "lock"}, ValueError),
    ({"pack_impl": "bogus"}, ValueError),
    ({"hier_leader_perm": ((1, 0),) * 4}, ValueError),
    ({"codec": "int8", "error_tol": 0.001}, ValueError),
    ({"codec": "bogus", "error_tol": 1.0}, ValueError),
    ({"codec": "bf16", "error_tol": 0.1, "baked_metadata": False}, ValueError),
])
def test_spec_validation(kwargs, exc):
    """ExchangeSpec keeps the JAX rules (a lossy codec without an
    ``error_tol`` covering its bound, ragged over two axes or with a codec,
    a codec without baked tables all raise ValueError, as in the JAX
    package).  ``store=`` is duck-typed, as in the JAX package: an object
    without the plan store's methods fails on first use, under
    ``variant="auto"`` too (``tests/test_torch_planstore.py`` holds the
    stores themselves)."""
    mesh = VirtualMesh((2, 4), ("o", "i"), device="cpu")
    kwargs = {"axis": "i", **kwargs}
    counts = random_counts(4, max_count=5)
    if kwargs["axis"] == ("o", "i"):
        counts = random_counts(8, max_count=5)
    with pytest.raises(exc) as e:
        alltoallv_init(counts, (4,), torch.float32, mesh, cache=PlanCache(),
                       **kwargs)
    if exc is AttributeError:
        assert "get" in str(e.value)


def test_embed_not_ported():
    """What embed() refuses, with the JAX plan's message: a plan with no
    baked tables to embed (``baked_metadata=False``)."""
    plan = alltoallv_init(random_counts(4), (4,), torch.float32, cpu_mesh(4),
                          baked_metadata=False, cache=PlanCache())
    with pytest.raises(ValueError, match="requires baked_metadata=True"):
        plan.embed()
