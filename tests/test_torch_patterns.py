"""The port's exchange patterns (allgatherv, reduce-scatter) against the JAX
package.

The INIT pieces (``expand_counts``, ``bake_tables``, ``identity_maps``,
geometry) are numpy on both sides and must match bit for bit over the
cases of ``tests/test_patterns.py``.  The five plans of ``chip_smoke.py``'s
``patterns_path`` (allgatherv fence, lock and fence_hierarchy on (2, 4);
reduce-scatter fence and lock) run in one JAX subprocess
(``tests/_torch_parity_jax_patterns.py patterns``, 8 host devices) and on
``VirtualMesh(..., device="cpu")`` on the same integer-valued float32
buffers, so the reduce-scatter sums are exact: the outputs must be equal
bit for bit, and equal to each pattern's numpy reference.  Then the spec
rules of ``tests/test_patterns.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity_jax_patterns as parity
from repro.core import metadata as jax_md, patterns as jax_patterns
from repro_torch.core import (PlanCache, allgatherv_init, exchange_init,
                              patterns, reduce_scatter_init)
from repro_torch.core import metadata as md
from repro_torch.core.plan import ExchangeSpec
from repro_torch.kernels import a2a_fence
from repro_torch.launch.mesh import VirtualMesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INITS = {"allgatherv": allgatherv_init, "reduce_scatter": reduce_scatter_init}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_patterns") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_parity_jax_patterns.py"),
         "patterns", str(out)], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def counts_of(kind: str, p: int, seed: int = 0) -> np.ndarray:
    """``tests/test_patterns.py::_counts``."""
    rng = np.random.default_rng(seed + p)
    if kind == "dense":
        return rng.integers(16, 40, p)
    if kind == "ragged":
        c = rng.integers(0, 30, p)
        c[rng.integers(0, p)] = 0
        return c
    c = rng.integers(1, 6, p)
    c[0] = 200
    return c


def mesh_of(shape):
    names = ("x",) if len(shape) == 1 else ("o", "i")
    return VirtualMesh(shape, names, device="cpu"), (
        names[0] if len(names) == 1 else names)


@pytest.mark.parametrize("coll", ["allgatherv", "reduce_scatter"])
@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("kind", ["dense", "ragged", "skewed"])
def test_init_pieces_match_jax(coll, p, kind):
    """expand_counts, validate_matrix, send/recv rows, bake_tables,
    table_shapes and identity_maps equal the JAX pattern's, bit for bit."""
    counts = counts_of(kind, p)
    mine, theirs = patterns.get(coll), jax_patterns.get(coll)
    sc = mine.expand_counts(counts)
    np.testing.assert_array_equal(sc, theirs.expand_counts(counts))
    mine.validate_matrix(sc)
    tile = md.TILE_ROWS
    assert mine.send_rows(sc, tile) == theirs.send_rows(sc, tile)
    assert mine.recv_rows(sc, tile) == theirs.recv_rows(sc, tile)
    cap = md.global_capacity(sc, tile)
    recv = mine.recv_rows(sc, tile)
    a, b = mine.bake_tables(sc, cap, recv), theirs.bake_tables(sc, cap, recv)
    for key in ("pack_src", "pack_valid", "unpack_src", "unpack_valid"):
        got, want = getattr(a, key), getattr(b, key)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert mine.table_shapes(p, cap, recv) == theirs.table_shapes(p, cap, recv)
    send = mine.send_rows(sc, tile)
    assert mine.identity_maps(sc, cap, send, recv) == theirs.identity_maps(
        sc, cap, send, recv)
    np.testing.assert_array_equal(patterns.as_matrix(coll, counts),
                                  jax_patterns.as_matrix(coll, counts))


@pytest.mark.parametrize("coll", ["allgatherv", "reduce_scatter"])
def test_identity_detection_uniform_tile_aligned(coll):
    """Uniform tile-aligned counts are identity maps in both packages; a
    ragged vector is not.  The port's identity plan embeds as the bare
    exchange and equals its full epoch."""
    p, c = 4, 2 * md.TILE_ROWS
    mine, theirs = patterns.get(coll), jax_patterns.get(coll)
    for counts, want in ((np.full(p, c), True),
                         (np.array([c, c - 3, c, c]), False)):
        sc = mine.expand_counts(counts)
        cap = md.global_capacity(sc, md.TILE_ROWS)
        args = (sc, cap, mine.send_rows(sc, md.TILE_ROWS),
                mine.recv_rows(sc, md.TILE_ROWS))
        assert mine.identity_maps(*args) is want
        assert theirs.identity_maps(*args) is want
    plan = INITS[coll](np.full(p, c), (3,), torch.float32,
                       VirtualMesh((p,), ("x",), device="cpu"),
                       cache=PlanCache())
    assert plan.identity_maps
    x = torch.arange(plan.p * plan.send_rows * 3, dtype=torch.float32)
    x = x.reshape(plan.p * plan.send_rows, 3)
    emb = plan.embed()(x)
    full = plan.wait(plan.start(x)).reshape(emb.shape)
    assert torch.equal(emb, full)


@pytest.mark.parametrize("case", parity.PATTERN_PLANS, ids=parity.plan_id)
def test_plan_matches_jax(jax_ref, case):
    """The plan's standalone epoch and its embedded form equal the JAX plan
    and the pattern's numpy reference bit for bit (integer-valued floats);
    padding rows of the window keep their stale bytes."""
    coll, variant, shape = case
    counts = parity.pattern_counts()
    mesh, axis = mesh_of(shape)
    plan = INITS[coll](counts, parity.PATTERN_FEATURE, torch.float32, mesh,
                       axis=axis, variant=variant, cache=PlanCache())
    x = jax_ref[f"{parity.plan_id(case)}/x"]
    want = jax_ref[f"{parity.plan_id(case)}/out"].reshape(
        (plan.p, plan.recv_rows) + parity.PATTERN_FEATURE)
    xt = torch.from_numpy(x.reshape((-1,) + parity.PATTERN_FEATURE))
    win = plan.start(xt)
    win.fill_(99.0)
    got = plan.wait(plan.start(xt)).numpy().reshape(want.shape)
    valid = plan.index_tables.unpack_valid
    np.testing.assert_array_equal(got[valid], want[valid])
    assert (got[~valid] == 99.0).all()
    ref = patterns.get(coll).reference(x, counts, plan.recv_rows)
    np.testing.assert_array_equal(want[valid], ref[valid])
    emb = plan.embed()(xt).numpy()
    np.testing.assert_array_equal(emb, ref)


def test_plan_kernels():
    """Only the reduce-scatter fence epoch names a kernel (K2, the one its
    rule takes for the plan's 16-byte rows at its capacity: the bucket
    kernel); the others are plain tensor ops, as their JAX versions are XLA
    collectives."""
    counts = parity.pattern_counts()
    names, plans = {}, {}
    for coll, variant, shape in parity.PATTERN_PLANS:
        mesh, axis = mesh_of(shape)
        plan = INITS[coll](counts, (4,), torch.float32, mesh, axis=axis,
                           variant=variant, cache=PlanCache())
        names[(coll, variant)] = [k.name for k in plan.kernels()]
        plans[(coll, variant)] = plan
    rs = plans[("reduce_scatter", "fence")]
    assert a2a_fence.fence_kernel_choice("cuda", rs.capacity * 16, 0, 0) == "bulk"
    assert names.pop(("reduce_scatter", "fence")) == [
        a2a_fence.fence_cuda_kernel(16, rs.capacity).name]
    assert all(v == [] for v in names.values())


def test_structural_validation_rejects_wrong_family():
    ag, rs = patterns.get("allgatherv"), patterns.get("reduce_scatter")
    m = np.arange(16).reshape(4, 4)
    with pytest.raises(ValueError, match="row-constant"):
        ag.validate_matrix(m)
    with pytest.raises(ValueError, match="column-constant"):
        rs.validate_matrix(m)
    with pytest.raises(ValueError, match="unknown collective"):
        patterns.get("allreduce")


@pytest.mark.parametrize("coll,kwargs", [
    ("reduce_scatter", {"variant": "fence_hierarchy"}),
    ("reduce_scatter", {"codec": "int8"}),
    ("allgatherv", {"variant": "ragged"}),
    ("allgatherv", {"pack_impl": "pallas"}),
    ("allgatherv", {"baked_metadata": False}),
    ("reduce_scatter", {"hier_leader_perm": ((1, 0, 3, 2),)}),
])
def test_spec_rejects_unsupported_combinations(coll, kwargs):
    """``tests/test_patterns.py``'s spec rules: each combination the JAX
    spec refuses raises ValueError in the port too."""
    counts = np.full(4, md.TILE_ROWS)
    base = dict(feature_shape=(4,), dtype=np.float32, axis=("x",))
    from repro.core.plan import ExchangeSpec as JaxSpec
    sc = patterns.as_matrix(coll, counts)
    for spec_cls in (ExchangeSpec, JaxSpec):
        with pytest.raises(ValueError):
            spec_cls(send_counts=sc, collective=coll, **{**base, **kwargs})
    # the alltoallv spec is untouched by the generalization
    ExchangeSpec(send_counts=np.full((4, 4), 8), variant="fence", **base)


def test_exchange_init_takes_expanded_matrices():
    """``exchange_init`` accepts the family's [P] vector or its expanded
    matrix alike; a matrix of the wrong structure raises."""
    mesh = VirtualMesh((4,), ("x",), device="cpu")
    counts = np.array([3, 0, 9, 5])
    a = exchange_init("allgatherv", counts, (2,), torch.float32, mesh,
                      cache=PlanCache())
    b = exchange_init("allgatherv", patterns.as_matrix("allgatherv", counts),
                      (2,), torch.float32, mesh, cache=PlanCache())
    assert a.signature.digest == b.signature.digest
    with pytest.raises(ValueError, match="row-constant"):
        exchange_init("allgatherv", np.arange(16).reshape(4, 4), (2,),
                      torch.float32, mesh, cache=PlanCache())


def test_signature_matches_jax():
    """A pattern plan's signature digest equals the JAX package's
    (``PatternSignature`` over the expanded matrix and the collective)."""
    counts = parity.pattern_counts()
    for coll in ("allgatherv", "reduce_scatter"):
        plan = INITS[coll](counts, (4,), torch.float32,
                           VirtualMesh((8,), ("x",), device="cpu"),
                           cache=PlanCache())
        want = jax_md.PatternSignature.build(
            plan.send_counts, (4,), np.float32, "fence", ("x",), 16,
            lock_schedule="ring", tile_rows=md.TILE_ROWS, pack_impl="jnp",
            baked_metadata=True, axis_sizes=(8,), codec="identity",
            hier_leader_perm=(), collective=coll)
        assert plan.signature.digest == want.digest
