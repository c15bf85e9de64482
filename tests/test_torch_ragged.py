"""The port's ragged variant against the JAX package and the numpy oracle.

The JAX ragged epoch is ``lax.ragged_all_to_all``, which XLA:CPU cannot
execute, so one JAX subprocess (``tests/_torch_parity_jax_patterns.py
ragged``, 8 host devices) only builds the JAX plans and records their INIT
metadata; the port's tables must equal it.  The port's epochs run on
``VirtualMesh(..., device="cpu")`` (K1's plain version) and are held
against ``repro.core.reference.alltoallv_global`` and against the port's
fence plan: valid rows bit for bit; rows past each rank's recv count keep
the window's earlier bytes.  The flat gather's run table (what K1 reads on
a card) must cover the window once, in order.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity_jax_patterns as parity
from repro.core import reference as jax_reference
from repro_torch.core import PlanCache, alltoallv_init, metadata as md
from repro_torch.core import variants
from repro_torch.kernels import gather_rows
from repro_torch.launch.mesh import VirtualMesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = sorted(parity.RAGGED_CASES)
FEATURE = (4,)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ragged") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_parity_jax_patterns.py"),
         "ragged", str(out)], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def counts_of(name):
    p, recipe = parity.RAGGED_CASES[name]
    return parity.ragged_counts_of(p, recipe)


def ragged_plan(counts, **kw):
    p = counts.shape[0]
    return alltoallv_init(counts, FEATURE, torch.float32,
                          VirtualMesh((p,), ("x",), device="cpu"), axis="x",
                          variant="ragged", cache=PlanCache(), **kw)


def send_buffer(plan, counts, seed=0):
    bufs = jax_reference.make_testbufs(counts, FEATURE, np.float32,
                                       plan.send_rows, seed=seed)
    return bufs, torch.from_numpy(bufs.reshape((-1,) + FEATURE))


def assert_valid_rows(got, want, counts):
    rc = md.recv_counts(counts).sum(axis=1)
    for r in range(counts.shape[0]):
        np.testing.assert_array_equal(got[r, :rc[r]].view(np.uint32),
                                      want[r, :rc[r]].view(np.uint32))


@pytest.mark.parametrize("name", CASES)
def test_init_tables_match_jax(jax_ref, name):
    """sdispls, put_displs, recv counts, recv_rows and the signature digest
    of the port's ragged plan equal those of the JAX ragged plan."""
    counts = counts_of(name)
    plan = ragged_plan(counts)
    np.testing.assert_array_equal(plan.send_counts, jax_ref[f"{name}/send_counts"])
    for key in ("sdispls", "put_displs", "recv_counts"):
        np.testing.assert_array_equal(getattr(plan, key), jax_ref[f"{name}/{key}"])
    summary = json.loads(str(jax_ref[f"{name}/summary"]))
    mine = plan.metadata_summary()
    for key in parity.RAGGED_SUMMARY_KEYS:
        assert mine[key] == summary[key], key
    assert plan.signature.digest == summary["digest"]
    assert plan.index_tables is None and mine["variant"] == "ragged"


@pytest.mark.parametrize("name", CASES)
def test_epoch_matches_oracle_and_fence(name):
    """Valid rows bit-equal to the oracle and to the port's fence plan;
    repeated epochs give the same rows."""
    counts = counts_of(name)
    plan = ragged_plan(counts)
    bufs, x = send_buffer(plan, counts)
    want = jax_reference.alltoallv_global(bufs, counts, plan.recv_rows)
    got = plan.wait(plan.start(x)).numpy().reshape(want.shape)
    assert_valid_rows(got, want, counts)
    fence = alltoallv_init(counts, FEATURE, torch.float32,
                           VirtualMesh((counts.shape[0],), ("x",), device="cpu"),
                           axis="x", variant="fence", pack_impl="fused",
                           cache=PlanCache())
    assert (fence.send_rows, fence.recv_rows) == (plan.send_rows, plan.recv_rows)
    assert_valid_rows(got, fence.wait(fence.start(x)).numpy().reshape(want.shape),
                      counts)
    again = plan.wait(plan.start(x)).numpy().reshape(want.shape)
    np.testing.assert_array_equal(again.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("name", CASES)
def test_stale_rows_kept(name):
    """Rows past each rank's recv count keep the window's earlier bytes, in
    every pipelined slot."""
    counts = counts_of(name)
    plan = ragged_plan(counts)
    bufs, x = send_buffer(plan, counts)
    rc = md.recv_counts(counts).sum(axis=1)
    want = jax_reference.alltoallv_global(bufs, counts, plan.recv_rows)
    for slot_value in (7.0, -3.5):
        win = plan.start_pipelined(x)
        win.fill_(slot_value)
        plan.start_pipelined(x)              # the other slot
        win2 = plan.start_pipelined(x)       # back to the filled slot
        assert win2.data_ptr() == win.data_ptr()
        got = plan.wait(win2).numpy().reshape(want.shape)
        assert_valid_rows(got, want, counts)
        for r in range(counts.shape[0]):
            assert (got[r, rc[r]:] == slot_value).all()


@pytest.mark.parametrize("name", CASES)
def test_flat_gather_and_run_table_cover_the_window(name):
    """The INIT-baked flat gather puts each valid row once, at
    ``j*R + put_displs[i, j] + k``; its run table (16-byte rows) covers the
    ``[1, P*R]`` window once, in order, with zero chunks for the padding."""
    counts = counts_of(name)
    plan = ragged_plan(counts)
    p, s, r = plan.p, plan.send_rows, plan.recv_rows
    idx, valid = plan._table_host
    assert idx.shape == valid.shape == (1, p * r) and idx.dtype == np.int32
    assert int(valid.sum()) == int(counts.sum())
    for i in range(p):
        for j in range(p):
            n = int(counts[i, j])
            out0 = j * r + plan.put_displs[i, j]
            np.testing.assert_array_equal(
                idx[0, out0:out0 + n], i * s + plan.sdispls[i, j] + np.arange(n))
    rb = int(np.prod(FEATURE)) * 4
    runs = gather_rows.bake_runs(torch.from_numpy(idx), torch.from_numpy(valid),
                                 rb, host=(idx, valid))
    table = runs.chunks.numpy()
    rows = table[:, gather_rows.ROWS]
    assert rows.sum() == p * r and (rows <= gather_rows.RUN_CHUNK_BYTES // rb).all()
    zeros = table[:, gather_rows.SOURCE] == gather_rows.ZEROS
    assert rows[zeros].sum() == p * r - int(counts.sum())
    assert runs.x_rows <= p * s


def test_plan_kernels_and_compile_on_cpu():
    """The ragged plan names one kernel, K1 from its run table; CPU plans
    bake no run table, and ``embed()`` refuses the variant."""
    plan = ragged_plan(counts_of("dense8"))
    assert [k.name for k in plan.kernels()] == [gather_rows.RUNS.name]
    assert plan._run_sources() == {"ragged": (0, None)}
    plan.compile()
    assert plan.run_tables == {}
    with pytest.raises(ValueError, match="cannot be embedded"):
        plan.embed()


def test_ragged_tables_refuse_int32_overflow():
    """The flat gather's entries must fit int32 (K1's tables)."""
    counts = np.ones((4, 4), np.int64)
    with pytest.raises(ValueError, match="int32"):
        variants.ragged_tables(counts, md.displacements(counts),
                               md.put_displacements(counts), 2 ** 30, 8)


@pytest.mark.parametrize("kwargs,match", [
    ({"codec": "int8", "error_tol": 0.1}, "codec='identity' only"),
    ({"codec": "bf16", "error_tol": 0.1}, "codec='identity' only"),
    ({"pack_impl": "fused"}, "requires variant='fence'"),
])
def test_jax_errors(kwargs, match):
    """Ragged with a codec, or with the fused pack, raises the JAX
    package's ValueError."""
    with pytest.raises(ValueError, match=match):
        ragged_plan(counts_of("dense4"), **kwargs)


def test_two_axes_raise():
    """Ragged takes a single axis, as in the JAX package."""
    with pytest.raises(ValueError, match="single axis"):
        alltoallv_init(counts_of("dense8"), FEATURE, torch.float32,
                       VirtualMesh((2, 4), ("o", "i"), device="cpu"),
                       axis=("o", "i"), variant="ragged", cache=PlanCache())
