"""The pod-aware reduce of the port (``parallel/collectives.py``) against
the JAX package on a ``(2, 4)`` ("pod", "data") mesh.

One JAX subprocess (``tests/_torch_parity_jax_families.py collectives``,
~6 s alone) runs ``hierarchical_psum_mean`` raw and plan-backed and
``flat_psum_mean`` under ``shard_map`` at ``dist_cases``' shapes (each rank
a ``[1, 16, 32]`` shard, scatter dim 1) and at a row count the inner axis
does not divide (``[1, 13, 32]``: the raw path falls back to the flat sum,
the plan pads), and ``plan_rs_ag_pair``'s capacity for a few row counts.
The port holds the global view ``[8, *local]`` on
``VirtualMesh(..., device="cpu")``.

Tolerances (float32, sums in another order): rtol 1e-5, atol 1e-6, as
``dist_cases``' hierarchical_psum; capacities equal; the port's three paths
against each other the same.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity_jax_families as parity
from repro_torch.core import metadata as md
from repro_torch.kernels import _build
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = VirtualMesh((2, 4), ("pod", "data"), device="cpu")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_collectives") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, "tests", "_torch_parity_jax_families.py"),
         "collectives", str(out)], capture_output=True, text=True,
        timeout=600, env=env, cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def port_reduce(x: torch.Tensor, name: str) -> torch.Tensor:
    with axis_rules(DEFAULT_RULES, MESH):
        if name == "flat":
            return collectives.flat_psum_mean(x, ("pod", "data"))
        return collectives.hierarchical_psum_mean(
            x, inner_axis="data", outer_axis="pod", scatter_dim=1,
            mesh=MESH if name == "plan" else None)


@pytest.mark.parametrize("name", ["raw", "plan", "flat"])
@pytest.mark.parametrize("i", range(len(parity.REDUCE_SHAPES)))
def test_reduce_matches_jax(ref, i, name):
    local = parity.REDUCE_SHAPES[i]
    x = torch.from_numpy(ref[f"{i}/x"]).reshape((8,) + local)
    got = port_reduce(x, name)
    assert got.shape == x.shape
    want = ref[f"{i}/{name}"].reshape((8,) + local)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    flat = port_reduce(x, "flat")
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-5, atol=1e-6)


def test_pair_capacity_matches_jax(ref):
    caps = []
    for rows in parity.PAIR_ROWS:
        rs, ag, cap = collectives.plan_rs_ag_pair(rows, (4,), torch.float32,
                                                  "data", MESH)
        assert cap % md.TILE_ROWS == 0 and 4 * cap >= rows
        assert rs.spec.collective == "reduce_scatter" and rs.p == 4
        assert ag.spec.collective == "allgatherv" and ag.p == 4
        assert rs.recv_rows == cap and ag.send_rows == cap
        caps.append(cap)
    assert caps == ref["pair_caps"].tolist()


def test_plan_backed_reduce_runs_one_rs_epoch_per_pod():
    """The plan-backed path: one reduce-scatter fence epoch per pod (K2's
    plain version here), the cross-pod sum, and the allgatherv's bare
    gather (no exchange); a second call reuses both plans."""
    x = torch.randn((8, 32, 16), generator=torch.Generator().manual_seed(3))
    port_reduce(x, "plan")
    k2 = _build.counts()["a2a_fence"]["plain_calls"]
    got = port_reduce(x, "plan")
    assert _build.counts()["a2a_fence"]["plain_calls"] - k2 == 2
    want = x.sum(0, keepdim=True).expand_as(x) / 8
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="ranks"):
        port_reduce(x[:4], "plan")
