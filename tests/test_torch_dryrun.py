"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``).

One JAX subprocess runs the CI capture cell (reduced OLMoE-1B-7B,
train_4k at 64 tokens x 8 on a (2, 4) mesh of 8 host devices); the port's
record of the same cell must hold the same ``plan_inits``, and a store
prewarmed from it makes the port's first INIT warm.  In process: for each
reduced architecture's train step, and for the prefill and decode of
OLMoE and Jamba, a CPU run and a ``meta`` trace give the same counter
totals (FLOPs, calls per kernel, collective stats); the catalogue equals
JAX's; the production meshes; the micro-batch ladder and the CLI."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import cells as jax_cells

from repro_torch import planstore
from repro_torch.configs import ShapeConfig, cells, get_reduced, list_archs
from repro_torch.core import INIT_STATS
from repro_torch.kernels import _build
from repro_torch.launch import dryrun
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (dp_size, make_host_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.planstore import PlanStore, prewarm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CI_CELL = ["--cell", "olmoe-1b-7b:train_4k", "--reduced", "--mesh-shape", "2,4",
           "--seq-len", "64", "--global-batch", "8"]
RECORD = "olmoe-1b-7b__train_4k__mesh2x4.json"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the reduced steps are small, and several
    threads per test worker oversubscribe the CPUs (a reduced Jamba step
    takes 0.3 s on one thread and 20 s on eight beside other work)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The JAX and the port's records of the CI capture cell."""
    root = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               REPRO_DRYRUN_DEVICES="8", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", *CI_CELL,
                        "--out", str(root / "jax")], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert dryrun.main([*CI_CELL, "--out", str(root / "port")]) == 0
    return {name: json.loads((root / name / RECORD).read_text())
            for name in ("jax", "port")} | {"root": root}


def test_plan_inits_equal_jax(records):
    """Equal INIT requests: the same fields, the dtype under its name in
    both packages (``float32``)."""
    jax_reqs = records["jax"]["plan_inits"]
    port_reqs = records["port"]["plan_inits"]
    assert len(jax_reqs) == 1
    assert port_reqs == jax_reqs
    req = port_reqs[0]
    assert req["dtype"] == "float32" and req["feature_shape"] == [128]
    assert np.array_equal(req["send_counts"], np.full((4, 4), 48))
    assert (req["variant"], req["pack_impl"]) == ("fence", "jnp")


def test_record_fields(records):
    port, jax = records["port"], records["jax"]
    for key in ("arch", "shape", "mesh", "chips", "kind", "n_micro"):
        assert port[key] == jax[key], key
    assert port["scan_correction"] is None
    kernels = port["counted"]["kernels"]
    # 4 MoE layers: dispatch and combine in the forward, the recomputation
    # and the backward (K2); gate and up in the forward and recomputation.
    # XLA's module holds the same 24 all-to-alls.
    assert kernels["K2"]["calls"] == 24 and kernels["K6"]["calls"] == 16
    assert port["collectives"]["counts"] == {"all-to-all": 24}
    assert jax["collectives"]["counts"]["all-to-all"] == 24
    roof = port["roofline"]
    assert roof["flops_per_chip"] == port["counted"]["flops"] / 8
    assert roof["dominant"] in ("compute", "memory", "collective")
    mem = port["memory_per_rank"]
    assert mem["total"] == sum(v for k, v in mem.items() if k != "total")
    assert port["memory_one_card"] >= mem["activations"] > 0


def test_prewarm_from_port_record_makes_first_init_warm(records, tmp_path):
    reqs = prewarm.requests_from_dryrun(str(records["root"] / "port"))
    assert reqs == records["port"]["plan_inits"]
    store = PlanStore(tmp_path / "store")
    report = prewarm.prewarm(reqs, store, device="cpu")
    assert [r["warm"] for r in report["prewarmed"]] == [False]
    INIT_STATS.reset()
    try:
        planstore.configure(PlanStore(tmp_path / "store"))
        bundle = steps_mod.make_train_bundle(
            get_reduced("olmoe-1b-7b"), ShapeConfig("train_4k", "train", 64, 8),
            make_mesh((2, 4), ("data", "model"), device="cpu"))
    finally:
        planstore.configure(None)
    assert bundle.moe_plan.a2a.warm_loaded
    assert INIT_STATS.table_bakes == 0


def _totals(arch, kind, device, mesh_dims=(1, 4)):
    cfg = get_reduced(arch)
    shape = ShapeConfig(kind, kind, 16, 2)
    mesh = make_mesh(mesh_dims, ("data", "model"), device=device)
    bundle = steps_mod.make_bundle(cfg, shape, mesh)
    inputs = dryrun.step_inputs(bundle, cfg, shape, device)
    _build.reset_counts()
    _, counter = dryrun.trace_step(bundle, inputs)
    counts = _build.counts()
    return ({"flops": counter.flops, "calls": counter.calls(),
             "kernels": counter.totals()["kernels"],
             "collectives": counter.stats().to_json()},
            sum(c["plain_calls"] for c in counts.values()),
            sum(c["launches"] for c in counts.values()))


@pytest.mark.parametrize("arch", list_archs())
def test_cpu_run_and_meta_trace_count_the_same_train_step(arch):
    cpu, cpu_plain, cpu_launches = _totals(arch, "train", "cpu")
    meta, meta_plain, meta_launches = _totals(arch, "train", "meta")
    assert cpu == meta
    assert cpu["flops"] > 0
    assert meta_plain == 0 and cpu_launches == meta_launches == 0
    assert cpu_plain == sum(cpu["calls"].values())


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_cpu_run_and_meta_trace_count_the_same_serving(arch, kind):
    cpu, _, _ = _totals(arch, kind, "cpu", (1, 8))
    meta, meta_plain, _ = _totals(arch, kind, "meta", (1, 8))
    assert cpu == meta and meta_plain == 0
    n_moe = sum(get_reduced(arch).is_moe_layer(i)
                for i in range(get_reduced(arch).n_layers))
    assert meta["calls"]["K2"] == 2 * n_moe and meta["calls"]["K6"] == 2 * n_moe


def test_cells_equal_jax_catalogue():
    got = [(c.name, s.name, why) for c, s, why in cells(include_skipped=True)]
    want = [(c.name, s.name, why) for c, s, why in jax_cells(True)]
    assert got == want and len(got) == 40
    assert [(c.name, s.name) for c, s, _ in cells()] == [
        (c.name, s.name) for c, s, _ in jax_cells()]
    assert sum(why is not None for *_, why in got) == 8


def test_production_and_host_meshes():
    single = make_production_mesh(multi_pod=False, device="meta")
    multi = make_production_mesh(multi_pod=True, device="meta")
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert dp_size(single) == 16 and dp_size(multi) == 32
    host = make_host_mesh(8, device="cpu")
    assert host.shape == {"x": 8} and host.device.type == "cpu"
    assert make_host_mesh(device="meta").shape == {"x": 1}


def test_micro_batch_ladder_and_cli(tmp_path, monkeypatch, capsys):
    """Over the budget, a train cell climbs JAX's ladder to 8 micro-batches
    (a dense model: the same FLOPs); ``--list`` names the cells; a failing
    cell makes the run exit nonzero."""
    cfg = get_reduced("olmo-1b")
    shape = ShapeConfig("train_4k", "train", 32, 8)
    mesh = make_mesh((1, 4), ("data", "model"), device="meta")
    first = dryrun.run_cell(cfg, shape, mesh, "m", None)
    monkeypatch.setattr(dryrun, "HBM_BUDGET", 0)
    laddered = dryrun.run_cell(cfg, shape, mesh, "m", None)
    assert first["n_micro"] == 1 and laddered["n_micro"] == 8
    assert laddered["counted"]["flops"] == first["counted"]["flops"]
    capsys.readouterr()
    assert dryrun.main(["--list", "--mesh", "single"]) == 0
    listed = capsys.readouterr().out.split()
    assert len(listed) == 32 and "olmoe-1b-7b:train_4k" in listed

    def boom(*args, **kwargs):
        raise RuntimeError("no fit")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    assert dryrun.main(["--cell", "olmo-1b:train_4k", "--reduced",
                        "--mesh-shape", "1,4", "--out", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "1 FAILURES" in out and "olmo-1b:train_4k:mesh1x4" in out
