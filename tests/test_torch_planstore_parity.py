"""The port's plan store against the JAX package's: one file format, two
environments that never warm each other, one record format.

One JAX subprocess (``tests/_torch_parity_jax_planstore.py``, 8 host
devices) INITs the cases of ``CASES`` on (8,) and (2, 4) against a JAX
``PlanStore`` with capture on, and decodes and validates the files the
port wrote for the same cases (cold INITs on the CPU, before the
subprocess starts).  Held here:

  * JAX-written files decode in the port's codec with every table
    bit-equal to the port's cold bake of the same pattern;
  * port-written files decode in the JAX codec with every table equal (by
    sha256) to the port's;
  * each package's validation rejects the other's file, and neither
    package's store finds it: a file never warms across packages;
  * the JAX-captured INIT records replay through the port's prewarm to
    plans with the JAX plans' digests (an auto record to the JAX decision
    signature), and a second replay is warm.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity_jax_planstore as parity
from repro_torch.core import INIT_STATS, PlanCache, autotune, exchange_init
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.planstore import ArtifactError, PlanStore, codec, prewarm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base = tmp_path_factory.mktemp("planstore_parity")
    jax_dir, port_dir = base / "jax", base / "port"
    jax_dir.mkdir()
    cache, decisions = PlanCache(), {}
    store = PlanStore(port_dir)
    for name, (coll, shape, names, axis, _, opts) in parity.CASES.items():
        mesh = VirtualMesh(shape, names, device="cpu")
        plan = exchange_init(coll, parity.case_counts(name), parity.FEATURE,
                             torch.float32, mesh, axis=axis, cache=cache,
                             store=store, **opts)
        if opts["variant"] == "auto":
            decisions[name] = autotune.decision_signature(plan.spec, mesh)
    out = base / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_parity_jax_planstore.py"),
         str(jax_dir), str(port_dir), str(out)],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with open(out) as f:
        data = json.load(f)
    plans = {sig.digest: plan for (sig, _), plan in cache._plans.items()}
    return {"json": data, "jax_dir": jax_dir, "port_dir": port_dir,
            "plans": plans, "decisions": decisions}


def _tables(art) -> dict:
    """An artifact's or plan's tables by the codec's segment names."""
    out = {}
    if art.index_tables is not None:
        for n in ("pack_src", "pack_valid", "unpack_src", "unpack_valid"):
            out[n] = np.asarray(getattr(art.index_tables, n))
    if art.hier_schedule is not None:
        for n in ("s1_src", "s1_valid", "s2_src", "s2_valid", "s3_src",
                  "s3_valid", "unpack_src", "unpack_valid"):
            out["hier_" + n] = np.asarray(getattr(art.hier_schedule, n))
    return out


def _files(d):
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".plan"))


def test_jax_files_decode_in_port_codec_bit_equal(ref):
    """Every JAX entry decodes in the port's codec; its tables are bit-equal
    (values, dtype, shape) to the port's cold bake of the same pattern, and
    its environment keys read ``"<missing>"``."""
    seen = set()
    for path in _files(ref["jax_dir"]):
        art = codec.load(path)
        assert art.torch_version == art.device_kind == "<missing>"
        digest = art.signature["digest"]
        if art.payload_kind == "meta_only":
            assert art.auto_choice["variant"] in ("fence", "lock",
                                                  "fence_hierarchy")
            assert digest == ref["decisions"]["auto24"].digest
            continue
        want = _tables(ref["plans"][digest])
        got = _tables(art)
        assert sorted(got) == sorted(want)
        for n in want:
            assert got[n].dtype == want[n].dtype and np.array_equal(got[n],
                                                                    want[n])
        seen.add(digest)
    assert seen == set(ref["json"]["jax_tables"])


def test_port_files_decode_in_jax_codec_bit_equal(ref):
    """Every port entry decodes in the JAX codec with every table equal, by
    sha256 over dtype, shape and bytes, to the port's own; its JAX
    environment keys read ``"<missing>"``."""
    files = ref["json"]["port_files"]
    assert sorted(files) == sorted(os.path.basename(p)
                                   for p in _files(ref["port_dir"]))
    for name, rec in files.items():
        assert rec["jax_version"] == rec["backend"] == "<missing>"
        art = codec.load(os.path.join(ref["port_dir"], name))
        assert rec["payload"] == art.payload_kind
        assert rec["tables"] == {n: parity.sha(a)
                                 for n, a in _tables(art).items()}
        if rec["payload"] != "meta_only":
            assert rec["tables"] == parity.artifact_tables(
                ref["plans"][rec["digest"]])
        else:
            assert rec["auto_choice"] == art.auto_choice


def test_each_package_rejects_the_others_file(ref, tmp_path):
    """The JAX validation rejects every port file (its jax version reads
    ``"<missing>"``) and a JAX store over the port's directory finds none;
    the port's validation rejects every JAX file, a JAX file copied under
    the port's key is an invalid entry, and the INIT stays cold."""
    for rec in ref["json"]["port_files"].values():
        assert "jax version" in rec["jax_validation"]
        assert rec["jax_store_hit"] is False
    plans = ref["plans"]
    port = PlanStore(tmp_path)
    for path in _files(ref["jax_dir"]):
        art = codec.load(path)
        digest = art.signature["digest"]
        if digest not in plans:
            continue
        sig = plans[digest].signature
        with pytest.raises(ArtifactError, match="torch version"):
            art.validate_against(sig)
        shutil.copy(path, port.path_for(sig, "cpu"))
        assert port.get(sig, "cpu") is None
    assert port.invalid == len(ref["json"]["jax_tables"])
    plan = plans[ref["json"]["plans"]["fence8"]["digest"]]
    shutil.copy(_files(ref["jax_dir"])[0], port.path_for(plan.signature, "cpu"))
    INIT_STATS.reset()
    again = exchange_init("alltoallv", parity.case_counts("fence8"),
                          parity.FEATURE, torch.float32, plan.mesh,
                          cache=PlanCache(), store=port)
    assert not again.warm_loaded and INIT_STATS.table_bakes == 1


def test_jax_records_replay_through_port_prewarm(ref, tmp_path):
    """The JAX-captured records (dtype names, axis sizes, options) replay
    through the port's prewarm on the CPU: each concrete request's plan has
    the JAX plan's digest and tables, the auto request the JAX decision
    signature; a second replay against the same store is warm."""
    reqs = ref["json"]["requests"]
    assert [r["variant"] for r in reqs] == [
        o["variant"] for *_, o in parity.CASES.values()]
    store = PlanStore(tmp_path)
    rows = prewarm.prewarm(reqs, store, device="cpu")["prewarmed"]
    for (name, want), row, req in zip(ref["json"]["plans"].items(), rows,
                                      reqs):
        if req["variant"] == "auto":
            plan = prewarm.init_from_request(req, store, device="cpu")
            assert autotune.decision_signature(
                plan.spec, plan.mesh).digest == want["decision_digest"]
            continue
        assert row["digest"] == want["digest"], name
        assert ref["json"]["jax_tables"][row["digest"]] == \
            parity.artifact_tables(ref["plans"][row["digest"]])
    INIT_STATS.reset()
    again = prewarm.prewarm(reqs, PlanStore(tmp_path), device="cpu")
    assert INIT_STATS.table_bakes == 0 and INIT_STATS.autotune_bursts == 0
    assert all(r["warm"] for r in again["prewarmed"]
               if r["variant"] != "ragged")
