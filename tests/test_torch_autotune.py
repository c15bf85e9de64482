"""The port's ``variant="auto"`` (``repro_torch.core.autotune``) against the
JAX package's (``repro.core.autotune``), on the CPU.

In process: ``decision_signature`` digests equal JAX's over fence, lock,
the hierarchy, the collective families, ``embeddable`` and ``error_tol``
codec sets; ``candidate_variants`` equal JAX's plus ``ragged`` on every
single-axis alltoallv (a difference by design: XLA:CPU cannot run JAX's
ragged epoch, the port runs its own on every device); ``_candidate_spec``
equal.

Against one JAX subprocess (``tests/_torch_parity_jax_autotune.py``, 8 host
devices): both packages' sweeps run with ``measure_arms`` replaced by the
same table of arm times, on ``VirtualMesh(..., device="cpu")`` here.  The
decision, the arm times, every ``measure_arms`` call (the clear winner,
the refinement of two finalists within 25 %, the ``variant@codec`` arms),
the burst counts and the winner's digest must be equal, the port's ragged
arm aside; ``codec_fits`` equals JAX's ``breakeven.codec_fits`` on the same
times.  A warm decision runs no sweep, decisions made on two devices never
alias, the auto plan's valid rows equal the numpy oracles, and the MoE
layer with ``a2a_variant="auto"`` is bit-equal to its fence layer.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity_jax_autotune as parity
from repro import compat as jcompat
from repro.core import autotune as jauto
from repro.core import breakeven as jbe
from repro.core import patterns as jpatterns
from repro.core import plan as jplan
from repro.core import reference as jreference
from repro_torch.configs.base import MoEConfig
from repro_torch.core import INIT_STATS, PlanCache, autotune, exchange_init
from repro_torch.core import breakeven as tbe
from repro_torch.core import metadata as md
from repro_torch.core import patterns as tpatterns
from repro_torch.core import plan as tplan
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.models import moe
from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = parity.TOL_INT8


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_autotune") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "_torch_parity_jax_autotune.py"),
         str(out)], capture_output=True, text=True, timeout=600, env=env,
        cwd=ROOT)
    if r.returncode != 0:
        raise AssertionError(f"JAX reference run failed:\n{r.stderr[-5000:]}")
    with open(out) as f:
        return json.load(f)


class _Mesh:
    """The mesh shape is all the JAX signature code reads."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


# name -> (collective, mesh shape, axis, spec fields, embeddable, error_tol)
SPECS = {
    "fence": ("alltoallv", (8,), ("x",), {}, False, None),
    "fence_embed": ("alltoallv", (8,), ("x",), {}, True, None),
    "fused": ("alltoallv", (8,), ("x",), {"pack_impl": "fused"}, False, None),
    "lock_pairwise": ("alltoallv", (8,), ("x",),
                      {"variant": "lock", "lock_schedule": "pairwise",
                       "tile_rows": 16}, False, None),
    "codec_int8": ("alltoallv", (8,), ("x",), {}, False, TOL),
    "codec_fp8_embed": ("alltoallv", (8,), ("x",), {"pack_impl": "pallas"},
                        True, 0.1),
    "codec_identity_only": ("alltoallv", (8,), ("x",), {}, False, 0.001),
    "bf16_rows": ("alltoallv", (8,), ("x",),
                  {"dtype": "bfloat16", "feature_shape": (3, 5)}, False, TOL),
    "unbaked": ("alltoallv", (8,), ("x",), {"baked_metadata": False}, False,
                None),
    "hier_fused": ("alltoallv", (4, 2), ("o", "i"),
                   {"variant": "fence_hierarchy", "pack_impl": "fused"},
                   False, None),
    "hier_perm": ("alltoallv", (4, 2), ("o", "i"),
                  {"variant": "fence_hierarchy",
                   "hier_leader_perm": ((1, 0),) * 4}, True, TOL),
    "two_axis_fence": ("alltoallv", (4, 2), ("o", "i"), {}, False, None),
    "outer_one": ("alltoallv", (1, 8), ("o", "i"), {}, False, None),
    "allgatherv": ("allgatherv", (8,), ("x",), {}, False, TOL),
    "allgatherv_hier": ("allgatherv", (2, 4), ("o", "i"), {}, True, None),
    "reduce_scatter": ("reduce_scatter", (8,), ("x",), {}, False, TOL),
}


def _specs(name):
    """The same spec in both packages, and the shape-only mesh."""
    collective, shape, axes, fields, _, _ = SPECS[name]
    rng = np.random.default_rng(len(name))
    counts = (rng.integers(0, 7, (8, 8)) if collective == "alltoallv"
              else rng.integers(1, 7, 8))
    kw = {"feature_shape": (4,), "dtype": "float32", "variant": "fence",
          "axis": axes, "collective": collective, **fields}
    kw["send_counts"] = tpatterns.as_matrix(collective, counts)
    jkw = dict(kw, dtype=jnp.dtype(kw["dtype"]),
               send_counts=jpatterns.as_matrix(collective, counts))
    return (jplan.ExchangeSpec(**jkw), tplan.ExchangeSpec(**kw),
            _Mesh(shape, axes), VirtualMesh(shape, axes, device="cpu"))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_decision_signature_matches_jax(name):
    """Digest for digest, incl. ``auto`` vs ``auto_embed``, the
    ``auto[int8,bf16,identity]`` codec string and the row bytes."""
    _, _, _, _, embeddable, tol = SPECS[name]
    jspec, tspec, jmesh, tmesh = _specs(name)
    want = jauto.decision_signature(jspec, jmesh, embeddable=embeddable,
                                    error_tol=tol)
    got = autotune.decision_signature(tspec, tmesh, embeddable=embeddable,
                                      error_tol=tol)
    assert got.digest == want.digest
    other = autotune.decision_signature(tspec, tmesh,
                                        embeddable=not embeddable,
                                        error_tol=tol)
    assert other.digest != got.digest


@pytest.mark.parametrize("name", sorted(SPECS))
def test_candidate_variants_are_jax_plus_ragged(name):
    """JAX adds ragged only where XLA can execute it (not on the CPU); the
    port runs it on every device, so single-axis alltoallv sweeps rank it
    too.  Every other candidate, and its spec, is JAX's."""
    assert not jcompat.ragged_alltoall_executes()
    collective, _, axes, _, _, _ = SPECS[name]
    jspec, tspec, jmesh, tmesh = _specs(name)
    want = jauto.candidate_variants(jspec, jmesh)
    extra = ["ragged"] if collective == "alltoallv" and len(axes) == 1 else []
    got = autotune.candidate_variants(tspec, tmesh)
    assert got == want + extra
    for v in got:
        for cdc in ("identity", "int8"):
            if cdc != "identity" and (v == "ragged"
                                      or collective != "alltoallv"
                                      or not tspec.baked_metadata):
                continue
            t = autotune._candidate_spec(tspec, v, cdc)
            j = jauto._candidate_spec(jspec, v, cdc)
            for f in ("variant", "codec", "pack_impl", "hier_leader_perm",
                      "lock_schedule", "tile_rows", "baked_metadata", "axis",
                      "collective"):
                assert getattr(t, f) == getattr(j, f), (v, cdc, f)


def _run_port(name, monkeypatch):
    """The case's two auto INITs on one cache, with the table's times."""
    collective, shape, axis, _, opts, _ = parity.CASES[name]
    axes = (axis,) if isinstance(axis, str) else axis
    mesh = VirtualMesh(shape, axes, device="cpu")
    calls, stats = [], []
    monkeypatch.setattr(tbe, "measure_arms",
                        parity.fake_measure_arms(name, calls))
    cache = PlanCache()
    for _ in range(2):
        before = INIT_STATS.as_dict()
        plan = exchange_init(collective, parity.case_counts(name),
                             parity.FEATURE, torch.float32, mesh, axis=axis,
                             variant="auto", cache=cache, **opts)
        after = INIT_STATS.as_dict()
        stats.append({k: after[k] - before[k]
                      for k in ("autotune_sweeps", "autotune_bursts")})
    return plan, calls, stats


def _jax_arms(arms):
    return [a for a in arms if not a.startswith("ragged")]


@pytest.mark.parametrize("name", sorted(parity.CASES))
def test_autotune_matches_jax(jax_ref, name, monkeypatch):
    want = jax_ref[name]
    plan, calls, stats = _run_port(name, monkeypatch)
    choice = plan.auto_choice
    assert (choice["variant"], choice["codec"]) == (want["variant"],
                                                    want["codec"])
    assert {a: t for a, t in choice["times"].items()
            if a in _jax_arms(choice["times"])} == want["times"]
    ragged_arms = len(choice["times"]) - len(want["times"])
    assert len(calls) == len(want["calls"])
    for got_call, want_call in zip(calls, want["calls"]):
        assert dict(got_call, arms=_jax_arms(got_call["arms"])) == want_call
    bursts = calls[0]["bursts"]
    assert stats[0] == {"autotune_sweeps": 1, "autotune_bursts":
                        want["stats"][0]["autotune_bursts"]
                        + bursts * ragged_arms}
    assert stats[1] == want["stats"][1] == {"autotune_sweeps": 0,
                                            "autotune_bursts": 0}
    assert plan.signature.digest == want["digest"]
    assert {f: getattr(plan.spec, f) for f in want["spec"]} == want["spec"]
    fit = choice["breakeven"]
    ranked = sorted(choice["times"].values())
    assert fit["t_best"] == ranked[0] and fit["t_second"] == ranked[1]
    assert fit["n_amortize"] == math.ceil(fit["sweep_seconds"]
                                          / (ranked[1] - ranked[0]))
    if "codec_fits" in choice:
        per_codec = {}
        for arm, t in choice["times"].items():
            cdc = autotune._split_arm(arm)[1]
            per_codec[cdc] = min(per_codec.get(cdc, math.inf), t)
        assert choice["codec_fits"] == jbe.codec_fits(per_codec,
                                                      fit["sweep_seconds"])
        assert choice["codec_fits"]["int8"]["n_amortize_vs_identity"] >= 1


def test_embeddable_never_picks_ragged(monkeypatch):
    """Ragged fastest by far: a plain sweep picks it, an embeddable one
    measures fence and lock only."""
    counts = parity.case_counts("clear")
    mesh = VirtualMesh((8,), ("x",), device="cpu")
    times = {"fence": 2e-3, "lock": 3e-3, "ragged": 1e-4}
    monkeypatch.setattr(tbe, "measure_arms",
                        lambda arms, **kw: {a: times[a] for a in arms})
    cache = PlanCache()
    plain = exchange_init("alltoallv", counts, (4,), torch.float32, mesh,
                          variant="auto", cache=cache)
    embed = exchange_init("alltoallv", counts, (4,), torch.float32, mesh,
                          variant="auto", cache=cache, embeddable=True)
    assert plain.spec.variant == "ragged" and embed.spec.variant == "fence"
    assert sorted(embed.auto_choice["times"]) == ["fence", "lock"]
    assert len(cache.auto_choices) == 2


def test_decisions_on_two_devices_never_alias(monkeypatch):
    """A decision measured on a card is keyed by its device: a CPU INIT of
    the same pattern does not replay it, but sweeps on its own."""
    counts = parity.case_counts("refine")
    mesh = VirtualMesh((8,), ("x",), device="cpu")
    cache = PlanCache()
    spec = tplan.ExchangeSpec(send_counts=counts, feature_shape=(4,),
                              dtype=torch.float32, axis=("x",))
    sig = autotune.decision_signature(spec, mesh)
    card = {"variant": "lock", "codec": "identity", "times": {"lock": 1e-3}}
    cache.auto_choices[(sig, torch.device("cuda", 0))] = card
    times = {"fence": 1e-3, "lock": 5e-3, "ragged": 9e-3}
    monkeypatch.setattr(tbe, "measure_arms",
                        lambda arms, **kw: {a: times[a] for a in arms})
    sweeps = INIT_STATS.autotune_sweeps
    plan = exchange_init("alltoallv", counts, (4,), torch.float32, mesh,
                         variant="auto", cache=cache)
    assert INIT_STATS.autotune_sweeps == sweeps + 1
    assert plan.spec.variant == "fence" and plan.auto_choice is not card
    assert cache.auto_choices[(sig, torch.device("cuda", 0))] is card
    assert cache.auto_choices[(sig, mesh.device)] is plan.auto_choice
    again = exchange_init("alltoallv", counts, (4,), torch.float32, mesh,
                          variant="auto", cache=cache)
    assert again is plan and INIT_STATS.autotune_sweeps == sweeps + 1
    forced = autotune.autotune_variant(spec, mesh, cache, force_measure=True,
                                       annotate={"reason": "stale"})
    assert INIT_STATS.autotune_sweeps == sweeps + 2
    assert forced.auto_choice["reason"] == "stale"


def _valid_rows_equal(got, want, n_valid):
    for r, n in enumerate(n_valid):
        np.testing.assert_array_equal(got[r, :n].view(np.uint32),
                                      want[r, :n].view(np.uint32))


@pytest.mark.parametrize("collective,shape,pack_impl", [
    ("alltoallv", (8,), "fused"), ("alltoallv", (2, 4), "fused"),
    ("alltoallv", (8,), "jnp"), ("allgatherv", (2, 4), "jnp"),
    ("reduce_scatter", (8,), "jnp")])
def test_auto_plan_matches_the_oracle(collective, shape, pack_impl):
    """Measured for real on the CPU: whatever wins, its epoch's valid rows
    equal the JAX package's numpy oracle (integer-valued rows, so the
    reduce-scatter sums are exact)."""
    axes = ("x",) if len(shape) == 1 else ("o", "i")
    p = int(np.prod(shape))
    rng = np.random.default_rng(p + len(collective))
    counts = (rng.integers(0, 9, (p, p)) if collective == "alltoallv"
              else rng.integers(1, 9, p))
    mesh = VirtualMesh(shape, axes, device="cpu")
    plan = exchange_init(collective, counts, (4,), torch.float32, mesh,
                         axis=axes if len(axes) > 1 else axes[0],
                         variant="auto", pack_impl=pack_impl,
                         cache=PlanCache(), autotune_iters=3)
    assert plan.spec.variant == plan.auto_choice["variant"]
    bufs = rng.integers(-8, 9, (p, plan.send_rows, 4)).astype(np.float32)
    got = plan.wait(plan.start(torch.from_numpy(bufs.reshape(-1, 4))))
    got = got.numpy().reshape(p, plan.recv_rows, 4)
    want = jpatterns.get(collective).reference(bufs, counts, plan.recv_rows)
    if collective == "alltoallv":
        n_valid = md.recv_counts(counts).sum(axis=1)
        _valid_rows_equal(got, jreference.alltoallv_global(
            bufs, counts, plan.recv_rows), n_valid)
    else:
        n_valid = ([counts.sum()] * p if collective == "allgatherv"
                   else counts)
    _valid_rows_equal(got, want, n_valid)


def test_moe_auto_layer_is_bit_equal_to_fence():
    """OLMoE-shaped routing at a CPU size on EP 8: the layer built with
    ``a2a_variant="auto"`` (its dispatch resolved to the measured winner)
    gives the fence layer's output and aux losses bit for bit."""
    d, e, t = 16, 8, 64
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                  * 0.25)
              for k, s in (("router", (d, e)), ("w_gate", (e, d, 32)),
                           ("w_up", (e, d, 32)), ("w_down", (e, 32, d)))}
    x = torch.from_numpy(rng.standard_normal((1, t, d)).astype(np.float32))
    mesh = VirtualMesh((1, 8), ("data", "model"), device="cpu")
    out = {}
    for variant in ("fence", "auto"):
        cfg = MoEConfig(n_experts=e, top_k=2, d_expert=32,
                        a2a_variant=variant)
        with axis_rules(DEFAULT_RULES, mesh):
            plan = moe.MoEDispatchPlan.build(cfg, t, mesh, d_model=d,
                                             dtype=torch.float32,
                                             cache=PlanCache(),
                                             autotune_iters=3)
            out[variant] = (plan, *moe.apply_moe(params, x, cfg, plan))
    plan = out["auto"][0]
    assert plan.variant == plan.a2a.auto_choice["variant"] in ("fence", "lock")
    assert plan.a2a.p == 8 and plan.a2a.identity_maps
    for got, want in zip(out["auto"][1:], out["fence"][1:]):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="d_model"):
        with axis_rules(DEFAULT_RULES, mesh):
            moe.MoEDispatchPlan.build(
                dataclasses.replace(cfg, a2a_variant="auto"), t, mesh)
