"""The port's resilience layer (``repro_torch.runtime``: the skew monitor,
leader re-election, chaos injection, the re-plan ladder and elastic plan
resharding, and the trainer's and the launcher's wiring of them) against
the JAX package's (``repro.runtime``), on the CPU.

Everything the JAX side contributes is host numpy or runs on one device,
so both packages run in this process (no subprocess):

* ``rank_health``, ``role_carry``, ``permutation_cost`` and
  ``choose_leader_perm`` on seeded counts and healths: equal.
* ``reshard_counts`` and ``reshard_request`` on shrink, grow and the
  refused cases: equal.
* One epoch stream (and rank rings) fed to both packages'
  ``PlanSkewMonitor``: the same report at every ``observe``, ratios
  within 1e-12 and the same worst rank.
* ``ChaosInjector`` specs: the same parse, the same schedule of window
  failures, poison bytes, step faults and rank stalls, the same counters
  and the same parse errors.
* The ``ReplanManager`` stub scenarios of the JAX package's
  ``tests/test_runtime.py`` replayed against both managers: the same
  events, ladder positions and plans built.

Port only, with outputs held to the JAX package's numpy oracle
(``repro.core.reference``) bit for bit: on ``VirtualMesh((2, 4))`` a hot
swap (sustained-skew background re-plan, then a forced swap to the
runner-up) and a rung-0 leader re-bake (its permutation equal to JAX's
``choose_leader_perm`` over the same rank rings); chaos recovery on
``(8,)``; the reduced OLMoE trainer on ``(2, 1, 4)`` under ``hier_ep``
with a ``rank_slow`` chaos spec and ``replan`` re-electing its leaders,
losses bit-equal to the same run without chaos; the train launcher's
``--chaos ... --assert-recovery --replan-at`` and an ``--elastic`` resume
from ``(1, 8)`` onto ``(2, 4)``.  Timing gates of the JAX dist cases (the
15 % recovery of the epoch p50) are readings on a host this shared, not
gates: every loop here runs a bounded number of epochs or has a deadline.
"""

import dataclasses
import json
import os
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metadata as jmd
from repro.core import reference as jreference
from repro.core._exec_stats import EXEC_TELEMETRY as JTEL
from repro.core.plan import AlltoallvSpec as JSpec
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.runtime import chaos as jchaos
from repro.runtime import leader as jleader
from repro.runtime import replan as jreplan
from repro.runtime import straggler as jstraggler
from repro_torch.core import (EXEC_TELEMETRY as TTEL, INIT_STATS, PlanCache,
                              WindowCache, alltoallv_init)
from repro_torch.core import metadata as tmd
from repro_torch.core._exec_stats import EpochRing as TRing
from repro_torch.core.autotune import _candidate_spec, decision_signature
from repro_torch.core.plan import AlltoallvSpec as TSpec
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.planstore import PlanStore, parse_store_url
from repro_torch.runtime import chaos as tchaos
from repro_torch.runtime import fault as tfault
from repro_torch.runtime import leader as tleader
from repro_torch.runtime import replan as treplan
from repro_torch.runtime import straggler as tstraggler
from repro.core._exec_stats import EpochRing as JRing

DEADLINE_S = 60.0


def _plain(obj):
    """Tuples as lists, numpy scalars as Python numbers (JSON round trip)."""
    return json.loads(json.dumps(obj, default=lambda o: o.item()
                                 if hasattr(o, "item") else str(o)))


# --- leader election ------------------------------------------------------

LEADER_MESHES = ((2, 4), (4, 2), (3, 3), (8, 8), (5, 2))


def _leader_counts(po, pi, seed, kind):
    rng = np.random.default_rng(seed)
    p = po * pi
    c = rng.integers(0, 9, size=(p, p))
    if kind == "banded":      # sparse: most group pairs carry nothing
        i, j = np.indices((p, p))
        c = np.where(np.abs(i - j) <= pi, c, 0)
    return c


@pytest.mark.parametrize("kind", ["dense", "banded"])
@pytest.mark.parametrize("mesh", LEADER_MESHES)
def test_leader_functions_equal_jax(mesh, kind):
    po, pi = mesh
    p = po * pi
    rng = np.random.default_rng(po * 10 + pi)
    for seed in range(3):
        c = _leader_counts(po, pi, seed, kind)
        np.testing.assert_array_equal(tleader.role_carry(c, po, pi),
                                      jleader.role_carry(c, po, pi))
        health = np.ones(p)
        slow = rng.choice(p, size=1 + seed % 2, replace=False)
        health[slow] = rng.uniform(1.5, 4.0, size=slow.size)
        for h, exclude in ((None, ()), (health, ()), (health, tuple(slow)),
                           (None, (int(slow[0]),))):
            got = tleader.choose_leader_perm(c, po, pi, h, exclude=exclude)
            assert got == jleader.choose_leader_perm(c, po, pi, h,
                                                     exclude=exclude)
            hh = np.ones(p) if h is None else h
            for perm in (None, got):
                assert tleader.permutation_cost(c, po, pi, perm, hh) == \
                    jleader.permutation_cost(c, po, pi, perm, hh)
    with pytest.raises(ValueError):
        tleader.choose_leader_perm(np.ones((p, p)), po, pi, np.ones(p + 1))


def test_rank_health_equal_jax():
    rng = np.random.default_rng(5)
    digest = "parity-rank-health"
    try:
        for r in range(8):
            for t in rng.uniform(0.01, 0.02, size=6) * (3.0 if r == 5 else 1):
                TTEL.record_rank(digest, r, float(t))
                JTEL.record_rank(digest, r, float(t))
        np.testing.assert_array_equal(tleader.rank_health(digest, 8),
                                      jleader.rank_health(digest, 8))
        assert int(np.argmax(tleader.rank_health(digest, 8))) == 5
        # ranks past p are ignored; one sampled rank gives all-ones
        np.testing.assert_array_equal(tleader.rank_health(digest, 4),
                                      jleader.rank_health(digest, 4))
        np.testing.assert_array_equal(tleader.rank_health("parity-none", 4),
                                      np.ones(4))
    finally:
        TTEL.reset_rank_rings(digest)
        JTEL.reset_rank_rings(digest)


# --- elastic resharding ---------------------------------------------------

class _Mesh:
    """What ``reshard_request`` reads of a mesh, in either package."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


@pytest.mark.parametrize("p,p_new", [(8, 4), (8, 2), (8, 1), (4, 8),
                                     (2, 8), (6, 6), (6, 3), (3, 6)])
def test_reshard_counts_equal_jax(p, p_new):
    c = np.random.default_rng(p * 100 + p_new).integers(0, 17, size=(p, p))
    got = treplan.reshard_counts(c, p_new)
    np.testing.assert_array_equal(got, jreplan.reshard_counts(c, p_new))
    assert got.shape == (p_new, p_new) and got.sum() == c.sum()


def test_reshard_counts_refusals_equal_jax():
    c = np.ones((8, 8), np.int64)
    for bad in ((c, 3), (c[0], 4), (c, 0)):
        with pytest.raises(ValueError) as t_err:
            treplan.reshard_counts(*bad)
        with pytest.raises(ValueError) as j_err:
            jreplan.reshard_counts(*bad)
        assert str(t_err.value) == str(j_err.value)


RESHARD_REQUESTS = {
    "flat_fused_shrink": ({"axis": ["x"], "axis_sizes": [8],
                           "variant": "fence", "pack_impl": "fused"},
                          ((4,), ("x",))),
    "flat_grow": ({"axis": ["model"], "axis_sizes": [4], "variant": "lock",
                   "pack_impl": "fused"}, ((2, 8), ("data", "model"))),
    "hier_to_flat": ({"axis": ["o", "i"], "axis_sizes": [2, 4],
                      "variant": "fence_hierarchy", "pack_impl": "fused"},
                     ((4,), ("i",))),
    "hier_to_hier": ({"axis": ["o", "i"], "axis_sizes": [2, 4],
                      "variant": "fence_hierarchy", "pack_impl": "fused"},
                     ((2, 2), ("o", "i"))),
    "two_axis_fence": ({"axis": ["o", "i"], "axis_sizes": [2, 4],
                        "variant": "fence", "pack_impl": "fused"},
                       ((4, 4), ("o", "i"))),
    "ragged": ({"axis": ["x"], "axis_sizes": [8], "variant": "ragged"},
               ((2,), ("x",))),
}


@pytest.mark.parametrize("name", sorted(RESHARD_REQUESTS))
def test_reshard_request_equal_jax(name):
    req, (shape, axes) = RESHARD_REQUESTS[name]
    p = int(np.prod(req["axis_sizes"]))
    req = {**req, "send_counts": np.random.default_rng(p).integers(
        0, 9, size=(p, p)).tolist(), "feature_shape": [4], "dtype": "float32"}
    mesh = _Mesh(shape, axes)
    assert treplan.reshard_request(req, mesh) == \
        jreplan.reshard_request(req, mesh)


def test_reshard_request_refusals_equal_jax():
    req = {"axis": ["x"], "axis_sizes": [8], "variant": "fence",
           "send_counts": np.ones((8, 8), np.int64).tolist()}
    for mesh in (_Mesh((4,), ("y",)), _Mesh((3,), ("x",))):
        with pytest.raises(ValueError) as t_err:
            treplan.reshard_request(req, mesh)
        with pytest.raises(ValueError) as j_err:
            jreplan.reshard_request(req, mesh)
        assert str(t_err.value) == str(j_err.value)


# --- the skew monitor -----------------------------------------------------

def _epoch_stream(seed, n=80, hot_from=30, factor=2.5):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.009, 0.011, size=n)
    t[hot_from:] *= factor
    t[12] *= 4.0          # a one-off spike: forgiven
    return t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skew_monitor_reports_equal_jax(seed):
    digest = f"parity-skew-{seed}"
    stream = _epoch_stream(seed)
    rng = np.random.default_rng(seed + 10)
    slow = int(rng.integers(0, 8))
    kw = dict(threshold=1.6, window=4, sustain=2, warmup=6, digest=digest)
    t_ring, j_ring = TRing(), JRing()
    t_comp, j_comp = TRing(), JRing()
    mons = [(tstraggler.PlanSkewMonitor(t_ring, **kw),
             jstraggler.PlanSkewMonitor(j_ring, **kw)),
            (tstraggler.PlanSkewMonitor(t_ring, compute_ring=t_comp,
                                        attribution=1.0, **kw),
             jstraggler.PlanSkewMonitor(j_ring, compute_ring=j_comp,
                                        attribution=1.0, **kw))]
    fired = 0
    try:
        for e, dt in enumerate(stream):
            for ring in (t_ring, j_ring):
                ring.record(float(dt))
            c = 0.05 * (1.0 if e < 50 else 3.0)   # compute slows late
            t_comp.record(c)
            j_comp.record(c)
            for r in range(8):
                s = float(dt) * (3.0 if r == slow else 1.0)
                TTEL.record_rank(digest, r, s)
                JTEL.record_rank(digest, r, s)
            for tm, jm in mons:
                tr, jr = tm.observe(), jm.observe()
                assert (tr is None) == (jr is None), (e, tr, jr)
                assert tm.baseline == jm.baseline
                if tr is None:
                    continue
                fired += 1
                for f in ("epoch", "recent_mean", "baseline", "windows_hot",
                          "worst_rank"):
                    assert getattr(tr, f) == getattr(jr, f), f
                assert abs(tr.ratio - jr.ratio) <= 1e-12
                assert abs(tr.worst_rank_ratio - jr.worst_rank_ratio) <= 1e-12
                assert tr.worst_rank == slow
            if e == 60:
                tm, jm = mons[0]
                mons[0] = (tm.clone_for(t_ring, digest=digest),
                           jm.clone_for(j_ring, digest=digest))
            if e == 70:
                for tm, jm in mons:
                    tm.reset()
                    jm.reset()
        assert fired > 0
    finally:
        TTEL.reset_rank_rings(digest)
        JTEL.reset_rank_rings(digest)


# --- chaos injection ------------------------------------------------------

CHAOS_SPECS = (
    "seed=7,window_fail=0.25,fail_step=4+9,device_loss_step=11,"
    "stall_steps=3-5,stall_seconds=0.0001",
    "seed=3,window_fail_rate=0.5,fail_steps=2,device_loss_steps=5+7",
    "rank_slow=0:3.0+2:2.0,rank_slow_from=4,rank_slow_weight=0.05",
    "seed=11,rank_slow=5:1.5,stall_step=1,stall_seconds=0.0001",
    "",
)


class _FakeBackend:
    def __init__(self, keys):
        self._keys = list(keys)
        self.written = {}

    def keys(self):
        return list(self._keys)

    def put_bytes(self, key, data):
        self.written[key] = data


class _FakeStore:
    def __init__(self, keys):
        self.store_backend = _FakeBackend(keys)


def _chaos_trace(mod, spec):
    inj = mod.ChaosInjector.parse(spec)
    out = {"parse": [inj.seed, inj.window_fail_rate, sorted(inj.fail_steps),
                     sorted(inj.device_loss_steps), sorted(inj.stall_steps),
                     inj.stall_seconds, sorted(inj.rank_slow.items()),
                     inj.rank_slow_from, inj.rank_slow_weight]}
    windows = []
    for _ in range(40):
        try:
            inj.maybe_fail_window()
            windows.append(0)
        except mod.ChaosError as err:
            windows.append(str(err))
    out["windows"] = windows
    store = _FakeStore(["k1", "k2", "k3"])
    out["poisoned"] = inj.poison_store(store)
    out["poison_bytes"] = {k: v.hex()
                           for k, v in store.store_backend.written.items()}
    steps = []
    for step in list(range(13)) + [4, 8, 11]:
        try:
            inj.step_hook(step)
            steps.append(0)
        except mod.ChaosError as err:
            steps.append(str(err))
    out["steps"] = steps
    out["rank"] = [[inj.rank_slow_factors(s),
                    inj.scale_rank_times(s, {r: 1e-3 for r in range(6)}),
                    inj.maybe_rank_stall(s, carry, 1e-5)]
                   for s in range(7) for carry in (None, {0, 1}, {5})]
    out["injected"] = dict(inj.injected)
    return _plain(out)


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_chaos_schedule_equal_jax(spec):
    assert _chaos_trace(tchaos, spec) == _chaos_trace(jchaos, spec)


@pytest.mark.parametrize("spec", ["kill:1", "frobnicate=1", "seed",
                                  "rank_slow=0", "fail_step=x"])
def test_chaos_parse_errors_equal_jax(spec):
    with pytest.raises(ValueError) as t_err:
        tchaos.ChaosInjector.parse(spec)
    with pytest.raises(ValueError) as j_err:
        jchaos.ChaosInjector.parse(spec)
    assert str(t_err.value) == str(j_err.value)


def test_chaos_window_proxy_and_classification():
    inj = tchaos.ChaosInjector(seed=3, window_fail_rate=1.0)
    cache = inj.wrap_window_cache(WindowCache())
    with pytest.raises(tchaos.ChaosError) as err:
        cache.get(8, (4,), torch.float32)
    assert tfault.classify_failure(err.value) == "device_loss"
    assert cache.stats == {"hits": 0, "recreates": 0, "live": 0}
    inj.window_fail_rate = 0.0
    assert cache.get(8, (4,), torch.float32).rows == 8
    cache.free()
    assert inj.injected["window"] == 1


# --- the re-plan ladder: the JAX package's stub scenarios -------------------

class _StubPlan:
    def __init__(self, spec, digest):
        self.spec = spec
        self.signature = type("Sig", (), {"digest": digest})()
        self.auto_choice = None
        self.freed = False

    def free(self):
        self.freed = True


class _StubCache:
    """PlanCache stand-in: hands out stub plans keyed by spec.variant and
    keeps them (so a scenario can check free())."""

    def __init__(self, tag):
        self.auto_choices = {}
        self.built = []
        self.plans = []
        self.tag = tag

    def get(self, spec, mesh, store=None):
        self.built.append(spec.variant)
        p = _StubPlan(spec, f"digest{self.tag}-{spec.variant}")
        self.plans.append(p)
        return p


class _Pkg:
    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.replan, self.tel, self.md = jreplan, JTEL, jmd
            self.spec = lambda c, axis, **kw: JSpec(c, (4,), jnp.float32,
                                                    axis, **kw)
            self.mesh = jmake_mesh
        else:
            self.replan, self.tel, self.md = treplan, TTEL, tmd
            self.spec = lambda c, axis, **kw: TSpec(c, (4,), "float32",
                                                    axis, **kw)
            self.mesh = lambda shape, axes: VirtualMesh(shape, axes,
                                                        device="cpu")

    def flat_spec(self):
        return self.spec(np.array([[3]]), ("x",), variant="lock")

    def hier_plan(self, digest, p_outer=2, p_inner=4):
        p = p_outer * p_inner
        counts = np.ones((p, p), np.int64)
        plan = _StubPlan(self.spec(counts, ("o", "i"),
                                   variant="fence_hierarchy"), digest)
        plan.p, plan.p_outer, plan.p_inner = p, p_outer, p_inner
        plan.send_counts = counts
        plan.hier_schedule = type("HS", (), {
            "leader_perm": self.md.normalize_leader_perm(None, p_outer,
                                                         p_inner)})()
        return plan


def _manager_state(mgr, cache, plans=()):
    return _plain({"events": mgr.events, "stage": mgr._ladder_stage,
                   "rebakes": mgr.leader_rebakes,
                   "replans": mgr.replans_completed,
                   "built": cache.built, "live": mgr.plan.spec.variant,
                   "perm": mgr.plan.spec.hier_leader_perm,
                   "freed": [p.freed for p in plans],
                   "choices": list(cache.auto_choices.values())})


def _sc_autotuner_faults(pkg, mp):
    def boom(*a, **k):
        raise RuntimeError("autotuner exploded")

    mp.setattr(pkg.replan, "autotune_variant", boom)
    old = _StubPlan(pkg.flat_spec(), "digest-old")
    cache = _StubCache("-f")
    mgr = pkg.replan.ReplanManager(old, pkg.mesh((1,), ("x",)), cache,
                                   background=False)
    mgr.trigger("unit")
    assert mgr.observe()
    return _manager_state(mgr, cache, [old])


def _sc_rung0_then_recovery(pkg, mp):
    old = pkg.hier_plan("lead-old")
    cache = _StubCache("-r0")
    try:
        for r in range(8):
            for _ in range(4):
                pkg.tel.record_rank("lead-old", r, 0.3 if r == 0 else 0.1)
        mgr = pkg.replan.ReplanManager(old, pkg.mesh((1, 1), ("o", "i")),
                                       cache, background=False)
        mgr.trigger({"kind": "sustained_skew", "worst_rank": 0,
                     "baseline_s": 0.1})
        assert mgr.observe()
        mid = _manager_state(mgr, cache, [old])
        ring = pkg.tel.ring(mgr.plan.signature.digest)
        for _ in range(mgr.monitor.warmup):
            ring.record(0.1)
        assert not mgr.observe()
        return [mid, _manager_state(mgr, cache, [old])]
    finally:
        pkg.tel.reset_rank_rings("lead-old")


def _fake_autotune(variant):
    def fake(spec, mesh, cache, **kw):
        w = _StubPlan(spec, "sandbox-winner")
        w.auto_choice = {"variant": variant, "codec": "identity"}
        return w
    return fake


def _sc_rung0_ineligible(pkg, mp):
    mp.setattr(pkg.replan, "autotune_variant", _fake_autotune("fence"))
    old = pkg.hier_plan("lead-noblame")
    cache = _StubCache("-nb")
    mgr = pkg.replan.ReplanManager(old, pkg.mesh((1, 1), ("o", "i")), cache,
                                   background=False)
    mgr.trigger({"kind": "sustained_skew", "worst_rank": None})
    assert mgr.observe()
    return _manager_state(mgr, cache, [old])


def _sc_ladder_exhausts(pkg, mp):
    mp.setattr(pkg.replan, "autotune_variant", _fake_autotune("lock"))
    old = _StubPlan(pkg.flat_spec(), "ladder-old")
    cache = _StubCache("-lad")
    mgr = pkg.replan.ReplanManager(old, pkg.mesh((1,), ("x",)), cache,
                                   background=False)
    states = []
    for _ in range(3):
        mgr.trigger("unit")
        mgr.observe()
        states.append(_manager_state(mgr, cache, [old]))
    return states


def _sc_close_frees_pending(pkg, mp):
    def slow_autotune(spec, mesh, cache, **kw):
        time.sleep(0.05)
        return _fake_autotune("fence")(spec, mesh, cache)

    mp.setattr(pkg.replan, "autotune_variant", slow_autotune)
    old = _StubPlan(pkg.flat_spec(), "close-old")
    cache = _StubCache("-close")
    mgr = pkg.replan.ReplanManager(old, pkg.mesh((1,), ("x",)), cache,
                                   background=True)
    mgr.trigger("unit")
    mgr.close()
    pending_freed = bool(cache.plans) and cache.plans[-1].freed
    mgr.close()
    installed = mgr.observe()
    return [_manager_state(mgr, cache, [old]), pending_freed, installed,
            mgr._thread is None, mgr._pending is None]


def _sc_install_resets_rank_rings(pkg, mp):
    old = _StubPlan(pkg.flat_spec(), "s2-old")
    new = _StubPlan(pkg.flat_spec(), "s2-new")
    pkg.tel.record_rank("s2-new", 0, 0.4)
    pkg.tel.record_rank("s2-new", 1, 0.1)
    mgr = pkg.replan.ReplanManager(old, pkg.mesh((1,), ("x",)),
                                   _StubCache("-s2"), background=False)
    swapped = mgr.force_swap(new)
    return [swapped, pkg.tel.rank_summary("s2-new"), old.freed,
            mgr.plan is new, _plain(mgr.events)]


SCENARIOS = {"autotuner_faults": _sc_autotuner_faults,
             "rung0_then_recovery": _sc_rung0_then_recovery,
             "rung0_ineligible": _sc_rung0_ineligible,
             "ladder_exhausts": _sc_ladder_exhausts,
             "close_frees_pending": _sc_close_frees_pending,
             "install_resets_rank_rings": _sc_install_resets_rank_rings}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_manager_ladder_equal_jax(name, monkeypatch):
    got = {pkg: SCENARIOS[name](_Pkg(pkg), monkeypatch)
           for pkg in ("torch", "jax")}
    assert got["torch"] == got["jax"]


# --- exchanges on P=8 virtual ranks ------------------------------------------

def _setup_pattern(p, seed, max_count=13, feature=(4,)):
    """The JAX dist cases' pattern and oracle (``repro.core.reference``)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_count, size=(p, p))
    send_rows = max(jmd.round_up(jmd.max_total_send(counts), 8), 8)
    recv_rows = max(jmd.round_up(jmd.max_total_recv(counts), 8), 8)
    bufs = jreference.make_testbufs(counts, feature, np.float32, send_rows)
    expect = jreference.alltoallv_global(bufs, counts, recv_rows)
    x = torch.from_numpy(bufs.reshape(p * send_rows, *feature))
    return counts, x, expect, jmd.recv_counts(counts), recv_rows


def _check(out, expect, rc, p, recv_rows):
    got = out.numpy().reshape(p, recv_rows, -1)
    for r in range(p):
        n = int(rc[r].sum())
        np.testing.assert_array_equal(got[r, :n].view(np.uint32),
                                      expect[r, :n].view(np.uint32))


def _carrying(plan):
    return {int(r) for rnd in plan.hier_schedule.round_perms
            for pair in rnd for r in pair}


def test_hot_swap_on_2x4(tmp_path):
    """JAX's ``replan_hot_swap`` on the port: sustained chaos stalls trip
    the monitor, a background sandbox sweep re-measures (a real sweep) and
    stores its verdict with the replan provenance, then a forced swap to
    the runner-up frees the old plan; every epoch equals the oracle."""
    p = 8
    mesh = VirtualMesh((2, 4), ("outer", "inner"), device="cpu")
    counts, x, expect, rc, recv_rows = _setup_pattern(p, seed=9)
    TTEL.reset()
    store, cache = PlanStore(str(tmp_path)), PlanCache()
    plan = alltoallv_init(counts, (4,), "float32", mesh,
                          axis=("outer", "inner"), variant="auto",
                          cache=cache, store=store, autotune_iters=2)
    spec0 = plan.spec
    _check(plan.wait(plan.start(x)), expect, rc, p, recv_rows)
    sweeps0 = INIT_STATS.autotune_sweeps
    plan.record_starts = False
    monitor = tstraggler.PlanSkewMonitor(
        TTEL.ring(plan.signature.digest), threshold=1.6, window=4,
        sustain=2, warmup=6)
    mgr = treplan.ReplanManager(plan, mesh, cache, store=store,
                                monitor=monitor, iters=2, background=True)
    inj = tchaos.ChaosInjector(seed=0, stall_steps=range(6, 10_000),
                               stall_seconds=0.03)
    deadline = time.time() + DEADLINE_S
    for e in range(10_000):
        t0 = time.perf_counter()
        inj.maybe_stall(e)
        cur = mgr.plan
        _check(cur.wait(cur.start(x)), expect, rc, p, recv_rows)
        cur.record_epoch(time.perf_counter() - t0)
        mgr.observe()
        if e == 9:
            assert mgr.replans_completed == 0 and mgr.events == []
        if mgr.replans_completed >= 1:
            break
        assert time.time() < deadline, "re-plan never completed"
    assert inj.injected["stall"] > 0
    assert INIT_STATS.autotune_sweeps > sweeps0
    sig = decision_signature(spec0, mesh)
    fresh = cache.auto_choices[(sig, mesh.device)]
    assert fresh["replan"]["kind"] == "sustained_skew"
    assert fresh["replan"]["ratio"] > 1.6
    assert fresh["replan"]["prev_variant"] == spec0.variant
    stored = store.get_auto(sig, mesh.device)
    assert stored is not None and stored["replan"] == _plain(fresh["replan"])

    live = mgr.plan
    times = {v.partition("@")[0]: t for v, t in
             live.auto_choice["times"].items()}
    runner = min((v for v in times if v != live.spec.variant), key=times.get)
    alt = cache.get(_candidate_spec(spec0, runner), mesh, store=store)
    old = mgr.plan
    assert mgr.force_swap(alt, reason="operator")
    assert mgr.plan is alt
    assert old.window._slots == {} and old._tables is None
    assert old.run_tables == {} and old._pack is None and old._packs is None
    _check(alt.wait(alt.start(x)), expect, rc, p, recv_rows)
    swap = TTEL.swaps[-1]
    assert swap["variant_to"] == runner
    assert swap["new"] == alt.signature.digest
    mgr.close()


@pytest.mark.parametrize("pack_impl", ["jnp", "fused"])
def test_leader_rebake_on_2x4(pack_impl):
    """JAX's ``leader_rebake_recovery`` on the port: a 3x ``rank_slow`` on
    a carrying leader trips the monitor, rung 0 re-elects leaders around it
    (one schedule bake, no sweep), the new permutation equals JAX's
    ``choose_leader_perm`` over the same rank rings, the slow rank leaves
    the carrying set and every epoch equals the oracle, before, across and
    after the swap (``fused``: stage 2 under the non-identity permutation
    follows ``stage2_leader_ppermute``, not the Pallas K5)."""
    p = 8
    mesh = VirtualMesh((2, 4), ("outer", "inner"), device="cpu")
    counts, x, expect, rc, recv_rows = _setup_pattern(p, seed=11)
    TTEL.reset()
    cache = PlanCache()
    plan = alltoallv_init(counts, (4,), "float32", mesh,
                          axis=("outer", "inner"), variant="fence_hierarchy",
                          pack_impl=pack_impl, cache=cache)
    _check(plan.wait(plan.start(x)), expect, rc, p, recv_rows)
    bursts0, bakes0 = INIT_STATS.autotune_bursts, INIT_STATS.table_bakes
    slow = min(_carrying(plan))
    inj = tchaos.ChaosInjector(seed=0, rank_slow={slow: 3.0},
                               rank_slow_from=6, rank_slow_weight=0.05)
    monitor = tstraggler.PlanSkewMonitor(
        TTEL.ring(plan.signature.digest), threshold=1.6, window=4,
        sustain=2, warmup=6, digest=plan.signature.digest)
    mgr = treplan.ReplanManager(plan, mesh, cache, monitor=monitor,
                                background=False)

    def run_epoch(e):
        cur = mgr.plan
        cur.record_starts = False
        t0 = time.perf_counter()
        out = cur.wait(cur.start(x))
        work = time.perf_counter() - t0
        extra = inj.maybe_rank_stall(e, _carrying(cur), work)
        cur.record_epoch(work + extra)
        for r, t in inj.scale_rank_times(
                e, {r: work for r in range(p)}).items():
            TTEL.record_rank(cur.signature.digest, r, t)
        _check(out, expect, rc, p, recv_rows)

    deadline = time.time() + DEADLINE_S
    for e in range(10_000):
        run_epoch(e)
        mgr.observe()
        if mgr.replans_completed >= 1:
            break
        assert time.time() < deadline, "leader re-bake never installed"
    assert mgr.leader_rebakes == 1
    ev = mgr.events[-1]
    assert ev["event"] == "swap" and ev["kind"] == "leader_rebake"
    assert ev["worst_rank"] == slow
    new = mgr.plan
    assert new.spec.variant == "fence_hierarchy"
    assert slow not in _carrying(new)
    assert INIT_STATS.autotune_bursts == bursts0
    assert INIT_STATS.table_bakes == bakes0 + 1
    assert plan.window._slots == {} and plan._tables is None
    assert TTEL.rank_summary(new.signature.digest) == {}
    # JAX's election over the same rank rings: the old digest's rings are
    # exactly the samples the decision read.
    digest = plan.signature.digest
    try:
        for (d, r), ring in list(TTEL.rank_rings.items()):
            if d == digest:
                for t in ring.window(0, ring.count):
                    JTEL.record_rank(digest, r, float(t))
        health = jleader.rank_health(digest, p)
        np.testing.assert_array_equal(health, tleader.rank_health(digest, p))
        want = jleader.choose_leader_perm(counts, 2, 4, health,
                                          exclude=(slow,))
    finally:
        JTEL.reset_rank_rings(digest)
    assert new.spec.hier_leader_perm == want
    e0 = e + 1
    for e2 in range(e0, e0 + 12):
        run_epoch(e2)
        mgr.observe()
    mgr.close()
    mgr.close()


def test_chaos_recovery_on_8():
    """JAX's ``chaos_recovery`` on the port: window-allocation failures
    retried, a poisoned store read as a miss, a flaky remote store degrading
    to misses, step and device-loss faults through ``run_with_recovery``
    (device loss rebuilds the plan first); every epoch equals the oracle."""
    import tempfile

    p = 8
    mesh = VirtualMesh((8,), ("x",), device="cpu")
    counts, x, expect, rc, recv_rows = _setup_pattern(p, seed=5)
    with tempfile.TemporaryDirectory() as d:
        store = parse_store_url(f"fsremote://{d}/remote?fail_rate=0.25&seed=11")
        inj = tchaos.ChaosInjector(seed=3, window_fail_rate=0.5,
                                   fail_steps=(4,), device_loss_steps=(8,),
                                   stall_steps=(6,), stall_seconds=0.05)
        state = {"rebuilds": 0, "plan_rebuild_hook": 0}

        def rebuild(err=None):
            for _ in range(50):
                try:
                    cache = PlanCache(
                        window_cache=inj.wrap_window_cache(WindowCache()))
                    state["plan"] = alltoallv_init(
                        counts, (4,), "float32", mesh, axis="x",
                        variant="fence", pack_impl="fused", cache=cache,
                        store=store)
                    state["rebuilds"] += 1
                    return
                except tchaos.ChaosError:
                    continue
            raise AssertionError("window allocation never succeeded")

        rebuild()
        assert inj.poison_store(store) >= 1
        INIT_STATS.reset()
        done = set()

        def run_step(step):
            inj.step_hook(step)
            plan = state["plan"]
            _check(plan.wait(plan.start(x)), expect, rc, p, recv_rows)
            done.add(step)
            return {}

        def rebuild_plans(err):
            state["plan_rebuild_hook"] += 1
            assert tfault.classify_failure(err) == "device_loss"
            rebuild(err)

        def restore():
            return (max(done) + 1) if done else 0

        policy = tfault.RetryPolicy(max_restarts=5, backoff_seconds=0.0,
                                    decay_after=2)
        final = tfault.run_with_recovery(
            run_step, restore=restore, start_step=0, n_steps=12,
            policy=policy, rebuild_plans=rebuild_plans)
        assert final == 12 and done == set(range(12))
        assert inj.injected["step"] == 1 and inj.injected["device"] == 1
        assert inj.injected["stall"] >= 1 and inj.injected["poison"] >= 1
        assert inj.injected["window"] >= 1, inj.injected
        assert state["plan_rebuild_hook"] == 1 and state["rebuilds"] >= 2
        s = INIT_STATS.as_dict()
        assert s["store_invalid"] + store.errors >= 1, (s, store.stats)
        assert s["cold_inits"] >= 1
        assert policy.restarts <= 1


# --- the trainer and the launcher -------------------------------------------

@pytest.fixture
def one_thread():
    """One intra-op thread for the tests that hold two trainer runs
    bit-equal.  Several threads now give bit-equal runs too, since the
    token embedding's backward sums in a fixed order: see
    ``tests/test_torch_train_rest.py::test_trainer_bit_reproducible_with_threads_under_load``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reduced_train(mesh_shape, axes, rules_name, variant, steps, chaos=None,
                   replan=False, seq=16, batch=8, layers=1):
    from repro_torch.configs import ShapeConfig, get_reduced
    from repro_torch.core import reset_global_plan_cache
    from repro_torch.launch import steps as steps_mod
    from repro_torch.parallel.sharding import RULE_PROFILES
    from repro_torch.train import ScheduleConfig, Trainer, TrainerConfig

    reset_global_plan_cache()
    cfg = get_reduced("olmoe-1b-7b", n_layers=layers)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, a2a_variant=variant))
    shape = ShapeConfig("train_4k", "train", seq, batch)
    mesh = VirtualMesh(mesh_shape, axes, device="cpu")
    sched = ScheduleConfig(kind="cosine", peak_lr=3e-4, warmup_steps=1,
                           total_steps=steps, decay_steps=2)
    bundle = steps_mod.make_train_bundle(cfg, shape, mesh, sched=sched,
                                         rules=RULE_PROFILES[rules_name])
    tr = Trainer(bundle, TrainerConfig(n_steps=steps, replan=replan,
                                       log_every=100), chaos=chaos)
    result = tr.run()
    return tr, result


def test_trainer_leader_rebake_losses_equal_clean_run(one_thread):
    """The reduced OLMoE on ``(2, 1, 4)`` under ``hier_ep`` with
    ``fence_hierarchy``: a ``rank_slow`` chaos spec on a carrying leader
    and ``replan`` give a ``leader_rebake`` event whose permutation drops
    the slow rank from the carrying set, and losses bit-equal at every step
    to the same run without chaos and replan (the exchange moves rows)."""
    steps = 13
    axes = ("pod", "data", "model")
    clean, _ = _reduced_train((2, 1, 4), axes, "hier_ep", "fence_hierarchy",
                              steps)
    slow = min(_carrying(clean._backing_a2a()))
    TTEL.reset()          # the clean run fed the same plan's rank rings
    inj = tchaos.ChaosInjector.parse(
        f"rank_slow={slow}:3.0,rank_slow_from=4,rank_slow_weight=0.05")
    tr, result = _reduced_train((2, 1, 4), axes, "hier_ep",
                                "fence_hierarchy", steps, chaos=inj,
                                replan=True)
    (ev,) = result["replans"]
    assert ev["kind"] == "leader_rebake" and ev["worst_rank"] == slow
    assert ev["swapped"] and ev["step"] == 11
    a2a = tr._backing_a2a()
    assert [list(r) for r in a2a.spec.hier_leader_perm] == ev["leader_perm"]
    assert slow not in _carrying(a2a)
    assert result["chaos"]["rank_slow"] > 0
    assert TTEL.swaps[-1]["reason"]["kind"] == "leader_rebake"
    assert [h["loss"] for h in tr.history] == \
        [h["loss"] for h in clean.history]


def test_trainer_rank_probe_keys_are_plan_ranks(one_thread):
    tr, _ = _reduced_train((2, 1, 4), ("pod", "data", "model"), "hier_ep",
                           "fence_hierarchy", 1)
    a2a = tr._backing_a2a()
    assert sorted(a2a.rank_summaries()) == list(range(a2a.p)) == \
        list(range(8))
    assert _carrying(a2a) == {0, 4}


def _launch(argv):
    from repro_torch.launch import train as launcher
    return launcher.main(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                          "cpu", "--seq-len", "32", "--global-batch", "8",
                          "--log-every", "100", *argv])


def test_launcher_chaos_assert_recovery_replan_at(tmp_path, capsys,
                                                  one_thread):
    result = _launch(["--mesh", "1,8", "--steps", "4", "--ckpt-dir",
                      str(tmp_path / "ckpt"), "--ckpt-every", "1",
                      "--chaos", "seed=1,fail_step=1,device_loss_step=2,"
                      "stall_steps=3,stall_seconds=0.001",
                      "--assert-recovery", "--replan-at", "1"])
    assert "ASSERT-RECOVERY OK" in capsys.readouterr().out
    assert result["chaos"]["step"] == 1 and result["chaos"]["device"] == 1
    assert [r["kind"] for r in result["recoveries"]] == ["transient",
                                                        "device_loss"]
    (ev,) = result["replans"]
    assert ev["kind"] == "forced" and ev["step"] == 1


def test_launcher_assert_recovery_fails_without_faults(tmp_path, capsys,
                                                       one_thread):
    with pytest.raises(SystemExit) as err:
        _launch(["--mesh", "1,8", "--steps", "1", "--assert-recovery"])
    assert err.value.code == 4
    assert "ASSERT-RECOVERY FAILED" in capsys.readouterr().out


def test_launcher_elastic_resume_1x8_onto_2x4(tmp_path, capsys,
                                              one_thread):
    ckpt = str(tmp_path / "ckpt")
    first = _launch(["--mesh", "1,8", "--steps", "4", "--ckpt-every", "2",
                     "--ckpt-dir", ckpt, "--elastic"])
    shutil.rmtree(os.path.join(ckpt, f"step_{4:09d}"))
    capsys.readouterr()
    resumed = _launch(["--mesh", "2,4", "--steps", "4", "--ckpt-dir", ckpt,
                       "--elastic"])
    out = capsys.readouterr().out
    assert "elastic resume: mesh {'data': 1, 'model': 8} -> " \
           "{'data': 2, 'model': 4}; resharded 1 plan(s), skipped 0" in out
    assert resumed["final_step"] == 4
    assert resumed["last_metrics"] == first["last_metrics"]
    with open(os.path.join(ckpt, "init_requests.json")) as fh:
        assert json.load(fh)["mesh"] == {"data": 2, "model": 4}
