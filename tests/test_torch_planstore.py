"""The port's plan store (``repro_torch.planstore``) on the CPU, in process:
the twins of ``tests/test_planstore.py`` and the store's hooks in INIT.

Store mechanics: codec round-trips; a truncated, garbage or tampered entry
is a miss, never a crash; another torch version, repro version or device
kind is a different key and a cold INIT; another mesh factorization a
different key; LRU eviction and the stale-tmp sweep; merges
(``attach_breakeven``, ``put_auto``, concurrent writers and CAS merges in
spawned processes) never drop fields; the ``fsremote://`` bytes path with
corruption and injected faults; the tiered store's promotion, write-back
with the remote down and eviction under a reader; ``parse_store_url``.

Hooks: a second INIT of a stored pattern with a fresh ``PlanCache`` and a
fresh store handle bakes no table and runs no sweep, and its valid rows are
bit-equal to the cold plan's (fence, lock, hierarchy on (2, 4), auto,
allgatherv, reduce-scatter); the capture, prewarm from a dryrun-style JSON
and the CLI; the reduced OLMoE MoE layer with ``store=``,
``ServeEngine(plan_store=)`` and ``launch.serve --device cpu --plan-store``
run twice, the second run warm.  The JAX package's files and records are
held against the port's in ``tests/test_torch_planstore_parity.py``.
"""

import contextlib
import io
import json
import multiprocessing as mp
import os
import warnings

import numpy as np
import pytest
import torch

from repro_torch import planstore
from repro_torch.configs import get_reduced
from repro_torch.core import (INIT_STATS, ExchangeSpec, PlanCache,
                              alltoallv_init, capture_init_requests,
                              exchange_init, reference, reset_global_plan_cache)
from repro_torch.core import metadata as md
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import VirtualMesh
from repro_torch.models import moe
from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules
from repro_torch.planstore import (ABSENT, ArtifactError, FsRemoteBackend,
                                   GenerationConflict, LocalDirBackend,
                                   PlanArtifact, PlanStore, RemoteUnavailable,
                                   SCHEMA_VERSION, TieredPlanStore, codec,
                                   parse_store_url, prewarm, signature_meta,
                                   store_key)
from repro_torch.planstore import __main__ as cli
from repro_torch.serve import ServeEngine

H100 = "NVIDIA H100 80GB HBM3"


def _counts(p, seed, lo=0, hi=50):
    return np.random.default_rng(seed).integers(lo, hi, (p, p)).astype(np.int64)


def _sig(counts, variant="fence", axis=("x",), axis_sizes=None, **kw):
    p = counts.shape[0]
    return md.PatternSignature.build(
        counts, (4,), "float32", variant, axis, 16,
        axis_sizes=axis_sizes if axis_sizes is not None else (p,), **kw)


def _baked_artifact(counts):
    cap = md.global_capacity(counts)
    recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
    tables = md.baked_index_tables(counts, cap, recv_rows)
    sig = _sig(counts)
    return sig, PlanArtifact(signature=signature_meta(sig),
                             index_tables=tables), tables


def _fill(counts):
    return np.asarray(np.full((4, 4), counts), np.int64)


# --- codec and store mechanics ------------------------------------------------


@pytest.mark.parametrize("p,seed", [(2, 0), (5, 1), (8, 2), (10, 3)])
def test_baked_tables_roundtrip(tmp_path, p, seed):
    """signature -> save -> load under a fresh store handle -> identical
    tables, bit for bit, as read-only memmaps."""
    sig, art, tables = _baked_artifact(_counts(p, seed))
    PlanStore(tmp_path).put_artifact(sig, art)
    got = PlanStore(tmp_path).get(sig)
    assert got is not None and got.payload_kind == "baked_tables"
    for name in ("pack_src", "pack_valid", "unpack_src", "unpack_valid"):
        a = getattr(got.index_tables, name)
        assert isinstance(a, np.memmap) and not a.flags.writeable
        np.testing.assert_array_equal(a, getattr(tables, name))


@pytest.mark.parametrize("p_inner,seed", [(1, 0), (2, 1), (4, 2)])
def test_hier_schedule_roundtrip(tmp_path, p_inner, seed):
    counts = _counts(2 * p_inner, seed, hi=30)
    recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
    sched = md.hier_two_stage_schedule(counts, 2, p_inner, recv_rows)
    sig = _sig(counts, variant="fence_hierarchy", axis=("o", "i"),
               axis_sizes=(2, p_inner))
    PlanStore(tmp_path).put_artifact(
        sig, PlanArtifact(signature=signature_meta(sig), hier_schedule=sched))
    got = PlanStore(tmp_path).get(sig).hier_schedule
    scalars = ("p_outer", "p_inner", "n_macro", "remote_needed", "s1_cap",
               "s2_caps", "s2_offs", "total_s2", "s3_cap", "round_perms",
               "cross_group_puts", "leader_perm")
    assert [getattr(got, f) for f in scalars] == [getattr(sched, f)
                                                  for f in scalars]
    for a, b in zip(got.tables, sched.tables):
        np.testing.assert_array_equal(a, b)


def test_auto_choice_dumps_and_meta_only_roundtrip(tmp_path):
    counts = _fill(3)
    sig = _sig(counts, variant="auto")
    choice = {"variant": "ragged", "codec": "identity",
              "times": {"fence": 1e-4, "ragged": 5e-5}}
    PlanStore(tmp_path).put_auto(sig, choice)
    got = PlanStore(tmp_path).get(sig)
    assert got.auto_choice == choice and got.payload_kind == "meta_only"
    assert got.index_tables is None and got.hier_schedule is None
    _, art, tables = _baked_artifact(_fill(2))
    back = codec.loads(codec.dumps(art))
    np.testing.assert_array_equal(back.index_tables.pack_src, tables.pack_src)
    assert back.torch_version == torch.__version__
    assert back.device_kind == "cpu"


@pytest.mark.parametrize("defect", ["truncate", "garbage", "torch", "repro",
                                    "schema", "device_kind", "signature"])
def test_defective_entry_is_miss_not_crash(tmp_path, defect):
    """A truncated or garbage file, one whose metadata names another torch
    version, repro version, schema or device kind, or another pattern's
    file under this key: a miss counted as invalid, the entry removed, the
    slot reusable."""
    sig, art, _ = _baked_artifact(_fill(7))
    store = PlanStore(tmp_path)
    path = store.path_for(sig)
    if defect == "truncate":
        store.put_artifact(sig, art)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    elif defect == "garbage":
        with open(path, "wb") as f:
            f.write(os.urandom(512))
    elif defect == "signature":
        other, other_art, _ = _baked_artifact(_fill(8))
        os.replace(store.put_artifact(other, other_art), path)
    else:
        field, value = {"torch": ("torch_version", "9.9.9"),
                        "repro": ("repro_version", "0.0.0-other"),
                        "schema": ("schema_version", SCHEMA_VERSION + 1),
                        "device_kind": ("device_kind", H100)}[defect]
        bad = _baked_artifact(_fill(7))[1]
        setattr(bad, field, value)
        with open(path, "wb") as f:                 # bypass put_artifact
            codec.dump(bad, f)
    store = PlanStore(tmp_path)
    assert store.get(sig) is None and store.invalid == 1
    assert not os.path.exists(path)
    store.put_artifact(sig, art)                    # the slot is reusable
    assert store.get(sig) is not None


@pytest.mark.parametrize("field", ["torch_ver", "repro_ver", "device_kind"])
def test_environment_mismatch_falls_back_cold(tmp_path, field):
    """A store written under another torch version, repro version or
    device kind is keyed differently: the live INIT misses and bakes (a
    cold INIT), and the other environment still finds its own entry."""
    counts = _counts(8, 4, hi=20)
    mesh = VirtualMesh((8,), ("x",), device="cpu")
    other = {"torch_ver": "9.9.9", "repro_ver": "0.0.0-other",
             "device_kind": H100}[field]
    alltoallv_init(counts, (4,), torch.float32, mesh, cache=PlanCache(),
                   store=PlanStore(tmp_path, **{field: other}))
    live = PlanStore(tmp_path)
    sig = _sig(counts, axis_sizes=(8,))
    assert live.path_for(sig, mesh.device) != PlanStore(
        tmp_path, **{field: other}).path_for(sig, mesh.device)
    INIT_STATS.reset()
    plan = alltoallv_init(counts, (4,), torch.float32, mesh, cache=PlanCache(),
                          store=live)
    assert not plan.warm_loaded and INIT_STATS.table_bakes == 1
    assert live.misses == 1 and live.invalid == 0
    assert PlanStore(tmp_path, **{field: other}).get(sig, mesh.device)


def test_device_kind_comes_from_the_inits_device(monkeypatch, tmp_path):
    """The kind is the card's name for a CUDA device and "cpu" for the
    CPU, per call: one store keys a CPU INIT and a card INIT of one pattern
    apart, and a CPU decision is never served for the card."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: H100)
    assert planstore.device_kind(torch.device("cuda", 0)) == H100
    assert planstore.device_kind("cpu") == planstore.device_kind(None) == "cpu"
    store = PlanStore(tmp_path)
    sig = _sig(_fill(3), variant="auto")
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert store.key_for(sig, cpu) != store.key_for(sig, card)
    store.put_auto(sig, {"variant": "ragged", "times": {}}, cpu)
    assert store.get_auto(sig, card) is None
    assert store.get_auto(sig, cpu)["variant"] == "ragged"
    assert PlanStore(tmp_path, device_kind=H100).get_auto(sig, cpu) is None
    with pytest.raises(ValueError):
        TieredPlanStore(PlanStore(tmp_path / "a"),
                        PlanStore(tmp_path / "b", device_kind=H100))


def test_axis_sizes_mismatch_is_a_different_key(tmp_path):
    counts = np.full((8, 8), 3)
    s24 = _sig(counts, variant="fence_hierarchy", axis=("o", "i"),
               axis_sizes=(2, 4))
    s42 = _sig(counts, variant="fence_hierarchy", axis=("o", "i"),
               axis_sizes=(4, 2))
    assert store_key(s24) != store_key(s42)
    recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
    PlanStore(tmp_path).put_artifact(
        s24, PlanArtifact(signature=signature_meta(s24),
                          hier_schedule=md.hier_two_stage_schedule(
                              counts, 2, 4, recv_rows)))
    assert PlanStore(tmp_path).get(s42) is None
    assert PlanStore(tmp_path).get(s24) is not None


def test_lru_eviction_and_stale_tmp_sweep(tmp_path):
    store = PlanStore(tmp_path, max_entries=3)
    stale = tmp_path / "tmp-999-deadbeef.plan"
    fresh = tmp_path / "tmp-999-cafef00d.plan"
    for p in (stale, fresh):
        p.write_bytes(b"partial write")
    os.utime(stale, (0, 0))
    sigs = []
    for i in range(5):
        sig, art, _ = _baked_artifact(_fill(i + 1))
        sigs.append(sig)
        store.put_artifact(sig, art)
        os.utime(store.path_for(sig), (i + 1, i + 1))
    assert len(store.entries()) <= 3 and store.evictions >= 2
    assert store.get(sigs[0]) is None and store.get(sigs[-1]) is not None
    assert not stale.exists() and fresh.exists()


class _RacingBackend(LocalDirBackend):
    """Injects one competing ``put_auto`` between a merge's read and its
    conditional put."""

    def __init__(self, root, sig, choice):
        super().__init__(root)
        self._sig, self._choice, self._raced = sig, choice, False

    def get_with_generation(self, key):
        out = super().get_with_generation(key)
        if not self._raced:
            self._raced = True
            PlanStore(self.root).put_auto(self._sig, self._choice)
        return out


def test_merges_keep_every_field(tmp_path):
    """``attach_breakeven`` keeps the tables; it also merges with an auto
    decision published between its read and its put (CAS retry); a table
    publish keeps a fit attached before the tables existed."""
    sig, art, tables = _baked_artifact(_fill(6))
    store = PlanStore(tmp_path / "a")
    store.put_artifact(sig, art)
    store.attach_breakeven(sig, {"t_init": 1e-3, "n_breakeven": 34})
    got = store.get(sig)
    assert got.breakeven["n_breakeven"] == 34 and got.index_tables is not None

    auto = _sig(_fill(12), variant="auto")
    choice = {"variant": "lock", "times": {"lock": 5e-5}}
    PlanStore(_RacingBackend(tmp_path / "b", auto, choice)).attach_breakeven(
        auto, {"t_init": 1e-3, "n_breakeven": 21})
    final = PlanStore(tmp_path / "b").get(auto)
    assert final.auto_choice == choice and final.breakeven["n_breakeven"] == 21

    class FakePlan:
        index_tables = tables
        hier_schedule = None

    store = PlanStore(tmp_path / "c")
    store.attach_breakeven(sig, {"t_init": 1e-3, "n_breakeven": 7})
    assert store.put_plan(sig, FakePlan) is not None
    got = PlanStore(tmp_path / "c").get(sig)
    assert got.payload_kind == "baked_tables" and got.breakeven["n_breakeven"] == 7


def test_conditional_put_generation_tokens(tmp_path):
    be = LocalDirBackend(tmp_path)
    be.put_bytes("k", b"v1", if_generation=ABSENT)
    with pytest.raises(GenerationConflict):
        be.put_bytes("k", b"v2", if_generation=ABSENT)
    data, gen = be.get_with_generation("k")
    assert data == b"v1" and gen != ABSENT
    be.put_bytes("k", b"v2", if_generation=gen)
    with pytest.raises(GenerationConflict):
        be.put_bytes("k", b"v3", if_generation=gen)
    assert be.get_bytes("k") == b"v2"
    assert be.get_with_generation("missing") == (None, ABSENT)


def _hammer(args):
    """Worker of the concurrency tests: ``put`` alternates table publishes
    and gets on one key; ``merge`` interleaves ``put_auto`` and
    ``attach_breakeven`` on one auto key."""
    kind, root, seed, rounds = args
    rng = np.random.default_rng(seed)
    store = PlanStore(root)
    loads = 0
    if kind == "put":
        sig, art, tables = _baked_artifact(_fill(11))
        for _ in range(rounds):
            if rng.random() < 0.5:
                store.put_artifact(sig, art)
            got = store.get(sig)
            if got is not None:
                loads += 1
                np.testing.assert_array_equal(got.index_tables.pack_src,
                                              tables.pack_src)
        return loads
    sig = _sig(_fill(13), variant="auto")
    for i in range(rounds):
        if rng.random() < 0.5:
            store.put_auto(sig, {"variant": "lock",
                                 "times": {"lock": float(seed)}})
        else:
            store.attach_breakeven(sig, {"t_init": float(i)}, retries=50)
    return loads


def test_concurrent_writers_and_merges(tmp_path):
    """Spawned processes hammer one key: every read decodes to the exact
    tables, and interleaved CAS merges leave an entry holding both the
    auto decision and the break-even fit."""
    sig, _, tables = _baked_artifact(_fill(11))
    auto = _sig(_fill(13), variant="auto")
    seed = PlanStore(tmp_path)
    seed.put_auto(auto, {"variant": "fence", "times": {}})
    seed.attach_breakeven(auto, {"t_init": 0.0})
    jobs = ([("put", str(tmp_path), s, 15) for s in range(2)]
            + [("merge", str(tmp_path), s, 8) for s in range(2)])
    with mp.get_context("spawn").Pool(4) as pool:
        loads = pool.map(_hammer, jobs)
    assert sum(loads) > 0
    np.testing.assert_array_equal(
        PlanStore(tmp_path).get(sig).index_tables.pack_src, tables.pack_src)
    final = PlanStore(tmp_path).get(auto)
    assert final.auto_choice["variant"] in ("fence", "lock")
    assert "t_init" in final.breakeven


# --- remote and tiered stores -------------------------------------------------


@pytest.mark.parametrize("defect", [None, "truncate", "garbage", "tamper"])
def test_fsremote_bytes_path_and_corruption(tmp_path, defect):
    """The remote double round-trips through ``codec.loads`` (no path, no
    memmap); a truncated, garbage or tampered object is a miss and removed
    remotely."""
    sig, art, tables = _baked_artifact(_fill(7))
    writer = PlanStore(FsRemoteBackend(tmp_path))
    writer.put_artifact(sig, art)
    assert writer.path_for(sig) is None
    obj = tmp_path / (writer.key_for(sig) + ".plan")
    if defect == "truncate":
        with open(obj, "r+b") as f:
            f.truncate(os.path.getsize(obj) // 2)
    elif defect == "garbage":
        obj.write_bytes(os.urandom(256))
    elif defect == "tamper":
        art.torch_version = "9.9.9"
        with open(obj, "wb") as f:
            codec.dump(art, f)
    store = PlanStore(FsRemoteBackend(tmp_path))
    got = store.get(sig)
    if defect is None:
        assert not isinstance(got.index_tables.pack_src, np.memmap)
        np.testing.assert_array_equal(got.index_tables.pack_src,
                                      tables.pack_src)
        return
    assert got is None and store.invalid == 1 and not obj.exists()


def test_fsremote_faults_degrade_to_misses(tmp_path):
    sig, art, _ = _baked_artifact(_fill(5))
    down = PlanStore(FsRemoteBackend(tmp_path, fail_rate=1.0))
    assert down.get(sig) is None and down.errors == 1 and down.misses == 1
    with pytest.raises(RemoteUnavailable):
        down.put_artifact(sig, art)
    assert isinstance(RemoteUnavailable("x"), OSError)
    store = PlanStore(FsRemoteBackend(tmp_path), max_entries=2)
    for i in range(5):
        s, a, _ = _baked_artifact(_fill(i + 1))
        store.put_artifact(s, a)
    assert len(store.entries()) == 5 and store.evictions == 0


def test_tiered_promotion_writeback_and_eviction_under_reader(tmp_path):
    """A remote hit is promoted into the local tier and memmapped from
    there, the second get stays local; puts land in both tiers and stay
    best-effort with the remote down; an eviction under a reader leaves
    its memmapped tables readable; a merge refreshes the local tier."""
    remote_dir, local_dir = tmp_path / "remote", tmp_path / "local"
    sig, art, tables = _baked_artifact(_fill(9))
    PlanStore(FsRemoteBackend(remote_dir)).put_artifact(sig, art)
    remote_be = FsRemoteBackend(remote_dir)
    tiered = TieredPlanStore(PlanStore(local_dir), PlanStore(remote_be))
    got = tiered.get(sig)
    assert tiered.promotions == 1
    assert isinstance(got.index_tables.pack_src, np.memmap)
    ops = remote_be.ops
    assert isinstance(tiered.get(sig).index_tables.pack_src, np.memmap)
    assert remote_be.ops == ops and tiered.local.hits == 1
    assert tiered.local.purge() == 1                  # evicted under the reader
    np.testing.assert_array_equal(got.index_tables.pack_src, tables.pack_src)

    sig2, art2, _ = _baked_artifact(_fill(6))
    tiered.put_artifact(sig2, art2)
    assert PlanStore(FsRemoteBackend(remote_dir)).get(sig2) is not None
    assert PlanStore(local_dir).get(sig2) is not None
    broken = TieredPlanStore(PlanStore(local_dir), PlanStore(
        FsRemoteBackend(remote_dir, fail_rate=1.0)))
    assert broken.get(sig2) is not None
    broken.put_artifact(sig2, art2)
    assert broken.remote_errors == 1
    dead = TieredPlanStore(PlanStore(tmp_path / "empty"), PlanStore(
        FsRemoteBackend(remote_dir, fail_rate=1.0)))
    assert dead.get(sig2) is None and dead.remote_errors == 1

    tiered.attach_breakeven(sig2, {"t_init": 2e-3})
    local_art = PlanStore(local_dir).get(sig2)
    assert local_art.payload_kind == "baked_tables"
    assert local_art.breakeven["t_init"] == 2e-3
    bytes_only = TieredPlanStore(PlanStore(FsRemoteBackend(tmp_path / "l2")),
                                 PlanStore(FsRemoteBackend(remote_dir)))
    np.testing.assert_array_equal(
        bytes_only.get(sig).index_tables.pack_src, tables.pack_src)


def test_parse_store_url_and_default_store(tmp_path, monkeypatch):
    d = str(tmp_path)
    local = parse_store_url(os.path.join(d, "a"))
    assert isinstance(local.store_backend, LocalDirBackend)
    assert isinstance(parse_store_url("file://" + os.path.join(d, "b"))
                      .store_backend, LocalDirBackend)
    rem = parse_store_url(f"fsremote://{d}/r?latency_ms=1.5&fail_rate=0.25&seed=7")
    assert isinstance(rem.store_backend, FsRemoteBackend)
    assert (rem.store_backend.latency_ms, rem.store_backend.fail_rate) == (1.5, 0.25)
    tiered = parse_store_url(f"tiered:local={d}/cache,remote=fsremote://{d}/shared")
    assert isinstance(tiered, TieredPlanStore)
    assert isinstance(tiered.remote.store_backend, FsRemoteBackend)
    assert parse_store_url(tiered) is tiered
    for bad in ("tiered:remote=x", "tiered:local=a", "fsremote://",
                f"fsremote://{d}/r?bogus=1"):
        with pytest.raises(ValueError):
            parse_store_url(bad)
    monkeypatch.setattr(planstore.store, "_configured", False)
    monkeypatch.setattr(planstore.store, "_default", None)
    monkeypatch.setenv(planstore.ENV_VAR, f"{d}/env")
    assert planstore.default_store().root == f"{d}/env"
    try:
        assert planstore.configure(f"{d}/set") is planstore.default_store()
    finally:
        planstore.configure(None)
    assert planstore.default_store() is None


# --- warm INIT through the port's entry points --------------------------------


def _oracle(counts, feature=(4,)):
    send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
    bufs = reference.make_testbufs(counts, feature, np.float32, send_rows)
    return torch.from_numpy(bufs.reshape((-1,) + feature))


def _valid_rows(plan, out):
    out = out.reshape((plan.p, plan.recv_rows) + plan.spec.feature_shape)
    rc = plan.recv_counts.sum(axis=1)
    return [out[r, :rc[r]].clone() for r in range(plan.p)]


WARM_CASES = {
    "fence": ((8,), "x", dict(variant="fence", pack_impl="pallas")),
    "fence_fused": ((8,), "x", dict(variant="fence", pack_impl="fused")),
    "lock": ((8,), "x", dict(variant="lock", pack_impl="pallas")),
    "lock_2axis": ((2, 4), ("o", "i"), dict(variant="lock")),
    "hierarchy": ((2, 4), ("o", "i"), dict(variant="fence_hierarchy",
                                           pack_impl="fused")),
    "auto": ((8,), "x", dict(variant="auto", embeddable=True)),
    "auto_2axis": ((2, 4), ("o", "i"), dict(variant="auto")),
}


@pytest.mark.parametrize("case", sorted(WARM_CASES))
def test_second_init_is_warm_and_bit_equal(tmp_path, case):
    """Cold INIT against an empty store, then a second INIT of the pattern
    with a fresh cache and a fresh store handle: zero bakes, zero bursts,
    at least one store hit, ``warm_loaded``, the cold run's variant, and
    valid rows bit-equal to the cold plan's; no warning is raised (the
    memmapped tables are copied, never wrapped writable)."""
    shape, axis, kw = WARM_CASES[case]
    counts = _counts(8, 11, lo=1, hi=24)
    mesh = VirtualMesh(shape, ("x",) if axis == "x" else axis, device="cpu")
    x = _oracle(counts)

    def init():
        return alltoallv_init(counts, (4,), torch.float32, mesh, axis=axis,
                              cache=PlanCache(), store=PlanStore(tmp_path),
                              autotune_iters=2, **kw)

    cold = init()
    want = _valid_rows(cold, cold.wait(cold.start(x)))
    INIT_STATS.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warm = init()
        got = _valid_rows(warm, warm.wait(warm.start(x)))
    stats = INIT_STATS.as_dict()
    assert stats["table_bakes"] == 0 and stats["autotune_bursts"] == 0
    assert stats["store_hits"] >= 1 and stats["autotune_sweeps"] == 0
    assert warm.spec.variant == cold.spec.variant
    if warm.spec.variant != "ragged":       # ragged stores no tables (JAX too)
        assert warm.warm_loaded
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if kw["variant"] == "auto":
        assert warm.auto_choice == cold.auto_choice


@pytest.mark.parametrize("collective", ["allgatherv", "reduce_scatter"])
def test_families_warm_start(tmp_path, collective):
    counts = np.random.default_rng(5).integers(1, 9, 8).astype(np.int64)
    mesh = VirtualMesh((8,), ("x",), device="cpu")
    plans = []
    for _ in range(2):
        INIT_STATS.reset()
        plans.append(exchange_init(collective, counts, (4,), torch.float32,
                                   mesh, cache=PlanCache(),
                                   store=PlanStore(tmp_path)))
    assert not plans[0].warm_loaded and plans[1].warm_loaded
    assert INIT_STATS.table_bakes == 0 and INIT_STATS.store_hits == 1
    x = torch.randn(plans[0].global_send_shape,
                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(plans[1].wait(plans[1].start(x)),
                       plans[0].wait(plans[0].start(x)))


def test_ragged_publishes_nothing_and_store_false(tmp_path):
    counts = _counts(8, 2, hi=10)
    mesh = VirtualMesh((8,), ("x",), device="cpu")
    store = PlanStore(tmp_path)
    alltoallv_init(counts, (4,), torch.float32, mesh, variant="ragged",
                   cache=PlanCache(), store=store)
    assert store.puts == 0 and store.misses == 1
    try:
        planstore.configure(store)
        alltoallv_init(counts, (4,), torch.float32, mesh, cache=PlanCache(),
                       store=False)
        assert store.puts == 0
        alltoallv_init(counts, (4,), torch.float32, mesh, cache=PlanCache())
        assert store.puts == 1                # None: the process default
    finally:
        planstore.configure(None)


def test_capture_prewarm_from_dryrun_json_then_warm(tmp_path):
    """INITs under capture give replayable records (the JAX fields, dtype
    by the port's ``dtype_name``); written as a dryrun cell's
    ``plan_inits`` and prewarmed into an empty store, they make the next
    INIT of each pattern warm."""
    counts = _counts(8, 3, lo=1, hi=12)
    mesh8 = VirtualMesh((8,), ("x",), device="cpu")
    mesh24 = VirtualMesh((2, 4), ("o", "i"), device="cpu")
    with capture_init_requests() as reqs:
        alltoallv_init(counts, (4,), torch.bfloat16, mesh8, cache=PlanCache(),
                       store=False)
        alltoallv_init(counts, (4,), torch.bfloat16, mesh8, cache=PlanCache(),
                       store=False)                            # a duplicate
        alltoallv_init(counts, (4,), "float32", mesh24, axis=("o", "i"),
                       variant="auto", autotune_iters=2, cache=PlanCache(),
                       store=False)
    assert len(reqs) == 3 and reqs[0]["dtype"] == "bfloat16"
    assert reqs[2]["axis_sizes"] == [2, 4] and reqs[2]["variant"] == "auto"
    assert set(reqs[0]) == {"collective", "send_counts", "feature_shape",
                            "dtype", "axis", "axis_sizes", "variant",
                            "lock_schedule", "tile_rows", "pack_impl",
                            "baked_metadata", "embeddable", "autotune_iters",
                            "codec", "error_tol", "hier_leader_perm"}
    cell = tmp_path / "cells"
    cell.mkdir()
    (cell / "cell0.json").write_text(json.dumps({"plan_inits": reqs}))
    (cell / "broken.json").write_text("{")
    loaded = prewarm.requests_from_dryrun(str(cell))
    assert len(loaded) == 2
    store = PlanStore(tmp_path / "store")
    report = prewarm.prewarm(loaded, store, device="cpu")
    assert [r["warm"] for r in report["prewarmed"]] == [False, False]
    assert report["skipped"] == []
    INIT_STATS.reset()
    rows = prewarm.prewarm(loaded, PlanStore(tmp_path / "store"),
                           device="cpu")["prewarmed"]
    assert INIT_STATS.table_bakes == 0 and INIT_STATS.autotune_bursts == 0
    assert [r["digest"] for r in rows] == [
        r["digest"] for r in report["prewarmed"]]


def test_cli_warm_check_inspect_prewarm_purge(tmp_path):
    """``python -m repro_torch.planstore`` in process on the CPU:
    warm-check cold then warm (``--assert-warm``), inspect, prewarm of a
    reduced OLMoE decode profile, purge."""
    store = str(tmp_path / "s")

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
        return rc, buf.getvalue()

    rc, out = run("warm-check", "--store", store, "--device", "cpu",
                  "--iters", "2")
    first = json.loads(out)
    assert rc == 0 and not first["warm"] and first["device_kind"] == "cpu"
    rc, out = run("warm-check", "--store", store, "--device", "cpu",
                  "--assert-warm")
    second = json.loads(out)
    assert rc == 0 and second["warm"]
    assert second["chosen_variant"] == first["chosen_variant"]
    assert second["init_stats"]["store_hits"] >= 1
    rc, out = run("inspect", "--dir", store)
    kinds = {e["payload"] for e in json.loads(out)["entries"]}
    assert rc == 0 and "meta_only" in kinds and "hier_schedule" in kinds
    try:
        rc, out = run("prewarm", "--store", store, "--device", "cpu",
                      "--reduced", "--profile", "olmoe-1b-7b:decode_32k:1x8")
    finally:
        planstore.configure(None)
    rows = json.loads(out)["prewarmed"]
    assert rc == 0 and rows and rows[0]["axis_sizes"] == [8]
    # A training profile builds the train bundle: its MoE dispatch INIT.
    reqs = prewarm.requests_from_profile("olmoe-1b-7b", "train_4k", (1, 8),
                                         device="cpu", seq_len=32,
                                         global_batch=4)
    assert [r["axis_sizes"] for r in reqs] == [[8]]
    rc, out = run("purge", "--store", store)
    assert rc == 0 and json.loads(out)["removed"] >= 3


# --- consumers: the MoE layer, the engine, the launcher -------------------------


def test_moe_layer_store_warm_and_bit_equal(tmp_path):
    """The reduced OLMoE MoE layer's dispatch plan with ``store=`` under
    ``a2a_variant="auto"``: the second build (fresh cache, fresh handle)
    replays the decision and the tables; the layer's output is bit-equal."""
    import dataclasses

    cfg = get_reduced("olmoe-1b-7b")
    mcfg = dataclasses.replace(cfg.moe, a2a_variant="auto")
    mesh = VirtualMesh((1, 8), ("data", "model"), device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = {"router": torch.randn(cfg.d_model, mcfg.n_experts, generator=gen),
              "w_gate": torch.randn(mcfg.n_experts, cfg.d_model, mcfg.d_expert,
                                    generator=gen) * 0.05,
              "w_up": torch.randn(mcfg.n_experts, cfg.d_model, mcfg.d_expert,
                                  generator=gen) * 0.05,
              "w_down": torch.randn(mcfg.n_experts, mcfg.d_expert, cfg.d_model,
                                    generator=gen) * 0.05}
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    outs, plans = [], []
    with axis_rules(DEFAULT_RULES, mesh):
        for _ in range(2):
            INIT_STATS.reset()
            plan = moe.MoEDispatchPlan.build(
                mcfg, 32, mesh, d_model=cfg.d_model, dtype=torch.float32,
                store=PlanStore(tmp_path), cache=PlanCache(), autotune_iters=2)
            plans.append((plan, INIT_STATS.as_dict()))
            outs.append(moe.apply_moe(params, x, mcfg, plan=plan)[0])
    (cold, _), (warm, stats) = plans
    assert stats["table_bakes"] == 0 and stats["autotune_bursts"] == 0
    assert warm.a2a.warm_loaded and warm.variant == cold.variant
    assert torch.equal(outs[0], outs[1])


def test_engine_and_launcher_plan_store_second_run_warm(tmp_path):
    """``ServeEngine(plan_store=)`` and ``launch.serve --device cpu
    --plan-store`` twice against one store: the second run (fresh global
    cache, fresh store handle) bakes no table and prints warm INIT
    stats; its tokens equal the first run's."""
    store = str(tmp_path / "serve-store")
    argv = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
            "--mesh", "1,8", "--batch", "2", "--prompt-len", "8",
            "--tokens", "2", "--plan-store", store]
    outs = []
    try:
        for _ in range(2):
            reset_global_plan_cache()
            INIT_STATS.reset()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                serve_cli.main(argv)
            outs.append((buf.getvalue(), INIT_STATS.as_dict()))
        (first, cold), (second, warm) = outs
        assert cold["table_bakes"] >= 1 and cold["store_puts"] >= 1
        assert warm["table_bakes"] == 0 and warm["store_hits"] >= 1
        assert warm["warm_inits"] >= 1 and "plan-store init stats" in second

        def tokens(out):      # the printed token rows, between the timings
            lines = out.splitlines()   # line and the INIT stats line
            return lines[1:next(i for i, ln in enumerate(lines)
                                if ln.startswith("plan-store init stats"))]
        assert tokens(first) == tokens(second) and tokens(first)

        reset_global_plan_cache()
        INIT_STATS.reset()
        cfg = get_reduced("olmoe-1b-7b")
        mesh = VirtualMesh((1, 8), ("data", "model"), device="cpu")
        eng = ServeEngine(cfg, mesh, batch=2, prompt_len=8, max_seq=18,
                          plan_store=store)
        assert eng.moe_plan.a2a.warm_loaded
        assert INIT_STATS.table_bakes == 0
    finally:
        planstore.configure(None)
        reset_global_plan_cache()


def test_exchange_spec_unchanged_by_store():
    """``ExchangeSpec`` holds no store: a stored pattern keys as before."""
    counts = _counts(4, 0, hi=5)
    spec = ExchangeSpec(send_counts=counts, feature_shape=(4,),
                        dtype=torch.float32, axis=("x",))
    assert "store" not in {f for f in spec.__dataclass_fields__}
    assert SCHEMA_VERSION == 3
    with pytest.raises(ArtifactError):
        codec.loads(b"not a plan")
