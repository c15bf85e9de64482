"""The port's ranks in processes against the JAX package.

One JAX subprocess (``tests/_torch_parity_jax_procs.py``, 4 host devices)
runs the reference plans; one group of 4 gloo processes
(``python -m repro_torch.testing.dist_cases parity --ranks 4 --device
cpu``) runs the port's process-mesh plans on the same inputs, every rank
writing its receive rows, while its windows live in shared-memory files
and every kernel takes its plain version.  The two run at once.
Tolerance: valid rows bit for bit (rows below each rank's recv count, as
``src/repro/core/plan.py:547-551`` leaves padding stale), since every
function here only moves rows; the lock also at 60-byte rows.  Then the
ported dist cases (``all``), a rank that dies, a rank that lives but never
signals, the bounded flag wait, the flag slots the plain versions write
(the peer kernels' layout), the grid budget and the error records.  Every
subprocess has a timeout, and each rank runs one intra-op thread.
"""

import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _torch_parity_jax_procs as ref
from repro.core import metadata as jax_md
from repro_torch.core import alltoallv_init, metadata as md
from repro_torch.core.plan import ExchangeSpec, check_process_spec
from repro_torch.kernels import _build, a2a_lock, rma_signal
from repro_torch.launch.mesh import ProcessMesh, init_process_mesh
from repro_torch.testing import dist_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = ref.P
KEYS = tuple(ref.CASES) + ref.PIPELINED + ref.BASELINES


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def _dist_case(*args, flag_timeout=60, timeout=240):
    """A dist case on 4 gloo processes; flag waits get a minute, since the
    whole test run loads the CPUs."""
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.testing.dist_cases", *args,
         "--ranks", str(P), "--device", "cpu", "--timeout", "120",
         "--flag-timeout", str(flag_timeout)],
        capture_output=True, text=True, timeout=timeout, env=_env(), cwd=ROOT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's reference arrays and the port's per-rank rows and facts."""
    import json

    out = tmp_path_factory.mktemp("procs")
    jax_out = out / "jax.npz"
    jax_run = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_parity_jax_procs.py"),
         str(jax_out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=_env(), cwd=ROOT)
    try:
        port = _dist_case("parity", "--out", str(out))
        _, jax_err = jax_run.communicate(timeout=300)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
    assert jax_run.returncode == 0, f"JAX reference run failed:\n{jax_err[-4000:]}"
    assert port.returncode == 0 and "CASE_OK parity" in port.stdout, (
        f"port run failed:\n{port.stdout[-2000:]}\n{port.stderr[-4000:]}")
    facts = json.loads(port.stdout.strip().splitlines()[-1])["ranks"]
    with np.load(jax_out) as f:
        jax = {k: f[k] for k in f.files}
    ranks = []
    for r in range(P):
        with np.load(out / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    return jax, ranks, facts


def _pattern(key):
    return ref.CASES[key][0] if key in ref.CASES else "random"


@pytest.mark.parametrize("key", KEYS)
def test_process_plan_rows_match_jax(runs, key):
    """Each rank's valid rows of fence (jnp, pallas, fused), lock (ring,
    pairwise, pallas), the banded pattern with elided lock rounds, three
    pipelined epochs and the baseline: bit-equal to the JAX plan's rank
    row (dist cases alltoallv_variants, pallas_pack_in_plan,
    fused_pack_fence, sparse_lock_elision, pipelined_epochs)."""
    jax, ranks, _ = runs
    counts = ref.pattern_counts(_pattern(key))
    rc = md.recv_counts(counts)
    np.testing.assert_array_equal(rc, jax_md.recv_counts(counts))
    want = jax[key]
    for r in range(P):
        n = int(rc[r].sum())
        got = ranks[r][key]
        assert got.shape == want.shape[1:], (got.shape, want.shape)
        np.testing.assert_array_equal(got[:n].view(np.uint8),
                                      want[r, :n].view(np.uint8))


def test_inputs_are_jax_inputs(runs):
    """The port's parity run reads JAX's send buffers, rank by rank."""
    jax, _, _ = runs
    for name, (counts, bufs) in dist_cases.parity_inputs(P).items():
        np.testing.assert_array_equal(counts, ref.pattern_counts(name))
        np.testing.assert_array_equal(bufs, jax[f"{name}/x"])


def test_sparse_lock_rounds_elided(runs):
    """The banded pattern's lock plans run 2 of 3 rounds on every rank
    (ring offsets 1 and 3; XOR partners 1 and 3)."""
    _, _, facts = runs
    for f in facts:
        assert f["banded-lock-ring-rounds"] == [2, 3]
        assert f["banded-lock-pairwise-rounds"] == [2, 3]
        assert f["pipelined_slots"] == 2


def test_window_reuse_and_reregistration(runs):
    """A plan with the same recv bytes reuses the window, registered once;
    a size change gets a new window (the paper's reuse rule)."""
    _, _, facts = runs
    for f in facts:
        assert f["window"] == {"same_window_same_bytes": True,
                               "registrations_after_two_plans": 1,
                               "new_window_on_size_change": True,
                               "recreates": 2, "hits": 1}


def test_collective_free(runs):
    """FREE releases every slot, closes the region and removes this rank's
    shared-memory file, on every rank."""
    _, _, facts = runs
    for f in facts:
        assert f["free"] == {"slots_after": 0, "file_removed": True,
                             "region_closed": True}


def test_count_digest_mismatch_raises_on_every_rank(runs):
    """One rank with another count matrix: INIT raises on every rank,
    each naming the disagreeing rank."""
    _, _, facts = runs
    for r, f in enumerate(facts):
        assert f["digest_mismatch"].startswith(f"rank {r}: ranks disagree")
        assert f"ranks [{P - 1}]" in f["digest_mismatch"]


def test_geometry_mismatch_raises_on_every_rank(runs):
    """Every rank counts the 4 ranks on its host; one rank whose windows
    lie in memory of another kind (which its peers cannot map) makes INIT
    raise on every rank, naming it."""
    _, _, facts = runs
    for r, f in enumerate(facts):
        assert f["ranks_on_device"] == P
        assert f["geometry_mismatch"].startswith(
            f"rank {r}: ranks disagree on the peer kernels' geometry")
        assert f"ranks [{P - 1}]" in f["geometry_mismatch"]


@pytest.mark.parametrize("variant,key", [
    ("lock", "random-lock-jnp-ring"), ("fence", "random-fence-pallas-ring")])
def test_uneven_layout_registers_with_the_fewest_k4_ctas(runs, variant, key):
    """Ranks spread 2, 2, 1, 1 over cards of 8 CTAs each: every window
    registers with 4 K4 CTAs (the fewest; 4 round slots per origin in every
    pad), each rank's own K2 budget and system scope, and every rank's rows
    are bit-equal to the even run's and to JAX's."""
    jax, ranks, facts = runs
    rc = md.recv_counts(ref.pattern_counts("random"))
    for r, f in enumerate(facts):
        per_card = 2 if r < P // 2 else 1
        assert f[f"uneven-{variant}"] == {
            "lock_ctas": 4, "fence_ctas": 8 // per_card, "sys_scope": True,
            "pad_flags": rma_signal.pad_len(P, 4)}
        impl = "jnp" if variant == "lock" else "pallas"
        got = ranks[r][f"uneven-{variant}-{impl}"]
        np.testing.assert_array_equal(got.view(np.uint8),
                                      ranks[r][key].view(np.uint8))
        n = int(rc[r].sum())
        np.testing.assert_array_equal(got[:n].view(np.uint8),
                                      jax[key][r, :n].view(np.uint8))


def test_dist_cases_all_on_the_cpu():
    """The eight ported dist cases on 4 gloo processes, each against the
    port's oracle."""
    r = _dist_case("all")
    assert r.returncode == 0, r.stderr[-4000:]
    oks = [ln.split()[1] for ln in r.stdout.splitlines()
           if ln.startswith("CASE_OK")]
    assert oks == list(dist_cases.CASES) and len(oks) == 8


def test_killed_rank_fails_the_group_within_the_timeout():
    """A rank killed after INIT: the harness ends every process with an
    error well inside its 120 s timeout, naming the dead rank."""
    t0 = time.monotonic()
    r = _dist_case("killed_rank", flag_timeout=5)
    assert r.returncode != 0
    assert time.monotonic() - t0 < 120
    assert f"rank(s) [{P - 1}] failed (exit codes [-9])" in r.stderr


STALLED = ("stalled_rank", "stalled_rank_lock")
STALL_FLAG_TIMEOUT = 5


@pytest.fixture(scope="module")
def stalled():
    """Both stalled-rank cases at once, each on 4 gloo processes, with a
    5 s flag timeout (so a survivor that the loaded CPUs start late is not
    taken for the stalled rank) under the harness's 120 s."""
    import json

    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.testing.dist_cases", name,
         "--ranks", str(P), "--device", "cpu", "--timeout", "120",
         "--flag-timeout", str(STALL_FLAG_TIMEOUT)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(),
        cwd=ROOT) for name in STALLED}
    out = {}
    try:
        for name, pr in procs.items():
            stdout, stderr = pr.communicate(timeout=240)
            out[name] = (pr.returncode, stdout, stderr)
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                pr.kill()
    for name, (rc, stdout, stderr) in out.items():
        assert rc == 0 and f"CASE_OK {name}" in stdout, (
            f"{name}:\n{stdout[-2000:]}\n{stderr[-4000:]}")
        out[name] = json.loads(stdout.strip().splitlines()[-1])["ranks"]
    return out


@pytest.mark.parametrize("name", STALLED)
def test_stalled_rank_fails_every_flag_wait(stalled, name):
    """The last rank lives but never signals: every other rank's WAIT
    raises its bounded flag wait's error, naming itself, epoch 1 and a
    flag of rank 3 (open for the fence; open or round for the lock), after
    at least the 5 s flag timeout and well inside the harness's 120 s."""
    flags = "open" if name == "stalled_rank" else "(open|round)"
    ranks = stalled[name]
    assert ranks[P - 1] == {"rank": P - 1, "stalled": True}
    for r in range(P - 1):
        assert re.match(rf"rank {r}, epoch 1: the {flags} flag of rank {P - 1} ",
                        ranks[r]["error"]), ranks[r]
        assert STALL_FLAG_TIMEOUT <= ranks[r]["seconds"] < 60, ranks[r]


def _local_window(rank, p, timeout, lock_ctas=1, nbytes=64):
    pads = [torch.zeros(rma_signal.pad_len(p, lock_ctas), dtype=torch.int64)
            for _ in range(p)]
    peers = [torch.zeros(nbytes, dtype=torch.uint8) for _ in range(p)]
    return rma_signal.PeerWindow(rank=rank, p=p, local=peers[rank],
                                 peers=peers, pad=pads[rank], pads=pads,
                                 timeout=timeout, lock_ctas=lock_ctas)


def test_flag_wait_is_bounded():
    """A flag no peer sets: the wait raises after its timeout, naming the
    rank, the epoch and the flag; a set flag passes."""
    win = _local_window(1, 3, 0.3)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 1, epoch 4: the close flag "
                                           r"of rank 2 stayed at 0"):
        rma_signal.wait_flag(win, rma_signal.CLOSE, 2, 4)
    assert time.monotonic() - t0 < 5
    win.pads[1][rma_signal.OPEN * 3 + 0] = 4
    rma_signal.wait_flag(win, rma_signal.OPEN, 0, 4)


def test_signal_plain_stores_the_epoch_in_every_peer():
    """Origin 1 signals ``round`` of epoch 7: flag ``2*P + 1`` of every
    other pad holds 7, its own pad and every other flag stay 0."""
    win = _local_window(1, 3, 0.3)
    rma_signal.rma_signal_plain(win, rma_signal.ROUND, 7, wait=False)
    for t in range(3):
        want = torch.zeros(9, dtype=torch.int64)
        if t != 1:
            want[2 * 3 + 1] = 7
        assert torch.equal(win.pads[t], want)


@pytest.mark.parametrize("resident,ranks,want", [
    (1056, 1, 1056),        # a card of its own: the whole card
    (1056, 8, 132),         # 8 ranks on one card: an eighth each
    (396, 16, 24),
    (3, 8, 1),              # never below one CTA
    (0, 1, 1),
])
def test_grid_budget(resident, ranks, want):
    assert rma_signal.grid_budget(resident, ranks) == want


# (variant, schedule, round capacities): rank 1 of 4 with 3 round slots
# per origin; the banded caps elide ring round 2 (target 3, source 3).
PLAIN_FLAG_CASES = [("fence", "ring", None),
                    ("lock", "ring", [8, 8, 0, 8]),
                    ("lock", "pairwise", [8, 8, 0, 8])]


@pytest.mark.parametrize("variant,sched,caps", PLAIN_FLAG_CASES)
def test_plain_epochs_write_the_kernels_flag_slots(variant, sched, caps):
    """The plain peer epochs write the flags where the kernels do: after
    epoch 5, open (and close for the fence) of rank 1 in every peer's pad,
    and for the lock every round slot of rank 1 in each active round's
    target's pad; an elided round's target keeps its slots untouched, and
    so does every flag another origin owns.  The puts land in rows [C, 2C)
    of each target's window."""
    from repro_torch.kernels import a2a_fence

    p, me, slots, cap, epoch = 4, 1, 3, 8, 5
    win = _local_window(me, p, 5.0, lock_ctas=slots, nbytes=p * cap * 16)
    idx = rma_signal.flag_index
    for j in range(p):           # every peer has opened, closed and put
        win.pad[idx(p, slots, rma_signal.OPEN, j)] = epoch
        win.pad[idx(p, slots, rma_signal.CLOSE, j)] = epoch
        r0 = idx(p, slots, rma_signal.ROUND, j)
        win.pad[r0:r0 + slots] = epoch
    before = [t.clone() for t in win.pads]
    packed = torch.arange(p * cap * 4, dtype=torch.float32).reshape(p * cap, 4)
    if variant == "fence":
        a2a_fence.rma_alltoallv_fence_peer_plain(packed, win, cap, epoch)
        targets = set(range(p)) - {me}
    else:
        a2a_lock.rma_alltoallv_lock_peer_plain(packed, win, cap, caps, sched,
                                               epoch)
        targets = {(me + r) % p if sched == "ring" else me ^ r
                   for r in range(1, p) if caps[r]}
        assert len(targets) == 2
    for t in set(range(p)) - {me}:
        want = before[t].clone()
        want[idx(p, slots, rma_signal.OPEN, me)] = epoch
        if variant == "fence":
            want[idx(p, slots, rma_signal.CLOSE, me)] = epoch
        elif t in targets:
            r0 = idx(p, slots, rma_signal.ROUND, me)
            want[r0:r0 + slots] = epoch
        assert torch.equal(win.pads[t], want), (t, win.pads[t])
    assert torch.equal(win.pads[me], before[me])
    rows = packed.view(torch.uint8).reshape(p, cap * 16)
    for t in targets | {me}:
        assert torch.equal(win.peers[t][cap * 16:2 * cap * 16], rows[t])


@pytest.mark.parametrize("purpose,origin,want", [
    (rma_signal.OPEN, 3, "the open flag of rank 3 did not reach the epoch"),
    (rma_signal.ROUND, 2, "the round flag of rank 2 did not reach the epoch"),
    (rma_signal.GRID, 1, "its own grid did not meet within 4.0 s"),
])
def test_flag_error_names_the_record(purpose, origin, want):
    """A kernel's record (1, epoch, purpose * P + origin, rank), whatever
    slot it waited on, reads back as the flag and rank it names."""
    win = _local_window(1, 4, 2.0, lock_ctas=5)
    win.error = torch.tensor([1, 6, purpose * 4 + origin, 1])
    err = win.flag_error()
    assert str(err).startswith(f"rank 1, epoch 6: {want}"), err
    win.error[0] = 0
    assert win.flag_error() is None


@pytest.mark.parametrize("sched", ["ring", "pairwise"])
def test_lock_peer_steps_leave_out_elided_rounds(sched):
    """The peer lock's phases: round 0 with the first active round, then
    each active round; rounds of capacity 0 are not there at all."""
    caps = np.array([8, 0, 3, 0, 0, 0, 0, 2])
    steps = a2a_lock.lock_peer_steps(8, 8, caps, sched)
    assert steps == [[(0, 8), (2, 3)], [(7, 2)]]
    full = a2a_lock.lock_peer_steps(4, 8, None, sched)
    assert full == [[(0, 8), (1, 8)], [(2, 8)], [(3, 8)]]
    table = a2a_lock.lock_peer_schedule(8, 8, a2a_lock.caps_key(caps), sched)
    assert table.n_entries == 3 and table.n_phases == 2
    assert table.table.tolist() == [0, 2, 7, 8, 3, 2, 0, 2, 3]


@pytest.mark.parametrize("variant,kw", [
    ("fence_hierarchy", {"axis": ("o", "i")}),
    ("ragged", {}),
    ("fence", {"codec": "bf16"}),
    ("fence", {"collective": "allgatherv"}),
])
def test_unported_process_variants_raise(variant, kw):
    """The hierarchy, ragged, codecs and the other families raise
    ``NotImplementedError`` on a process mesh, naming the roadmap item."""
    counts = np.full((4, 4), 2)
    kw = dict(kw)
    spec = ExchangeSpec(send_counts=counts, feature_shape=(4,), dtype="float32",
                        axis=kw.pop("axis", ("x",)), variant=variant, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 3"):
        check_process_spec(spec)


def test_auto_on_a_process_mesh_raises_before_any_collective():
    mesh = ProcessMesh(0, 4, "cpu")
    with pytest.raises(NotImplementedError, match="variant='auto'"):
        alltoallv_init(np.full((4, 4), 2), (4,), torch.float32, mesh,
                       variant="auto", store=False)


def test_process_mesh_asks_for_a_card_unless_cpu():
    """Without ``device="cpu"`` the mesh asks for CUDA and raises here,
    before it joins any process group."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_process_mesh(0, 2, "tcp://localhost:1")


def test_build_skips_the_lock_when_every_library_is_there(tmp_path, monkeypatch):
    """``build()`` returns at once when every library is built (each rank
    loads what the parent built), and takes the build directory's lock
    otherwise."""
    lib = tmp_path / "x.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_build, "library_path", lambda source: lib)
    monkeypatch.setattr(_build, "_build_lock", None)    # must not be taken
    assert _build.build(("a", "b")) == {"a": 0.0, "b": 0.0}
