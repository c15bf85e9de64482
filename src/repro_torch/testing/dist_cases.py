"""Multi-rank cases of the port, one process per rank:

    python -m repro_torch.testing.dist_cases <case|all> --ranks N [--device cpu]

Port of ``repro.testing.dist_cases``, the JAX package's harness of
multi-device cases run by subprocess.  Here a case runs in N processes
spawned for it (``spawn``: the spawn start method, a free port on
localhost, one ``launch.mesh.ProcessMesh`` rank each), every rank checks
its own shard against the oracle (``core.reference``) and the harness
prints ``CASE_OK <case>`` once every rank has passed.  If any rank fails,
dies or outlives the timeout, the harness kills the group, names the
failure and exits non-zero.  ``all`` runs the ported cases one after the
other in one group.

``CASES`` are the JAX package's cases on the path of the process mesh
(the flat fence and lock plans, the baseline, the peer kernels);
``PORT_CASES`` are the port's own: ``parity`` (every rank's rows of each
variant into ``--out`` for the CPU tests to hold against JAX's),
``digest_mismatch``, ``killed_rank`` (a rank dies: the harness must fail,
within the timeout), ``stalled_rank`` and ``stalled_rank_lock`` (a rank
stays alive but never signals: every other rank's flag wait must raise,
naming it), ``epoch_times`` (each rank's fence and lock epoch time on a
dense 1 MiB-per-pair pattern, with its launches and the window's
geometry) and ``ipc_probe`` (on a card: which mechanism maps a peer's
memory with several processes on one card).  Without ``--device
cpu`` every rank runs on a card (rank r on ``cuda:(r % device_count)``)
and the kernels are built in the parent before the ranks start.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import socket
import sys
import tempfile
import time
import traceback
import uuid

import numpy as np

CASES = {}
PORT_CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def port_case(fn):
    PORT_CASES[fn.__name__] = fn
    return fn


# -- the harness ---------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, ranks, init_method, device, token, out_dir, kwargs):
    import torch

    from ..launch.mesh import init_process_mesh

    path = os.path.join(out_dir, f"rank{rank}.json")
    result = {"rank": rank, "ok": False}
    try:
        torch.set_num_threads(1)
        mesh = init_process_mesh(rank, ranks, init_method, device=device,
                                 timeout=kwargs.pop("timeout", 120.0),
                                 flag_timeout=kwargs.pop("flag_timeout", 10.0),
                                 token=token)
        result["data"] = fn(mesh, **kwargs)
        mesh.close()
        result["ok"] = True
    except BaseException as exc:                     # reported to the parent
        result["error"] = "".join(traceback.format_exception(exc))[-4000:]
    with open(path + ".tmp", "w") as f:
        json.dump(result, f, default=str)
    os.replace(path + ".tmp", path)
    sys.stdout.flush()
    os._exit(0 if result["ok"] else 1)


def remove_run_files(token: str) -> None:
    """Remove the shared-memory files of run ``token`` that a rank left
    behind (a killed rank removes nothing)."""
    from ..core.window import shm_dir

    d = shm_dir()
    for name in os.listdir(d):
        if name.startswith(f"repro_torch_{token}_"):
            try:
                os.unlink(os.path.join(d, name))
            except OSError:
                pass


def spawn(fn, ranks: int, device: str | None = None, timeout: float = 300.0,
          **kwargs) -> list:
    """Run ``fn(mesh, **kwargs)`` on ``ranks`` spawned processes, one rank
    each, and return every rank's result (JSON-able) in rank order.  If a
    rank fails, dies or the group outlives ``timeout`` seconds, every rank
    still alive is killed and ``RuntimeError`` names what happened.  On a
    card the kernels are built here first."""
    import multiprocessing as mp

    if device is None or device.startswith("cuda"):
        from ..kernels import _build

        _build.build()
    ctx = mp.get_context("spawn")
    token = uuid.uuid4().hex[:12]
    init_method = f"tcp://localhost:{free_port()}"
    kwargs.setdefault("timeout", min(120.0, timeout))
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as out_dir:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, ranks, init_method, device, token,
                                   out_dir, dict(kwargs)), daemon=True)
                 for r in range(ranks)]
        for pr in procs:
            pr.start()
        deadline = time.monotonic() + timeout
        failure = None
        try:
            while any(pr.is_alive() for pr in procs):
                bad = [r for r, pr in enumerate(procs)
                       if not pr.is_alive() and pr.exitcode != 0]
                if bad:
                    failure = f"rank(s) {bad} failed (exit codes " \
                              f"{[procs[r].exitcode for r in bad]})"
                    break
                if time.monotonic() > deadline:
                    failure = f"the ranks outlived the timeout of {timeout} s"
                    break
                time.sleep(0.05)
            bad = [r for r, pr in enumerate(procs)
                   if not pr.is_alive() and pr.exitcode != 0]
            if failure is None and bad:
                failure = f"rank(s) {bad} failed (exit codes " \
                          f"{[procs[r].exitcode for r in bad]})"
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
            for pr in procs:
                pr.join(10)
            remove_run_files(token)
        results = []
        for r in range(ranks):
            path = os.path.join(out_dir, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    results.append(json.load(f))
            else:
                results.append({"rank": r, "ok": False,
                                "error": "no result (killed or died)"})
    if failure is not None:
        errors = "\n".join(f"--- rank {res['rank']}:\n{res.get('error', '')}"
                           for res in results if not res.get("ok"))
        raise RuntimeError(f"{failure}\n{errors}")
    return [res["data"] for res in results]


# -- helpers of the cases --------------------------------------------------------

def _setup_pattern(p, seed=0, max_count=13, feature=(4,), dtype=np.float32):
    """The JAX harness's ``_setup_pattern``: counts, every rank's send
    buffer, the oracle, recv counts and the padded row counts."""
    from ..core import metadata as md, reference
    from .patterns import random_counts

    counts = random_counts(p, seed, max_count)
    send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
    recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
    bufs = reference.make_testbufs(counts, feature, dtype, send_rows)
    expect = reference.alltoallv_global(bufs, counts, recv_rows)
    return counts, bufs, expect, md.recv_counts(counts), send_rows, recv_rows


def _shard(mesh, bufs):
    import torch

    return torch.from_numpy(np.ascontiguousarray(bufs[mesh.rank])).to(mesh.device)


def _check(mesh, got, expect, rc):
    """This rank's valid rows against the oracle's, bit for bit (the JAX
    cases allow a relative tolerance; rows only move)."""
    n = int(rc[mesh.rank].sum())
    g = got.cpu().numpy()[:n]
    w = expect[mesh.rank, :n]
    if not np.array_equal(g.view(np.uint8), w.view(np.uint8)):
        raise AssertionError(f"rank {mesh.rank}: valid rows differ from the "
                             f"oracle (max |diff| "
                             f"{np.abs(g.astype(np.float64) - w).max()})")


def _init(mesh, counts, feature, dtype, **kw):
    import torch

    from ..core import PlanCache, alltoallv_init

    kw.setdefault("cache", PlanCache())
    return alltoallv_init(counts, feature, getattr(torch, np.dtype(dtype).name),
                          mesh, axis="x", store=False, **kw)


@contextlib.contextmanager
def planted_geometry(**over):
    """Within the block, every window this rank registers starts from its
    own ``core.window.peer_geometry`` with the entries ``over`` replaced:
    another layout of ranks over cards, or another kind of memory, as a
    rank of such a mesh would report it."""
    from ..core import window

    real = window.peer_geometry
    window.peer_geometry = lambda mesh: {**real(mesh), **over}
    try:
        yield
    finally:
        window.peer_geometry = real


def _banded_counts(p, width=1, base=11, seed=3):
    from .patterns import banded_counts

    return banded_counts(p, width, base, seed)


def _baseline(mesh, counts, send_rows, recv_rows, capacity, feature, dtype,
              variant="fence"):
    import torch

    from ..core.baseline import make_nonpersistent

    exe = make_nonpersistent(mesh, axis="x", p=mesh.world_size,
                             capacity=capacity, send_rows=send_rows,
                             recv_rows=recv_rows, feature_shape=feature,
                             dtype=getattr(torch, np.dtype(dtype).name),
                             variant=variant)
    row = torch.as_tensor(np.asarray(counts)[mesh.rank], dtype=torch.int32,
                          device=mesh.device)
    return exe, row


# -- the ported cases ------------------------------------------------------------

@case
def alltoallv_variants(mesh):
    """fence / lock (ring + pairwise) / baseline vs the oracle (the JAX
    case without its hierarchy leg)."""
    p = mesh.world_size
    counts, bufs, expect, rc, send_rows, recv_rows = _setup_pattern(p)
    x = _shard(mesh, bufs)
    runs = [("fence", {}), ("lock", {})]
    if p & (p - 1) == 0:
        runs.append(("lock", {"lock_schedule": "pairwise"}))
    for variant, kw in runs:
        plan = _init(mesh, counts, (4,), np.float32, variant=variant, **kw)
        _check(mesh, plan.wait(plan.start(x)), expect, rc)
        plan.free()
    plan0 = _init(mesh, counts, (4,), np.float32)
    exe, row = _baseline(mesh, counts, send_rows, recv_rows, plan0.capacity,
                         (4,), np.float32)
    _check(mesh, exe(x, row), expect, rc)
    plan0.free()


@case
def alltoallv_dtypes_and_features(mesh):
    """Shape/dtype sweep for the fence engine."""
    from ..core import metadata as md, reference

    p = mesh.world_size
    for seed, feature, dtype in [(1, (8,), np.float32), (2, (3, 5), np.float32),
                                 (3, (16,), np.float16), (4, (), np.float32)]:
        counts = np.random.default_rng(seed).integers(0, 9, size=(p, p))
        send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
        recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
        bufs = reference.make_testbufs(counts, feature, dtype, send_rows)
        expect = reference.alltoallv_global(bufs, counts, recv_rows)
        plan = _init(mesh, counts, feature, dtype)
        got = plan.wait(plan.start(_shard(mesh, bufs)))
        _check(mesh, got, expect, md.recv_counts(counts))
        plan.free()


@case
def plan_and_window_reuse(mesh):
    """Plan cache hits, window reuse across epochs, re-INIT on size change."""
    import torch

    from ..core import PlanCache

    p = mesh.world_size
    cache = PlanCache()
    counts = np.arange(p * p, dtype=np.int64).reshape(p, p) % 7 + 1
    plan1 = _init(mesh, counts, (4,), np.float32, cache=cache)
    plan2 = _init(mesh, counts, (4,), np.float32, cache=cache)
    assert plan1 is plan2 and cache.hits == 1 and cache.misses == 1
    x = torch.zeros(plan1.global_send_shape, device=mesh.device)
    g0 = plan1.window.generation
    for _ in range(3):
        plan1.wait(plan1.start(x))
    assert plan1.window.generation == max(g0, 1), "window must be reused"
    counts2 = np.roll(counts, 1, axis=1)
    plan3 = _init(mesh, counts2, (4,), np.float32, cache=cache)
    assert plan3 is not plan1
    assert plan3.window is plan1.window, "window cached by recv bytes"
    plan3.wait(plan3.start(x))
    assert plan1.window.generation == 1, "same bytes: not re-registered"
    plan4 = _init(mesh, counts * 2, (4,), np.float32, cache=cache)
    assert plan4.window is not plan1.window
    plan4.wait(plan4.start(torch.zeros(plan4.global_send_shape,
                                       device=mesh.device)))
    assert plan4.window.generation == 1
    cache.window_cache.free()


@case
def rma_kernels(mesh):
    """The peer fence and lock kernels (the plain versions on the CPU) vs
    the bucketed oracle (``kernels.ref.a2a_bucketed_ref``)."""
    import torch

    from ..core.window import SharedRegion
    from ..kernels import ops, ref

    p, me = mesh.world_size, mesh.rank
    rng = np.random.default_rng(0)
    for cap, feat in [(8, 100), (16, 128)]:
        packed_all = rng.standard_normal((p, p * cap, feat)).astype(np.float32)
        want = ref.a2a_bucketed_ref(packed_all, p, cap)[me]
        region = SharedRegion(mesh, p * cap * feat * 4)
        packed = torch.from_numpy(packed_all[me]).to(mesh.device)
        for variant in ("fence", "lock"):
            ops.rma_alltoallv_peer(packed, region.win, variant=variant,
                                   capacity=cap)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize()
            got = region.win.view(p * cap, (feat,), torch.float32).cpu()
            np.testing.assert_array_equal(got.numpy(), want)
            mesh.barrier()        # every rank has read before the next epoch
        region.free()


@case
def pallas_pack_in_plan(mesh):
    """Persistent plan with pack_impl='pallas' matches the oracle."""
    p = mesh.world_size
    counts, bufs, expect, rc, _, _ = _setup_pattern(p, seed=5, max_count=9)
    plan = _init(mesh, counts, (4,), np.float32, variant="fence",
                 pack_impl="pallas")
    _check(mesh, plan.wait(plan.start(_shard(mesh, bufs))), expect, rc)
    plan.free()


@case
def sparse_lock_elision(mesh):
    """Zero-capacity lock rounds are skipped and the output is identical to
    both the oracle and the unelided (full-capacity) exchange."""
    from ..core import metadata as md, reference

    p = mesh.world_size
    counts = _banded_counts(p, width=1)
    send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
    recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
    bufs = reference.make_testbufs(counts, (4,), np.float32, send_rows)
    expect = reference.alltoallv_global(bufs, counts, recv_rows)
    rc = md.recv_counts(counts)
    x = _shard(mesh, bufs)
    plan = _init(mesh, counts, (4,), np.float32, variant="lock")
    if p > 3:
        assert plan.lock_rounds_active == 2, plan.lock_rounds_active
        assert plan.lock_rounds_active < plan.lock_rounds_total
    got = plan.wait(plan.start(x))
    _check(mesh, got, expect, rc)
    exe, row = _baseline(mesh, counts, send_rows, recv_rows, plan.capacity,
                         (4,), np.float32, variant="lock")
    full = exe(x, row)
    n = int(rc[mesh.rank].sum())
    np.testing.assert_array_equal(got.cpu().numpy()[:n], full.cpu().numpy()[:n])
    plan.free()


@case
def fused_pack_fence(mesh):
    """pack_impl='fused' (the peer K3, its plain version on the CPU)
    matches the oracle: 16-byte rows (the tile kernel on a card) and
    60-byte rows (the warp-per-row kernel)."""
    p = mesh.world_size
    for feature in ((4,), (3, 5)):
        counts, bufs, expect, rc, _, _ = _setup_pattern(p, seed=9, max_count=9,
                                                        feature=feature)
        plan = _init(mesh, counts, feature, np.float32, variant="fence",
                     pack_impl="fused")
        _check(mesh, plan.wait(plan.start(_shard(mesh, bufs))), expect, rc)
        plan.free()


@case
def pipelined_epochs(mesh):
    """start_pipelined alternates window slots; every epoch's output is
    correct and slots really double-buffer (two registered windows)."""
    p = mesh.world_size
    counts, bufs, expect, rc, _, _ = _setup_pattern(p, seed=11)
    x = _shard(mesh, bufs)
    plan = _init(mesh, counts, (4,), np.float32)
    prev = plan.start_pipelined(x)
    for _ in range(3):
        cur = plan.start_pipelined(x)
        _check(mesh, plan.wait(prev), expect, rc)
        prev = cur
    _check(mesh, plan.wait(prev), expect, rc)
    assert len(plan.window._slots) == 2, "double buffering must use 2 slots"
    a, b = (plan.window._slots[s].win.local for s in (0, 1))
    assert a.data_ptr() != b.data_ptr()
    plan.free()


# -- the port's own cases --------------------------------------------------------

PARITY_PATTERN = {"seed": 0, "max_count": 13, "feature": (4,)}
# (name, variant, pack_impl, lock_schedule); "banded" runs on banded counts.
PARITY_PLANS = (("fence", "jnp", "ring"), ("fence", "pallas", "ring"),
                ("fence", "fused", "ring"), ("lock", "jnp", "ring"),
                ("lock", "jnp", "pairwise"), ("lock", "pallas", "ring"))


def parity_inputs(p):
    """The parity run's counts and every rank's send buffer per pattern:
    ``random`` (``_setup_pattern``), ``random15`` (its counts, 60-byte rows
    of 15 float32) and ``banded`` (elided lock rounds)."""
    from ..core import metadata as md, reference

    out = {}
    random = _setup_pattern(p)[0]
    for name, counts, feature in (("random", random, (4,)),
                                  ("random15", random, (15,)),
                                  ("banded", _banded_counts(p, width=1), (4,))):
        send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
        bufs = reference.make_testbufs(counts, feature, np.float32, send_rows)
        out[name] = (counts, bufs)
    return out


@port_case
def parity(mesh, out=None):
    """Every rank's receive rows for each plan of ``PARITY_PLANS`` on the
    random pattern, the lock at 60-byte rows, lock ring and pairwise on the
    banded one, three pipelined epochs (inputs scaled by 1, 2, 3) and the
    baseline (fence, lock), into ``out/rank<r>.npz``; window reuse and
    registration, the collective FREE, a count-digest mismatch, the ranks
    on the card, an uneven layout of ranks over cards (``planted_geometry``;
    its rows too) and a geometry mismatch as facts."""
    import torch

    from ..core import PlanCache

    p, me = mesh.world_size, mesh.rank
    res, facts = {}, {}
    inputs = parity_inputs(p)
    counts, bufs = inputs["random"]
    x = _shard(mesh, bufs)
    for variant, impl, sched in PARITY_PLANS:
        plan = _init(mesh, counts, (4,), np.float32, variant=variant,
                     pack_impl=impl, lock_schedule=sched)
        res[f"random-{variant}-{impl}-{sched}"] = plan.wait(plan.start(x)).cpu()
        plan.free()
    plan = _init(mesh, counts, (15,), np.float32, variant="lock")
    res["random15-lock-jnp-ring"] = plan.wait(plan.start(
        _shard(mesh, inputs["random15"][1]))).cpu()
    plan.free()
    bcounts, bbufs = inputs["banded"]
    bx = _shard(mesh, bbufs)
    for sched in ("ring", "pairwise"):
        plan = _init(mesh, bcounts, (4,), np.float32, variant="lock",
                     lock_schedule=sched)
        facts[f"banded-lock-{sched}-rounds"] = [plan.lock_rounds_active,
                                                plan.lock_rounds_total]
        res[f"banded-lock-jnp-{sched}"] = plan.wait(plan.start(bx)).cpu()
        plan.free()
    plan = _init(mesh, counts, (4,), np.float32)
    outs = [plan.start_pipelined(x * k) for k in (1.0, 2.0)]
    res["pipelined-0"] = plan.wait(outs[0]).cpu().clone()
    outs.append(plan.start_pipelined(x * 3.0))     # slot 0 again
    res["pipelined-1"] = plan.wait(outs[1]).cpu()
    res["pipelined-2"] = plan.wait(outs[2]).cpu()
    facts["pipelined_slots"] = len(plan.window._slots)
    for variant in ("fence", "lock"):
        exe, row = _baseline(mesh, counts, plan.send_rows, plan.recv_rows,
                             plan.capacity, (4,), np.float32, variant)
        res[f"baseline-{variant}"] = exe(x, row).cpu()
    plan.free()

    # Window reuse and re-registration (the paper's rule).
    cache = PlanCache()
    wc = cache.window_cache
    a = _init(mesh, counts, (4,), np.float32, cache=cache)
    a.wait(a.start(x))
    b = _init(mesh, np.roll(counts, 1, axis=1), (4,), np.float32, cache=cache)
    b.wait(b.start(torch.zeros(b.global_send_shape, device=mesh.device)))
    c = _init(mesh, counts * 2, (4,), np.float32, cache=cache)
    c.wait(c.start(torch.zeros(c.global_send_shape, device=mesh.device)))
    facts["window"] = {"same_window_same_bytes": b.window is a.window,
                       "registrations_after_two_plans": a.window.generation,
                       "new_window_on_size_change": c.window is not a.window,
                       "recreates": wc.recreates, "hits": wc.hits}
    # The collective FREE: every rank's files (or mappings) go only after
    # every rank reached it.
    region = a.window._slots[0].region
    path = region.path
    cache.window_cache.free()
    facts["free"] = {"slots_after": len(a.window._slots),
                     "file_removed": path is None or not os.path.exists(path),
                     "region_closed": region.win is None}
    # A count matrix that differs on one rank raises on every rank.
    bad = counts.copy()
    if me == p - 1:
        bad[0, 0] += 1
    try:
        _init(mesh, bad, (4,), np.float32)
        facts["digest_mismatch"] = "no error"
    except ValueError as exc:
        facts["digest_mismatch"] = str(exc)
    # An uneven layout (ranks 2, 2, 1, 1, ... per card; 8 CTAs a card)
    # registers: every rank takes the fewest K4 CTAs, its own K2 grid and
    # system scope, and its rows equal the even run's.
    per_card = 2 if me < p // 2 else 1
    with planted_geometry(ranks_on_device=per_card, fence_ctas=8 // per_card,
                          lock_ctas=8 // per_card):
        for variant, impl in (("lock", "jnp"), ("fence", "pallas")):
            plan = _init(mesh, counts, (4,), np.float32, variant=variant,
                         pack_impl=impl)
            res[f"uneven-{variant}-{impl}"] = plan.wait(plan.start(x)).cpu()
            win = plan.window._slots[0].win
            facts[f"uneven-{variant}"] = {
                "lock_ctas": win.lock_ctas, "fence_ctas": win.fence_ctas,
                "sys_scope": win.sys_scope, "pad_flags": win.pad.numel()}
            plan.free()
    # A rank whose windows lie in memory of another kind (a card's among
    # the CPU's) cannot map its peers': INIT raises on every rank.
    facts["ranks_on_device"] = mesh.ranks_on_device
    other = "cuda" if mesh.device.type == "cpu" else "cpu"
    with planted_geometry(**({"memory": other} if me == p - 1 else {})):
        try:
            _init(mesh, counts, (4,), np.float32).compile()
            facts["geometry_mismatch"] = "no error"
        except ValueError as exc:
            facts["geometry_mismatch"] = str(exc)
    if out is not None:
        np.savez(os.path.join(out, f"rank{me}.npz"),
                 **{k: v.numpy() for k, v in res.items()})
    return facts


@port_case
def digest_mismatch(mesh):
    """One rank passes another count matrix: INIT raises on every rank."""
    p = mesh.world_size
    counts = _setup_pattern(p)[0]
    if mesh.rank == 0:
        counts = counts.copy()
        counts[p - 1, 0] += 1
    try:
        _init(mesh, counts, (4,), np.float32)
    except ValueError as exc:
        assert "disagree" in str(exc), exc
        return str(exc)
    raise AssertionError(f"rank {mesh.rank}: INIT did not raise")


@port_case
def killed_rank(mesh):
    """The last rank dies after INIT; the others start an epoch.  The
    harness must end with an error within its timeout, never hang."""
    import signal

    p = mesh.world_size
    counts, bufs, expect, rc, _, _ = _setup_pattern(p)
    plan = _init(mesh, counts, (4,), np.float32)
    plan.compile()
    mesh.barrier()
    if mesh.rank == p - 1:
        os.kill(os.getpid(), signal.SIGKILL)
    plan.wait(plan.start(_shard(mesh, bufs)))


def _stalled(mesh, variant):
    """The last rank stays alive but never starts the epoch, so it never
    signals its OPEN.  Every other rank's epoch must end with the error of
    its bounded flag wait, naming itself, the epoch and a flag of the
    stalled rank, no sooner than the flag timeout; then every rank meets
    at a barrier.  Returns each rank's message and seconds."""
    p, me = mesh.world_size, mesh.rank
    counts, bufs, _, _, _, _ = _setup_pattern(p)
    plan = _init(mesh, counts, (4,), np.float32, variant=variant)
    plan.compile()
    x = _shard(mesh, bufs)
    mesh.barrier()
    if me == p - 1:
        mesh.barrier()
        return {"rank": me, "stalled": True}
    t0 = time.monotonic()
    try:
        plan.wait(plan.start(x))
    except RuntimeError as exc:
        seconds, msg = time.monotonic() - t0, str(exc)
    else:
        raise AssertionError(f"rank {me}: the epoch ended without rank "
                             f"{p - 1}'s OPEN")
    flags = "open" if variant == "fence" else "(open|round)"
    if not re.match(rf"rank {me}, epoch 1: the {flags} flag of rank {p - 1} ",
                    msg) or seconds < mesh.flag_timeout:
        raise AssertionError(f"rank {me}: after {seconds:.2f} s: {msg}")
    mesh.barrier()
    return {"rank": me, "error": msg, "seconds": seconds}


@port_case
def stalled_rank(mesh):
    """A live rank that never signals: the fence epoch's OPEN wait (the
    signal kernel) fails every other rank within the flag timeout."""
    return _stalled(mesh, "fence")


@port_case
def stalled_rank_lock(mesh):
    """A live rank that never signals: the lock epoch's flag waits (inside
    the peer K4) fail every other rank within the flag timeout."""
    return _stalled(mesh, "lock")


@port_case
def epoch_times(mesh, iters=20):
    """Each rank's epoch time for fence and lock (``pack_impl="pallas"``)
    on config A's dense pattern at P = world size (1024 rows of 1 KiB per
    pair), valid rows against the oracle first; on a card CUDA events
    around each START (the card's time; ``clock`` says which), on the CPU
    the host clock around START and WAIT.  Also each epoch's launches and
    the window's geometry (ranks on the card, CTAs, flag scope)."""
    import statistics

    import torch

    from ..core import metadata as md, reference
    from ..kernels import _build

    p, me = mesh.world_size, mesh.rank
    counts = np.full((p, p), 1024, np.int64)
    rows = max(md.round_up(md.max_total_send(counts), 8), 8)
    bufs = reference.make_testbufs(counts, (256,), np.float32, rows)
    expect = reference.alltoallv_global(bufs, counts, rows)
    rc = md.recv_counts(counts)
    x = _shard(mesh, bufs)
    cuda = mesh.device.type == "cuda"
    out = {"rank": me, "device": str(mesh.device),
           "clock": "cuda events" if cuda else "host"}
    for variant in ("fence", "lock"):
        plan = _init(mesh, counts, (256,), np.float32, variant=variant,
                     pack_impl="pallas")
        _check(mesh, plan.wait(plan.start(x)), expect, rc)
        win = plan.window._slots[0].win
        out["geometry"] = {"ranks_on_device": mesh.ranks_on_device,
                           "fence_ctas": win.fence_ctas,
                           "lock_ctas": win.lock_ctas,
                           "sys_scope": win.sys_scope}
        mesh.barrier()
        before = _build.counts()
        ms = []
        for _ in range(iters):
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                recv = plan.start(x)
                b.record()
                plan.wait(recv)
                b.synchronize()
                ms.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                plan.wait(plan.start(x))
                ms.append((time.perf_counter() - t0) * 1e3)
        after = _build.counts()
        out[variant] = {
            "epoch_ms_p50": statistics.median(ms), "epoch_ms_min": min(ms),
            "epoch_ms_max": max(ms),
            "launches_per_epoch": {
                k: (after[k]["launches"] - before[k]["launches"]) / iters
                for k in after
                if after[k]["launches"] != before[k]["launches"]}}
        _check(mesh, plan.wait(plan.start(x)), expect, rc)
        plan.free()
    return out


@port_case
def ipc_probe(mesh):
    """On a card: which mechanism maps another process's memory with
    several processes on one card.  (1) the port's cudaMalloc and CUDA IPC
    handle (``kernels.rma_signal``); (2) PyTorch's own IPC sharing
    (``torch.multiprocessing.reductions.reduce_tensor``); (3)
    ``torch.distributed._symmetric_memory``.  Each: the peer's bytes read
    back through the mapping."""
    import pickle

    import torch

    from ..core.window import SharedRegion

    out = {"rank": mesh.rank, "device": str(mesh.device)}
    p, me = mesh.world_size, mesh.rank
    try:
        region = SharedRegion(mesh, 4096)
        region.win.local.fill_(me + 1)
        torch.cuda.synchronize()
        mesh.barrier()
        seen = [int(t[0]) for t in region.win.peers]
        out["cuda_ipc"] = "ok" if seen == list(range(1, p + 1)) else f"read {seen}"
        region.free()
    except Exception as exc:                              # a probe: report
        out["cuda_ipc"] = f"failed: {exc!r}"[:300]
    try:
        from torch.multiprocessing.reductions import reduce_tensor

        t = torch.full((1024,), float(me + 1), device=mesh.device)
        rebuild, args = reduce_tensor(t)
        blobs = mesh.all_gather_object(pickle.dumps((rebuild, args)))
        seen = []
        for r, blob in enumerate(blobs):
            if r == me:
                seen.append(me + 1)
                continue
            fn, a = pickle.loads(blob)
            seen.append(int(fn(*a)[0].item()))
        mesh.barrier()
        out["torch_reduce_tensor"] = ("ok" if seen == list(range(1, p + 1))
                                      else f"read {seen}")
        del t
    except Exception as exc:
        out["torch_reduce_tensor"] = f"failed: {exc!r}"[:300]
    try:
        import torch.distributed as dist
        import torch.distributed._symmetric_memory as symm

        t = symm.empty(1024, device=mesh.device)
        t.fill_(float(me + 1))
        handle = symm.rendezvous(t, dist.group.WORLD.group_name)
        torch.cuda.synchronize()
        mesh.barrier()
        seen = [int(handle.get_buffer(r, (1,), torch.float32)[0].item())
                for r in range(p)]
        out["symmetric_memory"] = ("ok" if seen == list(range(1, p + 1))
                                   else f"read {seen}")
    except Exception as exc:
        out["symmetric_memory"] = f"failed: {exc!r}"[:300]
    mesh.barrier()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("case", help="a case name, or 'all' (the ported cases)")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu (default: the card)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds for the whole group")
    ap.add_argument("--flag-timeout", type=float, default=10.0,
                    help="seconds a rank waits on a peer's flag")
    ap.add_argument("--out", default=None, help="output directory (parity)")
    args = ap.parse_args(argv)
    names = list(CASES) if args.case == "all" else [args.case]
    unknown = [n for n in names if n not in CASES and n not in PORT_CASES]
    if unknown:
        ap.error(f"unknown case {unknown[0]!r}; have "
                 f"{sorted(CASES) + sorted(PORT_CASES)}")
    kwargs = {"flag_timeout": args.flag_timeout}
    if args.case == "parity":
        kwargs["out"] = args.out
    fn = _run_all if args.case == "all" else (CASES.get(args.case)
                                              or PORT_CASES[args.case])
    if args.case == "all":
        kwargs["names"] = names
    results = spawn(fn, args.ranks, args.device, args.timeout, **kwargs)
    for name in names:
        print(f"CASE_OK {name}", flush=True)
    if args.case in PORT_CASES:
        print(json.dumps({"case": args.case, "ranks": results}, default=str),
              flush=True)
    return 0


def _run_all(mesh, names):
    for name in names:
        CASES[name](mesh)
        mesh.barrier()
    return names


if __name__ == "__main__":
    sys.exit(main())
