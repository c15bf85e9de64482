#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one NVIDIA H100, end to end.

    python3 chip_smoke.py

Phases, each printed as a JSON line:

  1. build    compile the CUDA kernels in src/repro_torch/kernels/csrc/ with
              nvcc for sm_90a into build/repro_torch_kernels/, all sources
              at once;
  2. kernels  each kernel against its plain PyTorch version on the card, on
              the same inputs, over dtypes and row widths (f32 F=256, bf16
              F=2048, f32 F=100, f32 (3, 5), f16 F=16), and for the lock
              kernel the ring and pairwise schedules with and without
              elided rounds.  Tolerance: every output byte equal (the
              kernels only move rows; invalid rows are +0.0);
  3. main     the persistent alltoallv plan through ``alltoallv_init`` on
              ``VirtualMesh((P,), ("x",))`` for fence x pallas, fence x fused,
              lock x pallas x ring and lock x pallas x pairwise, at
              A: P=8, dense, 1024 rows of 256 f32 per pair (1 MiB messages),
                 the top of benchmarks/msg_sweep.py, and
              B: P=64 virtual ranks, the hugetrace-like skewed pattern of
                 benchmarks/sparse_pattern.py with base_rows=64, 256 f32 rows.
              Valid rows must equal the numpy oracle
              (``core.reference.alltoallv_global``) bit for bit.  The kernel
              counters are zeroed just before and read just after: every
              kernel must have launched and no plain version may have run.
              Then every kernel against its plain version, bytes equal, on
              each config's own send buffer, baked tables and lock round
              capacities (ring and pairwise);
  4. times    CUDA events, warm-up, median of 20 runs: each kernel at
              config A (gated bytes equal to its plain version) beside its
              bound, its plain version, the one PyTorch call that computes
              the same function on A's dense pattern (index_select, or the
              bucket transpose) and the host time to enqueue it; every
              epoch at A and B beside its design bound (padded buckets) and
              its payload bound (valid rows only); persistent plans that
              pack as the baseline does; the non-persistent baseline.

Before the last line it prints the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them, and the ``{"kernels": [...]}`` line.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, it exits non-zero before printing it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM HBM3 bandwidth (NVIDIA data sheet): the bound of a byte mover.
HBM_BYTES_PER_S = 3.35e12
FEATURE = 256                       # float32 per row: 1 KiB rows
ITERS = 20
MAIN_RUNS = (("fence", "pallas", "ring"), ("fence", "fused", "ring"),
             ("lock", "pallas", "ring"), ("lock", "pallas", "pairwise"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def same_bytes(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


def expect_same(name, got, want) -> None:
    """Raise unless ``got`` and ``want`` hold the same bytes."""
    import torch
    torch.cuda.synchronize()
    if not same_bytes(got, want):
        diff = (got.float() - want.float()).abs()
        raise AssertionError(f"{name}: outputs differ "
                             f"(max |diff| {diff.nan_to_num(1e30).max().item()})")


def median_ms(fn, iters=ITERS, inner=5, warmup=3) -> float:
    """Median over ``iters`` runs of the device time of one call, each run
    timed with CUDA events around ``inner`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def median_host_ms(fn, iters=ITERS, warmup=3) -> float:
    """Median host time of ``fn`` (which ends by waiting for the device)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def median_enqueue_ms(fn, iters=ITERS, inner=5, warmup=3) -> float:
    """Median host time to enqueue one call of ``fn`` on an idle stream.
    Where it reaches the device time of the call, the host paces the card."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / inner)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------


def check_kernels(device) -> int:
    import numpy as np
    import torch
    from repro_torch.core import metadata as md
    from repro_torch.kernels import a2a_fence, a2a_lock, gather_rows
    from repro_torch.testing.patterns import banded_counts

    p = 8
    gen = torch.Generator(device=device).manual_seed(0)
    n_cases = 0

    def check(name, got, want):
        nonlocal n_cases
        expect_same(name, got, want)
        n_cases += 1

    def rand(shape, dtype):
        t = torch.randn(shape, generator=gen, device=device).to(dtype)
        # Row 0 of every rank feeds the invalid rows' (unused) source index:
        # a NaN there must not leak into the zeroed padding.
        t[:, 0] = float("nan")
        return t

    cases = [(torch.float32, (256,)), (torch.bfloat16, (2048,)),
             (torch.float32, (100,)), (torch.float32, (3, 5)),
             (torch.float16, (16,))]
    for ci, (dtype, feat) in enumerate(cases):
        tag = f"{dtype}{feat}"
        counts = np.random.default_rng(ci).integers(0, 40, size=(p, p))
        cap = md.global_capacity(counts)
        send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
        recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
        t = md.baked_index_tables(counts, cap, recv_rows)
        src, valid, rsrc, rvalid = (torch.tensor(a, device=device) for a in (
            t.pack_src, t.pack_valid, t.unpack_src, t.unpack_valid))
        x = rand((p, send_rows) + feat, dtype)

        packed = gather_rows.gather_rows(x, src, valid)
        check(f"gather_rows pack {tag}", packed,
              gather_rows.gather_rows_plain(x, src, valid))
        win = rand((p, recv_rows) + feat, dtype)
        w1, w2 = win.clone(), win.clone()
        gather_rows.gather_rows(packed, rsrc, rvalid, out=w1)
        gather_rows.gather_rows_plain(packed, rsrc, rvalid, out=w2)
        check(f"gather_rows unpack write-through {tag}", w1, w2)

        check(f"a2a_fence {tag}",
              a2a_fence.rma_alltoallv_fence(packed, p, cap),
              a2a_fence.rma_alltoallv_fence_plain(packed, p, cap))
        check(f"a2a_fence_fused {tag}",
              a2a_fence.rma_alltoallv_fence_fused(x, src, valid, p, cap),
              a2a_fence.rma_alltoallv_fence_fused_plain(x, src, valid, p, cap))

        for pattern, cnt in (("skewed", counts), ("banded", banded_counts(p))):
            for sched in ("ring", "pairwise"):
                caps = (md.xor_round_capacities(cnt) if sched == "pairwise"
                        else md.ring_round_capacities(cnt))
                for rc_name, rcaps in (("elided", caps), ("full", None)):
                    name = f"a2a_lock {sched} {pattern} {rc_name} {tag}"
                    check(name,
                          a2a_lock.rma_alltoallv_lock(packed, p, cap, rcaps, sched),
                          a2a_lock.rma_alltoallv_lock_plain(packed, p, cap, rcaps, sched))
    # Every round elided (all traffic local): the local bucket's own launch.
    local = np.diag(np.full(p, 9))
    cap = md.global_capacity(local)
    packed = torch.randn((p, p * cap, 16), generator=gen, device=device)
    check("a2a_lock all rounds elided",
          a2a_lock.rma_alltoallv_lock(packed, p, cap,
                                      md.ring_round_capacities(local)),
          a2a_lock.rma_alltoallv_lock_plain(packed, p, cap,
                                            md.ring_round_capacities(local)))
    return n_cases


# ---------------------------------------------------------------------------
# Phase 3: the main path through the public entry points
# ---------------------------------------------------------------------------


def make_config(name, counts, device):
    import numpy as np
    import torch
    from repro_torch.core import metadata as md, reference
    p = counts.shape[0]
    send_rows = max(md.round_up(md.max_total_send(counts), 8), 8)
    recv_rows = max(md.round_up(md.max_total_recv(counts), 8), 8)
    bufs = reference.make_testbufs(counts, (FEATURE,), np.float32, send_rows)
    expect = reference.alltoallv_global(bufs, counts, recv_rows)
    x = torch.from_numpy(bufs.reshape(p * send_rows, FEATURE)).to(device)
    return {"name": name, "p": p, "counts": counts, "send_rows": send_rows,
            "recv_rows": recv_rows, "expect": expect, "x": x,
            "rc": md.recv_counts(counts)}


def check_against_oracle(label, got, cfg) -> None:
    import numpy as np
    got = got.cpu().numpy().reshape(cfg["p"], cfg["recv_rows"], FEATURE)
    for r in range(cfg["p"]):
        n = int(cfg["rc"][r].sum())
        if not np.array_equal(got[r, :n].view(np.uint32),
                              cfg["expect"][r, :n].view(np.uint32)):
            raise AssertionError(f"{label}: rank {r} differs from the oracle")


def run_main_path(configs, device):
    from repro_torch.core import PlanCache, alltoallv_init
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import VirtualMesh

    plans = {}
    per_epoch = {}
    _build.reset_counts()
    for cfg in configs:
        mesh = VirtualMesh((cfg["p"],), ("x",))
        for variant, pack_impl, sched in MAIN_RUNS:
            label = f"{cfg['name']}:{variant}x{pack_impl}" + (
                f"x{sched}" if variant == "lock" else "")
            before = _build.counts()
            plan = alltoallv_init(cfg["counts"], (FEATURE,), "float32", mesh,
                                  axis="x", variant=variant,
                                  pack_impl=pack_impl, lock_schedule=sched,
                                  cache=PlanCache())
            out = plan.wait(plan.start(cfg["x"]))
            after = _build.counts()
            per_epoch[label] = {k: after[k]["launches"] - before[k]["launches"]
                                for k in after
                                if after[k]["launches"] != before[k]["launches"]}
            check_against_oracle(label, out, cfg)
            plans[label] = (plan, cfg)
    counts = _build.counts()
    missing = [k for k, v in counts.items() if v["launches"] == 0]
    plain = [k for k, v in counts.items() if v["plain_calls"] != 0]
    if missing or plain:
        raise AssertionError(f"main path: kernels not launched {missing}, "
                             f"plain versions called {plain}")
    return plans, per_epoch, {k: v["launches"] for k, v in counts.items()}


def check_at_main_shapes(cfg, plans, device) -> int:
    """Each kernel against its plain version on the main path's own inputs:
    the config's send buffer, the plans' baked tables and the lock plans'
    round capacities (ring and pairwise)."""
    import torch
    from repro_torch.kernels import a2a_fence, a2a_lock, gather_rows

    name = cfg["name"]
    fence = plans[f"{name}:fencexpallas"][0]
    p, cap = fence.p, fence.capacity
    x = cfg["x"].view(p, cfg["send_rows"], FEATURE)
    src, valid, rsrc, rvalid = fence.compile()._tables
    packed = gather_rows.gather_rows(x, src, valid)
    expect_same(f"{name}: gather_rows pack", packed,
                gather_rows.gather_rows_plain(x, src, valid))
    buckets = a2a_fence.rma_alltoallv_fence(packed, p, cap)
    expect_same(f"{name}: a2a_fence", buckets,
                a2a_fence.rma_alltoallv_fence_plain(packed, p, cap))
    expect_same(f"{name}: a2a_fence_fused",
                a2a_fence.rma_alltoallv_fence_fused(x, src, valid, p, cap),
                a2a_fence.rma_alltoallv_fence_fused_plain(x, src, valid, p, cap))
    gen = torch.Generator(device=device).manual_seed(1)
    win = torch.randn((p, cfg["recv_rows"], FEATURE), generator=gen,
                      device=device)
    w1, w2 = win.clone(), win.clone()
    gather_rows.gather_rows(buckets, rsrc, rvalid, out=w1)
    gather_rows.gather_rows_plain(buckets, rsrc, rvalid, out=w2)
    expect_same(f"{name}: gather_rows unpack write-through", w1, w2)
    for sched in ("ring", "pairwise"):
        lock = plans[f"{name}:lockxpallasx{sched}"][0]
        assert lock.capacity == cap
        rcaps = lock.round_capacities
        expect_same(f"{name}: a2a_lock {sched}",
                    a2a_lock.rma_alltoallv_lock(packed, p, cap, rcaps, sched),
                    a2a_lock.rma_alltoallv_lock_plain(packed, p, cap, rcaps, sched))
    return 6


# ---------------------------------------------------------------------------
# Phase 4: times on the card
# ---------------------------------------------------------------------------


def time_kernels(cfg_a, plan_fence, plan_lock, device):
    """Each kernel at config A: its time, bound, plain time, library call,
    and the host time to enqueue one call."""
    import torch
    from repro_torch.kernels import a2a_fence, a2a_lock, gather_rows

    p, cap = plan_fence.p, plan_fence.capacity
    x = cfg_a["x"].view(p, cfg_a["send_rows"], FEATURE)
    src, valid, _, _ = plan_fence.compile()._tables
    rb = FEATURE * 4
    n_valid = int(valid.sum().item())
    if n_valid != valid.numel():
        raise AssertionError("config A must be dense: the library calls "
                             "below compute the kernels' function only there")
    table_bytes = src.numel() * 4 + valid.numel()
    packed = gather_rows.gather_rows(x, src, valid)
    flat_x = x.reshape(-1, FEATURE)
    flat_idx = (src.long() + torch.arange(p, device=device)[:, None]
                * cfg_a["send_rows"]).reshape(-1)
    # Pack index composed with the bucket transpose: out[tgt][src*C + k].
    fused_idx = flat_idx.view(p, p, cap).transpose(0, 1).reshape(-1)
    lock_caps = plan_lock.round_capacities
    lock_read_rows = p * cap + p * sum(min(int(c), cap) for c in lock_caps[1:])

    def transpose():
        return packed.view(p, p, cap, FEATURE).transpose(0, 1).contiguous()

    rows, enqueue = [], {}
    specs = [
        ("gather_rows", "src/repro_torch/kernels/csrc/gather_rows.cu",
         "src/repro/kernels/gather_rows.py:82",
         lambda: gather_rows.gather_rows(x, src, valid),
         lambda: gather_rows.gather_rows_plain(x, src, valid),
         lambda: torch.index_select(flat_x, 0, flat_idx),
         n_valid * rb + table_bytes + p * p * cap * rb),
        ("a2a_fence", "src/repro_torch/kernels/csrc/a2a_fence.cu",
         "src/repro/kernels/a2a_fence.py:102",
         lambda: a2a_fence.rma_alltoallv_fence(packed, p, cap),
         lambda: a2a_fence.rma_alltoallv_fence_plain(packed, p, cap),
         transpose,
         2 * p * p * cap * rb),
        ("a2a_fence_fused", "src/repro_torch/kernels/csrc/a2a_fence.cu",
         "src/repro/kernels/a2a_fence.py:237",
         lambda: a2a_fence.rma_alltoallv_fence_fused(x, src, valid, p, cap),
         lambda: a2a_fence.rma_alltoallv_fence_fused_plain(x, src, valid, p, cap),
         lambda: torch.index_select(flat_x, 0, fused_idx),
         n_valid * rb + table_bytes + p * p * cap * rb),
        ("a2a_lock", "src/repro_torch/kernels/csrc/a2a_lock.cu",
         "src/repro/kernels/a2a_lock.py:74",
         lambda: a2a_lock.rma_alltoallv_lock(packed, p, cap, lock_caps, "ring"),
         lambda: a2a_lock.rma_alltoallv_lock_plain(packed, p, cap, lock_caps, "ring"),
         transpose,
         lock_read_rows * rb + p * p * cap * rb),
    ]
    for name, source, replaces, kern, plain, library, nbytes in specs:
        got, want = kern(), plain()
        expect_same(f"A: {name} at timing", got, want)
        # At A every row is valid and every lock round full, so the one
        # library call computes the same function.
        expect_same(f"A: {name} library call", library().view(got.shape), got)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "max_abs_err": float((got.float() - want.float()).abs().max().item()),
            "ms": median_ms(kern), "plain_ms": median_ms(plain),
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "bytes": nbytes,
            "library_ms": median_ms(library),
        })
        enqueue[name] = median_enqueue_ms(kern)
    return rows, enqueue


def design_bytes(plan) -> int:
    """Least bytes one epoch of this design moves: each pass reads its input
    rows once and writes its output rows once, padded buckets included."""
    spec, p, cap, rb = plan.spec, plan.p, plan.capacity, plan.row_bytes
    t = plan.index_tables
    n_pack_valid = int(t.pack_valid.sum())
    n_unpack_valid = int(t.unpack_valid.sum())
    tables = (t.pack_src.size * 5 + t.unpack_src.size * 5)
    bucket_rows = p * p * cap
    unpack = n_unpack_valid * 2 * rb
    if spec.pack_impl == "fused":
        return n_pack_valid * rb + bucket_rows * rb + unpack + tables
    pack = n_pack_valid * rb + bucket_rows * rb
    if spec.variant == "fence":
        exchange = 2 * bucket_rows * rb
    else:
        caps = plan.round_capacities
        read = p * cap + p * sum(min(int(c), cap) for c in caps[1:])
        exchange = read * rb + bucket_rows * rb
    return pack + exchange + unpack + tables


def payload_bytes(plan) -> int:
    """Least bytes any alltoallv of this pattern moves: every valid row read
    once and written once, plus the plan's index tables."""
    t = plan.index_tables
    tables = (t.pack_src.size * 5 + t.unpack_src.size * 5)
    return (int(t.pack_valid.sum()) + int(t.unpack_valid.sum())) \
        * plan.row_bytes + tables


def time_epochs(plans, configs, device):
    import torch
    from repro_torch.core import PlanCache, alltoallv_init
    from repro_torch.core.baseline import make_nonpersistent
    from repro_torch.launch.mesh import VirtualMesh

    timed = dict(plans)
    # Persistent plans that pack as the baseline does (index_select + mask):
    # the persistence gain apart from K1.
    for cfg in configs:
        mesh = VirtualMesh((cfg["p"],), ("x",))
        for variant in ("fence", "lock"):
            plan = alltoallv_init(cfg["counts"], (FEATURE,), "float32", mesh,
                                  axis="x", variant=variant, pack_impl="jnp",
                                  cache=PlanCache())
            label = f"{cfg['name']}:{variant}xjnp" + (
                "xring" if variant == "lock" else "")
            check_against_oracle(label, plan.wait(plan.start(cfg["x"])), cfg)
            timed[label] = (plan, cfg)
    out = {}
    for label, (plan, cfg) in timed.items():
        x = cfg["x"]
        out[label] = {
            "device_ms": median_ms(lambda: plan.start(x)),
            "epoch_ms": median_host_ms(lambda: plan.wait(plan.start(x))),
            "enqueue_ms": median_enqueue_ms(lambda: plan.start(x)),
            "design_bound_ms": bound_ms(design_bytes(plan)),
            "payload_bound_ms": bound_ms(payload_bytes(plan)),
        }
    for cfg in configs:
        p = cfg["p"]
        cnts = torch.tensor(cfg["counts"].reshape(-1), dtype=torch.int32,
                            device=device)
        fence_plan = plans[f"{cfg['name']}:fencexpallas"][0]
        for variant in ("fence", "lock"):
            exe = make_nonpersistent(
                VirtualMesh((p,), ("x",)), axis="x", p=p,
                capacity=fence_plan.capacity, send_rows=cfg["send_rows"],
                recv_rows=cfg["recv_rows"], feature_shape=(FEATURE,),
                dtype=torch.float32, variant=variant)
            got = exe(cfg["x"], cnts)
            check_against_oracle(f"{cfg['name']}:baseline {variant}", got, cfg)

            def call_and_wait():
                exe(cfg["x"], cnts)
                torch.cuda.synchronize()

            out[f"{cfg['name']}:baseline_{variant}"] = {
                "device_ms": median_ms(lambda: exe(cfg["x"], cnts)),
                "epoch_ms": median_host_ms(call_and_wait),
                "enqueue_ms": median_enqueue_ms(lambda: exe(cfg["x"], cnts)),
                "payload_bound_ms": bound_ms(payload_bytes(fence_plan)),
            }
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA device only", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.kernels import _build
    from repro_torch.testing.patterns import hugetrace_like_counts

    device = torch.device("cuda", torch.cuda.current_device())
    gpu = gpu_line()
    print(gpu, flush=True)
    emit({"gpu": gpu, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    per_source = _build.build()
    for k in _build.KERNELS.values():
        k._load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": per_source})

    emit({"phase": "kernels_vs_plain", "cases": check_kernels(device),
          "tolerance": "bytes equal"})

    configs = [
        make_config("A", np.full((8, 8), 1024, np.int64), device),
        make_config("B", hugetrace_like_counts(64, 64), device),
    ]
    plans, per_epoch, launches = run_main_path(configs, device)
    emit({"phase": "main_path", "launches": launches,
          "launches_per_epoch": per_epoch, "oracle": "valid rows bit-equal"})
    emit({"phase": "kernels_vs_plain_main_shapes",
          "cases": sum(check_at_main_shapes(c, plans, device) for c in configs),
          "tolerance": "bytes equal"})

    kernels, enqueue_ms = time_kernels(
        configs[0], plans["A:fencexpallas"][0], plans["A:lockxpallasxring"][0],
        device)
    for row in kernels:
        row["launches"] = launches[row["name"]]
    emit({"phase": "kernel_times_A", "gpu": gpu, "enqueue_ms": enqueue_ms})
    emit({"phase": "epoch_times", "gpu": gpu,
          "epochs": time_epochs(plans, configs, device)})

    print(gpu_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
