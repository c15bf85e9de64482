"""Dry run: trace every (arch x shape) cell on the production meshes on the
``meta`` device, count its work and capture its plan INITs (port of
``repro.launch.dryrun``).

The JAX package lowers and compiles each cell's step on fake host devices
and reads XLA's cost and memory analyses and the optimized HLO.  Here the
mesh's virtual ranks live on the ``meta`` device: the bundle builds (its
plans INIT on the host, their tables baked as for a card), parameters,
optimizer state, batch and caches are drawn as ``meta`` tensors, and one
step runs under ``roofline.trace.StepCounter``.  Every kernel wrapper
takes its shape path on ``meta``, so nothing is computed and nothing is
allocated, and the counter reads the step's aten FLOPs and bytes, its
kernel calls with their work, its exchanges and its live storage.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --cell olmo-1b:train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --cell olmoe-1b-7b:train_4k --reduced --mesh-shape 2,4 \\
        --seq-len 64 --global-batch 8   # CI prewarm capture

Per cell, writes ``<out>/<arch>__<shape>__<mesh>.json`` with the JAX
record's keys where they apply: ``cost_analysis`` (FLOPs and bytes per
card: the counted totals over the mesh's ranks), the counted totals
themselves and per kernel (``counted``), ``collectives`` (per rank),
``roofline`` (``roofline.analyze`` against the H100's constants),
``n_micro`` and ``plan_inits``: every INIT request the cell's bundles
issued (``core.capture_init_requests``), which ``repro_torch.planstore
prewarm --from-dryrun`` replays to prewarm a fleet store.  The memory:

- ``memory_per_rank``: parameters and optimizer state per rank from the
  bundle's partition specs, decode caches divided by the batch ways, and
  the trace's activation high-water (its live storage above what was live
  at the start) divided by the batch ways;
- ``memory_one_card``: the trace's live high-water itself, the port's
  layout with every virtual rank on one device.

``n_micro`` is JAX's ladder (1, 4, 8 micro-batches for a train cell),
climbed while ``memory_per_rank`` exceeds ``HBM_BUDGET``.
``scan_correction`` is null: XLA counts a loop body once, which the JAX
dry run corrects from 1- and 2-period variants, but the port's Python
layer loop traces every layer, so there is nothing to correct.  The
collectives that GSPMD inserts for FSDP or tensor parallelism have no
counterpart on one card (``roofline.trace``).  Failures are collected and
the run exits nonzero listing them, as JAX's does.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch

from .._tree import leaves, tree_map
from ..roofline import hw

# Per-rank budget of the micro-batch ladder: the card less ~3 % headroom
# (the JAX dry run keeps 0.5 of a v5e's 16 GiB).
HBM_BUDGET = hw.HBM_BYTES - int(2.5 * 2**30)


def step_inputs(bundle, cfg, shape, device, seed: int = 0) -> tuple:
    """The arguments of one call of ``bundle``'s step on ``device``:
    ``meta`` tensors of the right shapes, or seeded draws on a real device
    (parameters as the trainer draws them, uniform tokens)."""
    from ..configs.base import torch_dtype
    from ..models import api as model_api
    from ..models import transformer, whisper
    from ..train import optimizer as opt_mod
    from .steps import whisper_self_len

    device = torch.device(device)
    meta = device.type == "meta"
    gen = torch.Generator("cpu" if meta else device).manual_seed(seed)
    cpu = torch.Generator("cpu").manual_seed(seed + 1)

    def tokens(*dims):
        if meta:
            return torch.empty(dims, dtype=torch.int32, device=device)
        return torch.randint(0, cfg.vocab_size, dims, generator=cpu,
                             dtype=torch.int32).to(device)

    def floats(*dims, dtype=torch.bfloat16):
        if meta:
            return torch.empty(dims, dtype=dtype, device=device)
        return torch.randn(dims, generator=cpu).to(device, dtype)

    params, _ = model_api.init_model(cfg, gen, device)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt_state = opt_mod.init_opt_state(
            params, bundle.meta["adamw"],
            grad_err=bundle.meta.get("grad_compression", False))
        spec = bundle.meta["batch_spec"]
        batch = {k: (tokens(*v.shape) if not v.dtype.is_floating_point
                     else floats(*v.shape, dtype=v.dtype))
                 for k, v in spec.items()}
        return params, opt_state, batch, 0
    if shape.kind == "prefill":
        if cfg.family == "audio":
            return params, floats(b, s, cfg.d_model), tokens(b, 8)
        if cfg.family == "vlm":
            return (params, floats(b, cfg.frontend_len, cfg.frontend_dim),
                    tokens(b, s - cfg.frontend_len))
        return params, tokens(b, s)
    cache_dtype = torch_dtype(cfg.param_dtype)
    if cfg.family == "audio":
        self_len = whisper_self_len(cfg)
        caches = whisper.init_dec_caches(cfg, b, self_len, s, cache_dtype,
                                         device=device)
        return params, caches, tokens(b, 1), self_len - 1
    caches = transformer.init_caches(cfg, b, s, cache_dtype, device=device)
    return params, caches, tokens(b, 1), s - 1


def trace_step(bundle, inputs, counter=None):
    """Run ``bundle``'s step once on ``inputs`` under ``counter`` (a new
    ``StepCounter`` by default), the inputs' storage counted as live from
    the start.  Returns the step's output and the counter."""
    from ..roofline.trace import StepCounter

    counter = counter if counter is not None else StepCounter()
    counter.hold(inputs)
    with counter:
        out = bundle(*inputs)
    return out, counter


def memory_per_rank(bundle, cfg, shape, inputs, counter) -> dict:
    """Bytes per rank: parameters and optimizer state by their partition
    specs, decode caches and the activation high-water by batch ways."""
    from ..models import api as model_api
    from ..parallel.sharding import axis_rules, batch_ways, resolve
    from .steps import shard_ways

    mesh = bundle.mesh
    params = inputs[0]

    def sharded(tree, specs) -> int:
        return int(sum(t.numel() * t.element_size() / shard_ways(sp, mesh)
                       for t, sp in zip(leaves(tree), leaves(specs))))

    if shape.kind == "train":
        param_sh = bundle.meta["param_shardings"]
    else:
        with axis_rules(bundle.rules, mesh):
            _, logical = model_api.init_model(cfg, torch.Generator("cpu"),
                                              device="meta")
            param_sh = tree_map(lambda axes, p: resolve(axes, tuple(p.shape)),
                                logical, params)
    ways = batch_ways(shape.global_batch, mesh)
    out = {"params": sharded(params, param_sh)}
    if shape.kind == "train":
        out["optimizer"] = sharded(inputs[1], bundle.meta["opt_shardings"])
    if shape.kind == "decode":
        out["caches"] = int(sum(t.numel() * t.element_size()
                                for t in leaves(inputs[1])) / ways)
    out["activations"] = int((counter.live_peak_bytes
                              - counter.live_start_bytes) / ways)
    out["total"] = sum(out.values())
    return out


def run_cell(cfg, shape, mesh, mesh_name, out_dir, perf_variant=None,
             bundle_kw=None) -> dict:
    """Trace one cell on ``mesh`` (a ``meta`` mesh for the dry run) and
    write its record; returns it."""
    from ..core import start_init_capture, stop_init_capture
    from ..planstore.prewarm import dedupe_requests
    from ..roofline import analyze as roofline_mod
    from . import steps as steps_mod

    bundle_kw = dict(bundle_kw or {})
    ladder = ([bundle_kw.pop("n_micro", 1), 4, 8] if shape.kind == "train"
              else [None])
    device = mesh.device
    chips = math.prod(mesh.shape.values())

    start_init_capture()
    try:
        for n_micro in ladder:
            kw = dict(bundle_kw)
            if n_micro is not None:
                kw["n_micro"] = n_micro
            t0 = time.perf_counter()
            bundle = steps_mod.make_bundle(cfg, shape, mesh, **kw)
            inputs = step_inputs(bundle, cfg, shape, device)
            t_bundle = time.perf_counter() - t0
            t0 = time.perf_counter()
            _, counter = trace_step(bundle, inputs)
            t_trace = time.perf_counter() - t0
            mem = memory_per_rank(bundle, cfg, shape, inputs, counter)
            if mem["total"] <= HBM_BUDGET or n_micro == ladder[-1]:
                break
            print(f"    [mem {mem['total'] / 2**30:.1f} GiB per rank > "
                  f"budget; retry n_micro={n_micro}->next]", flush=True)
            del bundle, inputs, counter
    finally:
        plan_inits = dedupe_requests(stop_init_capture())

    totals = counter.totals()
    cost = {"flops": totals["flops"] / chips,
            "bytes accessed": totals["bytes accessed"] / chips}
    stats = counter.stats()
    roof = roofline_mod.analyze(cfg, shape, mesh_name, chips, cost, stats,
                                peak_memory=mem["total"])
    record = {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "chips": chips, "kind": shape.kind, "n_micro": n_micro,
        "device": str(device),
        "seconds_bundle": round(t_bundle, 2),
        "seconds_trace": round(t_trace, 2),
        "memory_per_rank": mem,
        "memory_one_card": counter.live_peak_bytes,
        "cost_analysis": cost,
        "counted": {k: totals[k] for k in ("flops", "bytes accessed",
                                           "aten_flops", "aten_bytes",
                                           "kernels")},
        "scan_correction": None,
        "collectives": stats.to_json(),
        "roofline": roof.to_json(),
        "plan_inits": plan_inits,
    }
    if perf_variant:
        record["perf_variant"] = perf_variant
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{cfg.name}__{shape.name}__{mesh_name}"
        if perf_variant:
            tag += f"__{perf_variant}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(record, f, indent=1)
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    p.add_argument("--mesh-shape", default=None, metavar="D,D[,D]",
                   help="explicit mesh dims instead of the production "
                        "meshes, axes named like launch/train.py "
                        "((pod,)data,model), so a reduced cell's captured "
                        "plan_inits match a --mesh D,D train run exactly")
    p.add_argument("--cell", default="all",
                   help="all | comma list of arch:shape")
    p.add_argument("--reduced", action="store_true",
                   help="smoke-scale configs")
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--global-batch", type=int, default=None)
    p.add_argument("--out", default="experiments/dryrun-torch")
    p.add_argument("--list", action="store_true")
    args = p.parse_args(argv)

    from ..configs import SHAPES, ShapeConfig, cells, get, get_reduced
    from .mesh import make_mesh, make_production_mesh

    arch_of = get_reduced if args.reduced else get
    if args.cell == "all":
        todo = [(c, s) for c, s, _ in cells(include_skipped=False)]
        skipped = [(c, s, why) for c, s, why in cells(include_skipped=True)
                   if why]
        if args.reduced:
            todo = [(get_reduced(c.name), s) for c, s in todo]
    else:
        todo, skipped = [], []
        for spec in args.cell.split(","):
            a, s = spec.split(":")
            todo.append((arch_of(a), SHAPES[s]))
    if args.seq_len or args.global_batch or args.reduced:
        todo = [(c, ShapeConfig(s.name, s.kind,
                                args.seq_len or (256 if args.reduced else s.seq_len),
                                args.global_batch or (8 if args.reduced
                                                      else s.global_batch)))
                for c, s in todo]

    if args.list:
        for c, s in todo:
            print(f"{c.name}:{s.name}")
        return 0

    meshes = []
    if args.mesh_shape:
        dims = tuple(int(d) for d in args.mesh_shape.split(","))
        axes = ("pod", "data", "model")[-len(dims):]
        meshes.append((f"mesh{'x'.join(str(d) for d in dims)}",
                       make_mesh(dims, axes, device="meta")))
    else:
        if args.mesh in ("single", "both"):
            meshes.append(("pod256", make_production_mesh(
                multi_pod=False, device="meta")))
        if args.mesh in ("multi", "both"):
            meshes.append(("pods2x256", make_production_mesh(
                multi_pod=True, device="meta")))

    failures = []
    n_total = len(todo) * len(meshes)
    i = 0
    t_all = time.perf_counter()
    for mesh_name, mesh in meshes:
        for cfg, shape in todo:
            i += 1
            tag = f"{cfg.name}:{shape.name}:{mesh_name}"
            print(f"[{i}/{n_total}] {tag} ...", flush=True)
            try:
                rec = run_cell(cfg, shape, mesh, mesh_name, args.out)
                r = rec["roofline"]
                print(f"    ok  bundle={rec['seconds_bundle']}s "
                      f"trace={rec['seconds_trace']}s "
                      f"flops/chip={r['flops_per_chip']:.3e} "
                      f"mem/rank={rec['memory_per_rank']['total'] / 2**30:.2f}GiB "
                      f"n_micro={rec['n_micro']} "
                      f"dominant={r['dominant']}", flush=True)
            except Exception as e:  # noqa: BLE001 — collect all failures
                failures.append((tag, repr(e)))
                traceback.print_exc()

    for cfg, shape, reason in skipped:
        print(f"SKIP {cfg.name}:{shape.name} — {reason}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err[:200])
        return 1
    print(f"\nall {n_total} cells passed on {[m for m, _ in meshes]} in "
          f"{time.perf_counter() - t_all:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
