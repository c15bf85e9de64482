"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --mesh 1,8 --steps 20 --ckpt-dir CKPT

trains on the CUDA device (the default ``--device cuda``, which raises
where there is none); ``--reduced --device cpu`` runs the reduced
configuration on the CPU, every kernel taking its plain version.  The
flags are the JAX launcher's (``repro.launch.train``).  ``--plan-store``
sets the process's plan store: run twice against one store, the second
process's MoE dispatch INITs are warm, which ``--assert-warm-init``
checks.  ``--elastic`` captures the run's INIT requests next to the
checkpoints; resuming them on another mesh, ``--chaos``,
``--assert-recovery``, ``--replan`` and ``--replan-at`` raise
``NotImplementedError`` (ROADMAP.md item 18).
"""

from __future__ import annotations

import argparse
import logging

_RESILIENCE = "item 18, resilience"


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", default="train_4k")
    p.add_argument("--reduced", action="store_true",
                   help="smoke-scale config (CPU-runnable)")
    p.add_argument("--device", default="cuda",
                   help="device of the virtual mesh: cuda (default) or cpu")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--global-batch", type=int, default=None)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--mesh", default="1,1",
                   help="data,model (2 dims) or pod,data,model (3)")
    p.add_argument("--dispatch", default=None,
                   choices=["persistent_a2a", "nonpersistent_a2a", "gspmd"])
    p.add_argument("--a2a-variant", default=None,
                   choices=["fence", "lock", "fence_hierarchy", "auto"])
    p.add_argument("--overlap-chunks", type=int, default=None,
                   help="chunked dispatch->FFN->combine depth for the MoE EP "
                        "dispatch (1 = no overlap)")
    p.add_argument("--wire-codec", default=None,
                   choices=["identity", "bf16", "int8", "fp8"],
                   help="wire codec of the MoE EP exchange; lossy codecs "
                        "also need --codec-tol (their backward is not ported: "
                        "ROADMAP.md item 16a)")
    p.add_argument("--codec-tol", type=float, default=None,
                   help="declared relative error tolerance of a lossy wire "
                        "codec")
    p.add_argument("--grad-compression", action="store_true",
                   help="int8 + error-feedback data-parallel gradient sync; "
                        "the residual rides in the optimizer state")
    p.add_argument("--grad-sync", default="default",
                   choices=["default", "persistent_rs"],
                   help="'persistent_rs': the gradient sync rides a "
                        "persistent reduce-scatter + allgatherv plan pair "
                        "(train.grad.persistent_rs_sync)")
    p.add_argument("--rules", default="default",
                   choices=["default", "long_context", "decode", "pure_dp",
                            "hier_ep"],
                   help="sharding-rule launch profile "
                        "(parallel.sharding.RULE_PROFILES)")
    p.add_argument("--schedule", default=None,
                   choices=["cosine", "linear", "wsd", "constant"])
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--no-zero1", action="store_true")
    p.add_argument("--micro", type=int, default=1)
    p.add_argument("--plan-store", default=None, metavar="DIR_OR_URL",
                   help="persistent plan store, set as the process default "
                        "(repro_torch.planstore.configure): a directory, "
                        "fsremote://PATH, or tiered:local=DIR,remote=URL")
    p.add_argument("--assert-warm-init", action="store_true",
                   help="exit 3 unless every INIT of this run was warm: zero "
                        "autotune bursts, zero table bakes, at least one "
                        "store hit")
    p.add_argument("--elastic", action="store_true",
                   help="capture this run's INIT requests into "
                        "<ckpt-dir>/init_requests.json; a prior capture on "
                        "another mesh raises (item 18)")
    p.add_argument("--replan-at", type=int, default=None, metavar="STEP",
                   help="not ported (item 18)")
    p.add_argument("--replan", action="store_true",
                   help="not ported (item 18)")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="not ported (item 18)")
    p.add_argument("--assert-recovery", action="store_true",
                   help="not ported (item 18)")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="enable span tracing (repro_torch.obs) and export a "
                        "Chrome-trace JSON to PATH at exit")
    p.add_argument("--trace-jsonl", default=None, metavar="PATH",
                   help="also write the raw span records as JSONL to PATH "
                        "(implies tracing)")
    p.add_argument("--metrics-file", default=None, metavar="PATH",
                   help="write a Prometheus text-format metrics snapshot to "
                        "PATH at exit")
    args = p.parse_args(argv)

    from repro_torch.core.plan import not_ported
    if args.chaos or args.assert_recovery:
        raise not_ported("--chaos / --assert-recovery (fault injection)",
                         _RESILIENCE)
    if args.replan or args.replan_at is not None:
        raise not_ported("--replan / --replan-at (online re-planning)",
                         _RESILIENCE)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from repro_torch.obs import TRACER
    if args.trace or args.trace_jsonl:
        TRACER.enable()

    if args.plan_store:
        from repro_torch import planstore
        planstore.configure(args.plan_store)

    import dataclasses
    import json
    import os

    from repro_torch.configs import SHAPES, ShapeConfig, get, get_reduced
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import RULE_PROFILES
    from repro_torch.train import ScheduleConfig, Trainer, TrainerConfig

    cfg = get_reduced(args.arch) if args.reduced else get(args.arch)
    if (args.dispatch or args.a2a_variant or args.overlap_chunks
            or args.wire_codec or args.codec_tol is not None):
        assert cfg.moe is not None, f"{cfg.name} has no MoE layers"
        moe = dataclasses.replace(
            cfg.moe,
            dispatch=args.dispatch or cfg.moe.dispatch,
            a2a_variant=args.a2a_variant or cfg.moe.a2a_variant,
            overlap_chunks=args.overlap_chunks or cfg.moe.overlap_chunks,
            wire_codec=args.wire_codec or cfg.moe.wire_codec,
            codec_tol=(args.codec_tol if args.codec_tol is not None
                       else cfg.moe.codec_tol))
        cfg = dataclasses.replace(cfg, moe=moe)

    base_shape = SHAPES[args.shape]
    seq = args.seq_len or (256 if args.reduced else base_shape.seq_len)
    gb = args.global_batch or (8 if args.reduced else base_shape.global_batch)
    shape = ShapeConfig(args.shape, base_shape.kind, seq, gb)

    dims = tuple(int(d) for d in args.mesh.split(","))
    axes = ("pod", "data", "model")[-len(dims):]
    mesh = make_mesh(dims, axes, device=args.device)

    sched_kind = args.schedule or ("wsd" if cfg.name.startswith("minicpm")
                                   else "cosine")
    sched = ScheduleConfig(kind=sched_kind, peak_lr=args.lr,
                           warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps,
                           decay_steps=max(args.steps // 5, 1))

    req_path = (os.path.join(args.ckpt_dir, "init_requests.json")
                if args.elastic and args.ckpt_dir else None)
    if args.elastic and req_path is None:
        raise SystemExit("--elastic requires --ckpt-dir")
    if req_path and os.path.exists(req_path):
        from repro_torch.ckpt.reshard import mesh_axis_sizes
        with open(req_path) as fh:
            prior = json.load(fh)
        if prior.get("mesh") != mesh_axis_sizes(mesh) and prior.get("requests"):
            raise not_ported(
                f"an elastic resume from mesh {prior['mesh']} onto "
                f"{mesh_axis_sizes(mesh)} (runtime.replan.reshard_plans)",
                _RESILIENCE)

    def build_bundle():
        return steps_mod.make_train_bundle(
            cfg, shape, mesh, sched=sched, zero1=not args.no_zero1,
            n_micro=args.micro, rules=RULE_PROFILES[args.rules],
            grad_compression=args.grad_compression,
            grad_sync=args.grad_sync)

    if args.elastic:
        from repro_torch.ckpt.reshard import mesh_axis_sizes
        from repro_torch.core import capture_init_requests
        with capture_init_requests() as reqs:
            bundle = build_bundle()
        os.makedirs(args.ckpt_dir, exist_ok=True)
        with open(req_path, "w") as fh:
            json.dump({"mesh": mesh_axis_sizes(mesh),
                       "requests": list(reqs)}, fh)
        print(f"elastic: captured {len(reqs)} INIT request(s) -> {req_path}")
    else:
        bundle = build_bundle()
    trainer = Trainer(bundle, TrainerConfig(
        n_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, log_every=args.log_every))
    try:
        result = trainer.run()
    finally:
        trainer.close()
    print("train finished:", result)
    # Export observability artifacts before the assert gates: a failed
    # assertion is when the trace is most wanted.
    if args.trace:
        from repro_torch.obs import write_trace
        trace = write_trace(args.trace)
        print(f"trace: {len(trace['traceEvents'])} events -> {args.trace}")
    if args.trace_jsonl:
        from repro_torch.obs import write_jsonl
        n = write_jsonl(args.trace_jsonl)
        print(f"trace-jsonl: {n} events -> {args.trace_jsonl}")
    if args.metrics_file:
        from repro_torch.obs import write_metrics
        text = write_metrics(args.metrics_file)
        print(f"metrics: {len(text.splitlines())} lines -> {args.metrics_file}")
    if args.plan_store or args.assert_warm_init:
        from repro_torch.core import init_stats
        stats = init_stats()
        print("plan-store init stats:", stats)
        if args.assert_warm_init:
            cold = {k: stats[k] for k in ("autotune_bursts", "table_bakes")
                    if stats[k] != 0}
            if cold or stats["store_hits"] == 0:
                print("ASSERT-WARM-INIT FAILED:", stats)
                raise SystemExit(3)
            print("ASSERT-WARM-INIT OK: zero bursts, zero bakes, "
                  f"{stats['store_hits']} store hits")
    return result


if __name__ == "__main__":
    main()
