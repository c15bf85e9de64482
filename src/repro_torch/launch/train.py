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
checkpoints, and a resume on another mesh reshards and prewarms those
plans for the new geometry first (``runtime.replan.reshard_plans``).
``--chaos SPEC`` injects seeded faults (``runtime.chaos``), ``--replan``
arms the skew monitor, ``--replan-at STEP`` forces one re-plan, and
``--assert-recovery`` checks that every injected fault was recovered.
"""

from __future__ import annotations

import argparse
import logging


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
                        "also need --codec-tol (gradients as under jax.grad: "
                        "int8 gives the expert weights none)")
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
                   help="elastic-mesh resume: capture this run's INIT "
                        "requests into <ckpt-dir>/init_requests.json; when "
                        "a prior capture exists and its mesh differs from "
                        "--mesh, reshard and prewarm those plans for the new "
                        "geometry (runtime.replan.reshard_plans) before the "
                        "bundle is built, so the resumed run rebuilds warm")
    p.add_argument("--replan-at", type=int, default=None, metavar="STEP",
                   help="force one online re-plan of the EP dispatch "
                        "decision after STEP completes (re-measure in a "
                        "sandbox, hot-swap on a changed verdict)")
    p.add_argument("--replan", action="store_true",
                   help="arm the skew monitor: sustained per-step skew "
                        "attributable to the EP dispatch plan triggers an "
                        "online re-plan (a leader re-bake first for the "
                        "hierarchy)")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="deterministic fault injection for the run "
                        "(runtime.chaos.ChaosInjector.parse), e.g. "
                        "'seed=7,fail_step=5,stall_steps=3-4,"
                        "stall_seconds=0.1'")
    p.add_argument("--assert-recovery", action="store_true",
                   help="exit 4 unless the run completed all steps and "
                        "every injected --chaos fault was recovered (and, "
                        "with --replan-at, the forced re-plan ran)")
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

    # Elastic resume: before building anything, check whether a prior run
    # of this checkpoint dir captured INIT requests on a DIFFERENT mesh;
    # if so, project those plans onto today's geometry and prewarm the
    # store, then reset the INIT stats so --assert-warm-init judges only
    # the bundle build that follows (the reshard replay is one-time INIT
    # work by design, like a deploy-time prewarm).
    req_path = (os.path.join(args.ckpt_dir, "init_requests.json")
                if args.elastic and args.ckpt_dir else None)
    if args.elastic and req_path is None:
        raise SystemExit("--elastic requires --ckpt-dir")
    if req_path and os.path.exists(req_path):
        from repro_torch.ckpt.reshard import mesh_axis_sizes
        from repro_torch.runtime import replan as replan_mod
        with open(req_path) as fh:
            prior = json.load(fh)
        if prior.get("mesh") != mesh_axis_sizes(mesh) and prior.get("requests"):
            from repro_torch import planstore
            from repro_torch.core import reset_init_stats
            report = replan_mod.reshard_plans(
                prior["requests"], mesh, store=planstore.default_store())
            print(f"elastic resume: mesh {prior['mesh']} -> "
                  f"{mesh_axis_sizes(mesh)}; resharded "
                  f"{len(report['resharded'])} plan(s), skipped "
                  f"{len(report['skipped'])}:", report)
            reset_init_stats()

    chaos = None
    if args.chaos:
        from repro_torch.runtime.chaos import ChaosInjector
        chaos = ChaosInjector.parse(args.chaos)

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
        ckpt_every=args.ckpt_every, log_every=args.log_every,
        replan=args.replan, replan_at=args.replan_at), chaos=chaos)
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
    if args.assert_recovery:
        injected = sum((result.get("chaos") or {}).values())
        problems = []
        if result["final_step"] != args.steps:
            problems.append(f"run stopped at step {result['final_step']}"
                            f"/{args.steps}")
        if injected == 0:
            problems.append("no chaos faults were injected (nothing to "
                            "recover from: the assertion would be vacuous)")
        faults = sum((result.get("chaos") or {}).get(k, 0)
                     for k in ("step", "device", "window"))
        if faults and len(result["recoveries"]) < faults:
            problems.append(f"{faults} injected failure(s) but only "
                            f"{len(result['recoveries'])} recoveries")
        if args.replan_at is not None and not result["replans"]:
            problems.append("forced re-plan never ran")
        if problems:
            print("ASSERT-RECOVERY FAILED:", "; ".join(problems))
            raise SystemExit(4)
        print(f"ASSERT-RECOVERY OK: {injected} fault(s) injected, "
              f"{len(result['recoveries'])} recovered, "
              f"{len(result['replans'])} re-plan(s)")
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
