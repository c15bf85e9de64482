"""Serving launcher of the port: batched generation with KV caches.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
        --mesh 1,8 --batch 4 --prompt-len 128 --tokens 16

serves on the CUDA device (the default ``--device cuda``); ``--reduced
--device cpu`` runs the reduced configuration on the CPU, every kernel
taking its plain version.  ``--trace PATH`` writes a Chrome trace of the
INIT and prefill/decode spans at exit, ``--metrics-port`` serves the
Prometheus metrics while the process runs and ``--metrics-file`` writes a
snapshot of them at exit (``repro_torch.obs``).  ``--plan-store DIR_OR_URL``
sets the process's plan store (``repro_torch.planstore``): run twice
against one store, the second process's MoE dispatch INITs are warm, and
the INIT counters are printed at the end.  For the audio family (Whisper)
it makes ``--prompt-len`` stub frames (normal x 0.02, float32) and keeps 8
prompt tokens, as the JAX launcher does.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--tokens", type=int, default=16)
    p.add_argument("--max-seq", type=int, default=None)
    p.add_argument("--mesh", default="1,1")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="device of the virtual mesh: cuda (default) or cpu")
    p.add_argument("--plan-store", default=None, metavar="DIR_OR_URL",
                   help="persistent plan store, set as the process default "
                        "(repro_torch.planstore.configure): a directory, "
                        "fsremote://PATH, or tiered:local=DIR,remote=URL; "
                        "the MoE EP dispatch plans reuse the artifacts of "
                        "earlier serving processes on the same device kind")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="enable span tracing (repro_torch.obs) and export a "
                        "Chrome-trace JSON to PATH at exit — INIT spans plus "
                        "prefill/decode EXECUTE spans")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve Prometheus metrics on 127.0.0.1:PORT for the "
                        "lifetime of the process (repro_torch.obs."
                        "MetricsServer); 0 picks a free port")
    p.add_argument("--metrics-file", default=None, metavar="PATH",
                   help="write a Prometheus text-format metrics snapshot "
                        "to PATH at exit")
    args = p.parse_args(argv)

    import numpy as np

    from repro_torch.obs import TRACER, MetricsServer, write_metrics, write_trace

    from repro_torch.configs import get, get_reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import ServeEngine

    if args.trace:
        TRACER.enable()
    metrics_server = None
    if args.metrics_port is not None:
        metrics_server = MetricsServer(args.metrics_port).start()
        print(f"metrics: http://127.0.0.1:{metrics_server.port}/metrics")

    cfg = get_reduced(args.arch) if args.reduced else get(args.arch)
    dims = tuple(int(d) for d in args.mesh.split(","))
    axes = ("pod", "data", "model")[-len(dims):]
    mesh = make_mesh(dims, axes, device=args.device)
    max_seq = args.max_seq or (args.prompt_len + args.tokens + 8)

    try:
        eng = ServeEngine(cfg, mesh, batch=args.batch,
                          prompt_len=args.prompt_len, max_seq=max_seq,
                          seed=args.seed, plan_store=args.plan_store)
        rng = np.random.default_rng(args.seed)
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.batch, args.prompt_len)).astype(np.int32)
        frames = None
        if cfg.family == "audio":
            # the JAX launcher's stub: prompt-len frames, 8 prompt tokens
            frames = rng.standard_normal(
                (args.batch, args.prompt_len, cfg.d_model)).astype(np.float32) * 0.02
            prompts = prompts[:, :8]
        toks, stats = eng.generate(prompts, args.tokens, frames=frames)
        print(f"generated {toks.shape} on {mesh.device}: prefill "
              f"{stats.prefill_seconds*1e3:.1f} ms, decode "
              f"{stats.decode_seconds_per_token*1e3:.2f} ms/token")
        print(toks[:2])
        if args.plan_store:
            from repro_torch.core import init_stats
            print("plan-store init stats:", init_stats())
        if args.trace:
            trace = write_trace(args.trace)
            print(f"trace: {len(trace['traceEvents'])} events -> {args.trace}")
        if args.metrics_file:
            text = write_metrics(args.metrics_file)
            print(f"metrics: {len(text.splitlines())} lines -> "
                  f"{args.metrics_file}")
    finally:
        if metrics_server is not None:
            metrics_server.stop()
        if args.trace:
            TRACER.reset()
    return stats


if __name__ == "__main__":
    main()
