"""Perf hillclimb runner (port of ``repro.launch.perf_hillclimb``): traces
the three chosen cells under their optimization variants through the dry
run's ``run_cell`` on the single-pod production mesh on ``meta``, and
records the roofline terms beside the baseline sweep
(``experiments/dryrun-torch``).

Cells (the JAX package's choice):
  minicpm-2b:train_4k    the worst useful-compute ratio among the trains
  deepseek-67b:train_4k  the largest absolute collective term
  olmoe-1b-7b:train_4k   the paper-technique representative (MoE EP a2a)

    PYTHONPATH=src python -m repro_torch.launch.perf_hillclimb
"""

from __future__ import annotations

import dataclasses
import sys
import traceback


def main() -> int:
    from ..configs import SHAPES, get
    from ..parallel.sharding import PURE_DP_RULES
    from .dryrun import run_cell
    from .mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=False, device="meta")
    shape = SHAPES["train_4k"]
    out = "experiments/perf-torch"
    runs = []

    # --- cell 1: minicpm-2b — drop TP entirely (pure DP + FSDP) -----------
    cfg = get("minicpm-2b")
    runs.append(("minicpm-2b", "iter1_seqsp_rs", cfg, {}))
    runs.append(("minicpm-2b", "iter2_pure_dp", cfg,
                 {"rules": dict(PURE_DP_RULES), "fsdp_threshold_bytes": 0.0}))

    # --- cell 2: deepseek-67b — seq_sp reduce-scatter constraints ---------
    cfg = get("deepseek-67b")
    runs.append(("deepseek-67b", "iter1_seqsp_rs", cfg, {}))

    # --- cell 3: olmoe-1b-7b — EP a2a vs replicated-expert pure DP --------
    cfg = get("olmoe-1b-7b")
    runs.append(("olmoe-1b-7b", "iter1_seqsp_rs", cfg, {}))
    cfg_dp = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch="gspmd"))
    runs.append(("olmoe-1b-7b", "iter2_pure_dp_local_experts", cfg_dp,
                 {"rules": dict(PURE_DP_RULES), "fsdp_threshold_bytes": 0.0}))

    failed = 0
    for arch, variant, cfg, kw in runs:
        print(f"=== {arch} :: {variant} ===", flush=True)
        try:
            rec = run_cell(cfg, shape, mesh, "pod256", out,
                           perf_variant=variant, bundle_kw=kw)
            r = rec["roofline"]
            print(f"  compute={r['compute_s']:.3f}s memory={r['memory_s']:.3f}s "
                  f"collective={r['collective_s']:.3f}s dominant={r['dominant']} "
                  f"useful={r['useful_ratio']:.3f}", flush=True)
        except Exception as e:  # noqa: BLE001 — report every variant
            traceback.print_exc()
            print(f"  FAILED: {e}", flush=True)
            failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
