"""CLI for the observability layer (port of ``repro.obs.__main__``).

    python -m repro_torch.obs report [--trace PATH] [--json]
    python -m repro_torch.obs trace PATH [--validate] [--expect CAT ...] [--json]
    python -m repro_torch.obs metrics [--out PATH]

``report`` summarizes either a captured trace file (span counts and total
time by category — where a run's time went) or, with no arguments, this
process's live registries (mostly useful from a REPL).  ``trace
--validate`` is the trace contract: exits non-zero if the Chrome-trace JSON
is malformed, spans fail to nest, a warm INIT contains bake/burst
children, or an ``--expect``-ed category is absent.  ``metrics`` renders
the Prometheus exposition.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_report(args) -> int:
    if args.trace:
        with open(args.trace) as f:
            obj = json.load(f)
        by_cat: dict[str, dict] = {}
        for ev in obj.get("traceEvents", []):
            if ev.get("ph") not in ("X", "i"):
                continue
            c = by_cat.setdefault(ev.get("cat", "?"),
                                  {"spans": 0, "total_ms": 0.0})
            c["spans"] += 1
            c["total_ms"] += ev.get("dur", 0.0) / 1e3
        if args.json:
            print(json.dumps(by_cat, indent=2, sort_keys=True))
        else:
            print(f"{'category':<16} {'spans':>7} {'total_ms':>12}")
            for cat in sorted(by_cat):
                c = by_cat[cat]
                print(f"{cat:<16} {c['spans']:>7} {c['total_ms']:>12.3f}")
        return 0

    from ..core._exec_stats import EXEC_TELEMETRY
    from ..core._init_stats import INIT_STATS
    from .breakeven_check import check_breakeven
    rep = {"init": INIT_STATS.as_dict(),
           "exec": EXEC_TELEMETRY.summary(),
           "breakeven": check_breakeven()}
    if args.json:
        print(json.dumps(rep, indent=2, sort_keys=True, default=str))
    else:
        print("INIT counters:")
        for k, v in rep["init"].items():
            print(f"  {k:<18} {v}")
        print(f"plans with epochs: {len(rep['exec']['plans'])}, "
              f"swaps: {len(rep['exec']['swaps'])}")
        for r in rep["breakeven"]:
            print(f"  breakeven[{r['digest'][:12]}] residual="
                  f"{r['residual']:+.3f} over {r['epochs']} epochs")
    return 0


def _cmd_trace(args) -> int:
    from .trace_export import TraceValidationError, validate_trace
    try:
        summary = validate_trace(args.path, expect_cats=tuple(args.expect))
    except (TraceValidationError, OSError) as e:
        print(f"TRACE INVALID: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        cats = ", ".join(f"{c}={n}" for c, n in sorted(summary["by_cat"].items()))
        print(f"TRACE OK: {summary['events']} events across "
              f"{summary['threads']} thread(s) [{cats}] "
              f"warm_inits={summary['warm_inits']} "
              f"cold_inits={summary['cold_inits']}")
    return 0


def _cmd_metrics(args) -> int:
    from .metrics import render_metrics, write_metrics
    if args.out:
        write_metrics(args.out)
        print(f"wrote {args.out}")
    else:
        sys.stdout.write(render_metrics())
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("report", help="summarize a trace file or live registries")
    pr.add_argument("--trace", default=None, help="Chrome-trace JSON to summarize")
    pr.add_argument("--json", action="store_true")
    pr.set_defaults(fn=_cmd_report)

    pt = sub.add_parser("trace", help="validate an exported Chrome-trace file")
    pt.add_argument("path", help="Chrome-trace JSON file")
    pt.add_argument("--validate", action="store_true",
                    help="(default behavior; kept for explicitness)")
    pt.add_argument("--expect", action="append", default=[],
                    metavar="CAT", help="require >=1 span in this category")
    pt.add_argument("--json", action="store_true")
    pt.set_defaults(fn=_cmd_trace)

    pm = sub.add_parser("metrics", help="render Prometheus text exposition")
    pm.add_argument("--out", default=None, help="write to file instead of stdout")
    pm.set_defaults(fn=_cmd_metrics)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
