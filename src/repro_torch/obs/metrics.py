"""Prometheus text exposition over the repo's counters, rings, and fits (port
of ``repro.obs.metrics``: the same metric names, so one scrape configuration
reads both packages).

One render path serves three consumers: ``render_metrics()`` builds the
exposition-format text from ``INIT_STATS`` (warm/cold INIT counters, bake
and burst totals, store hit ratio), ``EXEC_TELEMETRY`` (per-digest epoch
latency summaries with p50/p95/p99, swap counter), and the break-even
validator (``repro_breakeven_residual`` per stored fit — the live check
that a plan's predicted amortization actually materializes).
``write_metrics(path)`` snapshots it to a file (the ``--metrics-file``
flag on the launchers); ``MetricsServer`` serves it over HTTP on a daemon
thread (the ``--metrics-port`` flag on ``repro_torch.launch.serve``) so a scraper
sees the engine's live state without touching the decode loop.

Everything here *reads* snapshots — rendering never blocks or mutates the
hot path.
"""

from __future__ import annotations

import http.server
import threading

from ..core._exec_stats import EXEC_TELEMETRY
from ..core._init_stats import INIT_STATS
from .breakeven_check import check_breakeven


def _line(out: list[str], name: str, value, labels: dict | None = None) -> None:
    if labels:
        lab = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        out.append(f"{name}{{{lab}}} {value}")
    else:
        out.append(f"{name} {value}")


def render_metrics(exec_snapshot: dict | None = None,
                   init_snapshot: dict | None = None) -> str:
    """Build the full Prometheus text exposition.  Pass explicit snapshots
    to render saved state (the CLI's ``metrics --from-json`` path); by
    default reads the live process-global registries."""
    init = init_snapshot if init_snapshot is not None else INIT_STATS.as_dict()
    ex = exec_snapshot if exec_snapshot is not None else EXEC_TELEMETRY.snapshot()
    out: list[str] = []

    out.append("# HELP repro_init_total Plan INITs by kind (cold=baked on host, warm=store artifact).")
    out.append("# TYPE repro_init_total counter")
    _line(out, "repro_init_total", init["cold_inits"], {"kind": "cold"})
    _line(out, "repro_init_total", init["warm_inits"], {"kind": "warm"})

    out.append("# HELP repro_table_bakes_total Host-side index/schedule table bakes.")
    out.append("# TYPE repro_table_bakes_total counter")
    _line(out, "repro_table_bakes_total", init["table_bakes"])

    out.append("# HELP repro_autotune_sweeps_total variant=auto measurement sweeps.")
    out.append("# TYPE repro_autotune_sweeps_total counter")
    _line(out, "repro_autotune_sweeps_total", init["autotune_sweeps"])

    out.append("# HELP repro_autotune_bursts_total Timing bursts executed across all sweeps.")
    out.append("# TYPE repro_autotune_bursts_total counter")
    _line(out, "repro_autotune_bursts_total", init["autotune_bursts"])

    out.append("# HELP repro_store_requests_total Plan-store operations by result.")
    out.append("# TYPE repro_store_requests_total counter")
    for result, field in (("hit", "store_hits"), ("miss", "store_misses"),
                          ("put", "store_puts"), ("invalid", "store_invalid")):
        _line(out, "repro_store_requests_total", init[field], {"result": result})

    lookups = init["store_hits"] + init["store_misses"] + init["store_invalid"]
    ratio = init["store_hits"] / lookups if lookups else 0.0
    out.append("# HELP repro_store_hit_ratio Store hits over lookups (hit+miss+invalid).")
    out.append("# TYPE repro_store_hit_ratio gauge")
    _line(out, "repro_store_hit_ratio", f"{ratio:.6f}")

    out.append("# HELP repro_plan_swaps_total Plan hot-swaps installed by the re-plan manager.")
    out.append("# TYPE repro_plan_swaps_total counter")
    _line(out, "repro_plan_swaps_total", len(ex.get("swaps", [])))

    rebakes = sum(1 for s in ex.get("swaps", [])
                  if isinstance(s.get("reason"), dict)
                  and s["reason"].get("kind") == "leader_rebake")
    out.append("# HELP repro_leader_rebakes_total Hot-swaps installed by a leader re-election (ladder rung 0).")
    out.append("# TYPE repro_leader_rebakes_total counter")
    _line(out, "repro_leader_rebakes_total", rebakes)

    out.append("# HELP repro_epoch_seconds Per-plan epoch wall time over the retained ring window.")
    out.append("# TYPE repro_epoch_seconds summary")
    for digest, s in sorted(ex.get("plans", {}).items()):
        if not s.get("count"):
            continue
        lab = {"digest": digest}
        for q, key in (("0.5", "p50_s"), ("0.95", "p95_s"), ("0.99", "p99_s")):
            if key in s:
                _line(out, "repro_epoch_seconds",
                      f"{s[key]:.9f}", {**lab, "quantile": q})
        _line(out, "repro_epoch_seconds_count", s["count"], lab)
        _line(out, "repro_epoch_seconds_sum",
              f"{s['count'] * s['mean_s']:.9f}", lab)

    # Per-rank epoch times, where the per-rank signal is being fed
    # (rank_rings keyed (digest, rank) — the skew-attribution input).
    ranks = ex.get("ranks", {})
    if ranks:
        out.append("# HELP repro_epoch_rank_seconds Per-rank epoch wall time (p50 of retained window).")
        out.append("# TYPE repro_epoch_rank_seconds gauge")
        for (digest, rank), s in sorted(ranks.items()):
            if s.get("count"):
                _line(out, "repro_epoch_rank_seconds", f"{s['p50_s']:.9f}",
                      {"digest": digest, "rank": rank})

    residuals = check_breakeven(ex)
    if residuals:
        out.append("# HELP repro_breakeven_residual Relative error of observed steady epoch time vs the Eq.1-3 fit stored with the plan ((obs-pred)/pred).")
        out.append("# TYPE repro_breakeven_residual gauge")
        for r in residuals:
            _line(out, "repro_breakeven_residual",
                  f"{r['residual']:.6f}", {"digest": r["digest"]})
        out.append("# HELP repro_breakeven_n_amortize Predicted epochs to amortize INIT, from the stored fit.")
        out.append("# TYPE repro_breakeven_n_amortize gauge")
        for r in residuals:
            if r.get("n_amortize") is not None:
                _line(out, "repro_breakeven_n_amortize",
                      r["n_amortize"], {"digest": r["digest"]})

    return "\n".join(out) + "\n"


def write_metrics(path: str, **kw) -> str:
    """Write the exposition to ``path``; returns the rendered text."""
    import os
    text = render_metrics(**kw)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return text


class _Handler(http.server.BaseHTTPRequestHandler):
    def do_GET(self):     # noqa: N802 (stdlib API name)
        if self.path.rstrip("/") not in ("", "/metrics"):
            self.send_response(404)
            self.end_headers()
            return
        body = render_metrics().encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):     # silence per-request stderr noise
        pass


class MetricsServer:
    """Minimal scrape endpoint on a daemon thread (stdlib only — the
    container has no prometheus_client and must not grow one)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="repro-metrics", daemon=True)

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
