"""Unified observability: span tracing, metrics exposition, break-even checks
(port of ``repro.obs``).

The subsystem that makes the paper's amortization argument *visible in a
live run* instead of only in offline benchmark sweeps:

- ``spans``           process-global ``TRACER`` — ring-buffered spans and
                      instants covering INIT (bakes, autotune bursts,
                      store ops), EXECUTE (epochs, steps, prefill/decode)
                      and runtime events (swaps, chaos, resharding)
- ``trace_export``    Chrome-trace/Perfetto JSON + JSONL exporters and the
                      structural validator (``chip_smoke.py``'s ``obs_path``
                      runs it on the card)
- ``metrics``         Prometheus text exposition (+ ``MetricsServer`` for
                      ``--metrics-port``) over INIT counters, epoch rings,
                      swap log and break-even residuals
- ``breakeven_check`` stored Eq. 1-3 fits vs observed steady-state epochs
                      (``breakeven_residual``)

CLI: ``python -m repro_torch.obs {report,trace,metrics}``.
"""

from .spans import TRACER, SpanBuffer, Tracer      # noqa: I001 — dependency-free, first
from .breakeven_check import breakeven_residual, check_breakeven
from .metrics import MetricsServer, render_metrics, write_metrics
from .trace_export import (TraceValidationError, chrome_trace, validate_trace,
                           write_jsonl, write_trace)

__all__ = [
    "TRACER",
    "Tracer",
    "SpanBuffer",
    "chrome_trace",
    "write_trace",
    "write_jsonl",
    "validate_trace",
    "TraceValidationError",
    "render_metrics",
    "write_metrics",
    "MetricsServer",
    "breakeven_residual",
    "check_breakeven",
]
