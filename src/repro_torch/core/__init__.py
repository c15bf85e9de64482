"""Persistent plan-backed collectives for PyTorch on an NVIDIA H100 (the
port of ``repro.core``: the alltoallv, allgatherv and reduce-scatter
families; fence, lock, the leader-combined hierarchy and the ragged
variant; wire codecs; ``variant="auto"``).

Public surface:
    exchange_init / ExchangePlan.start / .wait / .free     persistent path
    alltoallv_init / allgatherv_init / reduce_scatter_init per-collective INIT
    ExchangePlan.embed                                     epoch body for a host program
    baseline.make_nonpersistent                            MPI_Alltoallv stand-in
    breakeven                                              Eq. 1-3 model
    autotune                                               variant="auto"
    store= (repro_torch.planstore)                         cross-process warm start
    capture_init_requests                                  INIT records for prewarm
    EXEC_TELEMETRY                                         per-plan epoch rings
    reference.alltoallv_global / patterns.get(...).reference  numpy oracles
"""

from .api import (allgatherv_init, alltoallv_init, exchange_init,
                  global_plan_cache, init_stats, reduce_scatter_init,
                  reset_global_plan_cache, reset_init_stats)
from ._exec_stats import EXEC_TELEMETRY, EpochRing, ExecTelemetry
from ._init_stats import (INIT_STATS, capture_init_requests,
                          start_init_capture, stop_init_capture)
from .plan import (AlltoallvPlan, AlltoallvSpec, ExchangePlan, ExchangeSpec,
                   PlanCache, VARIANTS, WarmStartError)
from .window import Window, WindowCache
from . import (autotune, baseline, breakeven, metadata, patterns, reference,
               variants)

__all__ = [
    "exchange_init", "alltoallv_init", "allgatherv_init",
    "reduce_scatter_init", "global_plan_cache",
    "reset_global_plan_cache", "init_stats", "reset_init_stats", "INIT_STATS",
    "capture_init_requests", "start_init_capture", "stop_init_capture",
    "EXEC_TELEMETRY", "EpochRing", "ExecTelemetry",
    "AlltoallvPlan", "AlltoallvSpec", "ExchangePlan", "ExchangeSpec",
    "PlanCache", "VARIANTS", "WarmStartError", "Window", "WindowCache",
    "autotune", "baseline", "breakeven", "metadata", "patterns", "reference",
    "variants",
]
