"""Persistent plan-backed alltoallv for PyTorch on an NVIDIA H100 (the port
of ``repro.core``; so far the alltoallv plan: fence, lock and the
leader-combined hierarchy).

Public surface:
    alltoallv_init / exchange_init / ExchangePlan.start / .wait / .free
    ExchangePlan.embed                                     epoch body for a host program
    baseline.make_nonpersistent                            MPI_Alltoallv stand-in
    reference.alltoallv_global                             numpy oracle
"""

from .api import (alltoallv_init, exchange_init, global_plan_cache, init_stats,
                  reset_global_plan_cache, reset_init_stats)
from ._init_stats import INIT_STATS
from .plan import (AlltoallvPlan, AlltoallvSpec, ExchangePlan, ExchangeSpec,
                   PlanCache, VARIANTS, WarmStartError)
from .window import Window, WindowCache
from . import baseline, metadata, reference, variants

__all__ = [
    "exchange_init", "alltoallv_init", "global_plan_cache",
    "reset_global_plan_cache", "init_stats", "reset_init_stats", "INIT_STATS",
    "AlltoallvPlan", "AlltoallvSpec", "ExchangePlan", "ExchangeSpec",
    "PlanCache", "VARIANTS", "WarmStartError", "Window", "WindowCache",
    "baseline", "metadata", "reference", "variants",
]
