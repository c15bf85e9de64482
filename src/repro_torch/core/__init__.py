"""Persistent plan-backed collectives for PyTorch on an NVIDIA H100 (the
port of ``repro.core``: the alltoallv, allgatherv and reduce-scatter
families; fence, lock, the leader-combined hierarchy and the ragged
variant; wire codecs).

Public surface:
    exchange_init / ExchangePlan.start / .wait / .free     persistent path
    alltoallv_init / allgatherv_init / reduce_scatter_init per-collective INIT
    ExchangePlan.embed                                     epoch body for a host program
    baseline.make_nonpersistent                            MPI_Alltoallv stand-in
    reference.alltoallv_global / patterns.get(...).reference  numpy oracles
"""

from .api import (allgatherv_init, alltoallv_init, exchange_init,
                  global_plan_cache, init_stats, reduce_scatter_init,
                  reset_global_plan_cache, reset_init_stats)
from ._init_stats import INIT_STATS
from .plan import (AlltoallvPlan, AlltoallvSpec, ExchangePlan, ExchangeSpec,
                   PlanCache, VARIANTS, WarmStartError)
from .window import Window, WindowCache
from . import baseline, metadata, patterns, reference, variants

__all__ = [
    "exchange_init", "alltoallv_init", "allgatherv_init",
    "reduce_scatter_init", "global_plan_cache",
    "reset_global_plan_cache", "init_stats", "reset_init_stats", "INIT_STATS",
    "AlltoallvPlan", "AlltoallvSpec", "ExchangePlan", "ExchangeSpec",
    "PlanCache", "VARIANTS", "WarmStartError", "Window", "WindowCache",
    "baseline", "metadata", "patterns", "reference", "variants",
]
