"""Runtime resilience (port of ``repro.runtime``): the layer that keeps
persistent plans honest after INIT.

A plan is tuned once; the fleet degrades continuously.  This package
closes the loop from observation to recovery:

* ``straggler`` — step-level deadline tracking (``StragglerDetector``,
  EMA-based, feeds early checkpointing) and plan-level sustained-skew
  detection (``PlanSkewMonitor`` over the per-epoch telemetry rings of
  ``core._exec_stats``).
* ``leader`` — health-weighted leader election for the hierarchical
  exchange: per-rank slowdown factors from the telemetry rank rings
  (``rank_health``), per-role slab-carry weights from the pattern
  (``role_carry``), and the greedy assignment (``choose_leader_perm``)
  that demotes degraded ranks toward carry-free roles.
* ``replan`` — acts on the skew signal with a graceful-degradation
  ladder: a cheap leader re-bake first (hierarchy plans with a blamed
  rank), then the variant autotune in a background sandbox, then
  degrade-to-fence; every rung hot-swaps between epochs
  (``ReplanManager``), CAS-merges its verdict into the plan store so the
  fleet learns, and captured INIT requests project onto a shrunk/grown
  mesh for elastic resume (``reshard_plans``).
* ``fault`` — checkpoint-restart recovery (``run_with_recovery``), plan
  aware: device-loss-class failures rebuild plans before replay
  (``classify_failure``), and ``RetryPolicy`` decays its restart count
  after sustained progress.
* ``chaos`` — deterministic, seeded fault injection (window-allocation
  failures, store poisoning, epoch stalls, step/device faults, per-rank
  slowdowns) with per-kind counters; the test harness for everything
  above.
"""

from . import chaos, fault, leader, replan, straggler
from .chaos import ChaosError, ChaosInjector
from .fault import FaultError, RetryPolicy, classify_failure, run_with_recovery
from .leader import choose_leader_perm, permutation_cost, rank_health, role_carry
from .replan import ReplanManager, reshard_counts, reshard_plans, reshard_request
from .straggler import PlanSkewMonitor, SkewReport, StragglerDetector

__all__ = ["chaos", "fault", "leader", "replan", "straggler",
           "ChaosError", "ChaosInjector",
           "FaultError", "RetryPolicy", "classify_failure",
           "run_with_recovery",
           "choose_leader_perm", "permutation_cost", "rank_health",
           "role_carry",
           "ReplanManager", "reshard_counts", "reshard_plans",
           "reshard_request",
           "PlanSkewMonitor", "SkewReport", "StragglerDetector"]
