"""Runtime resilience (port of ``repro.runtime``, in part).

* ``fault`` — checkpoint-restart recovery (``run_with_recovery``), plan
  aware: device-loss-class failures rebuild plans before replay
  (``classify_failure``), and ``RetryPolicy`` decays its restart count
  after sustained progress.
* ``straggler`` — the step-level ``StragglerDetector``.

The per-plan skew monitor, leader re-election, re-planning, elastic
resharding and chaos injection come with ROADMAP.md item 18.
"""

from . import fault, straggler
from .fault import FaultError, RetryPolicy, classify_failure, run_with_recovery
from .straggler import StragglerDetector, StragglerReport

__all__ = ["fault", "straggler", "FaultError", "RetryPolicy",
           "classify_failure", "run_with_recovery", "StragglerDetector",
           "StragglerReport"]
