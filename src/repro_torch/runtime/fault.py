"""Fault tolerance: retrying step execution with checkpoint-restart,
plus plan-aware recovery (port of ``repro.runtime.fault``).

On a real fleet, device failures surface as ``torch.AcceleratorError``
(a CUDA error), XlaRuntimeError / SystemError under JAX, from the step
call; the recovery discipline is: reload the last
complete checkpoint, rebuild device state, and replay from there (the data
pipeline is (seed, step)-deterministic so replay is exact).  This module
implements that discipline; the injectable ``failure_hook`` lets tests
simulate faults at chosen steps.

Two refinements beyond plain checkpoint-restart:

* ``classify_failure`` splits errors into *device-loss class* (the device
  state itself — RMA windows, compiled executables — is suspect and the
  persistent plans must be rebuilt via ``rebuild_plans`` before replaying)
  and *transient* (checkpoint-restart alone suffices).
* ``RetryPolicy`` decays its restart count after sustained successful
  progress (``decay_after`` consecutive clean steps forgive one restart),
  so N transient faults spread across a long run no longer kill a job
  that recovered cleanly from every one of them.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

log = logging.getLogger("repro_torch.fault")


class FaultError(RuntimeError):
    pass


# Error types / message fragments that mean the device state itself (RMA
# windows, compiled plan executables) is suspect — not just the step.
_DEVICE_LOSS_TYPES = ("AcceleratorError", "OutOfMemoryError",
                      "XlaRuntimeError", "SystemError")
_DEVICE_LOSS_TOKENS = ("device", "window allocation", "data_loss",
                       "resource_exhausted", "internal: ", "dead",
                       "cuda error")


def classify_failure(err: Exception) -> str:
    """``"device_loss"`` (plans must be rebuilt) or ``"transient"``
    (checkpoint-restart suffices).  Matches by exception type name and
    message substring so injected faults (``runtime.chaos``) and real XLA
    errors classify identically without importing either."""
    if type(err).__name__ in _DEVICE_LOSS_TYPES:
        return "device_loss"
    msg = str(err).lower()
    if any(tok in msg for tok in _DEVICE_LOSS_TOKENS):
        return "device_loss"
    return "transient"


class RetryPolicy:
    def __init__(self, max_restarts: int = 3, backoff_seconds: float = 0.5,
                 decay_after: int = 25):
        self.max_restarts = max_restarts
        self.backoff_seconds = backoff_seconds
        self.decay_after = decay_after
        self.restarts = 0
        self._streak = 0  # consecutive successful steps since last failure

    def record_failure(self, step: int, err: Exception) -> None:
        self._streak = 0
        self.restarts += 1
        log.warning("step %d failed (%s); restart %d/%d",
                    step, err, self.restarts, self.max_restarts)
        if self.restarts > self.max_restarts:
            raise FaultError(
                f"exceeded {self.max_restarts} restarts; last error: {err}"
            ) from err
        time.sleep(self.backoff_seconds)

    def record_success(self) -> None:
        """One clean step; ``decay_after`` in a row forgive one restart.

        The budget measures failure *density*, not lifetime count — a
        fleet that recovers and then makes sustained progress has proven
        the fault was transient."""
        self._streak += 1
        if self.restarts > 0 and self._streak >= self.decay_after:
            self.restarts -= 1
            self._streak = 0
            log.info("sustained progress (%d clean steps); restart budget "
                     "decayed to %d/%d", self.decay_after, self.restarts,
                     self.max_restarts)


def run_with_recovery(
    run_step: Callable[[int], dict],
    restore: Callable[[], int],
    start_step: int,
    n_steps: int,
    policy: Optional[RetryPolicy] = None,
    failure_hook: Optional[Callable[[int], None]] = None,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
    rebuild_plans: Optional[Callable[[Exception], None]] = None,
    on_recovery: Optional[Callable[[int, Exception, str], None]] = None,
) -> int:
    """Drive steps [start, start+n) with restart-on-failure.

    run_step(step) executes one step (raising on device failure);
    restore() reloads the last checkpoint and returns the step to resume at.
    rebuild_plans(err), when given, is invoked for device-loss-class
    failures BEFORE restore() — persistent plans hold device state
    (windows, compiled executables) that checkpoint-restart alone does not
    refresh.  on_recovery(step, err, kind) observes each recovery.
    """
    policy = policy or RetryPolicy()
    step = start_step
    end = start_step + n_steps
    while step < end:
        try:
            if failure_hook is not None:
                failure_hook(step)
            metrics = run_step(step)
            if on_metrics is not None:
                on_metrics(step, metrics)
            step += 1
            policy.record_success()
        except FaultError:
            raise
        except Exception as err:  # noqa: BLE001 — any step failure triggers recovery
            failed_step = step
            policy.record_failure(step, err)
            kind = classify_failure(err)
            if kind == "device_loss" and rebuild_plans is not None:
                log.warning("device-loss-class failure at step %d; "
                            "rebuilding persistent plans", step)
                rebuild_plans(err)
            step = restore()
            if on_recovery is not None:
                on_recovery(failed_step, err, kind)
    return step
