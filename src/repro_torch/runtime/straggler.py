"""Straggler detection: per-step deadlines (port of the
``StragglerDetector`` half of ``repro.runtime.straggler``; the per-plan
``PlanSkewMonitor`` comes with the resilience slice, ROADMAP.md item 18).

The JAX module holds two detectors:

``StragglerDetector`` — the step-level deadline tracker the train loop
already used.  On a single controller we cannot preempt a slow chip, but
we can do what fleet schedulers do with the signal: keep an EMA of step
latency, flag steps beyond ``threshold x EMA`` (log + counter), and
surface a recommendation.  The train loop consults
``should_checkpoint_early`` so a degrading fleet checkpoints more often —
shrinking the replay window a straggler-turned-failure would cost.

``PlanSkewMonitor`` — the plan-level aggregator over the per-epoch
wall-time rings that ``AlltoallvPlan.start`` records into
(``repro.core._exec_stats``).  A persistent plan is tuned ONCE at INIT;
when a host degrades mid-run the fence/lock/hierarchy break-even that
tuning measured is stale.  The monitor detects *sustained* skew — a run
of consecutive whole windows above ``threshold x baseline`` — never a
one-off spike (GC pause, checkpoint write), and can attribute the skew to
the exchange rather than compute by comparing against a compute-side
ring.  A ``SkewReport`` is the trigger ``repro.runtime.replan`` acts on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class StragglerReport:
    step: int
    seconds: float
    ema_seconds: float
    ratio: float


class StragglerDetector:
    def __init__(self, threshold: float = 2.0, ema_alpha: float = 0.1,
                 warmup_steps: int = 3, window_steps: int = 5):
        self.threshold = threshold
        self.ema_alpha = ema_alpha
        self.warmup_steps = warmup_steps
        self.window_steps = window_steps
        self.ema: Optional[float] = None
        self.count = 0
        self.flagged: list[StragglerReport] = []
        self.last_step: Optional[int] = None
        self.last_seconds: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> Optional[StragglerReport]:
        if self._t0 is None:
            # stop() without a matching start(): no sample to take.
            return None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.count += 1
        self.last_step = step
        self.last_seconds = dt
        report = None
        if self.ema is not None and self.count > self.warmup_steps \
                and dt > self.threshold * self.ema:
            report = StragglerReport(step, dt, self.ema, dt / self.ema)
            self.flagged.append(report)
        # slow steps shouldn't drag the EMA up instantly
        alpha = self.ema_alpha if report is None else self.ema_alpha / 4
        self.ema = dt if self.ema is None else (1 - alpha) * self.ema + alpha * dt
        return report

    def should_checkpoint_early(self) -> bool:
        """Two flags within the last ``window_steps`` *steps* (by step
        number, not flag count) => degrading fleet."""
        if self.last_step is None:
            return False
        cutoff = self.last_step - self.window_steps
        recent = [r for r in self.flagged if r.step > cutoff]
        return len(recent) >= 2
