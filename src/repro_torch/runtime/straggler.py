"""Straggler detection: per-step deadlines + per-plan EXECUTE skew (port
of ``repro.runtime.straggler``).

Two complementary detectors live here:

``StragglerDetector`` — the step-level deadline tracker the train loop
already used.  On a single controller we cannot preempt a slow chip, but
we can do what fleet schedulers do with the signal: keep an EMA of step
latency, flag steps beyond ``threshold x EMA`` (log + counter), and
surface a recommendation.  The train loop consults
``should_checkpoint_early`` so a degrading fleet checkpoints more often —
shrinking the replay window a straggler-turned-failure would cost.

``PlanSkewMonitor`` — the plan-level aggregator over the per-epoch
wall-time rings that ``AlltoallvPlan.start`` records into
(``repro_torch.core._exec_stats``).  A persistent plan is tuned ONCE at INIT;
when a host degrades mid-run the fence/lock/hierarchy break-even that
tuning measured is stale.  The monitor detects *sustained* skew — a run
of consecutive whole windows above ``threshold x baseline`` — never a
one-off spike (GC pause, checkpoint write), and can attribute the skew to
the exchange rather than compute by comparing against a compute-side
ring.  A ``SkewReport`` is the trigger ``runtime.replan`` acts on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np


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


@dataclasses.dataclass
class SkewReport:
    """Sustained per-plan skew: the evidence a re-plan is triggered on."""
    epoch: int           # ring count when detected
    recent_mean: float   # mean of the last hot window (seconds)
    baseline: float      # warmup-median baseline (seconds)
    ratio: float         # recent_mean / baseline
    windows_hot: int     # consecutive hot windows observed
    # Per-rank attribution (from the (digest, rank) rank rings, when the
    # driver feeds them): which rank is slowest and by how much over the
    # across-rank median, the signal the hierarchy's leader re-election
    # needs to know WHICH member of a group degraded.
    worst_rank: "int | None" = None
    worst_rank_ratio: "float | None" = None


class PlanSkewMonitor:
    """Detect sustained skew in one plan's epoch ring.

    The baseline is the *median* of the first ``warmup`` epochs (median so
    a first epoch that compiles and allocates cannot inflate it).  The
    monitor then consumes complete, non-overlapping windows of ``window``
    epochs; a window is hot when its mean exceeds ``threshold x
    baseline``, and only ``sustain`` CONSECUTIVE hot windows produce a
    ``SkewReport``: a single slow epoch (or even a full slow window) is
    forgiven.

    When ``compute_ring`` is given (the step-level compute timing ring),
    the skew is attributed: the plan is only blamed when its degradation
    ratio is at least ``attribution`` times the compute ring's; a host
    whose *everything* got slower needs replacement, not a re-plan.
    """

    def __init__(self, ring, threshold: float = 1.5, window: int = 8,
                 sustain: int = 3, warmup: int = 8, compute_ring=None,
                 attribution: float = 1.0, digest: "str | None" = None):
        self.ring = ring
        self.threshold = float(threshold)
        self.window = int(window)
        self.sustain = int(sustain)
        self.warmup = int(warmup)
        self.compute_ring = compute_ring
        self.attribution = float(attribution)
        # Plan digest for per-rank attribution: when set, a SkewReport
        # names the slowest rank from the (digest, rank) rank rings.
        self.digest = digest
        self.baseline: Optional[float] = None
        self._compute_baseline: Optional[float] = None
        # Samples recorded before this monitor existed (or before its last
        # reset) are not its business: baseline and windows start at the
        # ring position observed at construction/reset time.
        self._origin = int(ring.count)
        self._cursor = self._origin
        self._hot = 0

    def clone_for(self, ring, compute_ring=None,
                  digest: "str | None" = None) -> "PlanSkewMonitor":
        """Fresh monitor with the same policy over a new plan's ring, used
        after a hot-swap so the new plan earns its own baseline."""
        return PlanSkewMonitor(ring, threshold=self.threshold,
                               window=self.window, sustain=self.sustain,
                               warmup=self.warmup,
                               compute_ring=compute_ring or self.compute_ring,
                               attribution=self.attribution,
                               digest=digest)

    def reset(self) -> None:
        self.baseline = None
        self._compute_baseline = None
        self._origin = int(self.ring.count)
        self._cursor = self._origin
        self._hot = 0

    def _ensure_baseline(self) -> bool:
        if self.baseline is not None:
            return True
        if self.ring.count < self._origin + self.warmup:
            return False
        base = self.ring.window(self._origin, self._origin + self.warmup)
        if base.size == 0:      # warmup samples already evicted: re-anchor
            self.reset()
            return False
        self.baseline = float(np.median(base))
        self._cursor = self._origin + self.warmup
        return True

    def observe(self) -> Optional[SkewReport]:
        """Consume newly complete windows; report on sustained skew."""
        if not self._ensure_baseline() or self.baseline <= 0.0:
            return None
        n = self.ring.count
        while self._cursor + self.window <= n:
            w = self.ring.window(self._cursor, self._cursor + self.window)
            self._cursor += self.window
            if w.size == 0:  # evicted before we read it: skip, don't guess
                continue
            if float(w.mean()) > self.threshold * self.baseline:
                self._hot += 1
            else:
                self._hot = 0
        if self._hot < self.sustain:
            return None
        recent = self.ring.last(self.window)
        ratio = float(recent.mean()) / self.baseline
        if not self._attributable(ratio):
            return None
        worst_rank, worst_ratio = self.rank_attribution()
        return SkewReport(epoch=n, recent_mean=float(recent.mean()),
                          baseline=self.baseline, ratio=ratio,
                          windows_hot=self._hot,
                          worst_rank=worst_rank,
                          worst_rank_ratio=worst_ratio)

    def rank_attribution(self) -> "tuple[int | None, float | None]":
        """Slowest rank and its ratio over the across-rank median p50,
        from the ``(digest, rank)`` rank rings; ``(None, None)`` when the
        driver feeds no per-rank signal or fewer than two ranks have
        samples.  Read-only over a telemetry snapshot: safe to call from
        the observe path while the step loop records."""
        if self.digest is None:
            return None, None
        from ..core._exec_stats import EXEC_TELEMETRY
        per_rank = {r: s["p50_s"]
                    for r, s in EXEC_TELEMETRY.rank_summary(self.digest).items()
                    if s.get("count")}
        if len(per_rank) < 2:
            return None, None
        med = float(np.median(list(per_rank.values())))
        worst = max(per_rank, key=per_rank.get)
        if med <= 0.0:
            return None, None
        return int(worst), float(per_rank[worst] / med)

    def _attributable(self, plan_ratio: float) -> bool:
        """Blame the plan only when its slowdown outpaces compute's."""
        if self.compute_ring is None:
            return True
        cr = self.compute_ring
        if self._compute_baseline is None:
            if cr.count < self.warmup:
                return True  # no compute evidence yet: don't suppress
            base = cr.window(0, self.warmup)
            if base.size == 0:
                return True
            self._compute_baseline = float(np.median(base))
        if self._compute_baseline <= 0.0:
            return True
        compute_ratio = float(cr.last(self.window).mean()) / self._compute_baseline
        return plan_ratio >= self.attribution * compute_ratio
