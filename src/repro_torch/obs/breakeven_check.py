"""Live break-even validation: stored Eq. 1-3 fit vs observed epochs (port of
``repro.obs.breakeven_check``).

Every ``variant="auto"`` decision carries the fit its sweep measured
(``choice["breakeven"]``: the sweep cost, the winner's per-epoch time
``t_best``, the runner-up ``t_second``, and ``n_amortize`` — Eq. 3 applied
to the decision itself).  That fit is a *prediction*: the plan should run
steady-state epochs at ~``t_best``, and the sweep should amortize within
``n_amortize`` epochs.  This module checks the prediction against what the
EXECUTE telemetry rings actually observed:

    residual = (observed_p50 - t_best) / t_best

A residual near 0 means the amortization argument held in production; a
large positive residual means the plan never reached its predicted steady
state (drifted host, skewed rank, stale decision) — exactly the condition
a perf gate wants visible.  ``n_observed`` re-evaluates
Eq. 3 with the observed epoch time in place of the sweep's ``t_best``, so
the report also says how many epochs the sweep *actually* took to amortize
against the runner-up.

Fits reach this module via ``EXEC_TELEMETRY.record_fit`` (registered by
``core.autotune`` whenever a plan resolves with an auto decision, warm or
cold); of obs, core imports only ``obs.spans``.
"""

from __future__ import annotations

import math

from ..core._exec_stats import EXEC_TELEMETRY

# Epochs ignored at the front of a ring before "steady state" is claimed:
# the first dispatches pay executable warmup the fit never modeled.
STEADY_WARMUP = 3


def breakeven_residual(fit: dict, observed_p50: float) -> float:
    """Relative error of the observed steady epoch time against the fit's
    predicted ``t_best`` — the ``repro_breakeven_residual`` gauge."""
    t_best = float(fit.get("t_best") or 0.0)
    if t_best <= 0:
        return math.inf
    return (float(observed_p50) - t_best) / t_best


def check_breakeven(exec_snapshot: dict | None = None,
                    warmup: int = STEADY_WARMUP) -> list[dict]:
    """Residual report for every digest that has both a registered fit and
    enough ring samples (> ``warmup``).  Returns a list of dicts, one per
    plan; empty when nothing is checkable (no auto plans, no epochs)."""
    snap = exec_snapshot if exec_snapshot is not None else EXEC_TELEMETRY.snapshot()
    fits = snap.get("fits", {})
    plans = snap.get("plans", {})
    out: list[dict] = []
    for digest, fit in sorted(fits.items()):
        s = plans.get(digest)
        if not s or s.get("count", 0) <= warmup:
            continue
        observed = s.get("steady_p50_s", s.get("p50_s"))
        if observed is None:
            continue
        t_second = float(fit.get("t_second") or 0.0)
        sweep = float(fit.get("sweep_seconds") or 0.0)
        delta_obs = t_second - float(observed)
        out.append({
            "digest": digest,
            "t_best": fit.get("t_best"),
            "t_second": fit.get("t_second"),
            "sweep_seconds": fit.get("sweep_seconds"),
            "n_amortize": fit.get("n_amortize"),
            "observed_p50": float(observed),
            "epochs": int(s.get("count", 0)),
            "residual": breakeven_residual(fit, observed),
            # Eq. 3 re-evaluated with the observed epoch time: how many
            # epochs the sweep really needed to beat picking the runner-up.
            "n_observed": (int(math.ceil(sweep / delta_obs))
                           if delta_obs > 0 and sweep > 0 else None),
        })
    return out
