"""Break-even model for persistence (paper Eq. 1-3; port of
``repro.core.breakeven``).

    T_persist_total = T_init + N * T_persist          (1)
    T_base_total    = N * T_MPI                        (2)
    N_breakeven     = ceil(T_init / (T_MPI - T_persist))   (3)

The one-time cost has two parts here: host-side metadata (the plan's
``init_host_seconds``) and ``compile()`` (table upload, K1's run tables,
loading the kernels: ``init_compile_seconds``).  Callers pass their sum, or
either part, as ``t_init``.  A warm ``PlanCache`` pays neither.

Every timed call ends with the stream it ran on idle (``_block``): CUDA
launches return after the enqueue, so a host clock around an unblocked
call would time the host's enqueue and rank arms by host cost.  Only the
current stream is waited on, so a sandbox sweep on a stream of its own
(``runtime.replan.reautotune``) neither waits on nor is timed with the
live epochs another thread keeps enqueuing on theirs.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class BreakEven:
    t_init: float                 # one-time INIT cost (seconds)
    t_persist: float              # per-iteration start+wait (seconds)
    t_mpi: float                  # per-iteration non-persistent (seconds)
    n_breakeven: float            # iterations to amortize; inf if no gain

    @property
    def delta(self) -> float:
        return self.t_mpi - self.t_persist

    @property
    def savings_pct(self) -> float:
        return 100.0 * self.delta / self.t_mpi if self.t_mpi > 0 else 0.0

    def total_persistent(self, n: int) -> float:
        return self.t_init + n * self.t_persist

    def total_baseline(self, n: int) -> float:
        return n * self.t_mpi


def n_breakeven(t_init: float, t_mpi: float, t_persist: float) -> float:
    """Eq. 3; math.inf when persistence never pays off."""
    delta = t_mpi - t_persist
    if delta <= 0:
        return math.inf
    return math.ceil(t_init / delta) if t_init > 0 else 1


def codec_fits(per_codec_best: dict[str, float],
               sweep_seconds: float) -> dict[str, dict]:
    """Eq. 3 per (pattern, codec): each codec's best arm against the best
    identity arm.  ``t_init`` is the codec sweep itself (the one-time cost a
    tolerance-declaring INIT pays), the per-epoch saving is
    ``t_identity - t_codec``, and ``n_amortize_vs_identity`` is Eq. 3's
    epoch count — None (JSON-strict, no Infinity) when the codec never
    pays off for this pattern."""
    t_id = per_codec_best.get("identity", math.inf)
    out = {}
    for cdc, t in per_codec_best.items():
        saving = t_id - t
        out[cdc] = {
            "t_best": float(t),
            "saving_vs_identity": float(saving),
            "n_amortize_vs_identity": (
                int(n_breakeven(sweep_seconds, t_id, t))
                if saving > 0 and math.isfinite(t_id) else None),
        }
    return out


def size_fits(per_codec: dict[str, dict[float, float]]) -> dict[str, dict]:
    """Eq. 3-style linear transport fit per codec over a payload sweep.

    ``per_codec`` maps codec name -> {payload_kib: seconds}.  Each codec's
    timings are fit to ``t(s) = alpha + beta * s``: ``alpha`` is the
    per-epoch fixed cost (launches + codec passes), ``beta`` the per-KiB
    transport rate its wire width buys.  ``crossover_kib_vs_identity`` is
    the payload beyond which the codec's byte saving repays its fixed cost
    against the identity fit — None (JSON-strict) when ``beta >=
    beta_identity``: where moved bytes are cheaper than the encode/decode
    passes, a lossy codec never pays and the fit says so.
    """
    import numpy as np

    fits = {}
    for cdc, pts in per_codec.items():
        sizes = np.array(sorted(pts), dtype=np.float64)
        times = np.array([pts[s] for s in sizes], dtype=np.float64)
        beta, alpha = np.polyfit(sizes, times, 1)
        fits[cdc] = {"alpha_s": float(alpha), "beta_s_per_kib": float(beta)}
    ident = fits.get("identity")
    for cdc, f in fits.items():
        cross = None
        if ident is not None and cdc != "identity":
            dbeta = ident["beta_s_per_kib"] - f["beta_s_per_kib"]
            dalpha = f["alpha_s"] - ident["alpha_s"]
            if dbeta > 0:
                cross = max(dalpha / dbeta, 0.0)
        f["crossover_kib_vs_identity"] = cross
    return fits


def _block(out) -> None:
    """Wait until the current stream of the CUDA device that holds the
    tensor ``out`` is idle: the port's ``jax.block_until_ready``.  CPU
    tensors are ready on return."""
    if isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.current_stream(out.device).synchronize()


def measure_arms(arms: dict[str, Callable[[], torch.Tensor]],
                 iters: int = 50,
                 warmup: int = 5,
                 bursts: int = 4) -> dict[str, float]:
    """Interleaved min-of-bursts timing over named arms.

    Every arm runs in short bursts, round-robin across arms, and each arm's
    estimate is the *minimum* of its burst means.  Interleaving keeps a
    drifting background load from being attributed to whichever arm
    happened to run later; the min discards bursts that caught a load
    spike.  Each call is blocked until its stream is idle, so a burst mean
    is host wall time per whole epoch.  Every cross-arm metric of the port
    (break-even, autotune) goes through this one estimator.
    """
    for fn in arms.values():
        for _ in range(warmup):
            _block(fn())
    burst_iters = max(iters // bursts, 1)
    samples: dict[str, list[float]] = {name: [] for name in arms}
    for _ in range(bursts):
        for name, fn in arms.items():
            t0 = time.perf_counter()
            for _ in range(burst_iters):
                _block(fn())
            samples[name].append((time.perf_counter() - t0) / burst_iters)
    return {name: min(s) for name, s in samples.items()}


def measure(run_persistent: Callable[[], torch.Tensor],
            run_baseline: Callable[[], torch.Tensor],
            t_init: float,
            iters: int = 50,
            warmup: int = 5,
            bursts: int = 4) -> BreakEven:
    """Time both paths with the shared interleaved min-of-bursts estimator
    (each call blocked until its stream is idle; all virtual ranks share
    one device, so the MPI_MAX over ranks is implicit).  Back-to-back
    whole-block timing — persistent first, baseline second — would bias
    Eq. 3 against whichever path ran while the host was busier."""
    t = measure_arms({"persistent": run_persistent, "baseline": run_baseline},
                     iters=iters, warmup=warmup, bursts=bursts)
    return BreakEven(t_init=t_init, t_persist=t["persistent"],
                     t_mpi=t["baseline"],
                     n_breakeven=n_breakeven(t_init, t["baseline"],
                                             t["persistent"]))
