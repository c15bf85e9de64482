"""Process-wide EXECUTE instrumentation: per-plan epoch wall-time rings
(port of ``repro.core._exec_stats``; plain numpy, as in the JAX package).

``_init_stats`` makes the one-time INIT costs auditable; this module does
the same for the *steady state* the paper's amortization argument buys.
Every ``ExchangePlan.start``/``start_pipelined`` records the wall time of
its epoch dispatch into a fixed-size ring keyed by the plan's signature
digest (embedding consumers, whose epochs run inside a host program,
attribute step-level wall time through ``plan.record_epoch`` instead).

The rings are deliberately dumb — a numpy circular buffer, O(1) record,
no locking beyond the GIL — because they sit on the epoch hot path.  All
*policy* (what counts as sustained skew, when to re-plan) belongs to the
readers of the rings (``repro_torch.runtime``: the skew monitor, leader
re-election and the re-plan ladder).

``EXEC_TELEMETRY`` also records plan hot-swaps (``record_swap``) and the
Eq. 1-3 fits of ``variant="auto"`` decisions (``record_fit``).

Caveat, stated once: ``plan.start`` measures *dispatch* wall time.  On a
CUDA device ``start`` returns once the epoch's launches are enqueued, so
the sample is the host's enqueue time, not the epoch (on the CPU the plain
versions run synchronously and the sample is the epoch).  A caller that
wants end-to-end epoch time times ``start``+``wait`` itself and records it
via ``plan.record_epoch``, with ``plan.record_starts = False``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

DEFAULT_RING_CAPACITY = 512
DEFAULT_RANK_RING_CAPACITY = 128


class EpochRing:
    """Fixed-capacity ring of per-epoch wall times with absolute indexing.

    Samples are addressed by their absolute record index (0, 1, 2, ...);
    ``window(start, stop)`` clamps to the retained history, so a reader
    that falls behind loses old samples instead of seeing garbage."""

    __slots__ = ("capacity", "_buf", "_n")

    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY):
        self.capacity = int(capacity)
        self._buf = np.zeros(self.capacity, dtype=np.float64)
        self._n = 0

    def record(self, seconds: float) -> None:
        self._buf[self._n % self.capacity] = seconds
        self._n += 1

    @property
    def count(self) -> int:
        """Total samples ever recorded (not just retained)."""
        return self._n

    def window(self, start: int, stop: int) -> np.ndarray:
        """Samples with absolute indices in ``[start, stop)``, clamped to
        what the ring still retains (may be shorter than requested)."""
        stop = min(int(stop), self._n)
        start = max(int(start), self._n - self.capacity, 0)
        if start >= stop:
            return np.empty(0, dtype=np.float64)
        idx = np.arange(start, stop) % self.capacity
        return self._buf[idx].copy()

    def last(self, n: int) -> np.ndarray:
        return self.window(self._n - int(n), self._n)

    def summary(self) -> dict:
        view = self.last(self.capacity)
        if view.size == 0:
            return {"count": 0}
        return {"count": self._n,
                "mean_s": float(view.mean()),
                "p50_s": float(np.median(view)),
                "p95_s": float(np.percentile(view, 95)),
                "p99_s": float(np.percentile(view, 99)),
                "max_s": float(view.max()),
                "last_s": float(view[-1])}


class ExecTelemetry:
    """Registry of per-plan epoch rings + the hot-swap event log.

    Three kinds of state, three concurrency rules:

    - ``EpochRing.record`` stays lock-free (numpy slot store under the
      GIL) — it is the epoch hot path and each ring has one writer.
    - *Registry* mutation (inserting rings, appending swaps, registering
      fits) takes ``_lock``: ``ReplanManager``'s background thread creates
      rings and logs swaps concurrently with the step loop, and an
      unguarded dict insert racing an iteration in ``summary()`` raises
      ``RuntimeError: dictionary changed size``.
    - Readers use ``snapshot()``: a lock-free-read view built from shallow
      copies taken under the lock, so the exporters (Prometheus render,
      trace report) never hold the lock while formatting.

    ``rank_rings`` extends the per-plan signal per *rank* — keyed
    ``(digest, rank)`` — giving skew attribution and the hierarchy
    leader-re-assignment roadmap item the per-rank timing stream the
    driver-global rings could not provide.  ``fits`` holds the Eq. 1-3
    break-even fit stored with each auto decision, keyed by the winning
    plan's digest, for ``obs.breakeven_check`` to validate against the
    observed rings."""

    def __init__(self) -> None:
        self.rings: dict[str, EpochRing] = {}
        self.rank_rings: dict[tuple[str, int], EpochRing] = {}
        self.swaps: list[dict] = []
        self.fits: dict[str, dict] = {}
        self._lock = threading.Lock()

    def ring(self, digest: str,
             capacity: int = DEFAULT_RING_CAPACITY) -> EpochRing:
        r = self.rings.get(digest)
        if r is None:
            with self._lock:
                r = self.rings.setdefault(digest, EpochRing(capacity))
        return r

    def rank_ring(self, digest: str, rank: int,
                  capacity: int = DEFAULT_RANK_RING_CAPACITY) -> EpochRing:
        key = (digest, int(rank))
        r = self.rank_rings.get(key)
        if r is None:
            with self._lock:
                r = self.rank_rings.setdefault(key, EpochRing(capacity))
        return r

    def record(self, digest: str, seconds: float) -> None:
        self.ring(digest).record(float(seconds))

    def record_rank(self, digest: str, rank: int, seconds: float) -> None:
        """Record one rank's share of an epoch — the per-rank signal.  On
        the hot path after the first call per (digest, rank): dict get +
        ring store, no lock."""
        self.rank_ring(digest, rank).record(float(seconds))

    def record_fit(self, digest: str, fit: dict) -> None:
        """Register the Eq. 1-3 fit a plan's auto decision was measured
        with (``choice["breakeven"]``), for live break-even validation."""
        with self._lock:
            self.fits[digest] = dict(fit)

    def record_swap(self, *, old: str, new: str, reason,
                    variant_from: str | None = None,
                    variant_to: str | None = None) -> dict:
        """Log one plan hot-swap (``runtime.replan``): the EXECUTE-
        side evidence that a re-plan actually took effect."""
        ev = {"old": old, "new": new, "reason": reason,
              "variant_from": variant_from, "variant_to": variant_to,
              "time": time.time()}
        with self._lock:
            self.swaps.append(ev)
        return ev

    def rank_summary(self, digest: str) -> dict[int, dict]:
        """Per-rank ring summaries for one plan, keyed by rank."""
        with self._lock:
            items = [(k[1], r) for k, r in self.rank_rings.items()
                     if k[0] == digest]
        return {rank: r.summary() for rank, r in sorted(items)}

    def reset_rank_rings(self, digest: str) -> int:
        """Drop the per-rank rings of one plan.  Called on plan hot-swap:
        samples recorded under the old schedule (where the slow rank may
        have carried leader slabs) must not blame that rank under the new
        one — attribution after a swap restarts from fresh evidence.
        Returns the number of rings dropped."""
        with self._lock:
            stale = [k for k in self.rank_rings if k[0] == digest]
            for k in stale:
                del self.rank_rings[k]
        return len(stale)

    def reset(self) -> None:
        with self._lock:
            self.rings.clear()
            self.rank_rings.clear()
            self.swaps.clear()
            self.fits.clear()

    def snapshot(self) -> dict:
        """Consistent plain-data view for readers: ring summaries, rank
        summaries, swap list, fits.  The lock covers only the shallow
        copies; summaries are computed outside it (each ring read is
        independently safe), so a concurrent recorder is never blocked for
        longer than four dict copies."""
        with self._lock:
            rings = dict(self.rings)
            rank_rings = dict(self.rank_rings)
            swaps = list(self.swaps)
            fits = {d: dict(f) for d, f in self.fits.items()}
        return {"plans": {d: r.summary() for d, r in rings.items()},
                "ranks": {k: r.summary() for k, r in rank_rings.items()},
                "swaps": swaps,
                "fits": fits}

    def summary(self) -> dict:
        snap = self.snapshot()
        return {"plans": snap["plans"], "swaps": snap["swaps"]}


EXEC_TELEMETRY = ExecTelemetry()
