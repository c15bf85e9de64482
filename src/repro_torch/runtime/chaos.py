"""Deterministic fault injection for exchange hardening (port of
``repro.runtime.chaos``).

Same discipline as the plan store's ``fsremote://?fail_rate=&seed=``
backend: a private ``random.Random(seed)`` drives every probabilistic
decision — one draw per decision point — so a given seed replays the
IDENTICAL fault schedule, and per-kind counters record every injection so
tests can assert "the fault actually fired" instead of hoping it did.

Fault kinds:

* **window** — ``wrap_window_cache`` returns a proxy whose ``get`` raises
  ``ChaosError("window allocation failed")`` at ``window_fail_rate``:
  the RMA-window-allocation failure class (device OOM / dead device at
  INIT or rebuild time).  Classified as device-loss by
  ``fault.classify_failure``.
* **poison** — ``poison_store`` overwrites store entries with garbage
  bytes.  The store treats corruption as a miss (``store_invalid``), so a
  poisoned entry must degrade to a cold build, never a crash.
* **stall** — ``step_hook``/``maybe_stall`` sleeps ``stall_seconds`` on
  chosen steps: the degraded-host signal the straggler/skew monitors
  exist to catch.
* **step** / **device** — ``step_hook`` raises once per listed step
  (transient class, and device-loss class respectively); recovery replays
  the step, so firing is once-per-step-number, not once-per-visit.
* **rank_slow** — a deterministic per-rank slowdown (``rank_slow=R:F``:
  rank R runs F× slow from ``rank_slow_from`` on).  Two injection points
  drive the leader re-election loop end to end: ``scale_rank_times``
  inflates the slowed ranks' per-rank epoch samples (feeding skew
  attribution), and ``maybe_rank_stall`` stalls the epoch by the slow
  rank's share — the full ``(F-1)×base`` while the rank carries leader
  slabs, only ``rank_slow_weight`` of that once demoted to a carry-free
  role — so a successful re-bake measurably recovers the epoch p50.
"""

from __future__ import annotations

import random
import time
from typing import Iterable, Optional

from ..obs.spans import TRACER


class ChaosError(RuntimeError):
    """An injected fault."""


class _ChaosWindowCache:
    """WindowCache proxy: same surface, scheduled allocation failures."""

    def __init__(self, inner, injector: "ChaosInjector"):
        self._inner = inner
        self._injector = injector

    def get(self, rows: int, feature_shape, dtype):
        self._injector.maybe_fail_window()
        return self._inner.get(rows, feature_shape, dtype)

    def free(self) -> None:
        self._inner.free()

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _parse_steps(val: str) -> tuple[int, ...]:
    """``"4"`` | ``"4+9"`` | ``"3-6"`` (inclusive range) → step tuple."""
    out: list[int] = []
    for part in str(val).split("+"):
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return tuple(out)


class ChaosInjector:
    def __init__(self, seed: int = 0, window_fail_rate: float = 0.0,
                 fail_steps: Iterable[int] = (),
                 device_loss_steps: Iterable[int] = (),
                 stall_steps: Iterable[int] = (),
                 stall_seconds: float = 0.0,
                 rank_slow=(),
                 rank_slow_from: int = 0,
                 rank_slow_weight: float = 0.1):
        self.seed = int(seed)
        self.window_fail_rate = float(window_fail_rate)
        self.fail_steps = frozenset(int(s) for s in fail_steps)
        self.device_loss_steps = frozenset(int(s) for s in device_loss_steps)
        self.stall_steps = frozenset(int(s) for s in stall_steps)
        self.stall_seconds = float(stall_seconds)
        # rank -> slowdown factor (>= 1.0), active from rank_slow_from on.
        items = rank_slow.items() if hasattr(rank_slow, "items") else rank_slow
        self.rank_slow = {int(r): float(f) for r, f in items}
        self.rank_slow_from = int(rank_slow_from)
        self.rank_slow_weight = float(rank_slow_weight)
        self._rng = random.Random(self.seed)
        self._fired: set[int] = set()
        self._rank_slow_announced: set[int] = set()
        self.injected = {"window": 0, "poison": 0, "stall": 0,
                         "step": 0, "device": 0, "rank_slow": 0}

    # -- window allocation ---------------------------------------------------
    def maybe_fail_window(self) -> None:
        if self.window_fail_rate and \
                self._rng.random() < self.window_fail_rate:
            self.injected["window"] += 1
            TRACER.instant("chaos_injection", "runtime", kind="window",
                           n=self.injected["window"])
            raise ChaosError("chaos: window allocation failed "
                             f"(injection #{self.injected['window']})")

    def wrap_window_cache(self, cache) -> _ChaosWindowCache:
        return _ChaosWindowCache(cache, self)

    # -- store poisoning -----------------------------------------------------
    def poison_store(self, store, keys: Optional[Iterable[str]] = None) -> int:
        """Overwrite store entries with garbage bytes.  Returns the number
        poisoned.  Corruption must read as a miss (``store_invalid``)."""
        backend = store.store_backend
        poisoned = 0
        for key in list(keys if keys is not None else backend.keys()):
            junk = bytes(self._rng.randrange(256) for _ in range(64))
            backend.put_bytes(key, b"chaos-poison\x00" + junk)
            poisoned += 1
        self.injected["poison"] += poisoned
        if poisoned:
            TRACER.instant("chaos_injection", "runtime", kind="poison",
                           n=poisoned)
        return poisoned

    # -- epoch/step hooks ----------------------------------------------------
    def maybe_stall(self, step: int) -> float:
        """Sleep on listed steps (every visit — a degraded host is slow on
        the replay too).  Returns the seconds stalled."""
        if step in self.stall_steps and self.stall_seconds > 0:
            self.injected["stall"] += 1
            TRACER.instant("chaos_injection", "runtime", kind="stall",
                           step=step, seconds=self.stall_seconds)
            time.sleep(self.stall_seconds)
            return self.stall_seconds
        return 0.0

    # -- per-rank slowdown ---------------------------------------------------
    def rank_slow_factors(self, step: int) -> dict[int, float]:
        """Active ``{rank: factor}`` slowdowns at ``step`` (empty before
        ``rank_slow_from``)."""
        if not self.rank_slow or step < self.rank_slow_from:
            return {}
        return dict(self.rank_slow)

    def scale_rank_times(self, step: int, times) -> dict[int, float]:
        """Inflate slowed ranks' per-rank epoch samples.  ``times`` is a
        ``{rank: seconds}`` mapping (or pairs); returns a new dict with the
        active factors applied — the attribution-side half of the fault,
        feeding ``EXEC_TELEMETRY.record_rank`` so the skew monitor blames
        the right rank."""
        items = times.items() if hasattr(times, "items") else times
        factors = self.rank_slow_factors(step)
        return {int(r): float(t) * factors.get(int(r), 1.0)
                for r, t in items}

    def maybe_rank_stall(self, step: int, carrying_ranks, base_seconds: float,
                         ) -> float:
        """Stall the epoch by the slow ranks' share (really sleeps).

        A slowed rank costs the epoch ``(factor-1) * base_seconds`` while it
        sits in ``carrying_ranks`` (the set of ranks carrying leader slabs
        under the live schedule), but only ``rank_slow_weight`` of that once
        demoted to a carry-free role — member-stage work doesn't gate the
        inter-group epoch.  ``carrying_ranks=None`` means every rank gates
        the epoch (flat variants).  Returns the seconds stalled."""
        factors = self.rank_slow_factors(step)
        if not factors or base_seconds <= 0:
            return 0.0
        carrying = None if carrying_ranks is None \
            else {int(r) for r in carrying_ranks}
        extra = 0.0
        for rank, factor in factors.items():
            share = (factor - 1.0) * float(base_seconds)
            if carrying is not None and rank not in carrying:
                share *= self.rank_slow_weight
            if share <= 0:
                continue
            extra = max(extra, share)
            self.injected["rank_slow"] += 1
            if rank not in self._rank_slow_announced:
                # One instant per rank, not per epoch: the span ring is a
                # fixed-size buffer and a per-epoch instant would evict the
                # leader_rebake instant the chaos-smoke CI asserts on.
                self._rank_slow_announced.add(rank)
                TRACER.instant("chaos_injection", "runtime",
                               kind="rank_slow", step=step, rank=rank,
                               factor=factor)
        if extra > 0:
            time.sleep(extra)
        return extra

    def step_hook(self, step: int) -> None:
        """Per-step injection point (call at the top of the step body, so
        raised faults are caught by ``run_with_recovery``).  Stalls fire
        every visit; failures fire once per step number — recovery replays
        the step and must be allowed to make progress."""
        self.maybe_stall(step)
        if step in self.device_loss_steps and step not in self._fired:
            self._fired.add(step)
            self.injected["device"] += 1
            TRACER.instant("chaos_injection", "runtime", kind="device",
                           step=step)
            raise ChaosError(f"chaos: device lost during step {step}")
        if step in self.fail_steps and step not in self._fired:
            self._fired.add(step)
            self.injected["step"] += 1
            TRACER.instant("chaos_injection", "runtime", kind="step",
                           step=step)
            raise ChaosError(f"chaos: injected step fault at step {step}")

    # -- CLI spec ------------------------------------------------------------
    @classmethod
    def parse(cls, spec: str) -> "ChaosInjector":
        """Build from a CLI spec: comma-separated ``k=v`` pairs, e.g.
        ``seed=7,window_fail=0.2,fail_step=6,device_loss_step=9,``
        ``stall_steps=3-5,stall_seconds=0.1`` (step lists accept ``a+b``
        unions and ``a-b`` inclusive ranges).  Per-rank slowdowns:
        ``rank_slow=0:3.0+2:2.0,rank_slow_from=4,rank_slow_weight=0.05``."""
        kw: dict = {}
        for pair in filter(None, (p.strip() for p in spec.split(","))):
            k, _, v = pair.partition("=")
            if not _:
                raise ValueError(f"chaos spec entry {pair!r} is not k=v")
            k = k.strip()
            if k == "seed":
                kw["seed"] = int(v)
            elif k in ("window_fail", "window_fail_rate"):
                kw["window_fail_rate"] = float(v)
            elif k in ("fail_step", "fail_steps"):
                kw["fail_steps"] = _parse_steps(v)
            elif k in ("device_loss_step", "device_loss_steps"):
                kw["device_loss_steps"] = _parse_steps(v)
            elif k in ("stall_step", "stall_steps"):
                kw["stall_steps"] = _parse_steps(v)
            elif k == "stall_seconds":
                kw["stall_seconds"] = float(v)
            elif k == "rank_slow":
                # R:F pairs, "+"-separated: rank_slow=0:3.0+2:2.0
                pairs = []
                for item in str(v).split("+"):
                    r, _, f = item.partition(":")
                    if not _:
                        raise ValueError(
                            f"rank_slow entry {item!r} is not R:F")
                    pairs.append((int(r), float(f)))
                kw["rank_slow"] = pairs
            elif k == "rank_slow_from":
                kw["rank_slow_from"] = int(v)
            elif k == "rank_slow_weight":
                kw["rank_slow_weight"] = float(v)
            else:
                raise ValueError(f"unknown chaos knob {k!r}")
        return cls(**kw)
