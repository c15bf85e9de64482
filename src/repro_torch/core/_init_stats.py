"""Process-wide INIT instrumentation (the port's ``repro.core._init_stats``).

The paper's amortization argument is only auditable if the one-time costs
are observable: these counters record, per process, how many INITs ran
cold vs warm, how many host-side table bakes happened
(``baked_index_tables`` / ``hier_two_stage_schedule``, the expensive numpy
loops) and how many autotune measurement bursts executed.  The warm-start
contract is stated in these terms: *an INIT handed an artifact that
carries the tables performs zero table bakes, and a second
``variant="auto"`` INIT of one pattern on one cache runs no sweep.*

The fields are the JAX package's, so ``as_dict()`` has the same keys; the
plan-store counters stay 0 until the plan store is ported, and with it the
INIT-request capture for prewarming (ROADMAP.md, queue 1).

Counters are cumulative per process; ``reset()`` zeroes them.
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class InitStats:
    cold_inits: int = 0          # plans built by baking metadata on host
    warm_inits: int = 0          # plans built from a warm artifact's tables
    table_bakes: int = 0         # baked_index_tables / hier_two_stage_schedule runs
    autotune_sweeps: int = 0     # variant="auto" measurement sweeps
    autotune_bursts: int = 0     # timing bursts executed across all sweeps
    store_hits: int = 0          # artifacts loaded and validated
    store_misses: int = 0        # key not present on disk
    store_puts: int = 0          # artifacts written
    store_invalid: int = 0       # warm artifacts rejected (cold rebuild)

    def __post_init__(self) -> None:
        # Not a dataclass field: locks don't copy/compare and must not
        # appear in as_dict().
        object.__setattr__(self, "_lock", threading.Lock())

    def bump(self, field: str, n: int = 1) -> None:
        """Thread-safe increment (a bare ``+=`` can drop counts across
        threads)."""
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def reset(self) -> None:
        with self._lock:
            for f in dataclasses.fields(self):
                setattr(self, f.name, 0)

    def as_dict(self) -> dict:
        with self._lock:
            return {f.name: getattr(self, f.name)
                    for f in dataclasses.fields(self)}


INIT_STATS = InitStats()
