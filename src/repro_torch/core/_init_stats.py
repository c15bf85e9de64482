"""Process-wide INIT instrumentation (the port's ``repro.core._init_stats``).

The paper's amortization argument is only auditable if the one-time costs
are observable: these counters record, per process, how many INITs ran
cold vs warm and how many host-side table bakes happened
(``baked_index_tables``, the expensive numpy loops).  The warm-start
contract is stated in these terms: *an INIT handed an artifact that
carries the tables performs zero table bakes.*

The JAX package also counts autotune sweeps and plan-store traffic, and
captures INIT requests for prewarming; those fields arrive with the
autotune and plan-store slices of the port.

Counters are cumulative per process; ``reset()`` zeroes them.
"""

from __future__ import annotations

import dataclasses
import threading


@dataclasses.dataclass
class InitStats:
    cold_inits: int = 0          # plans built by baking metadata on host
    warm_inits: int = 0          # plans built from a warm artifact's tables
    table_bakes: int = 0         # baked_index_tables runs
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
