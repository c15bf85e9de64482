"""Process-wide INIT instrumentation (the port's ``repro.core._init_stats``).

The paper's amortization argument is only auditable if the one-time costs
are observable: these counters record, per process, how many INITs ran
cold vs warm, how many host-side table bakes happened
(``baked_index_tables`` / ``hier_two_stage_schedule``, the expensive numpy
loops), how many autotune measurement bursts executed, and how the plan
store (``repro_torch.planstore``) behaved.  The warm-start contract is
stated in these terms: *a second INIT of an identical pattern against a
populated store performs zero autotune measurement bursts and zero table
bakes.*

The fields are the JAX package's, so ``as_dict()`` has the same keys.
Counters are cumulative per process; ``reset()`` zeroes them.
"""

from __future__ import annotations

import contextlib
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
    store_misses: int = 0        # key not present in the store
    store_puts: int = 0          # artifacts written
    store_invalid: int = 0       # corrupt/mismatched entries treated as misses

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


# --- INIT-request capture ----------------------------------------------------
#
# The deploy-time prewarm pipeline (``repro_torch.planstore.prewarm``) needs
# the *requests* behind a run's INITs, not just their counts: every
# ``exchange_init`` call, serialized well enough to be replayed in another
# process (counts matrix, feature/dtype/axis geometry, variant + knobs,
# embeddable restriction).  Capture is opt-in and process-global, mirroring
# the counters above; the records have the JAX package's fields, so records
# captured by either package replay in the other.

_CAPTURE: list | None = None


def start_init_capture() -> None:
    """Begin recording ``exchange_init`` requests (clears prior capture)."""
    global _CAPTURE
    _CAPTURE = []


def stop_init_capture() -> list:
    """Stop recording; returns the captured request records."""
    global _CAPTURE
    out, _CAPTURE = (_CAPTURE or []), None
    return out


def capturing_inits() -> bool:
    return _CAPTURE is not None


def record_init_request(rec: dict) -> None:
    if _CAPTURE is not None:
        _CAPTURE.append(rec)


@contextlib.contextmanager
def capture_init_requests():
    """``with capture_init_requests() as reqs: ...`` — ``reqs`` is the live
    list; it is fully populated when the block exits."""
    start_init_capture()
    try:
        yield _CAPTURE
    finally:
        stop_init_capture()
