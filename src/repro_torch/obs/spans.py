"""Span-based tracing core: the one event model every subsystem records into
(port of ``repro.obs.spans``, which imports no JAX; the port keeps its own
copy).

The paper's amortization argument (Eq. 1-3) says a persistent plan pays a
one-time INIT cost and then runs metadata-free epochs.  ``_init_stats``
counts the INIT-side work and ``_exec_stats`` rings the EXECUTE-side wall
times, but neither shows *where a run's time actually goes* — this module
does: every interesting interval becomes a **span** (name, category, start,
duration, thread, attributes), every interesting moment an **instant
event**, and both land in one process-global buffer that exports to
Chrome-trace/Perfetto JSON (``obs.trace_export``), Prometheus text
(``obs.metrics``), and JSONL.

Span taxonomy (the categories the exporters and the trace validator key on):

  ``init``           one whole plan INIT (``ExchangePlan.__init__``);
                     args carry digest/variant/warm so a warm INIT is
                     checkable: it must contain zero bake/burst children
  ``init.bake``      host-side table bakes (``baked_index_tables`` /
                     ``hier_two_stage_schedule``)
  ``init.autotune``  ``variant="auto"`` sweeps and their measurement bursts
  ``store``          plan-store get/put/CAS-merge, attributed with backend
                     root and hit/miss outcome
  ``execute``        epoch dispatch / recorded epochs / train steps /
                     serve prefill+decode
  ``runtime``        re-plan triggers, hot-swaps, recovery, chaos
                     injections, elastic resharding (mostly instants)

Hot-path discipline
-------------------

Tracing is **off by default**: every instrumentation site guards on
``TRACER.enabled`` (one attribute load) and the disabled cost is just that
check.  Enabled, a finished span is one tuple stored into a slot of a
**preallocated ring** — the same storage discipline as
``core._exec_stats.EpochRing``: no locks on the record path (the slot
index comes from an ``itertools.count``, whose ``next`` is atomic under
the GIL, so concurrent writers — the re-plan background thread and the
step loop — never tear a record; a full ring overwrites oldest-first).
The JAX package's overhead contract (``benchmarks/resilience.py``,
``steady_traced`` row) is that tracing on stays within ~2% of a bare
epoch; ``chip_smoke.py``'s ``obs_path`` reads the port's on the card.
"""

from __future__ import annotations

import itertools
import threading
import time

DEFAULT_SPAN_CAPACITY = 1 << 16

# Span kinds (the ``ph`` phase the Chrome exporter emits).
COMPLETE = "X"        # a closed interval: ts + dur
INSTANT = "i"         # a moment: ts only


class SpanBuffer:
    """Preallocated ring of finished span records.

    A record is the tuple ``(name, cat, ph, ts_s, dur_s, tid, args)`` with
    times in seconds on the tracer's clock.  ``emit`` is lock-free (slot
    index from an atomic counter); ``snapshot`` returns the retained
    records oldest-first and may lose in-flight writes — acceptable for an
    observability buffer, never for correctness data."""

    __slots__ = ("capacity", "_slots", "_idx")

    def __init__(self, capacity: int = DEFAULT_SPAN_CAPACITY):
        self.capacity = int(capacity)
        self._slots = [None] * self.capacity
        self._idx = itertools.count()

    def emit(self, rec: tuple) -> None:
        self._slots[next(self._idx) % self.capacity] = rec

    @property
    def count(self) -> int:
        """Records emitted so far (approximate upper bound of retained)."""
        # count objects expose their next value via repr only; probing would
        # consume it.  Track via a non-consuming scan instead: cheap at
        # snapshot time, and emit() stays free of bookkeeping.
        return sum(1 for s in self._slots if s is not None)

    def snapshot(self) -> list[tuple]:
        """Retained records, oldest-first by timestamp."""
        recs = [s for s in self._slots if s is not None]
        recs.sort(key=lambda r: r[3])
        return recs


class _SpanCtx:
    """Context manager for one span; ``.args`` is mutable until exit, so a
    body can attach outcomes (warm/hit/variant) it only knows at the end."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_SpanCtx":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter()
        if exc is not None:
            self.args["error"] = repr(exc)
        self._tracer._emit(self.name, self.cat, COMPLETE,
                           self._t0, t1 - self._t0, self.args)


class _NullCtx:
    """Shared no-op context: ``TRACER.span`` returns this when disabled so
    call sites pay one attribute check and zero allocation."""

    __slots__ = ()
    args: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL = _NullCtx()


class Tracer:
    """Process-global span recorder (singleton ``TRACER``).

    ``enable(capacity)`` arms it; until then every API is a cheap no-op.
    Timestamps are ``perf_counter`` seconds relative to the enable call
    (``origin_unix`` maps them back to wall time for exporters)."""

    def __init__(self) -> None:
        self.enabled = False
        self.buffer: SpanBuffer | None = None
        self._t0 = 0.0
        self.origin_unix = 0.0
        self._thread_names: dict[int, str] = {}
        self._lock = threading.Lock()     # thread-name registry only

    # -- lifecycle -----------------------------------------------------------
    def enable(self, capacity: int = DEFAULT_SPAN_CAPACITY) -> "Tracer":
        self.buffer = SpanBuffer(capacity)
        self._t0 = time.perf_counter()
        self.origin_unix = time.time()
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self.enabled = False
        self.buffer = None
        with self._lock:
            self._thread_names.clear()

    # -- recording -----------------------------------------------------------
    def span(self, name: str, cat: str, **args) -> "_SpanCtx | _NullCtx":
        """``with TRACER.span("table_bake", "init.bake", p=64): ...``"""
        if not self.enabled:
            return _NULL
        return _SpanCtx(self, name, cat, args)

    def emit_span(self, name: str, cat: str, t0: float, t1: float,
                  args: dict | None = None) -> None:
        """Record an already-timed interval (``t0``/``t1`` are
        ``perf_counter`` readings).  The epoch hot path uses this — it
        already timed itself for the telemetry ring, so the span costs one
        tuple store, no context manager."""
        if self.enabled:
            self._emit(name, cat, COMPLETE, t0, t1 - t0, args)

    def instant(self, name: str, cat: str, **args) -> None:
        """Record a moment (hot-swap landed, chaos fault fired, ...)."""
        if self.enabled:
            self._emit(name, cat, INSTANT, time.perf_counter(), 0.0, args)

    def _emit(self, name: str, cat: str, ph: str, t0: float, dur: float,
              args: dict | None) -> None:
        tid = threading.get_ident()
        if tid not in self._thread_names:
            with self._lock:
                self._thread_names[tid] = threading.current_thread().name
        self.buffer.emit((name, cat, ph, t0 - self._t0, dur, tid, args))

    # -- reading -------------------------------------------------------------
    def snapshot(self) -> dict:
        """Everything an exporter needs, as plain data: retained records,
        thread names, and the wall-clock origin."""
        with self._lock:
            names = dict(self._thread_names)
        return {"records": self.buffer.snapshot() if self.buffer else [],
                "thread_names": names,
                "origin_unix": self.origin_unix}


TRACER = Tracer()


def enabled() -> bool:
    return TRACER.enabled
