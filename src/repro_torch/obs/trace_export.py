"""Exporters and validator for the span buffer: Chrome-trace JSON + JSONL
(port of ``repro.obs.trace_export``; the same events, so one viewer and
one validator read the traces of both packages).

``chrome_trace`` turns a ``Tracer.snapshot()`` into the Chrome trace event
format (the ``{"traceEvents": [...]}`` flavor) that both ``chrome://tracing``
and Perfetto's UI load directly: complete spans become ``"X"`` events with
microsecond ``ts``/``dur``, instants become ``"i"``, and thread metadata
(``"M"`` events) names the driver vs the re-plan background thread so a
hot-swap's sandbox sweep is visually separated from the step loop.

``validate_trace`` is the trace contract: beyond JSON
well-formedness it checks that spans on each thread nest properly (no
partial overlap — every span is either disjoint from or fully contained in
its predecessor) and enforces the warm-start rule in trace terms: an
``init`` span whose args say ``warm: true`` must contain **zero**
``init.bake`` / ``init.autotune`` children, because a warm INIT that bakes
tables or runs measurement bursts is not warm at all.
"""

from __future__ import annotations

import json
import os

from .spans import COMPLETE, INSTANT, TRACER

# Span categories with a nesting contract.  ``store`` spans are excluded:
# a CAS-merge retry loop re-enters ``store.put`` timing legitimately.
_NESTED_CATS = ("init", "init.bake", "init.autotune", "execute")


def chrome_trace(snapshot: dict | None = None) -> dict:
    """Render a tracer snapshot as a Chrome/Perfetto trace object."""
    snap = snapshot if snapshot is not None else TRACER.snapshot()
    pid = os.getpid()
    events: list[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": "repro-driver"}},
    ]
    for tid, tname in sorted(snap.get("thread_names", {}).items()):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": tname}})
    for name, cat, ph, ts_s, dur_s, tid, args in snap["records"]:
        ev = {"name": name, "cat": cat, "ph": ph, "pid": pid, "tid": tid,
              "ts": ts_s * 1e6, "args": dict(args) if args else {}}
        if ph == COMPLETE:
            ev["dur"] = dur_s * 1e6
        elif ph == INSTANT:
            ev["s"] = "t"     # thread-scoped instant
        events.append(ev)
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"origin_unix": snap.get("origin_unix", 0.0)}}


def write_trace(path: str, snapshot: dict | None = None) -> dict:
    """Write the Chrome trace JSON to ``path``; returns the trace object."""
    trace = chrome_trace(snapshot)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def write_jsonl(path: str, snapshot: dict | None = None) -> int:
    """Append the snapshot's records to a JSONL event log (one event per
    line, grep/jq-friendly); returns the number of lines written."""
    snap = snapshot if snapshot is not None else TRACER.snapshot()
    origin = snap.get("origin_unix", 0.0)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    n = 0
    with open(path, "a") as f:
        for name, cat, ph, ts_s, dur_s, tid, args in snap["records"]:
            rec = {"name": name, "cat": cat, "ph": ph,
                   "time_unix": origin + ts_s, "dur_s": dur_s,
                   "tid": tid, "args": args or {}}
            f.write(json.dumps(rec) + "\n")
            n += 1
    return n


# ---------------------------------------------------------------------------
# Validation


class TraceValidationError(ValueError):
    """A trace file violated the structural contract (malformed JSON,
    improper span nesting, or a warm INIT with bake/burst children)."""


def _load(trace) -> dict:
    if not isinstance(trace, dict):
        with open(trace) as f:
            try:
                trace = json.load(f)
            except json.JSONDecodeError as e:
                raise TraceValidationError(f"not valid JSON: {e}") from e
    if not isinstance(trace, dict) or \
            not isinstance(trace.get("traceEvents"), list):
        raise TraceValidationError("missing top-level traceEvents list")
    return trace


def validate_trace(trace, expect_cats: tuple[str, ...] = ()) -> dict:
    """Check a trace object/path; raises ``TraceValidationError`` on the
    first violation.  Returns a summary dict (event counts by category,
    warm/cold init counts) used by the CLI and ``chip_smoke.py``.

    ``expect_cats`` additionally requires at least one complete span in
    each listed category, e.g. ``("init", "execute")``."""
    obj = _load(trace)
    by_cat: dict[str, int] = {}
    by_thread: dict[tuple, list] = {}
    inits: list[dict] = []
    instants = 0
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            raise TraceValidationError(f"event {i} is not an object")
        ph = ev.get("ph")
        if ph == "M":
            continue
        for field in ("name", "ts", "pid", "tid"):
            if field not in ev:
                raise TraceValidationError(f"event {i} missing {field!r}")
        if ph == "i":
            instants += 1
            by_cat[ev.get("cat", "")] = by_cat.get(ev.get("cat", ""), 0) + 1
            continue
        if ph != "X":
            raise TraceValidationError(f"event {i} has unknown phase {ph!r}")
        if "dur" not in ev or ev["dur"] < 0:
            raise TraceValidationError(f"event {i} missing/negative dur")
        cat = ev.get("cat", "")
        by_cat[cat] = by_cat.get(cat, 0) + 1
        by_thread.setdefault((ev["pid"], ev["tid"]), []).append(ev)
        # INIT spans declare warmth explicitly; other init-cat spans
        # (plan_compile) are not INITs and don't count warm or cold.
        if cat == "init" and "warm" in (ev.get("args") or {}):
            inits.append(ev)

    # Nesting: per thread, sorted by start (ties: longer first), every span
    # must be contained in or disjoint from the enclosing open span.
    for key, evs in by_thread.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list[tuple[float, float, str]] = []
        # Sub-microsecond jitter from float round-trips shouldn't fail a
        # structurally sound trace.
        eps = 0.5
        for ev in evs:
            t0, t1 = ev["ts"], ev["ts"] + ev["dur"]
            while stack and stack[-1][1] <= t0 + eps:
                stack.pop()
            if stack and t1 > stack[-1][1] + eps:
                raise TraceValidationError(
                    f"span {ev['name']!r} on tid {key[1]} overlaps "
                    f"{stack[-1][2]!r} without nesting "
                    f"([{t0:.1f},{t1:.1f}]us vs end {stack[-1][1]:.1f}us)")
            if ev.get("cat") in _NESTED_CATS:
                stack.append((t0, t1, ev["name"]))

    # Warm-INIT rule: zero bake/autotune children inside a warm init span.
    warm = cold = 0
    for ev in inits:
        is_warm = bool((ev.get("args") or {}).get("warm"))
        warm += is_warm
        cold += not is_warm
        if not is_warm:
            continue
        t0, t1 = ev["ts"], ev["ts"] + ev["dur"]
        for other in by_thread.get((ev["pid"], ev["tid"]), []):
            if other is ev or other.get("cat") not in ("init.bake",
                                                       "init.autotune"):
                continue
            if other["ts"] >= t0 and other["ts"] + other["dur"] <= t1 + 0.5:
                raise TraceValidationError(
                    f"warm init span contains {other.get('cat')} child "
                    f"{other['name']!r} — warm-start contract violated")

    for cat in expect_cats:
        if by_cat.get(cat, 0) == 0:
            raise TraceValidationError(f"no spans in expected category {cat!r}")

    return {"events": sum(by_cat.values()), "by_cat": by_cat,
            "instants": instants, "warm_inits": warm, "cold_inits": cold,
            "threads": len(by_thread)}
