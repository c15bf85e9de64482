"""Break-even-driven variant selection for ``variant="auto"`` (port of
``repro.core.autotune``).

No variant wins everywhere: the fused fence epoch wins dense uniform
patterns, the lock schedule sparse banded ones (round elision), the
leader-combined hierarchy grouped meshes once padding dominates, and the
ragged epoch, which moves only valid rows, skewed ones.  ``variant="auto"``
turns that decision over to measurement: at INIT every candidate plan for
the frozen pattern is built, compiled and timed with the shared interleaved
min-of-bursts estimator (``breakeven.measure_arms``, each call blocked until
its stream is idle), and the fastest one becomes the plan.  The sweep is
one-time INIT cost — exactly the amortization contract of Eq. 1-3 — and the
decision is cached in the ``PlanCache`` under the pattern's decision
signature and the mesh's device, so a recurring pattern re-measures only
after a genuine pattern change, and a winner measured on the CPU's plain
versions is never replayed on the card.  With a plan store
(``repro_torch.planstore``) the decision also persists across processes:
keyed on the device kind of the mesh (the card's name or "cpu"), it
warm-starts the next process's INIT, which then measures nothing.

One difference from the JAX module, by design: the ragged epoch runs on
both devices here (one K1 launch on a card, its plain version on the CPU),
so every single-axis alltoallv sweep ranks ``ragged`` too, and a stored
port decision may name it (under the port's store key only).

The losing candidate plans stay in the plan cache (they cost INIT anyway);
callers that want their device memory back call ``free()`` on them.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..obs.spans import TRACER
from ..parallel import wirecodec
from . import breakeven
from . import metadata as md
from . import patterns
from ._exec_stats import EXEC_TELEMETRY
from ._init_stats import INIT_STATS
from .plan import AlltoallvPlan, AlltoallvSpec, PlanCache, torch_dtype


def candidate_variants(spec: AlltoallvSpec, mesh) -> list[str]:
    """Variants worth measuring for this spec's pattern.

    fence and lock always apply (over a 2-axis mesh they exchange on the
    linearized pair); the leader-combined hierarchy needs a genuine
    (outer, inner) factorization AND baked metadata (its two-stage tables
    have no in-graph twins, so A/B mode excludes it).  ragged joins on a
    single-axis exchange (the ragged spec takes one mesh axis); unlike the
    JAX package, whose XLA:CPU has no ragged emitter, the port runs it on
    every device.

    The spec's collective further restricts the set: reduce-scatter has no
    leader-combined hierarchy and no ragged form, allgatherv no ragged form
    (see ``core.patterns``).
    """
    cands = ["fence", "lock"]
    if (len(spec.axis) == 2 and int(mesh.shape[spec.axis[0]]) > 1
            and spec.baked_metadata):
        cands.append("fence_hierarchy")
    if len(spec.axis) == 1:
        cands.append("ragged")
    supported = patterns.get(spec.collective).supported_variants
    return [v for v in cands if v in supported]


def _sweep_codecs(spec: AlltoallvSpec, error_tol: float | None) -> list[str]:
    """The codecs a sweep ranks: those ``error_tol`` admits, identity alone
    for families that cannot sum or reorder encoded wire rows."""
    if not patterns.get(spec.collective).supports_codec:
        return ["identity"]
    return list(wirecodec.allowed(error_tol))


def decision_signature(spec: AlltoallvSpec, mesh,
                       embeddable: bool = False,
                       error_tol: float | None = None) -> md.PatternSignature:
    """The signature an auto decision is cached under (digest for digest
    the JAX package's).

    Distinct from the plan signatures of the candidates it ranks: it
    encodes the candidate-set restriction (``auto_embed`` vs ``auto``) and
    the eligible-codec set, so decisions measured over different arm sets
    never alias."""
    row_bytes = math.prod(spec.feature_shape) * torch_dtype(spec.dtype).itemsize
    codecs = _sweep_codecs(spec, error_tol)
    return md.PatternSignature.build(
        np.asarray(spec.send_counts), spec.feature_shape, spec.dtype,
        "auto_embed" if embeddable else "auto", spec.axis, row_bytes,
        lock_schedule=spec.lock_schedule, tile_rows=spec.tile_rows,
        pack_impl=spec.pack_impl, baked_metadata=spec.baked_metadata,
        axis_sizes=mesh.axis_sizes(spec.axis),
        codec=("auto[" + ",".join(codecs) + "]" if len(codecs) > 1
               else "identity"),
        collective=spec.collective)


def autotune_variant(
    spec: AlltoallvSpec,
    mesh,
    cache: PlanCache,
    iters: int = 12,
    warmup: int = 2,
    bursts: int = 3,
    embeddable: bool = False,
    error_tol: float | None = None,
    force_measure: bool = False,
    annotate: dict | None = None,
    store=None,
) -> AlltoallvPlan:
    """Measure every candidate for ``spec``'s pattern, return the winner.

    ``spec.variant`` is ignored (the caller passed ``variant="auto"``); all
    other spec fields are forwarded to each candidate.  The measurement
    input is a zeros buffer on the mesh's device — timing, not values, is
    under test, and a zeros epoch launches the identical kernels.

    ``embeddable=True`` restricts the candidate set to variants the
    embedded form (``plan.embed()``) supports — i.e. drops ``ragged``,
    which puts into the plan-owned window — so a winner chosen for an
    embedding consumer (MoE dispatch) is always embeddable.  A cached
    decision naming an excluded variant is ignored and re-measured.

    ``error_tol`` widens the sweep to a second dimension: every (variant,
    wire codec) pair whose codec is eligible under the tolerance
    (``wirecodec.allowed``) is measured, arms keyed ``"variant@codec"``,
    and the winning pair — plus per-codec Eq. 3 fits against the best
    identity arm — lands in the decision.

    A decision in ``cache.auto_choices``, else in ``store`` (a
    ``repro_torch.planstore.PlanStore``, duck-typed; its candidate plans
    load their tables from it too), is replayed without measuring; a fresh
    decision is published there (best-effort).  ``force_measure=True``
    re-measures anyway (a decision observed to have gone stale) and
    replaces it.  ``annotate`` merges extra keys into the
    fresh decision.  The decision lands on ``plan.auto_choice``.
    """
    codecs = _sweep_codecs(spec, error_tol)
    sweep_codecs = len(codecs) > 1
    auto_sig = decision_signature(spec, mesh, embeddable=embeddable,
                                  error_tol=error_tol)
    key = (auto_sig, mesh.device)

    cands = candidate_variants(spec, mesh)
    if embeddable:
        cands = [v for v in cands if v != "ragged"]

    def _usable(ch: dict | None) -> bool:
        # A decision for a variant excluded for this consumer (ragged for
        # an embedding caller), or naming a codec the declared tolerance no
        # longer admits, must not be trusted.
        return (ch is not None and ch.get("variant") in cands
                and ch.get("codec", "identity") in codecs)

    choice = None if force_measure else cache.auto_choices.get(key)
    if not _usable(choice):
        choice = None
    if choice is None and store is not None and not force_measure:
        choice = store.get_auto(auto_sig, mesh.device)
        if _usable(choice):
            cache.auto_choices[key] = choice
        else:
            choice = None
    if choice is not None:
        plan = cache.get(
            _candidate_spec(spec, choice["variant"],
                            choice.get("codec", "identity")), mesh,
            store=store)
        plan.auto_choice = choice
        if choice.get("breakeven"):
            # A warm decision still carries its sweep's Eq. 1-3 fit — the
            # live break-even validator checks it against observed epochs.
            EXEC_TELEMETRY.record_fit(plan.signature.digest,
                                      choice["breakeven"])
        return plan

    t_sweep0 = time.perf_counter()
    # Arm keys: bare variant names for the identity-only sweep, and
    # "variant@codec" once codecs join.
    plans: dict[str, AlltoallvPlan] = {}
    for variant in cands:
        for cdc in codecs:
            if cdc != "identity" and variant == "ragged":
                continue       # ragged writes raw wire bytes; identity only
            arm = f"{variant}@{cdc}" if sweep_codecs else variant
            plans[arm] = cache.get(_candidate_spec(spec, variant, cdc),
                                   mesh, store=store).compile()

    INIT_STATS.bump("autotune_sweeps")
    INIT_STATS.bump("autotune_bursts", bursts * len(plans))
    first = next(iter(plans.values()))
    x = torch.zeros(first.global_send_shape, dtype=first.dtype,
                    device=mesh.device)
    arms = {v: (lambda p=p: p.start(x)) for v, p in plans.items()}
    # Measurement bursts are not epochs: keep them out of the per-plan
    # EXECUTE telemetry rings.
    prev_record = {v: p.record_starts for v, p in plans.items()}
    for p in plans.values():
        p.record_starts = False
    try:
        with TRACER.span("measure_bursts", "init.autotune",
                         arms=sorted(arms), bursts=bursts, iters=iters):
            times = breakeven.measure_arms(arms, iters=iters, warmup=warmup,
                                           bursts=bursts)

        # Adaptive refinement: when the top two candidates land within 25%
        # the first (short) round cannot rank them reliably on a noisy
        # host, so they get a second round at double the budget and the
        # minimum of both rounds decides.  A clear winner skips the rerun.
        ranked = sorted(times, key=times.get)
        if len(ranked) > 1 and times[ranked[1]] < 1.25 * times[ranked[0]]:
            finalists = {v: arms[v] for v in ranked[:2]}
            INIT_STATS.bump("autotune_bursts",
                            max(bursts, 6) * len(finalists))
            with TRACER.span("measure_bursts_refine", "init.autotune",
                             arms=ranked[:2], bursts=max(bursts, 6)):
                refined = breakeven.measure_arms(
                    finalists, iters=2 * iters, warmup=warmup,
                    bursts=max(bursts, 6))
            for v, t in refined.items():
                times[v] = min(times[v], t)
    finally:
        for v, p in plans.items():
            p.record_starts = prev_record[v]

    best = min(times, key=times.get)
    best_variant, best_codec = _split_arm(best)
    # Eq. 1-3 applied to the *decision*: the sweep is the one-time INIT cost
    # and the per-epoch saving is best-vs-runner-up, so n_amortize is how
    # many epochs until measuring beat just picking the second-best variant.
    sweep_seconds = time.perf_counter() - t_sweep0
    ranked = sorted(times, key=times.get)
    delta = (times[ranked[1]] - times[ranked[0]]) if len(ranked) > 1 else 0.0
    choice = {"variant": best_variant,
              "codec": best_codec,
              "times": {v: float(t) for v, t in times.items()},
              "breakeven": {
                  "sweep_seconds": float(sweep_seconds),
                  "t_best": float(times[best]),
                  "t_second": float(times[ranked[1]]) if len(ranked) > 1
                  else float(times[best]),
                  # None = the sweep never amortizes (tie / single
                  # candidate); JSON-strict (no Infinity).
                  "n_amortize": (int(math.ceil(sweep_seconds / delta))
                                 if delta > 0 else None)}}
    if sweep_codecs:
        # Eq. 3 per (pattern, codec): the per-epoch saving of each codec's
        # best arm over the best identity arm, and how many epochs until
        # the sweep cost amortizes against shipping identity bytes.
        per_codec: dict[str, float] = {}
        for arm, t in times.items():
            _, cdc = _split_arm(arm)
            per_codec[cdc] = min(per_codec.get(cdc, float("inf")), t)
        choice["codec_fits"] = breakeven.codec_fits(per_codec, sweep_seconds)
    if annotate:
        choice.update(annotate)
    if TRACER.enabled:
        TRACER.emit_span("autotune_sweep", "init.autotune",
                         t_sweep0, t_sweep0 + sweep_seconds,
                         {"winner": best, "arms": len(plans),
                          "codecs": sweep_codecs})
    cache.auto_choices[key] = choice
    if store is not None:
        try:
            store.put_auto(auto_sig, choice, mesh.device)
        except OSError:
            pass                          # best-effort, same rule as put_plan
    plan = plans[best]
    plan.auto_choice = choice
    EXEC_TELEMETRY.record_fit(plan.signature.digest, choice["breakeven"])
    return plan


def _split_arm(key: str) -> tuple[str, str]:
    """"variant@codec" -> (variant, codec); bare variants are identity."""
    variant, _, cdc = key.partition("@")
    return variant, (cdc or "identity")


def _candidate_spec(spec: AlltoallvSpec, variant: str,
                    codec: str = "identity") -> AlltoallvSpec:
    kw = {}
    if spec.pack_impl == "fused" and (
            variant in ("lock", "ragged")
            or (variant == "fence" and len(spec.axis) != 1)):
        # The fused kernel exists for the fence epoch (single axis) and the
        # hierarchy leader stage; other candidates use the kernel gather
        # (ragged bypasses pack entirely, but its spec must still validate).
        kw["pack_impl"] = "pallas"
    if spec.hier_leader_perm is not None and variant != "fence_hierarchy":
        # A leader permutation is a hierarchy-only dimension; flat
        # candidates of the same pattern must not carry (or key on) it.
        kw["hier_leader_perm"] = None
    return dataclasses.replace(spec, variant=variant, codec=codec, **kw)
