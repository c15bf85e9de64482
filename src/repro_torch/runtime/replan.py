"""Online re-planning: observed degradation → background re-autotune →
atomic hot-swap, plus elastic-mesh plan resharding (port of
``repro.runtime.replan``).

A persistent plan amortizes its INIT cost across many epochs — but the
variant decision it amortizes was measured ONCE, on the fleet as it was at
INIT time.  Two things invalidate it mid-run:

* **A degraded host.**  A slow NIC or thermally throttled chip perturbs
  exactly the fence/lock/hierarchy break-even the autotuner measured.
  ``ReplanManager`` closes the loop with a graceful-degradation *ladder*,
  one rung per sustained-skew trigger:

  0. **Leader re-bake** (hierarchy plans with a blamed rank): re-elect the
     per-group leaders around the slow rank (``runtime.leader``'s
     health-weighted cost model), re-bake the two-stage schedule with the
     new permutation, and hot-swap it in.  Pure host work — one schedule
     bake, zero measurement bursts — so it is far cheaper than a sweep.
  1. **Re-autotune**: ``autotune_variant(force_measure=True)`` in a
     background thread, measuring in a *sandbox* ``PlanCache`` with its
     own ``WindowCache`` so the sweep never writes the live plan's window
     under an in-flight epoch.  On a card the sandbox's arms run on a
     stream of their own, and each timed call waits on that stream only:
     the sweep neither waits on the live epochs nor is timed with them.
  2. **Degrade-to-fence**: stop tuning and install the paper's safe
     default.

  Every rung hot-swaps between epochs: the manager's ``plan`` flips
  atomically under a lock, the old plan's window slots, device tables and
  K1 run tables are released (``free()``), the swap is logged to ``EXEC_TELEMETRY``, and the verdict
  (or re-election provenance) is CAS-merged into the plan store
  (``put_auto``) — one replica's degradation teaches the fleet.  After a
  swap the manager compares the new plan's earned baseline against the
  pre-skew one: recovery re-arms the ladder at rung 0, a still-degraded
  baseline escalates to the next rung.  If the autotuner *itself* faults
  mid-re-plan, the manager degrades to ``fence`` rather than keep a stale
  auto decision.

* **A changed mesh.**  Losing (or gaining) a pod invalidates every plan's
  geometry outright.  ``reshard_plans`` replays the INIT requests captured
  at build time (``capture_init_requests``) against the new mesh:
  count matrices are block-summed (shrink) or evenly split (grow) onto the
  new rank count, variants that need a dropped axis degrade, and the
  replay publishes warm artifacts for the new geometry — paired with
  ``ckpt.reshard.load_to_mesh`` this is the whole elastic-resume story:
  lose a pod, restore the checkpoint on the smaller mesh, rebuild every
  plan warm.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
from typing import Optional

import numpy as np
import torch

from ..core import PlanCache
from ..core._exec_stats import EXEC_TELEMETRY
from ..core.autotune import _candidate_spec, autotune_variant, \
    decision_signature
from ..obs.spans import TRACER
from . import leader as leader_mod
from .straggler import PlanSkewMonitor, SkewReport

log = logging.getLogger("repro_torch.replan")


def _sandbox_stream(device):
    """A CUDA stream of the sweep's own on a card (the measurement's
    ``_block`` waits on the current stream only); nothing on the CPU,
    where every call is synchronous."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device))


def reautotune(plan, mesh, store=None, iters: int = 8,
               embeddable: bool = False, error_tol: float | None = None,
               annotate: dict | None = None) -> dict:
    """Re-measure the variant decision for ``plan``'s pattern in a sandbox
    and return the fresh choice dict.

    The sweep runs in a throwaway ``PlanCache`` (own ``WindowCache``): the
    live plan keeps dispatching epochs while candidates are measured, and a
    shared window would be written by both sides at once.  On a card the
    sweep runs on a stream of its own (``_sandbox_stream``).  The sandbox's
    plans (their windows, tables and run tables) are freed before
    returning; the verdict is published to ``store`` by
    ``autotune_variant`` itself (CAS-merged, so concurrent publishes from
    other replicas survive)."""
    sandbox = PlanCache()
    try:
        with _sandbox_stream(mesh.device):
            winner = autotune_variant(plan.spec, mesh, sandbox, iters=iters,
                                      store=store, embeddable=embeddable,
                                      error_tol=error_tol, force_measure=True,
                                      annotate=annotate)
            return dict(winner.auto_choice)
    finally:
        for p in sandbox._plans.values():
            p.free()


class ReplanManager:
    """Owns one live plan and the observe → re-measure → swap loop.

    Drive it from the epoch loop::

        out = mgr.plan.start(x); mgr.plan.wait(out)
        mgr.plan.record_epoch(dt)      # or rely on start()'s dispatch timing
        mgr.observe()                  # between epochs; swaps land here

    ``observe()`` is the only place the live plan changes, and the caller
    controls when it runs — so a swap can never land mid-epoch.
    """

    def __init__(self, plan, mesh, cache: PlanCache, store=None,
                 monitor: Optional[PlanSkewMonitor] = None, iters: int = 8,
                 embeddable: bool = False, error_tol: float | None = None,
                 background: bool = True):
        self._plan = plan
        self.mesh = mesh
        self.cache = cache
        self.store = store
        self.iters = iters
        self.embeddable = embeddable
        self.error_tol = error_tol
        self.background = background
        self.monitor = monitor if monitor is not None else PlanSkewMonitor(
            EXEC_TELEMETRY.ring(plan.signature.digest),
            digest=plan.signature.digest)
        self.events: list[dict] = []
        self.replans_completed = 0
        self.leader_rebakes = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[tuple] = None   # (new_plan, reason)
        # Escalation ladder position: 0 = leader re-bake, 1 = re-autotune,
        # 2 = degrade-to-fence, 3 = exhausted.  Advanced per trigger,
        # re-armed to 0 when a swap's earned baseline shows recovery.
        self._ladder_stage = 0
        # Pre-skew baseline to judge the next swap's recovery against.
        self._expect_baseline: Optional[float] = None

    @property
    def plan(self):
        with self._lock:
            return self._plan

    # -- the loop ------------------------------------------------------------
    def observe(self) -> bool:
        """Call between epochs.  Returns True when a swap was installed."""
        if self._thread is not None:
            if self._thread.is_alive():
                return False            # re-measure still running
            self._thread = None
        if self._pending is not None:
            new_plan, reason = self._pending
            self._pending = None
            self.replans_completed += 1
            return self._install(new_plan, reason)
        rep = self.monitor.observe()
        if rep is not None:
            self.trigger(rep)
            return False
        if self._expect_baseline is not None \
                and self.monitor.baseline is not None:
            # The post-swap plan has earned its own baseline: judge the
            # swap against the pre-skew one.  Recovery re-arms the ladder
            # at the cheapest rung; a still-degraded baseline escalates —
            # the cloned monitor alone cannot, since it normalizes to the
            # degraded level it baselined on.
            expect, self._expect_baseline = self._expect_baseline, None
            post = self.monitor.baseline
            if expect > 0 and post > self.monitor.threshold * expect:
                self.trigger({"kind": "unrecovered",
                              "baseline_s": expect,
                              "post_swap_baseline_s": post,
                              "ratio": post / expect})
            else:
                self._ladder_stage = 0
                self.events.append({"event": "recovered",
                                    "baseline_s": expect,
                                    "post_swap_baseline_s": post})
        return False

    def trigger(self, rep: "SkewReport | dict | str") -> None:
        """Advance the ladder one rung (monitor-triggered or forced).

        Rung 0 — leader re-bake — only engages for a hierarchy plan whose
        skew names a ``worst_rank`` and whose re-election would actually
        lower the modeled bottleneck; otherwise the trigger falls through
        to the re-autotune rung immediately.  Past the fence rung, triggers
        only re-baseline the monitor (we're already on the safe default).
        """
        if self._thread is not None or self._pending is not None:
            return                      # one re-plan in flight at a time
        if isinstance(rep, SkewReport):
            reason = {"kind": "sustained_skew", "ratio": rep.ratio,
                      "baseline_s": rep.baseline,
                      "recent_mean_s": rep.recent_mean,
                      "windows_hot": rep.windows_hot, "epoch": rep.epoch,
                      "worst_rank": rep.worst_rank,
                      "worst_rank_ratio": rep.worst_rank_ratio}
        elif isinstance(rep, dict):
            reason = rep
        else:
            reason = {"kind": str(rep)}
        stage = self._ladder_stage
        log.warning("re-plan triggered for %s (ladder rung %d): %s",
                    self._plan.signature.digest[:12], stage, reason)
        TRACER.instant("replan_trigger", "runtime",
                       digest=self._plan.signature.digest,
                       kind=reason.get("kind"), stage=stage)
        if stage == 0:
            self._ladder_stage = 1
            perm = self._rebake_perm(reason)
            if perm is not None:
                self._run(self._leader_rebake, reason, perm)
                return
            stage = 1   # ineligible: fall through to the sweep now
        if stage == 1:
            self._ladder_stage = 2
            self._run(self._reautotune, reason)
            return
        if stage == 2:
            self._ladder_stage = 3
            self._run(self._degrade_fence, reason)
            return
        # Exhausted: already on the safe default.  Re-baseline so the
        # monitor stops re-firing every window on the degraded world.
        self.events.append({"event": "ladder_exhausted", **reason})
        self.monitor.reset()

    def force_swap(self, new_plan, reason: str = "forced") -> bool:
        """Install ``new_plan`` immediately (operator-forced swap)."""
        return self._install(new_plan, {"kind": reason})

    def close(self) -> None:
        """Shutdown path: join an in-flight background re-plan and free a
        pending-but-never-installed plan's window slots.  Without it, a
        re-plan landing after the last ``observe()`` leaks the new plan's
        window for the rest of the process.  Idempotent.  The live plan is
        NOT freed — its owner (trainer / bundle) controls its lifetime."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        pend, self._pending = self._pending, None
        if pend is not None:
            new_plan = pend[0]
            if new_plan is not None and new_plan is not self._plan:
                new_plan.free()

    # -- internals -----------------------------------------------------------
    def _run(self, fn, *args) -> None:
        if self.background:
            self._thread = threading.Thread(target=fn, args=args,
                                            daemon=True, name="repro-replan")
            self._thread.start()
        else:
            fn(*args)

    def _rebake_perm(self, reason: dict):
        """Rung-0 eligibility: a health-weighted leader permutation that
        would actually lower the modeled bottleneck, or None.

        Host-side numpy over telemetry summaries — cheap enough to run
        inline in ``trigger`` before any thread is spawned."""
        old = self._plan
        worst = reason.get("worst_rank")
        if old.spec.variant != "fence_hierarchy" or worst is None:
            return None
        health = leader_mod.rank_health(old.signature.digest, old.p)
        perm = leader_mod.choose_leader_perm(
            old.send_counts, old.p_outer, old.p_inner, health,
            exclude=(int(worst),))
        if perm == old.hier_schedule.leader_perm:
            return None                 # nothing to demote: escalate
        cur_cost = leader_mod.permutation_cost(
            old.send_counts, old.p_outer, old.p_inner,
            old.hier_schedule.leader_perm, health)
        new_cost = leader_mod.permutation_cost(
            old.send_counts, old.p_outer, old.p_inner, perm, health)
        if new_cost >= cur_cost:
            return None                 # the model says it cannot help
        return perm

    def _leader_rebake(self, reason: dict, perm) -> None:
        """Rung 0: re-elect leaders around the blamed rank and re-bake the
        two-stage schedule.  One host-side schedule bake plus a compile —
        zero measurement bursts, zero index-table bakes beyond the
        hierarchy schedule itself — which is why it sits below the full
        sandbox sweep on the ladder."""
        old = self._plan
        spec = dataclasses.replace(old.spec, hier_leader_perm=perm)
        with TRACER.span("leader_rebake_bake", "runtime",
                         digest=old.signature.digest,
                         worst_rank=reason.get("worst_rank")):
            new_plan = self.cache.get(spec, self.mesh, store=self.store)
        self.leader_rebakes += 1
        TRACER.instant("leader_rebake", "runtime",
                       old=old.signature.digest,
                       new=new_plan.signature.digest,
                       worst_rank=reason.get("worst_rank"),
                       leader_perm=[list(r) for r in perm])
        # Fleet provenance: merge the re-election into the pattern's
        # decision entry.  put_auto is a CAS conditional put, so a
        # concurrent publish from another replica is merged with, never
        # clobbered.  Keyed on the perm-free spec: the decision "use this
        # leadership for this pattern" belongs to the pattern, not to one
        # permutation's plan entry.
        base = dataclasses.replace(old.spec, hier_leader_perm=None)
        sig = decision_signature(base, self.mesh, embeddable=self.embeddable,
                                 error_tol=self.error_tol)
        choice = dict(getattr(old, "auto_choice", None)
                      or {"variant": old.spec.variant})
        choice["leader_rebake"] = {
            **reason, "kind": "leader_rebake",
            "prev_digest": old.signature.digest,
            "new_digest": new_plan.signature.digest,
            "leader_perm": [list(r) for r in perm]}
        self.cache.auto_choices[(sig, self.mesh.device)] = choice
        if self.store is not None:
            try:
                self.store.put_auto(sig, choice, self.mesh.device)
            except OSError:
                pass
        self._pending = (new_plan, {**reason, "kind": "leader_rebake",
                                    "leader_perm": [list(r) for r in perm]})

    def _degrade_fence(self, reason: dict) -> None:
        """Final rung: stop tuning, install the paper's safe default."""
        old = self._plan
        choice = {"variant": "fence", "codec": "identity",
                  "degraded": "ladder",
                  "replan": {**reason, "prev_variant": old.spec.variant}}
        spec = _candidate_spec(old.spec, "fence", "identity")
        sig = decision_signature(
            dataclasses.replace(old.spec, hier_leader_perm=None), self.mesh,
            embeddable=self.embeddable, error_tol=self.error_tol)
        self.cache.auto_choices[(sig, self.mesh.device)] = choice
        if self.store is not None:
            try:
                self.store.put_auto(sig, choice, self.mesh.device)
            except OSError:
                pass
        new_plan = self.cache.get(spec, self.mesh, store=self.store)
        TRACER.instant("degrade_fence", "runtime",
                       old=old.signature.digest,
                       new=new_plan.signature.digest)
        self._pending = (new_plan, {**reason, "kind": "degrade_fence"})

    def _reautotune(self, reason: dict) -> None:
        old = self._plan
        annotate = {"replan": {**reason, "prev_variant": old.spec.variant}}
        try:
            with TRACER.span("replan_sandbox_sweep", "runtime",
                             digest=old.signature.digest,
                             kind=reason.get("kind")):
                choice = reautotune(old, self.mesh, store=self.store,
                                    iters=self.iters,
                                    embeddable=self.embeddable,
                                    error_tol=self.error_tol,
                                    annotate=annotate)
            spec = _candidate_spec(old.spec, choice["variant"],
                                   choice.get("codec", "identity"))
        except Exception as err:  # noqa: BLE001 — a faulting autotuner must not kill the run
            # The autotuner itself faulted mid-re-plan: degrade to the
            # paper's safe default rather than keep trusting a decision we
            # have evidence is stale.
            log.warning("re-plan autotune faulted (%s); degrading to fence",
                        err)
            choice = {"variant": "fence", "codec": "identity",
                      "degraded": str(err),
                      "replan": annotate["replan"]}
            spec = _candidate_spec(old.spec, "fence", "identity")
            if self.store is not None:
                try:
                    self.store.put_auto(
                        decision_signature(old.spec, self.mesh,
                                           embeddable=self.embeddable,
                                           error_tol=self.error_tol),
                        choice, self.mesh.device)
                except OSError:
                    pass
        # Mirror the verdict into the live cache's decision tier so any
        # later auto INIT of this pattern (e.g. a bundle rebuild) resolves
        # instantly from the fresh measurement.
        sig = decision_signature(old.spec, self.mesh,
                                 embeddable=self.embeddable,
                                 error_tol=self.error_tol)
        self.cache.auto_choices[(sig, self.mesh.device)] = choice
        new_plan = self.cache.get(spec, self.mesh, store=self.store)
        new_plan.auto_choice = choice
        self._pending = (new_plan, {**annotate["replan"],
                                    "choice": choice.get("variant")})

    def _install(self, new_plan, reason: dict) -> bool:
        with self._lock:
            old = self._plan
            if new_plan is old or \
                    new_plan.signature.digest == old.signature.digest:
                # Re-measurement confirmed the incumbent: no swap, but the
                # monitor restarts with a fresh baseline — the world it
                # measured against has changed.
                # "event" is the outcome; "kind" (inside reason) stays the
                # trigger — sustained_skew / forced / operator.
                self.events.append({"event": "confirmed", **reason})
                self.monitor.reset()
                # A confirmed incumbent under real skew still needs the
                # recovery check: if the fresh baseline stays degraded,
                # escalate rather than normalize to it.
                self._expect_baseline = reason.get("baseline_s")
                return False
            self._plan = new_plan
        old.free()   # window slots, device tables and run tables dropped
        # Re-anchor the incoming plan's per-rank rings: samples recorded
        # under a previous tenure of this schedule (e.g. swapping back to
        # the round-robin digest) must not blame a rank for slab work it
        # no longer carries.
        EXEC_TELEMETRY.reset_rank_rings(new_plan.signature.digest)
        EXEC_TELEMETRY.record_swap(
            old=old.signature.digest, new=new_plan.signature.digest,
            reason=reason, variant_from=old.spec.variant,
            variant_to=new_plan.spec.variant)
        TRACER.instant("plan_hot_swap", "runtime",
                       old=old.signature.digest,
                       new=new_plan.signature.digest,
                       variant_from=old.spec.variant,
                       variant_to=new_plan.spec.variant,
                       kind=reason.get("kind"))
        self.events.append({"event": "swap",
                            "variant_from": old.spec.variant,
                            "variant_to": new_plan.spec.variant, **reason})
        self.monitor = self.monitor.clone_for(
            EXEC_TELEMETRY.ring(new_plan.signature.digest),
            digest=new_plan.signature.digest)
        self._expect_baseline = reason.get("baseline_s")
        log.warning("hot-swapped plan %s (%s) -> %s (%s)",
                    old.signature.digest[:12], old.spec.variant,
                    new_plan.signature.digest[:12], new_plan.spec.variant)
        return True


# --- elastic-mesh resharding -------------------------------------------------

def reshard_counts(counts, p_new: int) -> np.ndarray:
    """Project a PxP count matrix onto P_new ranks.

    Shrink (P % P_new == 0): consecutive blocks of g = P/P_new old ranks
    merge into one new rank; the new count is the block sum (the merged
    rank really does send/receive the union of its constituents' rows).
    Grow (P_new % P == 0): each old rank's rows split as evenly as
    possible across its g = P_new/P successors, remainder to the earliest
    (deterministic, so every replica projects identically).  Both conserve
    the matrix total.  Anything else raises — there is no principled row
    assignment between coprime rank counts."""
    c = np.asarray(counts, np.int64)
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise ValueError(f"counts must be square PxP, got {c.shape}")
    p = c.shape[0]
    p_new = int(p_new)
    if p_new <= 0:
        raise ValueError(f"p_new must be positive, got {p_new}")
    if p == p_new:
        return c.copy()
    if p % p_new == 0:
        g = p // p_new
        return c.reshape(p_new, g, p_new, g).sum(axis=(1, 3))
    if p_new % p == 0:
        g = p_new // p
        # Split each (src, dst) count over a g x g successor block: rows
        # divide over the g source successors first (even + remainder to
        # the earliest), then each successor's share divides over the g
        # destination successors the same way.
        out = np.zeros((p_new, p_new), np.int64)
        for i in range(p):
            for j in range(p):
                n = int(c[i, j])
                for a in range(g):
                    share = n // g + (1 if a < n % g else 0)
                    for b in range(g):
                        out[i * g + a, j * g + b] = \
                            share // g + (1 if b < share % g else 0)
        return out
    raise ValueError(
        f"cannot reshard {p} ranks onto {p_new}: neither divides the other")


def reshard_request(req: dict, new_mesh) -> dict:
    """Project one captured INIT request onto ``new_mesh``'s geometry.

    Axes missing from the new mesh are dropped; a hierarchy variant whose
    (outer, inner) factorization collapsed to one axis degrades to
    ``fence`` (the safe default), and a fused pack spec follows the same
    variant/axis eligibility rule the autotuner applies.  Raises
    ``ValueError`` when no axis of the request survives, or the rank
    counts don't divide (see ``reshard_counts``)."""
    axes = tuple(a for a in req["axis"] if a in new_mesh.axis_names)
    if not axes:
        raise ValueError(
            f"no axis of {tuple(req['axis'])} exists in the new mesh "
            f"(axes {tuple(new_mesh.axis_names)})")
    sizes = tuple(int(new_mesh.shape[a]) for a in axes)
    p_new = 1
    for s in sizes:
        p_new *= s
    counts = reshard_counts(np.asarray(req["send_counts"]), p_new)
    variant = req["variant"]
    if len(axes) == 1 and variant == "fence_hierarchy":
        variant = "fence"
    pack_impl = req.get("pack_impl", "jnp")
    if pack_impl == "fused" and (
            variant in ("lock", "ragged")
            or (variant == "fence" and len(axes) != 1)):
        pack_impl = "pallas"
    return {**req, "send_counts": counts.tolist(), "axis": list(axes),
            "axis_sizes": list(sizes), "variant": variant,
            "pack_impl": pack_impl,
            # Provenance for the prewarm report: which geometry this
            # pattern was projected from (and what it degraded from).
            "resharded_from": {
                "p": int(np.asarray(req["send_counts"]).shape[0]),
                "axis_sizes": [int(s) for s in req.get("axis_sizes", [])],
                "variant": req["variant"]}}


def reshard_plans(requests, new_mesh, store=None, cache=None,
                  autotune_iters: int | None = None) -> dict:
    """Replay captured INIT requests against a new mesh geometry.

    The elastic-resume prewarm: each request is projected onto the new
    mesh (``reshard_request``) and replayed through the prewarm machinery —
    cold builds publish to ``store``, so the restored replica's rebuild on
    the new mesh is warm.  Requests that cannot be projected are reported
    under ``"skipped"``, never dropped silently."""
    from ..planstore import prewarm

    cache = cache if cache is not None else PlanCache()
    rows: list[dict] = []
    skipped: list[dict] = []
    for req in prewarm.dedupe_requests(requests):
        try:
            projected = reshard_request(req, new_mesh)
        except ValueError as e:
            skipped.append({"skipped": str(e), "variant": req.get("variant"),
                            "axis": list(req.get("axis", ()))})
            continue
        row = prewarm.replay_request(
            projected, store if store is not None else False, cache=cache,
            autotune_iters=autotune_iters, device=new_mesh.device)
        (skipped if "skipped" in row else rows).append(row)
    return {"resharded": rows, "skipped": skipped}
