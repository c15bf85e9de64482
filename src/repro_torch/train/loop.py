"""Training loop: checkpoint/restart fault tolerance, straggler detection,
auto-resume and deterministic data replay, plus online re-planning (port
of ``repro.train.loop``): step wall times feed the EP dispatch plan's
EXECUTE telemetry ring, and on sustained skew (or a forced ``replan_at``
step) the hierarchy's leaders are re-elected around a slow rank, or the
variant decision is re-measured in a sandbox and the step bundle rebuilt
against the fresh verdict between steps.  A ``runtime.chaos`` injector
hooks into the timed step.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import torch

from .._tree import tree_map
from ..ckpt.manager import CheckpointManager
from ..ckpt.reshard import load_to_mesh, put_tree
from ..configs.base import torch_dtype
from ..core._exec_stats import EXEC_TELEMETRY
from ..data.pipeline import DataPipeline
from ..models import api as model_api
from ..obs.spans import TRACER
from ..runtime.fault import RetryPolicy, run_with_recovery
from ..runtime.straggler import PlanSkewMonitor, StragglerDetector
from . import optimizer as opt_mod

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainerConfig:
    n_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    async_ckpt: bool = True
    log_every: int = 10
    max_restarts: int = 3
    seed: int = 0
    # Online re-planning of the EP dispatch plan (plan-backed MoE only):
    # replan=True arms the skew monitor; replan_at forces one re-plan
    # after that step completes (a deterministic trigger for chaos runs).
    replan: bool = False
    replan_at: Optional[int] = None
    replan_threshold: float = 1.75
    replan_iters: int = 4
    # Per-rank epoch timing: probe the step's completion for each rank of
    # the dispatch plan and feed the (digest, rank) rank rings (skew
    # attribution).
    rank_timing: bool = True


class Trainer:
    """Owns device state and the recovery discipline around a train
    ``StepBundle`` (``launch.steps.make_train_bundle``)."""

    def __init__(self, bundle, tcfg: TrainerConfig, chaos=None):
        self.bundle = bundle
        self.tcfg = tcfg
        self.chaos = chaos
        self.cfg = bundle.meta["cfg"]
        self.shape = bundle.meta["shape"]
        self.mesh = bundle.mesh
        self.moe_plan = bundle.meta.get("moe_plan")
        if self._backing_a2a() is not None:
            log.info("EP dispatch plan-backed: variant=%s warm=%s "
                     "overlap_chunks=%d", self.moe_plan.variant,
                     self.moe_plan.a2a.warm_loaded,
                     self.moe_plan.overlap_chunks)
        self.pipe = DataPipeline(self.cfg, self.shape.seq_len,
                                 self.shape.global_batch, self.mesh,
                                 seed=1234 + tcfg.seed)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep,
                                       async_save=tcfg.async_ckpt)
                     if tcfg.ckpt_dir else None)
        self.straggler = StragglerDetector()
        self.params = None
        self.opt_state = None
        self.start_step = 0
        self.history: list[dict] = []
        self.replan_events: list[dict] = []
        self.recoveries: list[dict] = []
        self._saved_step: Optional[int] = None
        self._skew: Optional[PlanSkewMonitor] = None
        if tcfg.replan:
            self._arm_skew_monitor()

    def _backing_a2a(self):
        return getattr(self.moe_plan, "a2a", None) \
            if self.moe_plan is not None else None

    def _arm_skew_monitor(self) -> None:
        a2a = self._backing_a2a()
        if a2a is None:
            return
        self._skew = PlanSkewMonitor(
            EXEC_TELEMETRY.ring(a2a.signature.digest),
            threshold=self.tcfg.replan_threshold,
            window=4, sustain=2, warmup=4,
            digest=a2a.signature.digest)

    # -- state management ----------------------------------------------------
    def init_state(self) -> None:
        gen = torch.Generator(self.mesh.device).manual_seed(self.tcfg.seed)
        self.params, _ = model_api.init_model(self.cfg, gen, self.mesh.device)
        self.opt_state = opt_mod.init_opt_state(
            self.params, self.bundle.meta["adamw"],
            grad_err=self.bundle.meta.get("grad_compression", False))

    def try_resume(self) -> bool:
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        self._restore()
        return True

    def _restore(self) -> int:
        """Load the latest checkpoint; into the live state in place when
        there is one (a recovery), so the state is never held twice."""
        self.ckpt.wait()
        step, trees, extras = load_to_mesh(
            self.ckpt, self.mesh,
            out={"opt": self.opt_state, "params": self.params})
        dev = self.mesh.device
        self.opt_state = trees["opt"]
        if "params" in trees:
            self.params = trees["params"]
        else:
            # Saved once, as the fp32 master copy (see _save).
            dtype = torch_dtype(self.cfg.param_dtype)
            self.params = (tree_map(lambda m: m.to(dtype),
                                    self.opt_state["master"])
                           if self.params is None else
                           put_tree(self.opt_state["master"], dev,
                                    out=self.params))
        del trees
        self.pipe.load_state_dict(extras.get("data", {"step": step}))
        self.start_step = step
        log.info("restored checkpoint at step %d", step)
        return step

    def _save(self, step: int) -> None:
        """Checkpoint the state.  With fp32 master weights the params are
        their cast (``adamw_update`` keeps ``p == master.to(p.dtype)``, and
        ``init_opt_state`` starts it so), so the params are not written a
        second time: a checkpoint holds ``opt`` only and the restore casts
        the master copy back, bit for bit."""
        if self.ckpt is None:
            return
        trees = {"opt": self.opt_state}
        if "master" not in self.opt_state:
            trees["params"] = self.params
        self.ckpt.save(step, trees,
                       extras={"data": self.pipe.state_dict(), "step": step})
        self._saved_step = step

    # -- driving -------------------------------------------------------------
    def _run_one(self, step: int) -> dict:
        if self.chaos is not None:
            # Inside the recovery try-block: injected faults exercise the
            # real restart path, and stalls land inside the timed region so
            # the straggler and skew monitors see them.
            self.chaos.step_hook(step)
        self.straggler.start()
        t_step0 = time.perf_counter()
        batch = self.pipe.batch_at(step)
        self.params, self.opt_state, metrics = self.bundle(
            self.params, self.opt_state, batch, step)
        rank_seconds = self._probe_rank_times(metrics, t_step0)
        if self.chaos is not None and rank_seconds:
            # rank_slow, attribution side: inflate the slowed ranks' samples
            # so the skew monitor blames the right rank.
            rank_seconds = self.chaos.scale_rank_times(step, rank_seconds)
        if self.chaos is not None:
            # rank_slow, wall-time side: stall by the slow ranks' share of
            # the work done so far this step (pre-stall, so no feedback
            # loop through the EMA): the full factor while a slowed rank
            # carries leader slabs, the member share once demoted.
            self.chaos.maybe_rank_stall(step, self._carrying_ranks(),
                                        time.perf_counter() - t_step0)
        # float() waits for the step's last kernel: the JAX loop's
        # block_until_ready.
        out = {k: float(v) for k, v in metrics.items()}
        t_step1 = time.perf_counter()
        if TRACER.enabled:
            TRACER.emit_span("train_step", "execute", t_step0, t_step1,
                             {"step": step})
        report = self.straggler.stop(step)
        if report is not None:
            log.warning("straggler step %d: %.3fs (%.1fx EMA %.3fs)",
                        report.step, report.seconds, report.ratio,
                        report.ema_seconds)
        a2a = self._backing_a2a()
        if a2a is not None and self.straggler.last_seconds is not None:
            # The EP exchange runs embedded in the step, so the plan cannot
            # self-time; the step wall time is the epoch-level signal the
            # skew monitor watches.
            a2a.record_epoch(self.straggler.last_seconds, t_end=t_step1)
            if rank_seconds:
                a2a.record_epoch_ranks(rank_seconds)
        self._maybe_replan(step)
        if (step + 1) % self.tcfg.ckpt_every == 0 or \
                (self.straggler.should_checkpoint_early()
                 and self.ckpt is not None):
            self._save(step + 1)
        return out

    def _probe_rank_times(self, metrics, t0: float) -> "dict[int, float] | None":
        """Per-rank step completion times for the rank rings, keyed by the
        dispatch plan's rank numbers.

        The JAX loop blocks on each device's shard of one metric in turn
        and charges each device the time it became ready (a skyline).  On
        one card the P virtual ranks run on one stream and finish with the
        step: the probe waits for that stream once and charges every rank
        the step's time, as a host mesh gives near-uniform times in JAX.
        A slow rank stands out only where something (``runtime.chaos``'s
        ``rank_slow``) makes it."""
        a2a = self._backing_a2a()
        if not self.tcfg.rank_timing or a2a is None:
            return None
        arr = next(iter(metrics.values()), None)
        if not isinstance(arr, torch.Tensor):
            return None     # non-tensor metrics (tests with stub bundles)
        if arr.device.type == "cuda":
            torch.cuda.current_stream(arr.device).synchronize()
        seconds = time.perf_counter() - t0
        return {r: seconds for r in range(a2a.p)}

    def _carrying_ranks(self) -> "set[int] | None":
        """Ranks carrying inter-group leader slabs under the live hierarchy
        schedule (src or dst of any stage-2 put).  None means every rank
        gates the epoch: flat variants, or no plan-backed dispatch."""
        a2a = self._backing_a2a()
        sched = getattr(a2a, "hier_schedule", None) if a2a is not None else None
        if sched is None:
            return None
        return {int(r) for rnd in sched.round_perms
                for pair in rnd for r in pair}

    # -- online re-planning --------------------------------------------------
    def _maybe_replan(self, step: int) -> None:
        a2a = self._backing_a2a()
        if a2a is None:
            return
        forced = (self.tcfg.replan_at is not None
                  and step == self.tcfg.replan_at
                  and not any(ev.get("kind") == "forced"
                              for ev in self.replan_events))
        skew = self._skew.observe() if self._skew is not None else None
        if not forced and skew is None:
            return
        if not forced and self._try_leader_rebake(step, skew):
            return
        from .. import planstore
        from ..core import global_plan_cache
        from ..core.autotune import decision_signature
        from ..runtime import replan as replan_mod
        if forced:
            reason = {"kind": "forced", "step": step}
        else:
            reason = {"kind": "sustained_skew", "step": step,
                      "ratio": skew.ratio, "baseline_s": skew.baseline}
        error_tol = getattr(self.cfg.moe, "codec_tol", None) \
            if getattr(self.cfg, "moe", None) is not None else None
        TRACER.instant("replan_trigger", "runtime",
                       digest=a2a.signature.digest, kind=reason["kind"],
                       step=step)
        t0 = time.perf_counter()
        store = planstore.default_store()
        prev_variant = self.moe_plan.variant
        try:
            choice = replan_mod.reautotune(
                a2a, self.mesh, store=store, iters=self.tcfg.replan_iters,
                embeddable=True, error_tol=error_tol,
                annotate={"replan": {**reason,
                                     "prev_variant": prev_variant}})
        except Exception as err:  # noqa: BLE001 — a faulting autotuner must not kill training
            log.warning("re-plan autotune faulted (%s); degrading EP "
                        "dispatch decision to fence", err)
            choice = {"variant": "fence", "codec": "identity",
                      "degraded": str(err), "replan": reason}
        # Seed the live decision tier so the bundle rebuild (and any other
        # replica reading the store) resolves instantly from this verdict.
        live = global_plan_cache()
        live.auto_choices[(decision_signature(
            a2a.spec, self.mesh, embeddable=True,
            error_tol=error_tol), self.mesh.device)] = choice
        swapped = False
        if choice["variant"] != prev_variant and \
                getattr(self.cfg.moe, "a2a_variant", None) == "auto":
            old_digest = a2a.signature.digest
            self._rebuild_bundle()
            new_a2a = self._backing_a2a()
            swapped = new_a2a is not None and \
                new_a2a.signature.digest != old_digest
            if swapped:
                # _rebuild_bundle already freed the old plan and re-anchored
                # the incoming plan's rank rings.
                EXEC_TELEMETRY.record_swap(
                    old=old_digest, new=new_a2a.signature.digest,
                    reason=reason, variant_from=prev_variant,
                    variant_to=self.moe_plan.variant)
                TRACER.instant("plan_hot_swap", "runtime",
                               old=old_digest,
                               new=new_a2a.signature.digest,
                               variant_from=prev_variant,
                               variant_to=self.moe_plan.variant,
                               kind=reason["kind"])
        elif self._skew is not None:
            self._skew.reset()   # incumbent confirmed: fresh baseline
        ev = {**reason, "variant_from": prev_variant,
              "variant_to": choice["variant"], "swapped": swapped,
              "seconds": time.perf_counter() - t0}
        self.replan_events.append(ev)
        log.warning("re-plan at step %d: %s -> %s (swapped=%s, %.2fs)",
                    step, prev_variant, choice["variant"], swapped,
                    ev["seconds"])

    def _try_leader_rebake(self, step: int, skew) -> bool:
        """Ladder rung 0: demote the blamed rank out of leadership.

        Hierarchy plans with a ``worst_rank`` attribution get a cheap
        health-weighted leader re-election first (``runtime.leader``):
        host-side schedule bake and a rebuilt bundle, zero measurement
        bursts.  The full sandbox re-autotune only runs when re-election
        is ineligible or the cost model says it cannot lower the
        bottleneck."""
        a2a = self._backing_a2a()
        worst = getattr(skew, "worst_rank", None)
        if a2a is None or a2a.spec.variant != "fence_hierarchy" \
                or worst is None:
            return False
        from ..runtime import leader as leader_mod
        health = leader_mod.rank_health(a2a.signature.digest, a2a.p)
        perm = leader_mod.choose_leader_perm(
            a2a.send_counts, a2a.p_outer, a2a.p_inner, health,
            exclude=(int(worst),))
        if perm == a2a.hier_schedule.leader_perm:
            return False
        cur_cost = leader_mod.permutation_cost(
            a2a.send_counts, a2a.p_outer, a2a.p_inner,
            a2a.hier_schedule.leader_perm, health)
        new_cost = leader_mod.permutation_cost(
            a2a.send_counts, a2a.p_outer, a2a.p_inner, perm, health)
        if new_cost >= cur_cost:
            return False
        reason = {"kind": "leader_rebake", "step": step,
                  "ratio": skew.ratio, "baseline_s": skew.baseline,
                  "worst_rank": int(worst),
                  "worst_rank_ratio": skew.worst_rank_ratio}
        t0 = time.perf_counter()
        old_digest = a2a.signature.digest
        prev_variant = self.moe_plan.variant
        # Persist the election in bundle_kwargs so recovery rebuilds (and
        # any later re-plan's rebuild) keep the demotion.
        self.bundle.meta["bundle_kwargs"]["hier_leader_perm"] = perm
        self._rebuild_bundle()
        new_a2a = self._backing_a2a()
        if new_a2a is None or new_a2a.signature.digest == old_digest:
            return False     # identity election resolved back: escalate
        EXEC_TELEMETRY.record_swap(
            old=old_digest, new=new_a2a.signature.digest, reason=reason,
            variant_from=prev_variant, variant_to=self.moe_plan.variant)
        TRACER.instant("leader_rebake", "runtime", old=old_digest,
                       new=new_a2a.signature.digest, worst_rank=int(worst),
                       leader_perm=[list(r) for r in perm])
        ev = {**reason, "variant_from": prev_variant,
              "variant_to": self.moe_plan.variant, "swapped": True,
              "leader_perm": [list(r) for r in perm],
              "seconds": time.perf_counter() - t0}
        self.replan_events.append(ev)
        log.warning("leader re-bake at step %d: demoted rank %d "
                    "(%s -> %s, %.2fs)", step, int(worst), old_digest[:12],
                    new_a2a.signature.digest[:12], ev["seconds"])
        return True

    def _rebuild_bundle(self) -> None:
        """Rebuild the step bundle in place (same cfg, shape and mesh): the
        path a changed variant decision or leader election, or a
        device-loss-class failure, takes to fresh plans between steps.
        Params and optimizer state survive untouched.  When the rebuild
        lands on a *different* backing plan, the replaced plan's window
        slots, device tables and run tables are released, the incoming
        plan's per-rank rings are re-anchored (stale samples from the old
        schedule must not blame a now-demoted rank) and the skew monitor is
        re-armed on the incoming plan's ring."""
        from ..launch import steps as steps_mod
        old_a2a = self._backing_a2a()
        kw = dict(self.bundle.meta.get("bundle_kwargs") or {})
        self.bundle = steps_mod.make_train_bundle(
            self.cfg, self.shape, self.mesh, **kw)
        self.moe_plan = self.bundle.meta.get("moe_plan")
        new_a2a = self._backing_a2a()
        if old_a2a is not None and new_a2a is not None \
                and new_a2a is not old_a2a:
            old_a2a.free()
            EXEC_TELEMETRY.reset_rank_rings(new_a2a.signature.digest)
        if self._skew is not None:
            self._arm_skew_monitor()

    def close(self) -> None:
        """Teardown: drain the async checkpoint writer.  The trainer's
        re-plans run synchronously inside ``_maybe_replan`` (no background
        thread to join: the ``ReplanManager.close()`` analogue for
        manager-driven loops), so this is idempotent and safe to call
        after a faulted run."""
        if self.ckpt is not None:
            self.ckpt.wait()

    def run(self, failure_hook: Optional[Callable[[int], None]] = None) -> dict:
        if self.params is None and not self.try_resume():
            self.init_state()
            self._save(0)

        def on_metrics(step: int, metrics: dict):
            self.history.append({"step": step, **metrics})
            if step % self.tcfg.log_every == 0:
                log.info("step %d  %s", step,
                         "  ".join(f"{k}={v:.4f}" for k, v in metrics.items()))

        def rebuild_plans(err: Exception):
            # Device-loss class: the plan's window and tables are device
            # state the checkpoint does not cover.
            if self._backing_a2a() is not None:
                self._rebuild_bundle()

        def on_recovery(step: int, err: Exception, kind: str):
            self.recoveries.append({"step": step, "kind": kind,
                                    "error": str(err)})

        final = run_with_recovery(
            self._run_one,
            restore=self._restore,
            start_step=self.start_step,
            n_steps=self.tcfg.n_steps - self.start_step,
            policy=RetryPolicy(max_restarts=self.tcfg.max_restarts),
            failure_hook=failure_hook,
            on_metrics=on_metrics,
            rebuild_plans=rebuild_plans,
            on_recovery=on_recovery,
        )
        # The JAX loop saves the final step unconditionally; a step the
        # cadence has just saved is not written twice.
        if self.ckpt is not None and self._saved_step != final:
            self._save(final)
        self.close()
        return {"final_step": final,
                "last_metrics": self.history[-1] if self.history else {},
                "stragglers": len(self.straggler.flagged),
                "recoveries": self.recoveries,
                "replans": self.replan_events,
                "chaos": dict(self.chaos.injected)
                if self.chaos is not None else None,
                "ep_dispatch": self.ep_dispatch_report()}

    def ep_dispatch_report(self) -> dict | None:
        """INIT provenance of the EP dispatch plan (None for non-MoE runs):
        whether it is plan-backed, which variant won, and whether the
        backing plan warm-started from the store."""
        if self.moe_plan is None:
            return None
        a2a = self._backing_a2a()
        return {
            "plan_backed": a2a is not None,
            "variant": self.moe_plan.variant,
            "codec": self.moe_plan.codec,
            "overlap_chunks": self.moe_plan.overlap_chunks,
            "warm_loaded": bool(a2a.warm_loaded) if a2a is not None else False,
            "auto_choice": getattr(a2a, "auto_choice", None)
            if a2a is not None else None,
        }
