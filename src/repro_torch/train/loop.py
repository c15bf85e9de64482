"""Training loop: checkpoint/restart fault tolerance, straggler detection,
auto-resume and deterministic data replay (port of ``repro.train.loop``).
Step wall times feed the EP dispatch plan's telemetry ring, as in JAX.

Not ported yet (ROADMAP.md item 18, resilience): online re-planning
(``replan``, ``replan_at``, the skew monitor and the leader re-bake) and
chaos injection; asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import torch

from .._tree import tree_map
from ..ckpt.manager import CheckpointManager
from ..ckpt.reshard import put_tree
from ..configs.base import torch_dtype
from ..core.plan import not_ported
from ..data.pipeline import DataPipeline
from ..models import api as model_api
from ..obs.spans import TRACER
from ..runtime.fault import RetryPolicy, run_with_recovery
from ..runtime.straggler import StragglerDetector
from . import optimizer as opt_mod

log = logging.getLogger("repro_torch.train")

_RESILIENCE = "item 18, resilience"


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
    # Online re-planning of the EP dispatch plan: not ported (item 18),
    # asking for it raises.
    replan: bool = False
    replan_at: Optional[int] = None


class Trainer:
    """Owns device state and the recovery discipline around a train
    ``StepBundle`` (``launch.steps.make_train_bundle``)."""

    def __init__(self, bundle, tcfg: TrainerConfig, chaos=None):
        if chaos is not None:
            raise not_ported("chaos injection in the trainer", _RESILIENCE)
        if tcfg.replan or tcfg.replan_at is not None:
            raise not_ported("online re-planning of the EP dispatch plan",
                             _RESILIENCE)
        self.bundle = bundle
        self.tcfg = tcfg
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

    def _backing_a2a(self):
        return getattr(self.moe_plan, "a2a", None) \
            if self.moe_plan is not None else None

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
        step, trees, extras = self.ckpt.load()
        dev = self.mesh.device
        self.opt_state = put_tree(trees["opt"], dev, out=self.opt_state)
        if "params" in trees:
            self.params = put_tree(trees["params"], dev, out=self.params)
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
        self.straggler.start()
        t_step0 = time.perf_counter()
        batch = self.pipe.batch_at(step)
        self.params, self.opt_state, metrics = self.bundle(
            self.params, self.opt_state, batch, step)
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
            # self-time; the step wall time is the epoch-level signal.
            a2a.record_epoch(self.straggler.last_seconds, t_end=t_step1)
            rank_seconds = self._probe_rank_times()
            if rank_seconds:
                a2a.record_epoch_ranks(rank_seconds)
        if (step + 1) % self.tcfg.ckpt_every == 0 or \
                (self.straggler.should_checkpoint_early()
                 and self.ckpt is not None):
            self._save(step + 1)
        return out

    def _probe_rank_times(self) -> "dict[int, float] | None":
        """Per-rank step completion times for the rank rings.  The JAX
        loop waits on each device's shard in turn; on one card every
        virtual rank runs on one stream and finishes with the step, so
        there is nothing to tell the ranks apart: None."""
        return None

    def _rebuild_bundle(self) -> None:
        """Rebuild the step bundle in place (same cfg, shape and mesh): a
        device-loss-class failure's path to fresh plans between steps.
        Params and optimizer state survive untouched."""
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

    def close(self) -> None:
        """Teardown: drain the async checkpoint writer (idempotent)."""
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
                "chaos": None,
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
