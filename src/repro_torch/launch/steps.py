"""Step builders: train, prefill and decode bundles (port of
``repro.launch.steps``).

A bundle holds its step callable, its MoE dispatch plan, its cache dtype
(serving), the axis-rule profile it runs under and, for training, the
``meta`` the trainer reads.  The JAX package jits each step with
shardings and donates the training state; here a step is a plain PyTorch
function, called on the mesh's device with the rules active, and the
training step updates the state in place under ``torch.no_grad()`` (the
stand-in for donation).  The MoE token counts are the JAX package's
(``_moe_tokens_per_shard``; prefill plans ``batch/batch_ways * seq``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .._tree import leaves, tree_map
from ..configs.base import ModelConfig, ShapeConfig, torch_dtype
from ..models import api as model_api
from ..models import transformer, vlm, whisper
from ..parallel.sharding import (DECODE_RULES, DEFAULT_RULES, axis_rules,
                                 batch_ways, resolve)
from ..train import grad as grad_util
from ..train import optimizer as opt_mod
from ..train import schedule as sched_mod


@dataclasses.dataclass
class StepBundle:
    name: str
    mesh: Any
    rules: dict
    step: Callable
    moe_plan: Any
    cache_dtype: Optional[torch.dtype] = None
    meta: dict = dataclasses.field(default_factory=dict)

    def __call__(self, *args):
        with axis_rules(self.rules, self.mesh):
            return self.step(*args)

    def trace_context(self):
        return axis_rules(self.rules, self.mesh)


def _moe_tokens_per_shard(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    # batch_ways, not the data size: a rule profile may shard batch over
    # fewer axes (hier_ep puts experts on pod), and undercounting tokens
    # would undersize the MoE capacity.  Training sizes for seq - 1 tokens
    # per sequence, as the JAX package does (the forward runs on the full
    # sequence, which fits the tile-rounded chunk when seq * batch splits
    # evenly).
    b_loc = max(shape.global_batch // batch_ways(shape.global_batch, mesh), 1)
    if shape.kind == "decode":
        return b_loc
    return b_loc * max(shape.seq_len - 1, 1)


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def shard_ways(spec: tuple, mesh) -> int:
    """Ways a partition spec shards a tensor over ``mesh``."""
    n = 1
    for axes in spec:
        if axes is None:
            continue
        for a in (axes,) if isinstance(axes, str) else axes:
            n *= int(mesh.shape[a])
    return n


def make_train_bundle(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    *,
    sched: Optional[sched_mod.ScheduleConfig] = None,
    adamw: Optional[opt_mod.AdamWConfig] = None,
    zero1: bool = True,
    remat: bool = True,
    clip_norm: float = 1.0,
    n_micro: int = 1,
    rules: Optional[dict] = None,
    fsdp_threshold_bytes: float = 3 * 2**30,
    grad_compression: bool = False,
    grad_sync: str = "default",
    hier_leader_perm=None,
) -> StepBundle:
    """One training step: ``step(params, opt_state, batch, step_index) ->
    (params, opt_state, metrics)`` with the loss (``model_api.model_loss``,
    per-layer remat), ``n_micro`` accumulation, the DP gradient sync
    (``grad_compression``: int8 + error feedback; ``grad_sync=
    "persistent_rs"``: the plan-backed RS + AG pair), global-norm clipping
    and AdamW.  ``params`` and ``opt_state`` are updated in place and
    returned.  ``meta`` carries what the JAX bundle's does, the partition
    specs as metadata (nothing is placed by them on one card)."""
    sched = sched or sched_mod.ScheduleConfig()
    adamw = adamw or opt_mod.AdamWConfig(
        master_weights=(cfg.param_dtype != "float32"))
    rules = dict(rules or DEFAULT_RULES)
    if grad_sync not in ("default", "persistent_rs"):
        raise ValueError(f"unknown grad_sync {grad_sync!r}")

    with axis_rules(rules, mesh):
        params_abs, logical_specs = model_api.init_model(
            cfg, torch.Generator("cpu"), device="meta")
        param_sh = tree_map(lambda axes, p: resolve(axes, tuple(p.shape)),
                            logical_specs, params_abs)
        tp_bytes = sum(p.numel() * p.element_size() / shard_ways(sp, mesh)
                       for p, sp in zip(leaves(params_abs), leaves(param_sh)))
        dp_axes = tuple(rules.get("batch") or ("pod", "data"))
        fsdp = tp_bytes > fsdp_threshold_bytes
        if fsdp:
            param_sh = opt_mod.opt_state_shardings(
                logical_specs, params_abs, mesh, adamw, zero1=True,
                dp_axes=dp_axes)["m"]
        opt_sh = opt_mod.opt_state_shardings(
            logical_specs, params_abs, mesh, adamw, zero1=zero1,
            dp_axes=dp_axes, grad_err=grad_compression)
        batch_abs = model_api.batch_spec(cfg, shape.global_batch, shape.seq_len)
        moe_plan = model_api.build_moe_plan(
            cfg, _moe_tokens_per_shard(cfg, shape, mesh), mesh,
            hier_leader_perm=hier_leader_perm)

        comp_sync = rs_sync = None
        if grad_sync == "persistent_rs":
            rs_sync = grad_util.persistent_rs_sync(
                mesh, dp_axes, error_feedback=grad_compression)
        elif grad_compression:
            comp_sync = grad_util.compressed_sync(mesh, dp_axes)

    def loss_fn(p, b):
        return model_api.model_loss(p, cfg, b, moe_plan=moe_plan, remat=remat)

    def train_step(params, opt_state, batch, step):
        lr = sched_mod.lr_at(sched, step)
        loss, metrics, grads = grad_util.accumulate_grads(
            loss_fn, params, batch, n_micro)
        with torch.no_grad():
            new_err = None
            if comp_sync is not None:
                grads, new_err = comp_sync(grads, opt_state["grad_err"])
            elif rs_sync is not None:
                if grad_compression:
                    grads, new_err = rs_sync(grads, opt_state["grad_err"])
                else:
                    grads = rs_sync(grads)
            grads, gn = grad_util.clip_by_global_norm(grads, clip_norm)
            del loss
            opt_mod.adamw_update(grads, opt_state, params, lr, adamw)
            if new_err is not None:
                tree_map(lambda e, n: e.copy_(n), opt_state["grad_err"],
                         new_err)
        return params, opt_state, dict(metrics, grad_norm=gn, lr=lr)

    return StepBundle(
        f"train:{cfg.name}:{shape.name}", mesh, rules, train_step, moe_plan,
        meta={"cfg": cfg, "shape": shape, "moe_plan": moe_plan,
              "param_shardings": param_sh, "opt_shardings": opt_sh,
              "batch_spec": batch_abs, "logical_specs": logical_specs,
              "fsdp": fsdp, "sched": sched, "adamw": adamw,
              "grad_compression": grad_compression, "grad_sync": grad_sync,
              # Everything needed to rebuild this bundle mid-run
              # (device-loss recovery): make_train_bundle(cfg, shape, mesh,
              # **bundle_kwargs) reproduces it.
              "bundle_kwargs": {"sched": sched, "adamw": adamw,
                                "zero1": zero1, "remat": remat,
                                "clip_norm": clip_norm, "n_micro": n_micro,
                                "rules": rules,
                                "fsdp_threshold_bytes": fsdp_threshold_bytes,
                                "grad_compression": grad_compression,
                                "grad_sync": grad_sync,
                                "hier_leader_perm": hier_leader_perm}})


# ---------------------------------------------------------------------------
# Serve
# ---------------------------------------------------------------------------


def whisper_self_len(cfg: ModelConfig) -> int:
    """The decoder's self-attention cache length (its learned positions)."""
    return min(cfg.max_seq, 448)


def make_decode_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh) -> StepBundle:
    """One new token per sequence against caches of ``shape.seq_len``:
    ``step(params, caches, tokens [B, 1], index) -> (next [B, 1] int32,
    caches)``, caches written in place.  The audio family decodes through
    ``whisper.decode`` over the primed cross caches."""
    cache_dtype = torch_dtype(cfg.param_dtype)
    with axis_rules(DECODE_RULES, mesh):
        moe_plan = model_api.build_moe_plan(
            cfg, _moe_tokens_per_shard(cfg, shape, mesh), mesh)

    def decode_step(params, caches, tokens, index):
        if cfg.family == "audio":
            logits, caches = whisper.decode(params, cfg, tokens, None,
                                            caches=caches, cache_index=index,
                                            remat=False)
        else:
            logits, _, caches = transformer.forward(
                params, cfg, tokens, moe_plan=moe_plan, caches=caches,
                cache_index=index)
        nxt = torch.argmax(logits[:, -1].float(), -1)
        return nxt.to(torch.int32)[:, None], caches

    return StepBundle(f"decode:{cfg.name}:{shape.name}", mesh, DECODE_RULES,
                      decode_step, moe_plan, cache_dtype)


def make_prefill_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh) -> StepBundle:
    """Full-sequence prefill: ``step(params, *inputs) -> (last-token logits
    [B, V_padded], caches)``.  The inputs are ``tokens [B, S]``; for the
    audio family ``frames [B, T, d_model], tokens [B, S]`` (encode, prime
    the cross caches at the frames' length, then decode the prompt); for
    the vlm family ``patches [B, N, frontend_dim], tokens [B, S - N]``
    (the projected patches prepended).  Caches are sized ``S``
    (``shape.seq_len``), Whisper's self-attention ones
    ``min(max_seq, 448)``."""
    b, s = shape.global_batch, shape.seq_len
    cache_dtype = torch_dtype(cfg.param_dtype)
    with axis_rules(DEFAULT_RULES, mesh):
        moe_plan = model_api.build_moe_plan(
            cfg, max(b // batch_ways(b, mesh), 1) * s, mesh)

    def prefill(params, *inputs):
        if cfg.family == "audio":
            frames, tokens = inputs
            enc = whisper.encode(params, cfg, frames, remat=False)
            caches = whisper.init_dec_caches(
                cfg, b, whisper_self_len(cfg), frames.shape[1], cache_dtype,
                device=tokens.device)
            caches = whisper.prime_cross_caches(params, cfg, enc, caches)
            logits, caches = whisper.decode(params, cfg, tokens, None,
                                            caches=caches, cache_index=0,
                                            remat=False)
            return logits[:, -1], caches
        extra = None
        if cfg.family == "vlm":
            patches, tokens = inputs
            extra = vlm.project_patches(params["projector"], patches)
        else:
            (tokens,) = inputs
        caches = transformer.init_caches(cfg, b, s, cache_dtype,
                                         device=tokens.device)
        logits, _, caches = transformer.forward(
            params, cfg, tokens, moe_plan=moe_plan, caches=caches,
            cache_index=0, extra_embeds=extra)
        return logits[:, -1], caches

    return StepBundle(f"prefill:{cfg.name}:{shape.name}", mesh, DEFAULT_RULES,
                      prefill, moe_plan, cache_dtype)


def make_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh, **kw) -> StepBundle:
    """Shape-kind dispatch: train_* -> train, prefill_* -> prefill,
    decode_*/long_* -> decode."""
    if shape.kind == "train":
        return make_train_bundle(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return make_prefill_bundle(cfg, shape, mesh, **kw)
    return make_decode_bundle(cfg, shape, mesh, **kw)
