"""Step builders for serving: prefill and decode bundles (port of the
serving half of ``repro.launch.steps``).

A bundle holds its step callable, its MoE dispatch plan, its cache dtype
and the axis-rule profile it runs under.  The JAX package jits each step
with shardings; here a step is a plain PyTorch function, called on the
mesh's device, with the rules active so the MoE layer sees the right
expert axis.  The MoE token counts are the JAX package's: prefill plans
for ``batch/batch_ways * seq`` tokens per data shard, decode for
``_moe_tokens_per_shard`` (one token per sequence).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig, ShapeConfig, torch_dtype
from ..models import api as model_api
from ..models import transformer
from ..parallel.sharding import DECODE_RULES, DEFAULT_RULES, axis_rules, batch_ways


@dataclasses.dataclass
class StepBundle:
    name: str
    mesh: Any
    rules: dict
    step: Callable
    moe_plan: Any
    cache_dtype: torch.dtype

    def __call__(self, *args):
        with axis_rules(self.rules, self.mesh):
            return self.step(*args)


def _moe_tokens_per_shard(shape: ShapeConfig, mesh) -> int:
    # Decode only: the JAX helper's other branch sizes the train bundle.
    return max(shape.global_batch // batch_ways(shape.global_batch, mesh), 1)


def make_decode_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh) -> StepBundle:
    """One new token per sequence against caches of ``shape.seq_len``:
    ``step(params, caches, tokens [B, 1], index) -> (next [B, 1] int32,
    caches)``, caches written in place."""
    cache_dtype = torch_dtype(cfg.param_dtype)
    with axis_rules(DECODE_RULES, mesh):
        moe_plan = model_api.build_moe_plan(
            cfg, _moe_tokens_per_shard(shape, mesh), mesh)

    def decode_step(params, caches, tokens, index):
        logits, _, caches = transformer.forward(
            params, cfg, tokens, moe_plan=moe_plan, caches=caches,
            cache_index=index)
        nxt = torch.argmax(logits[:, -1].float(), -1)
        return nxt.to(torch.int32)[:, None], caches

    return StepBundle(f"decode:{cfg.name}:{shape.name}", mesh, DECODE_RULES,
                      decode_step, moe_plan, cache_dtype)


def make_prefill_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh) -> StepBundle:
    """Full-sequence prefill: ``step(params, tokens [B, S]) -> (last-token
    logits [B, V_padded], caches sized S)``."""
    b, s = shape.global_batch, shape.seq_len
    cache_dtype = torch_dtype(cfg.param_dtype)
    with axis_rules(DEFAULT_RULES, mesh):
        moe_plan = model_api.build_moe_plan(
            cfg, max(b // batch_ways(b, mesh), 1) * s, mesh)

    def prefill(params, tokens):
        caches = transformer.init_caches(cfg, b, s, cache_dtype,
                                         device=tokens.device)
        logits, _, caches = transformer.forward(
            params, cfg, tokens, moe_plan=moe_plan, caches=caches,
            cache_index=0)
        return logits[:, -1], caches

    return StepBundle(f"prefill:{cfg.name}:{shape.name}", mesh, DEFAULT_RULES,
                      prefill, moe_plan, cache_dtype)
