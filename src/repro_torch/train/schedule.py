"""LR schedules: linear warmup into cosine, linear, or WSD
(warmup-stable-decay, MiniCPM arXiv:2404.06395).  Port of
``repro.train.schedule``: the same formulas in float32."""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "cosine"        # cosine | linear | wsd | constant
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_steps: int = 1_000    # wsd: length of the final decay phase


def lr_at(cfg: ScheduleConfig, step) -> torch.Tensor:
    """Learning rate at ``step``, a 0-d float32 tensor on the CPU (it
    enters the optimizer's arithmetic as JAX's float32 scalar does)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = (torch.clamp(step / cfg.warmup_steps, max=1.0)
            if cfg.warmup_steps > 0 else torch.tensor(1.0))
    peak = cfg.peak_lr
    floor = cfg.peak_lr * cfg.min_lr_ratio

    if cfg.kind == "constant":
        return peak * warm
    if cfg.kind == "linear":
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        return warm * (peak + (floor - peak) * frac)
    if cfg.kind == "cosine":
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        return warm * (floor + 0.5 * (peak - floor)
                       * (1 + torch.cos(math.pi * frac)))
    if cfg.kind == "wsd":
        decay_start = cfg.total_steps - cfg.decay_steps
        frac = torch.clamp((step - decay_start) / max(cfg.decay_steps, 1), 0, 1)
        # stable at peak until decay_start, then linear to floor
        return warm * (peak + (floor - peak) * frac)
    raise ValueError(cfg.kind)
