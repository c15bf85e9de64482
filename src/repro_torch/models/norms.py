"""Normalization layers (port of ``repro.models.norms``): RMSNorm,
LayerNorm and OLMo's non-parametric LayerNorm, computed in float32 and
cast back."""

from __future__ import annotations

import torch

from ..parallel.sharding import ScopedFactory, ones_init, zeros_init


def init_norm(f: ScopedFactory, kind: str, dim: int) -> None:
    if kind == "rmsnorm":
        f.param("scale", (dim,), ("embed",), ones_init())
    elif kind == "layernorm":
        f.param("scale", (dim,), ("embed",), ones_init())
        f.param("bias", (dim,), ("embed",), zeros_init())
    elif kind == "nonparametric_ln":
        pass  # OLMo: no learnable affine
    else:
        raise ValueError(f"unknown norm {kind!r}")


def apply_norm(params: dict | None, kind: str, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    if kind == "rmsnorm":
        var = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
        return (y * params["scale"].float()).to(dtype)
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(dtype)
