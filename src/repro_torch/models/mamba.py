"""Mamba-1 selective-SSM block, Jamba's sequence mixer (port of
``repro.models.mamba``).

in_proj -> (x, z); causal depthwise conv on x; data-dependent (delta, B,
C); chunked selective scan (``scan_utils``); gate by silu(z); out_proj.
Decode carries ``{"conv": [B, d_conv-1, di], "ssm": [B, di, N] fp32}`` per
layer.  As in the JAX package, the prefill and decode functions return a
new cache; ``transformer.apply_stack`` copies it into its stacked slot.
Parameter names, layouts and inits are the JAX package's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel.sharding import ScopedFactory, normal_init, ones_init, zeros_init
from . import scan_utils


def d_inner(d_model: int, expand: int) -> int:
    return d_model * expand


def _dt_bias_init(gen, shape, dtype, device):
    """softplus^-1 of dt drawn log-uniform in [1e-3, 1e-1] (float32 draws)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return torch.log(torch.expm1(dt)).to(dtype)


def _a_log_init(gen, shape, dtype, device):
    """log(1..N) along the state axis (the last), broadcast over the rest."""
    n = shape[-1]
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return torch.log(a.expand(shape)).to(dtype)


def init_mamba(f: ScopedFactory, d_model: int, d_state: int, d_conv: int,
               expand: int, dt_rank: int | None) -> None:
    di = d_inner(d_model, expand)
    dtr = dt_rank if dt_rank is not None else max(1, math.ceil(d_model / 16))
    std = d_model ** -0.5
    f.param("w_in", (d_model, 2 * di), ("embed", "d_inner"), normal_init(std))
    f.param("conv_w", (d_conv, di), ("conv", "d_inner"), normal_init(d_conv ** -0.5))
    f.param("conv_b", (di,), ("d_inner",), zeros_init())
    f.param("w_x", (di, dtr + 2 * d_state), ("d_inner", None), normal_init(di ** -0.5))
    f.param("w_dt", (dtr, di), (None, "d_inner"), normal_init(dtr ** -0.5))
    f.param("dt_bias", (di,), ("d_inner",), _dt_bias_init)
    f.param("a_log", (di, d_state), ("d_inner", "state"), _a_log_init)
    f.param("d_skip", (di,), ("d_inner",), ones_init())
    f.param("w_out", (di, d_model), ("d_inner", "embed"), normal_init(di ** -0.5))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_xproj(params, xbc):
    dtr = params["w_dt"].shape[0]
    n = params["a_log"].shape[1]
    return torch.split(xbc, [dtr, n, n], dim=-1)


def _delta(params, dt_r, dtype):
    return _softplus(dt_r @ params["w_dt"].to(dtype)
                     + params["dt_bias"].to(dtype))


def apply_mamba(params: dict, x: torch.Tensor, *, d_state: int, d_conv: int,
                chunk: int = 64, return_cache: bool = False):
    """x: [B, S, D] -> [B, S, D] (training / prefill path).

    return_cache=True also returns the decode cache primed with the final
    SSM state and the conv tail (serve prefill)."""
    s = x.shape[1]
    xz = x @ params["w_in"].to(x.dtype)
    xi_raw, z = xz.chunk(2, dim=-1)                # [B, S, di]

    # causal depthwise conv along seq
    pad = F.pad(xi_raw, (0, 0, d_conv - 1, 0))
    conv = sum(pad[:, i: i + s] * params["conv_w"][i].to(x.dtype)
               for i in range(d_conv))
    xi = F.silu(conv + params["conv_b"].to(x.dtype))

    xbc = xi @ params["w_x"].to(x.dtype)
    dt_r, b_mat, c_mat = _split_xproj(params, xbc)
    delta = _delta(params, dt_r, x.dtype)
    scan_out = scan_utils.chunked_mamba_scan(
        delta, params["a_log"], b_mat, c_mat, xi, chunk=chunk,
        return_final_state=return_cache)
    y, h_end = scan_out if return_cache else (scan_out, None)
    y = y + xi * params["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    out = y @ params["w_out"].to(x.dtype)
    if return_cache:
        # last d_conv-1 raw conv inputs (zero-padded when s < d_conv-1)
        tail = pad[:, s: s + d_conv - 1]
        return out, {"conv": tail, "ssm": h_end}
    return out


def init_mamba_cache(b: int, di: int, d_state: int, d_conv: int, dtype,
                     device=None) -> dict:
    return {
        "conv": torch.zeros((b, d_conv - 1, di), dtype=dtype, device=device),
        "ssm": torch.zeros((b, di, d_state), dtype=torch.float32, device=device),
    }


def mamba_decode_step(params: dict, cache: dict, x: torch.Tensor, *,
                      d_state: int, d_conv: int) -> tuple[torch.Tensor, dict]:
    """x: [B, 1, D] single token; returns (y [B, 1, D], new cache)."""
    xz = x[:, 0] @ params["w_in"].to(x.dtype)
    xi, z = xz.chunk(2, dim=-1)                    # [B, di]

    hist = torch.cat([cache["conv"], xi[:, None]], dim=1)   # [B, d_conv, di]
    conv = torch.einsum("bkc,kc->bc", hist, params["conv_w"].to(x.dtype))
    xi_c = F.silu(conv + params["conv_b"].to(x.dtype))

    xbc = xi_c @ params["w_x"].to(x.dtype)
    dt_r, b_vec, c_vec = _split_xproj(params, xbc)
    delta = _delta(params, dt_r, x.dtype)
    h_new, y = scan_utils.mamba_decode_step(
        cache["ssm"], delta, params["a_log"], b_vec, c_vec, xi_c)
    y = y + xi_c * params["d_skip"].to(x.dtype)
    y = y * F.silu(z)
    out = (y @ params["w_out"].to(x.dtype))[:, None]
    return out, {"conv": hist[:, 1:], "ssm": h_new}
