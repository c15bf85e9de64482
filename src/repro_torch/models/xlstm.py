"""xLSTM blocks (port of ``repro.models.xlstm``): mLSTM (matrix memory,
chunkwise-parallel) and sLSTM (scalar memory with recurrent gate
connections, a sequential scan).

Follows arXiv:2405.04517 as the JAX package does: mLSTM blocks up-project
(up-proj -> q/k/v + exponential gating -> matrix memory -> down-proj);
sLSTM blocks keep the state at d_model with per-head recurrent weights.
The sLSTM's ``jax.lax.scan`` is a Python loop over the sequence here.
Caches: mLSTM ``{"c", "n", "m"}``, sLSTM ``{"c", "n", "h", "m"}``, all
float32, ``m`` starting at -1e30; the prefill and decode functions return
new caches, which ``transformer.apply_stack`` copies into their stacked
slots.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.sharding import ScopedFactory, normal_init, zeros_init
from . import scan_utils


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_dims(d_model: int, n_heads: int, proj_factor: float,
                qk_dim_factor: float) -> tuple[int, int, int]:
    d_up = int(d_model * proj_factor)
    d_up -= d_up % n_heads
    dk = int(d_up * qk_dim_factor) // n_heads
    return d_up, dk, d_up // n_heads


def init_mlstm(f: ScopedFactory, d_model: int, n_heads: int,
               proj_factor: float, qk_dim_factor: float) -> None:
    d_up, dk, dv = _mlstm_dims(d_model, n_heads, proj_factor, qk_dim_factor)
    std = d_model ** -0.5
    f.param("w_up", (d_model, 2 * d_up), ("embed", "d_inner"), normal_init(std))
    su = d_up ** -0.5
    f.param("wq", (d_up, n_heads, dk), ("d_inner", "heads", "head_dim"), normal_init(su))
    f.param("wk", (d_up, n_heads, dk), ("d_inner", "heads", "head_dim"), normal_init(su))
    f.param("wv", (d_up, n_heads, dv), ("d_inner", "heads", "head_dim"), normal_init(su))
    f.param("w_if", (d_up, 2 * n_heads), ("d_inner", "heads"), normal_init(su))
    f.param("b_if", (2 * n_heads,), ("heads",), zeros_init())
    f.param("w_down", (d_up, d_model), ("d_inner", "embed"), normal_init(su))


def _mlstm_qkv(params: dict, u: torch.Tensor, eq: str):
    dtype = u.dtype
    q = torch.einsum(eq, u, params["wq"].to(dtype))
    k = torch.einsum(eq, u, params["wk"].to(dtype))
    v = torch.einsum(eq, u, params["wv"].to(dtype))
    gates = u @ params["w_if"].to(dtype) + params["b_if"].to(dtype)
    log_i, f_pre = gates.chunk(2, dim=-1)              # [..., H]
    return q, k, v, log_i, f_pre


def apply_mlstm(params: dict, x: torch.Tensor, *, n_heads: int,
                chunk: int = 128, return_cache: bool = False):
    b, s, _ = x.shape
    up = x @ params["w_up"].to(x.dtype)
    u, z = up.chunk(2, dim=-1)                          # [B,S,d_up]
    q, k, v, log_i, f_pre = _mlstm_qkv(params, u, "bsu,uhd->bshd")
    log_f = F.logsigmoid(f_pre.float()).to(x.dtype)
    scan_out = scan_utils.chunkwise_mlstm(q, k, v, log_i, log_f, chunk=chunk,
                                          return_final_state=return_cache)
    y, final = scan_out if return_cache else (scan_out, None)
    y = y.reshape(b, s, -1)                             # [B,S,d_up]
    y = y * F.silu(z)
    out = y @ params["w_down"].to(x.dtype)
    if return_cache:
        c, n, m = final
        return out, {"c": c, "n": n, "m": m}
    return out


def init_mlstm_cache(b: int, d_model: int, n_heads: int, proj_factor: float,
                     qk_dim_factor: float, dtype=None, device=None) -> dict:
    """``dtype`` is unused (the state is float32), as in the JAX package."""
    _, dk, dv = _mlstm_dims(d_model, n_heads, proj_factor, qk_dim_factor)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((b, n_heads, dk, dv), **f32),
            "n": torch.zeros((b, n_heads, dk), **f32),
            "m": torch.full((b, n_heads), -1e30, **f32)}


def mlstm_decode_step(params: dict, cache: dict, x: torch.Tensor, *,
                      n_heads: int) -> tuple[torch.Tensor, dict]:
    """x: [B, 1, D]."""
    b = x.shape[0]
    up = x[:, 0] @ params["w_up"].to(x.dtype)
    u, z = up.chunk(2, dim=-1)
    q, k, v, log_i, f_pre = _mlstm_qkv(params, u, "bu,uhd->bhd")
    log_f = F.logsigmoid(f_pre.float())
    (c, n, m), y = scan_utils.mlstm_decode_step(
        (cache["c"], cache["n"], cache["m"]), q, k, v, log_i, log_f)
    y = y.reshape(b, -1) * F.silu(z)
    out = (y @ params["w_down"].to(x.dtype))[:, None]
    return out, {"c": c, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(f: ScopedFactory, d_model: int, n_heads: int) -> None:
    dh = d_model // n_heads
    std = d_model ** -0.5
    # gates: i, f, z, o
    f.param("w_gates", (d_model, 4, n_heads, dh), ("embed", None, "heads", "head_dim"),
            normal_init(std))
    f.param("r_gates", (4, n_heads, dh, dh), (None, "heads", "head_dim", None),
            normal_init(dh ** -0.5))
    f.param("b_gates", (4, n_heads, dh), (None, "heads", "head_dim"), zeros_init())
    f.param("w_out", (d_model, d_model), ("embed", "embed"), normal_init(std))


def _slstm_cell(params, state, gx):
    """One step. state: (c, n, h, m) each [B, H, dh] fp32; gx: [B, 4, H, dh]."""
    c, n, h, m = state
    rec = torch.einsum("bhd,ghde->bghe", h, params["r_gates"].to(h.dtype))
    g = gx + rec + params["b_gates"].to(h.dtype)
    gi, gf, gz, go = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    log_i = gi.float()
    log_f = F.logsigmoid(gf.float())
    m_new = torch.maximum(log_f + m, log_i)
    i_w = torch.exp(log_i - m_new)
    f_w = torch.exp(log_f + m - m_new)
    z = torch.tanh(gz.float())
    o = torch.sigmoid(go.float())
    c_new = f_w * c + i_w * z
    n_new = f_w * n + i_w
    h_new = o * c_new / torch.maximum(n_new, n_new.new_tensor(1e-6))
    return (c_new, n_new, h_new, m_new), h_new


def apply_slstm(params: dict, x: torch.Tensor, *, n_heads: int,
                return_cache: bool = False):
    b, s, d = x.shape
    dh = d // n_heads
    gx = torch.einsum("bsd,dghe->bsghe", x, params["w_gates"].to(x.dtype))
    zeros = torch.zeros((b, n_heads, dh), dtype=torch.float32, device=x.device)
    state = (zeros, zeros, zeros, torch.full_like(zeros, -1e30))
    hs = []
    for t in range(s):
        state, h = _slstm_cell(params, state, gx[:, t])
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    out = y @ params["w_out"].to(x.dtype)
    if return_cache:
        c, n, h, m = state
        return out, {"c": c, "n": n, "h": h, "m": m}
    return out


def init_slstm_cache(b: int, d_model: int, n_heads: int, device=None) -> dict:
    dh = d_model // n_heads
    z = torch.zeros((b, n_heads, dh), dtype=torch.float32, device=device)
    return {"c": z, "n": z.clone(), "h": z.clone(),
            "m": torch.full_like(z, -1e30)}


def slstm_decode_step(params: dict, cache: dict, x: torch.Tensor, *,
                      n_heads: int) -> tuple[torch.Tensor, dict]:
    b, _, d = x.shape
    gx = torch.einsum("bd,dghe->bghe", x[:, 0], params["w_gates"].to(x.dtype))
    state = (cache["c"], cache["n"], cache["h"], cache["m"])
    (c, n, h, m), h_out = _slstm_cell(params, state, gx)
    y = h_out.reshape(b, d).to(x.dtype) @ params["w_out"].to(x.dtype)
    return y[:, None], {"c": c, "n": n, "h": h, "m": m}
