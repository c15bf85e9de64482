"""GQA self-attention with RoPE, QK-norm and a KV cache (port of the
serving path of ``repro.models.attention``).

Layouts are the JAX package's: ``wq`` is ``[D, N, dh]``, ``wk``/``wv``
``[D, N_kv, dh]``, ``wo`` ``[N, dh, D]``, caches ``[B, S_max, N_kv, dh]``.
Scores are computed as ``_direct_attention`` computes them: a product in
the working dtype, softmax in float32 under the causal mask built from
positions.  The JAX package switches to a pure-JAX flash path at
``FLASH_THRESHOLD`` keys and above; that path is the same function summed
in another order and is not ported (no TPU kernel is involved), so long
contexts wait for the long-context slice (ROADMAP.md).

A cache write is in place: ``kv_cache["k"][:, i:i+S] = k`` updates the
caller's tensor (the JAX package returns a new cache), so a decode step
rewrites only its own rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.sharding import ScopedFactory, normal_init, ones_init

FLASH_THRESHOLD = 4096
NEG_INF = -1e30


def init_attention(f: ScopedFactory, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int, qk_norm: bool = False) -> None:
    std = d_model ** -0.5
    f.param("wq", (d_model, n_heads, head_dim), ("embed", "heads", "head_dim"),
            normal_init(std))
    f.param("wk", (d_model, n_kv, head_dim), ("embed", "kv_heads", "head_dim"),
            normal_init(std))
    f.param("wv", (d_model, n_kv, head_dim), ("embed", "kv_heads", "head_dim"),
            normal_init(std))
    f.param("wo", (n_heads, head_dim, d_model), ("heads", "head_dim", "embed"),
            normal_init((n_heads * head_dim) ** -0.5))
    if qk_norm:
        f.param("q_norm", (head_dim,), ("head_dim",), ones_init())
        f.param("k_norm", (head_dim,), ("head_dim",), ones_init())


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, N, dh]; positions: [S] or [B, S]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs            # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rms(x, scale, eps=1e-6):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _direct_attention(q, k, v, mask, scale):
    """q: [B,Sq,N,G,dh]  k,v: [B,Sk,N,dh]  mask: [B,Sq,Sk] or None."""
    s = torch.einsum("bqngd,bknd->bngqk", q, k).float() * scale
    if mask is not None:
        s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bngqk,bknd->bqngd", p.to(v.dtype), v)


def apply_attention(
    params: dict,
    x: torch.Tensor,                   # [B, S, D]
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    positions: torch.Tensor,           # [B, S] absolute positions of x
    causal: bool = True,
    rope_theta: Optional[float] = 10000.0,
    qk_norm: bool = False,
    kv_cache: Optional[dict] = None,   # {"k","v": [B, S_max, N_kv, dh]}
    cache_index: Optional[int] = None,  # write offset
) -> tuple[torch.Tensor, Optional[dict]]:
    b, s, _ = x.shape
    g = n_heads // n_kv
    scale = head_dim ** -0.5

    q = torch.einsum("bsd,dnh->bsnh", x, params["wq"].to(x.dtype))
    k = torch.einsum("btd,dnh->btnh", x, params["wk"].to(x.dtype))
    v = torch.einsum("btd,dnh->btnh", x, params["wv"].to(x.dtype))

    if qk_norm:
        q = _rms(q, params["q_norm"])
        k = _rms(k, params["k_norm"])
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    q = q.reshape(b, s, n_kv, g, head_dim)

    if kv_cache is not None:
        if cache_index is None:
            raise ValueError("a KV cache needs cache_index (the static "
                             "cross-attention cache is not ported)")
        kv_cache["k"][:, cache_index:cache_index + s] = k.to(kv_cache["k"].dtype)
        kv_cache["v"][:, cache_index:cache_index + s] = v.to(kv_cache["v"].dtype)
        k, v = kv_cache["k"], kv_cache["v"]
        k_pos = torch.arange(k.shape[1], device=x.device)[None].expand(b, -1)
    else:
        k_pos = positions if positions.dim() == 2 else positions[None].expand(b, -1)
    q_pos = positions if positions.dim() == 2 else positions[None].expand(b, -1)

    mask = q_pos[:, :, None] >= k_pos[:, None, :] if causal else None
    o = _direct_attention(q, k, v, mask, scale)
    o = o.reshape(b, s, n_heads, head_dim).to(x.dtype)
    y = torch.einsum("bsnh,nhd->bsd", o, params["wo"].to(x.dtype))
    return y, kv_cache
