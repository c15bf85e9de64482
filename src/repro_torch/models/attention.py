"""GQA self-attention with RoPE, QK-norm, a KV cache and the flash path
(port of ``repro.models.attention``).

Layouts are the JAX package's: ``wq`` is ``[D, N, dh]``, ``wk``/``wv``
``[D, N_kv, dh]``, ``wo`` ``[N, dh, D]``, caches ``[B, S_max, N_kv, dh]``,
queries grouped ``[B, S, N_kv, G, dh]``.  Two paths compute the same
function, switched as the JAX package switches them:

  direct  ``_direct_attention``: the scores as one product in the working
          dtype, softmax in float32 under the mask built from positions;
  flash   ``_flash_attention`` where the query length is > 1, there are
          ``FLASH_THRESHOLD`` keys or more and both lengths divide by
          their chunks (``Q_CHUNK``, ``K_CHUNK``): the JAX package's
          FlashAttention-2-style online softmax over key chunks inside
          query chunks, in float32, every tile masked by positions (fully
          masked tiles are not skipped), and a backward that recomputes
          each tile from ``(q, k, v, o, lse)`` and saves no ``[Sq, Sk]``
          tensor.

The flash path is plain PyTorch, tile by tile, as the JAX package's is
pure JAX: no Pallas kernel computes attention, so none is ported here.
It keeps the JAX path's arithmetic, quirks included: a query row whose
first key chunk is fully masked accumulates ``exp(0)`` per masked key
until a later chunk's ``alpha = exp(NEG_INF - m_new) = 0`` wipes it out,
and a row masked everywhere returns the mean of ``v``, as the direct
path's softmax over equal scores does.

A cache write is in place: ``kv_cache["k"][:, i:i+S] = k`` updates the
caller's tensor (the JAX package returns a new cache), so a decode step
rewrites only its own rows.  A cache without ``cache_index`` is static
(Whisper's cross-attention K/V, computed once at prefill): it is read, not
written, at key positions ``0..T-1``.  Cross-attention (``x_kv``) takes
its keys and values from the encoder states, applies no rope and promotes
dtypes as ``jnp.einsum`` does (Whisper's float32 encoder states against a
bf16 decoder).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.sharding import ScopedFactory, normal_init, ones_init

FLASH_THRESHOLD = 4096
Q_CHUNK = 512
K_CHUNK = 1024
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


def _promoted(*ts):
    """The tensors in their promoted dtype (JAX's promotion for a mixed
    einsum; a no-op when the dtypes agree)."""
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in ts]


def _direct_attention(q, k, v, mask, scale):
    """q: [B,Sq,N,G,dh]  k,v: [B,Sk,N,dh]  mask: [B,Sq,Sk] or None."""
    s = torch.einsum("bqngd,bknd->bngqk", *_promoted(q, k)).float() * scale
    if mask is not None:
        s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bngqk,bknd->bqngd", p.to(v.dtype), v)


def _tile_scores(qb, kb, qp, kp, causal, scale):
    """One tile's float32 scores ``[B, N, G, qc, kc]``, masked by positions."""
    s = torch.einsum("bqngd,bknd->bngqk", qb, kb).float() * scale
    if causal:
        msk = qp[:, None, None, :, None] >= kp[:, None, None, None, :]
        s = torch.where(msk, s, NEG_INF)
    return s


def _flash_fwd_impl(q, k, v, q_pos, k_pos, causal, scale):
    """o ``[B, Sq, N, G, dh]`` (q's dtype) and lse ``[B, N, G, Sq]`` (fp32)."""
    b, sq, n, g, dh = q.shape
    sk = k.shape[1]
    qc, kc = min(Q_CHUNK, sq), min(K_CHUNK, sk)
    o = torch.empty_like(q)
    lse = torch.empty((b, n, g, sq), dtype=torch.float32, device=q.device)
    for i in range(0, sq, qc):
        qb, qp = q[:, i:i + qc], q_pos[:, i:i + qc]
        m = torch.full((b, n, g, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, n, g, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, n, g, qc, dh), dtype=torch.float32,
                          device=q.device)
        for j in range(0, sk, kc):
            s = _tile_scores(qb, k[:, j:j + kc], qp, k_pos[:, j:j + kc],
                             causal, scale)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bngqk,bknd->bngqd", p, v[:, j:j + kc].float())
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        o[:, i:i + qc] = (acc / l_safe[..., None]).permute(0, 3, 1, 2, 4)
        lse[..., i:i + qc] = m + torch.log(l_safe)
    return o, lse


def _flash_bwd_impl(q, k, v, q_pos, k_pos, o, lse, do, causal, scale):
    """dq, dk, dv from the residuals, each tile's probabilities recomputed
    (the JAX package's ``_flash_bwd``: fp32 accumulators, dk and dv summed
    over query chunks in order, dq over key chunks in order)."""
    b, sq, n, g, dh = q.shape
    sk = k.shape[1]
    qc, kc = min(Q_CHUNK, sq), min(K_CHUNK, sk)
    dsum = torch.einsum("bqngd,bqngd->bngq", do.float(), o.float())
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for i in range(0, sq, qc):
        qb, qp = q[:, i:i + qc], q_pos[:, i:i + qc]
        do32 = do[:, i:i + qc].float()
        lseb, dsb = lse[..., i:i + qc], dsum[..., i:i + qc]
        dq_acc = torch.zeros((b, qc, n, g, dh), dtype=torch.float32,
                             device=q.device)
        for j in range(0, sk, kc):
            kb, vb = k[:, j:j + kc], v[:, j:j + kc]
            s = _tile_scores(qb, kb, qp, k_pos[:, j:j + kc], causal, scale)
            p = torch.exp(s - lseb[..., None])
            dv[:, j:j + kc] += torch.einsum("bngqk,bqngd->bknd", p, do32)
            dp = torch.einsum("bqngd,bknd->bngqk", do32, vb.float())
            ds = p * (dp - dsb[..., None]) * scale
            dq_acc = dq_acc + torch.einsum("bngqk,bknd->bqngd", ds, kb.float())
            dk[:, j:j + kc] += torch.einsum("bngqk,bqngd->bknd", ds, qb.float())
        dq[:, i:i + qc] = dq_acc
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The flash path with the JAX package's tile-recompute VJP: the
    residuals are only ``(q, k, v, o, lse)`` and the positions."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, scale):
        o, lse = _flash_fwd_impl(q, k, v, q_pos, k_pos, causal, scale)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, k_pos, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, q_pos, k_pos, o, lse,
                                     do.contiguous(), ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def _flash_attention(q, k, v, q_pos, k_pos, causal, scale):
    """q: [B,Sq,N,G,dh]; k,v: [B,Sk,N,dh]; *_pos: [B, S*] absolute
    positions.  FlashAttention-2-style chunked attention, differentiable
    in q, k and v."""
    return _FlashAttention.apply(q, k, v, q_pos, k_pos, causal, scale)


def use_flash(s: int, sk: int) -> bool:
    """Whether ``apply_attention`` takes the flash path for ``s`` queries
    against ``sk`` keys: the JAX package's condition."""
    return (s > 1 and sk >= FLASH_THRESHOLD and sk % min(K_CHUNK, sk) == 0
            and s % min(Q_CHUNK, s) == 0)


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
    x_kv: Optional[torch.Tensor] = None,   # cross-attention source [B, T, D]
    kv_positions: Optional[torch.Tensor] = None,
    kv_cache: Optional[dict] = None,   # {"k","v": [B, S_max, N_kv, dh]}
    cache_index: Optional[int] = None,  # write offset; None: a static cache
) -> tuple[torch.Tensor, Optional[dict]]:
    b, s, _ = x.shape
    g = n_heads // n_kv
    scale = head_dim ** -0.5
    static = kv_cache is not None and cache_index is None

    q = torch.einsum("bsd,dnh->bsnh", x, params["wq"].to(x.dtype))
    if not static:
        # the static cache replaces k and v (the JAX package computes and
        # drops them)
        src = x if x_kv is None else x_kv
        k = torch.einsum("btd,dnh->btnh", *_promoted(src, params["wk"].to(x.dtype)))
        v = torch.einsum("btd,dnh->btnh", *_promoted(src, params["wv"].to(x.dtype)))

    if qk_norm:
        q = _rms(q, params["q_norm"])
        if not static:
            k = _rms(k, params["k_norm"])
    if rope_theta is not None and x_kv is None:
        q = apply_rope(q, positions, rope_theta)
        if not static:
            k = apply_rope(k, positions, rope_theta)
    q = q.reshape(b, s, n_kv, g, head_dim)

    if static:
        k, v = kv_cache["k"], kv_cache["v"]
        k_pos = torch.arange(k.shape[1], device=x.device)[None].expand(b, -1)
    elif kv_cache is not None:
        kv_cache["k"][:, cache_index:cache_index + s] = k.to(kv_cache["k"].dtype)
        kv_cache["v"][:, cache_index:cache_index + s] = v.to(kv_cache["v"].dtype)
        k, v = kv_cache["k"], kv_cache["v"]
        k_pos = torch.arange(k.shape[1], device=x.device)[None].expand(b, -1)
    elif kv_positions is not None:
        k_pos = kv_positions
    elif x_kv is not None:
        # cross-attention: key positions index the encoder sequence
        k_pos = torch.arange(k.shape[1], device=x.device)[None].expand(b, -1)
    else:
        k_pos = positions if positions.dim() == 2 else positions[None].expand(b, -1)
    q_pos = positions if positions.dim() == 2 else positions[None].expand(b, -1)

    if use_flash(s, k.shape[1]):
        o = _flash_attention(q, k, v, q_pos, k_pos, causal, scale)
    else:
        mask = q_pos[:, :, None] >= k_pos[:, None, :] if causal else None
        o = _direct_attention(q, k, v, mask, scale)
    o = o.reshape(b, s, n_heads, head_dim).to(x.dtype)
    y = torch.einsum("bsnh,nhd->bsd", o, params["wo"].to(x.dtype))
    return y, kv_cache
