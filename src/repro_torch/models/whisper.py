"""Whisper-style encoder-decoder backbone, the audio family (port of
``repro.models.whisper``).

The conv frontend is a stub, as in the JAX package: the caller supplies
frame embeddings ``[B, T_frames, d_model]`` (what the two conv1d layers
would produce), so the encoder is the transformer stack plus sinusoidal
positions.  Decoder: learned positional embeddings, causal self-attention
with a KV cache, cross-attention over the encoder output (its K/V cached
once at prefill by ``prime_cross_caches``), GELU MLPs, LayerNorm, tied
embeddings.  The JAX package scans over the stacked layers; here a Python
loop runs them, each under ``torch.utils.checkpoint`` when ``remat`` and
autograd are on and no cache is passed.

Dtypes follow JAX's promotion: the encoder adds float32 sinusoids to the
frames, so float32 frames (what the serve launcher and the data pipeline
make) run the whole encoder in float32 against bf16 weights, and the
primed cross caches are cast to the cache dtype.

The decode caches are ``{"k", "v": [L, B, S_self, N_kv, dh], "ck", "cv":
[L, B, T_enc, N_kv, dh]}``; the self-attention rows are written in place.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils import checkpoint as torch_checkpoint

from ..configs.base import ModelConfig, torch_dtype
from ..parallel.sharding import ParamFactory, normal_init
from . import attention, embedding, mlp, norms
from .transformer import _index_tree, _StackFactory, cross_entropy


def _init_enc_block(f, cfg: ModelConfig) -> None:
    norms.init_norm(f.scope("ln1"), cfg.norm, cfg.d_model)
    attention.init_attention(f.scope("attn"), cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim)
    norms.init_norm(f.scope("ln2"), cfg.norm, cfg.d_model)
    mlp.init_mlp(f.scope("mlp"), cfg.activation, cfg.d_model, cfg.d_ff)


def _init_dec_block(f, cfg: ModelConfig) -> None:
    norms.init_norm(f.scope("ln1"), cfg.norm, cfg.d_model)
    attention.init_attention(f.scope("self_attn"), cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim)
    norms.init_norm(f.scope("ln_c"), cfg.norm, cfg.d_model)
    attention.init_attention(f.scope("cross_attn"), cfg.d_model, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim)
    norms.init_norm(f.scope("ln2"), cfg.norm, cfg.d_model)
    mlp.init_mlp(f.scope("mlp"), cfg.activation, cfg.d_model, cfg.d_ff)


def init_whisper(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Returns (params, logical_specs), drawn from ``generator``."""
    f = ParamFactory(generator, torch_dtype(cfg.param_dtype), device)
    embedding.init_embedding(f.scope("embed"), cfg.padded_vocab, cfg.d_model)
    f.param("pos_embed", (cfg.max_seq, cfg.d_model), ("seq", "embed"),
            normal_init(0.02))
    _init_enc_block(_StackFactory(f.scope("enc"), cfg.n_enc_layers), cfg)
    _init_dec_block(_StackFactory(f.scope("dec"), cfg.n_layers), cfg)
    norms.init_norm(f.scope("ln_enc_f"), cfg.norm, cfg.d_model)
    norms.init_norm(f.scope("ln_f"), cfg.norm, cfg.d_model)
    return f.params, f.logical_specs


def _attend(params, cfg, z, positions, causal, **kw):
    y, _ = attention.apply_attention(
        params, z, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, positions=positions, causal=causal,
        rope_theta=None, **kw)
    return y


def _layers(body, x, stack, n: int, remat: bool):
    """``x = body(x, layer_i)`` over the ``n`` stacked layers."""
    remat = remat and torch.is_grad_enabled()
    for i in range(n):
        blk = _index_tree(stack, i)
        if remat:
            x = torch_checkpoint.checkpoint(body, x, blk, use_reentrant=False)
        else:
            x = body(x, blk)
    return x


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor,
           remat: bool = True) -> torch.Tensor:
    """frames: [B, T, d_model] stub embeddings -> encoder states [B, T, D]."""
    b, t, _ = frames.shape
    x = frames + embedding.sinusoidal_positions(
        t, cfg.d_model, frames.dtype, frames.device)[None]
    positions = torch.arange(t, device=frames.device)[None].expand(b, t)

    def body(h, blk):
        z = norms.apply_norm(blk.get("ln1"), cfg.norm, h)
        h = h + _attend(blk["attn"], cfg, z, positions, causal=False)
        z = norms.apply_norm(blk.get("ln2"), cfg.norm, h)
        return h + mlp.apply_mlp(blk["mlp"], cfg.activation, z)

    x = _layers(body, x, params["enc"], cfg.n_enc_layers, remat)
    return norms.apply_norm(params.get("ln_enc_f"), cfg.norm, x)


def decode(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           enc_out: Optional[torch.Tensor] = None, *,
           caches: Optional[dict] = None,
           cache_index: Optional[int] = None,
           remat: bool = True):
    """tokens: [B, S].  Training: pass enc_out.  Prefill and decode steps:
    pass the caches primed by ``prime_cross_caches`` (cross K/V inside)
    and cache_index; the self-attention rows are written in place.
    Returns (logits [B, S, V_padded], caches or None)."""
    b, s = tokens.shape
    x = embedding.embed_tokens(params["embed"], tokens)
    base = 0 if cache_index is None else int(cache_index)
    positions = (base + torch.arange(s, device=x.device))[None].expand(b, s)
    x = x + params["pos_embed"][base:base + s][None].to(x.dtype)

    def body(h, blk, cache=None):
        z = norms.apply_norm(blk.get("ln1"), cfg.norm, h)
        h = h + _attend(
            blk["self_attn"], cfg, z, positions, causal=True,
            kv_cache=None if cache is None else {"k": cache["k"], "v": cache["v"]},
            cache_index=cache_index if cache is not None else None)
        z = norms.apply_norm(blk.get("ln_c"), cfg.norm, h)
        if cache is not None and enc_out is None:
            h = h + _attend(blk["cross_attn"], cfg, z, positions, causal=False,
                            kv_cache={"k": cache["ck"], "v": cache["cv"]})
        else:
            h = h + _attend(blk["cross_attn"], cfg, z, positions, causal=False,
                            x_kv=enc_out)
        z = norms.apply_norm(blk.get("ln2"), cfg.norm, h)
        return h + mlp.apply_mlp(blk["mlp"], cfg.activation, z)

    if caches is None:
        x = _layers(body, x, params["dec"], cfg.n_layers, remat)
    else:
        for i in range(cfg.n_layers):
            x = body(x, _index_tree(params["dec"], i), _index_tree(caches, i))
    x = norms.apply_norm(params.get("ln_f"), cfg.norm, x)
    logits = embedding.lm_logits(None, params["embed"], x, tied=True,
                                 valid_vocab=cfg.vocab_size)
    return logits, caches


def init_dec_caches(cfg: ModelConfig, batch: int, max_seq: int, enc_len: int,
                    dtype=torch.bfloat16, device=None) -> dict:
    """Stacked decoder caches: self-attn KV (max_seq) + cross KV (enc_len)."""
    def z(s):
        return torch.zeros((cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim),
                           dtype=dtype, device=device)
    return {"k": z(max_seq), "v": z(max_seq), "ck": z(enc_len), "cv": z(enc_len)}


def prime_cross_caches(params: dict, cfg: ModelConfig, enc_out: torch.Tensor,
                       caches: dict) -> dict:
    """Every layer's cross K/V from the encoder output, once (prefill):
    ``caches`` with ``ck``/``cv`` replaced, at the encoder's length."""
    ks, vs = [], []
    for i in range(cfg.n_layers):
        ca = _index_tree(params["dec"], i)["cross_attn"]
        ks.append(torch.einsum("btd,dnh->btnh", enc_out, ca["wk"].to(enc_out.dtype)))
        vs.append(torch.einsum("btd,dnh->btnh", enc_out, ca["wv"].to(enc_out.dtype)))
    return dict(caches, ck=torch.stack(ks).to(caches["ck"].dtype),
                cv=torch.stack(vs).to(caches["cv"].dtype))


def whisper_loss(params: dict, cfg: ModelConfig, batch: dict, remat: bool = True):
    """batch: {"frames": [B,T,D], "tokens": [B,S]}."""
    enc = encode(params, cfg, batch["frames"], remat=remat)
    logits, _ = decode(params, cfg, batch["tokens"], enc, remat=remat)
    targets = batch["tokens"][:, 1:]
    loss = cross_entropy(logits[:, :-1], targets).mean()
    return loss, {"nll": loss, "loss": loss}
