"""Decoder-only LM assembly (port of ``repro.models.transformer``).

Layers are stacked as in the JAX package: a repeating *period* of layer
slots (Jamba's 7:1 Mamba:attention interleave with its MoE cadence,
xLSTM's mLSTM/sLSTM alternation), each slot's parameters stacked on a
leading "stack" axis of ``n_layers / period`` repetitions.  The JAX
package scans over that axis under ``jax.checkpoint``; here
``apply_stack`` is a Python loop over it, and with ``remat`` (training)
each period runs under ``torch.utils.checkpoint`` (non-reentrant, no early
stop: the backward recomputes the whole period, every exchange and K6
launch of it again).  The training loss (``lm_loss``) is the JAX
package's: the NLL in four sequence chunks, the head recomputed per chunk,
plus the MoE aux terms.  A block is a sequence mixer (attention, Mamba,
mLSTM or sLSTM) followed by the MoE layer (on its cadence) or a dense FFN
(``mlp.py``), or by nothing where ``d_ff == 0``.

Caches: an attention slot's KV cache is written in place; a recurrent
slot's state (Mamba, mLSTM, sLSTM) comes back new from its block, as in
the JAX package, and ``apply_stack`` copies it into the stacked slot.
``forward(extra_embeds=...)`` prepends the VLM's projected patches.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils import checkpoint as torch_checkpoint

from ..configs.base import ModelConfig, torch_dtype
from ..parallel.sharding import (ParamFactory, active_rules, axis_rules,
                                 current_mesh)
from . import attention, embedding, mamba, mlp, moe, norms, xlstm


# ---------------------------------------------------------------------------
# Periodic layer structure
# ---------------------------------------------------------------------------


def layer_period(cfg: ModelConfig) -> int:
    """Smallest repeating pattern of layer kinds (and MoE cadence)."""
    p = 1
    if cfg.family == "hybrid":
        p = cfg.attn_every
    elif cfg.family == "ssm" and cfg.xlstm is not None:
        p = cfg.xlstm.slstm_every
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.every_k_layers)
    assert cfg.n_layers % p == 0, (cfg.name, cfg.n_layers, p)
    return p


class _StackFactory:
    """Factory adapter that prepends the stack axis: one draw of the full
    stacked shape."""

    def __init__(self, base, n_rep: int):
        self._base = base
        self._n = n_rep

    @property
    def dtype(self):
        return self._base.dtype

    def param(self, path, shape, axes, init):
        return self._base.param(path, (self._n,) + tuple(shape),
                                ("stack",) + tuple(axes), init)

    def scope(self, prefix):
        return _StackFactory(self._base.scope(prefix), self._n)


# ---------------------------------------------------------------------------
# One block (slot): sequence mixer + (optional) FFN/MoE, pre-norm residual
# ---------------------------------------------------------------------------


def init_block(f, cfg: ModelConfig, slot: int) -> None:
    kind = cfg.layer_kind(slot)
    norms.init_norm(f.scope("ln1"), cfg.norm, cfg.d_model)
    if kind == "attn":
        attention.init_attention(f.scope("attn"), cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim, cfg.qk_norm)
    elif kind == "mamba":
        mc = cfg.mamba
        mamba.init_mamba(f.scope("mamba"), cfg.d_model, mc.d_state, mc.d_conv,
                         mc.expand, mc.dt_rank)
    elif kind == "mlstm":
        xc = cfg.xlstm
        xlstm.init_mlstm(f.scope("mlstm"), cfg.d_model, cfg.n_heads,
                         xc.proj_factor, xc.qk_dim_factor)
    elif kind == "slstm":
        xlstm.init_slstm(f.scope("slstm"), cfg.d_model, cfg.n_heads)
    else:
        raise ValueError(kind)
    if cfg.d_ff > 0 or cfg.is_moe_layer(slot):
        norms.init_norm(f.scope("ln2"), cfg.norm, cfg.d_model)
        if cfg.is_moe_layer(slot):
            moe.init_moe(f.scope("moe"), cfg.d_model, cfg.moe)
        else:
            mlp.init_mlp(f.scope("mlp"), cfg.activation, cfg.d_model, cfg.d_ff)


def _mixer(params: dict, cfg: ModelConfig, kind: str, h: torch.Tensor, *,
           positions, cache, cache_index):
    """The slot's sequence mixer: (y, cache).  Attention writes its KV
    cache in place; a recurrent kind returns its new state (a prefill when
    ``h`` holds more than one position, else one decode step)."""
    if kind == "attn":
        return attention.apply_attention(
            params["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim, positions=positions,
            rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm, kv_cache=cache,
            cache_index=cache_index)
    prefill = h.shape[1] > 1
    if kind == "mamba":
        mc = cfg.mamba
        kw = dict(d_state=mc.d_state, d_conv=mc.d_conv)
        if cache is None:
            return mamba.apply_mamba(params["mamba"], h, **kw), None
        if prefill:   # serve prefill: run the full scan, prime the state
            return mamba.apply_mamba(params["mamba"], h, return_cache=True, **kw)
        return mamba.mamba_decode_step(params["mamba"], cache, h, **kw)
    if kind in ("mlstm", "slstm"):
        apply = xlstm.apply_mlstm if kind == "mlstm" else xlstm.apply_slstm
        if cache is None:
            return apply(params[kind], h, n_heads=cfg.n_heads), None
        if prefill:
            return apply(params[kind], h, n_heads=cfg.n_heads, return_cache=True)
        step = (xlstm.mlstm_decode_step if kind == "mlstm"
                else xlstm.slstm_decode_step)
        return step(params[kind], cache, h, n_heads=cfg.n_heads)
    raise ValueError(kind)


def apply_block(params: dict, cfg: ModelConfig, slot: int, x: torch.Tensor, *,
                positions: torch.Tensor,
                moe_plan: Optional[moe.MoEDispatchPlan],
                cache: Optional[dict] = None,
                cache_index: Optional[int] = None):
    """Returns (x, aux_losses [2], cache): the KV cache written in place,
    or a recurrent kind's new state."""
    rs = cfg.residual_scale
    h = norms.apply_norm(params.get("ln1"), cfg.norm, x)
    y, cache = _mixer(params, cfg, cfg.layer_kind(slot), h,
                      positions=positions, cache=cache,
                      cache_index=cache_index)
    x = x + y * rs if rs != 1.0 else x + y
    if cfg.is_moe_layer(slot):
        h = norms.apply_norm(params.get("ln2"), cfg.norm, x)
        y, aux = moe.apply_moe(params["moe"], h, cfg.moe, moe_plan)
        x = x + y * rs if rs != 1.0 else x + y
        return x, aux, cache
    if cfg.d_ff > 0:
        h = norms.apply_norm(params.get("ln2"), cfg.norm, x)
        y = mlp.apply_mlp(params["mlp"], cfg.activation, h)
        x = x + y * rs if rs != 1.0 else x + y
    return x, torch.zeros((2,), dtype=torch.float32, device=x.device), cache


# ---------------------------------------------------------------------------
# Full decoder stack
# ---------------------------------------------------------------------------


def init_lm(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Returns (params, logical_specs), drawn from ``generator`` on
    ``device`` (default: the generator's device)."""
    f = ParamFactory(generator, torch_dtype(cfg.param_dtype), device)
    embedding.init_embedding(f.scope("embed"), cfg.padded_vocab, cfg.d_model)
    period = layer_period(cfg)
    n_rep = cfg.n_layers // period
    for slot in range(period):
        init_block(_StackFactory(f.scope(f"slot{slot}"), n_rep), cfg, slot)
    norms.init_norm(f.scope("ln_f"), cfg.norm, cfg.d_model)
    embedding.init_lm_head(f.scope("head"), cfg.padded_vocab, cfg.d_model,
                           cfg.tie_embeddings)
    if cfg.frontend == "vision_patches":
        from . import vlm
        vlm.init_projector(f.scope("projector"), cfg.frontend_dim, cfg.d_model)
    return f.params, f.logical_specs


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def apply_stack(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                positions: torch.Tensor,
                moe_plan: Optional[moe.MoEDispatchPlan] = None,
                caches: Optional[list] = None,
                cache_index: Optional[int] = None,
                remat: bool = False):
    """Loop over the stacked blocks.  ``caches`` (per-slot stacked dicts,
    as ``init_caches`` makes them) are written in place and returned.
    ``remat`` (without caches, under autograd) checkpoints each period."""
    period = layer_period(cfg)
    n_rep = cfg.n_layers // period
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)

    # The axis rules are thread-local, and a CUDA backward (which runs the
    # recomputation) runs in autograd's device thread: the period takes
    # the caller's rules and mesh with it.
    rules, mesh = active_rules(), current_mesh()

    def period_fn(slot_params, h):
        auxs = torch.zeros((2,), dtype=torch.float32, device=h.device)
        with axis_rules(rules, mesh):
            for s in range(period):
                h, a, _ = apply_block(slot_params[s], cfg, s, h,
                                      positions=positions, moe_plan=moe_plan)
                auxs = auxs + a
        return h, auxs

    remat = remat and caches is None and torch.is_grad_enabled()
    for i in range(n_rep):
        if caches is None:
            slot_params = [_index_tree(params[f"slot{s}"], i)
                           for s in range(period)]
            if remat:
                with torch_checkpoint.set_checkpoint_early_stop(False):
                    x, a = torch_checkpoint.checkpoint(
                        period_fn, slot_params, x, use_reentrant=False)
            else:
                x, a = period_fn(slot_params, x)
            aux = aux + a
            continue
        for s in range(period):
            cache = _index_tree(caches[s], i)
            x, a, new = apply_block(_index_tree(params[f"slot{s}"], i), cfg, s,
                                    x, positions=positions, moe_plan=moe_plan,
                                    cache=cache, cache_index=cache_index)
            if new is not cache:        # a recurrent state: into its slot
                for name, t in new.items():
                    caches[s][name][i].copy_(t)
            aux = aux + a
    return x, aux, caches


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            moe_plan=None, caches=None, cache_index: Optional[int] = None,
            extra_embeds: Optional[torch.Tensor] = None,
            remat: bool = False, return_hidden: bool = False):
    """tokens: [B, S] -> logits [B, S, V_padded] (+ aux, caches).

    extra_embeds (VLM): [B, N, D] projected patches, prepended.
    decode: pass caches + cache_index (tokens is [B, 1]); prefill into
    fresh caches: cache_index 0.  ``return_hidden`` skips the logits
    product (the loss computes it chunked).
    """
    x = embedding.embed_tokens(params["embed"], tokens, cfg.embed_scale)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    b, s = x.shape[:2]
    base = 0 if cache_index is None else int(cache_index)
    positions = (base + torch.arange(s, device=x.device))[None].expand(b, s)
    x, aux, caches = apply_stack(params, cfg, x, positions=positions,
                                 moe_plan=moe_plan, caches=caches,
                                 cache_index=cache_index, remat=remat)
    x = norms.apply_norm(params.get("ln_f"), cfg.norm, x)
    if return_hidden:
        return x, aux, caches
    logits = embedding.lm_logits(params.get("head"), params["embed"], x,
                                 cfg.tie_embeddings, cfg.logit_scale,
                                 valid_vocab=cfg.vocab_size)
    return logits, aux, caches


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token NLL in float32, the max held constant (as the JAX
    package's ``stop_gradient``).  The target logit is gathered: the JAX
    package's where-iota contraction sums one nonzero term, the same
    value."""
    l32 = logits.float()
    m = l32.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.exp(l32 - m).sum(-1)) + m[..., 0]
    tgt = l32.gather(-1, targets.long()[..., None])[..., 0]
    return lse - tgt


def chunked_nll(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
                tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                n_chunks: int = 4, offset: int = 0):
    """Next-token NLL in sequence chunks, so only one chunk's [tokens, V]
    fp32 logits block is live; under autograd the head product is
    recomputed per chunk in the backward (``torch.utils.checkpoint``, as
    the JAX package's ``jax.checkpoint``).

    hidden: [B, S, D] final hidden states; tokens: [B, S_tok] with hidden
    position offset+i predicting tokens[:, i+1].  Returns (sum_nll,
    n_valid)."""
    b, s, _ = hidden.shape
    s_tok = tokens.shape[1]
    assert s == s_tok + offset, (s, s_tok, offset)
    pos = torch.arange(s, device=hidden.device)
    valid = (pos >= offset) & (pos < s - 1)
    m = valid[None].expand(b, s).float()
    tgt_full = torch.zeros((b, s), dtype=tokens.dtype, device=tokens.device)
    tgt_full[:, offset:s - 1] = tokens[:, 1:]
    if mask is not None:
        m = m.clone()
        m[:, offset:s - 1] *= mask.float()[:, 1:]

    chunk = s // n_chunks if (s % n_chunks == 0 and s >= 2 * n_chunks) else s

    def chunk_fn(h_c, t_c, m_c):
        logits = embedding.lm_logits(params.get("head"), params["embed"], h_c,
                                     cfg.tie_embeddings, cfg.logit_scale,
                                     valid_vocab=cfg.vocab_size)
        return (cross_entropy(logits, t_c) * m_c).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for a in range(0, s, chunk):
        args = (hidden[:, a:a + chunk], tgt_full[:, a:a + chunk],
                m[:, a:a + chunk])
        if torch.is_grad_enabled():
            total = total + torch_checkpoint.checkpoint(
                chunk_fn, *args, use_reentrant=False)
        else:
            total = total + chunk_fn(*args)
    return total, torch.clamp(m.sum(), min=1.0)


def lm_loss(params: dict, cfg: ModelConfig, batch: dict, *,
            moe_plan=None, remat: bool = True):
    """batch: {"tokens": [B, S] int32, "loss_mask": optional [B, S]}.
    Returns (loss, metrics) with the JAX package's metric names."""
    tokens = batch["tokens"]
    # Forward on the FULL sequence; the shift happens in chunked_nll.
    hidden, aux, _ = forward(params, cfg, tokens, moe_plan=moe_plan,
                             remat=remat, return_hidden=True)
    total, denom = chunked_nll(params, cfg, hidden, tokens,
                               batch.get("loss_mask"))
    loss = total / denom
    total = loss
    metrics = {"nll": loss}
    if cfg.moe is not None:
        lb, z = aux[0], aux[1]
        total = total + cfg.moe.aux_loss * lb + cfg.moe.router_z_loss * z
        metrics.update({"moe_lb": lb, "moe_z": z})
    metrics["loss"] = total
    return total, metrics


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, device=None):
    """Per-slot stacked cache dicts matching ``apply_stack``'s layout:
    attention ``{"k", "v": [n_rep, B, S, N_kv, dh]}``; Mamba ``{"conv",
    "ssm"}``, mLSTM ``{"c", "n", "m"}``, sLSTM ``{"c", "n", "h", "m"}``,
    each with the leading ``n_rep`` axis."""
    period = layer_period(cfg)
    n_rep = cfg.n_layers // period

    def stacked(tree):
        return {k: v[None].repeat((n_rep,) + (1,) * v.dim())
                for k, v in tree.items()}

    caches = []
    for slot in range(period):
        kind = cfg.layer_kind(slot)
        if kind == "attn":
            shape = (n_rep, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                           "v": torch.zeros(shape, dtype=dtype, device=device)})
            continue
        if kind == "mamba":
            mc = cfg.mamba
            di = mamba.d_inner(cfg.d_model, mc.expand)
            c = mamba.init_mamba_cache(batch, di, mc.d_state, mc.d_conv, dtype,
                                       device)
        elif kind == "mlstm":
            xc = cfg.xlstm
            c = xlstm.init_mlstm_cache(batch, cfg.d_model, cfg.n_heads,
                                       xc.proj_factor, xc.qk_dim_factor, dtype,
                                       device)
        elif kind == "slstm":
            c = xlstm.init_slstm_cache(batch, cfg.d_model, cfg.n_heads, device)
        else:
            raise ValueError(kind)
        caches.append(stacked(c))
    return caches
