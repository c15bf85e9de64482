"""Token embedding and the LM head (port of ``repro.models.embedding``).

The table is ``[padded_vocab, D]`` and the head ``[D, padded_vocab]``, as
in the JAX package; logits of the padding ids are masked to -1e9."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.sharding import ScopedFactory, normal_init


def init_embedding(f: ScopedFactory, vocab: int, d_model: int) -> None:
    """vocab here is the PADDED vocab (cfg.padded_vocab)."""
    f.param("table", (vocab, d_model), ("vocab", "embed"), normal_init(0.02))


def embed_tokens(params: dict, tokens: torch.Tensor,
                 scale: float = 1.0) -> torch.Tensor:
    """The table's rows at ``tokens`` (JAX's ``jnp.take``).  ``F.embedding``
    sums the gradient rows of repeated tokens in a fixed order; an index
    gather's backward adds them with atomic adds across threads, so on a
    multi-threaded CPU two runs of a trainer differed in the last bit."""
    y = F.embedding(tokens.long(), params["table"])
    if scale != 1.0:
        y = y * scale
    return y


def init_lm_head(f: ScopedFactory, vocab: int, d_model: int, tied: bool) -> None:
    if not tied:
        f.param("w_out", (d_model, vocab), ("embed", "vocab"),
                normal_init(d_model ** -0.5))


def lm_logits(head_params: dict | None, embed_params: dict, x: torch.Tensor,
              tied: bool, logit_scale: float = 1.0,
              valid_vocab: int | None = None) -> torch.Tensor:
    if tied:
        logits = x @ embed_params["table"].t().to(x.dtype)
    else:
        logits = x @ head_params["w_out"].to(x.dtype)
    if logit_scale != 1.0:
        logits = logits * logit_scale
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        # vocab-padding mask: pad ids can never win argmax
        iota = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(iota < valid_vocab, logits, -1e9)
    return logits


def sinusoidal_positions(length: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings ``[length, dim]``."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * idx / dim)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)
