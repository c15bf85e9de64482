"""minicpm-2b [dense] — WSD schedule, mup-style scaling [arXiv:2404.06395; hf].

40L d_model=2304 36H (kv=36, MHA) d_ff=5760 vocab=122753.
Scaling per the paper: scale_emb=12, scale_depth=1.4 (residual x 1.4/sqrt(L)),
logits scaled by 256/d_model.  Tied embeddings.  Trains with the WSD
(warmup-stable-decay) schedule — see repro_torch.train.schedule.

A copy of ``repro.configs.minicpm_2b``.
"""

import math

from .base import ModelConfig

_L = 40

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=_L,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_head=64,
    d_ff=5760,
    vocab_size=122753,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    embed_scale=12.0,
    residual_scale=1.4 / math.sqrt(_L),
    logit_scale=256.0 / 2304.0,
    max_seq=32768,
    source="arXiv:2404.06395; hf:openbmb/MiniCPM-2B-sft-bf16",
)
