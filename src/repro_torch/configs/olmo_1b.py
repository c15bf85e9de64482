"""olmo-1b [dense] — non-parametric LayerNorm [arXiv:2402.00838; hf].

16L d_model=2048 16H (kv=16, MHA) d_ff=8192 vocab=50304.
OLMo uses LayerNorm without learnable scale/bias and tied embeddings.

A copy of ``repro.configs.olmo_1b``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric_ln",
    activation="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    max_seq=32768,
    source="arXiv:2402.00838; hf:allenai/OLMo-1B",
)
