"""nemotron-4-15b [dense] — GQA, squared-ReLU [arXiv:2402.16819; unverified].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
~15.6B params (3.1B in the two untied 256k-vocab embeddings).

A copy of ``repro.configs.nemotron_4_15b``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab_size=256000,
    norm="layernorm",
    activation="squared_relu",
    rope_theta=10000.0,
    tie_embeddings=False,
    max_seq=32768,
    source="arXiv:2402.16819 (unverified tier)",
)
