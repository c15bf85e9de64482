"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954; hf].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
~67.5B params (0.84B embed + 0.84B head + 95 x 0.69B).

A copy of ``repro.configs.deepseek_67b``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22016,
    vocab_size=102400,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=10000.0,
    tie_embeddings=False,
    max_seq=32768,
    source="arXiv:2401.02954; hf:deepseek-ai/deepseek-llm-67b-base",
)
