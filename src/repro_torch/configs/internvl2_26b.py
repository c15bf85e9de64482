"""internvl2-26b [vlm] — InternViT + InternLM2 [arXiv:2404.16821; hf].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
The InternViT-6B frontend is a STUB per the assignment: ``input_specs``
supplies precomputed patch embeddings at the ViT hidden size (3200); the
model owns the MLP projector and the InternLM2-20B-like GQA decoder.
256 image tokens per example (448px tile after pixel-shuffle).

A copy of ``repro.configs.internvl2_26b``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=92553,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=10000.0,
    tie_embeddings=False,
    frontend="vision_patches",
    frontend_dim=3200,
    frontend_len=256,
    max_seq=32768,
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-26B",
)
