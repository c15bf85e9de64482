"""moonshot-v1-16b-a3b [moe] — kimi/moonlight 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (kv=16) d_ff(expert)=1408 vocab=163840, MoE 64e top-6,
2 shared experts (DeepSeek-V3-style).  Assignment specifies 48L (the HF
Moonlight checkpoint has 27; the assigned pool config is authoritative here,
yielding ~28B total / ~3.3B active).  Primary consumer of the persistent
alltoallv EP dispatch.

A copy of ``repro.configs.moonshot_v1_16b_a3b``.
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab_size=163840,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=50000.0,
    tie_embeddings=False,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        every_k_layers=1,
        n_shared_experts=2,
        capacity_factor=1.25,
        dispatch="persistent_a2a",
        a2a_variant="fence",
    ),
    max_seq=32768,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
