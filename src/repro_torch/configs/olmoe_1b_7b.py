"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060; hf] (a copy of
``repro.configs.olmoe_1b_7b``).

16L d_model=2048 16H (kv=16) d_ff(expert)=1024 vocab=50304, MoE every layer.
QK-norm per the paper.  OLMoE trains dropless; this framework uses
capacity-factor dispatch (cf=1.25) — the persistent-alltoallv plan's static
bucket schedule.  This arch is a primary consumer of the paper's technique
(EP dispatch).
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1024,
    vocab_size=50304,
    norm="rmsnorm",
    activation="swiglu",
    qk_norm=True,
    rope_theta=10000.0,
    tie_embeddings=False,
    moe=MoEConfig(
        n_experts=64,
        top_k=8,
        d_expert=1024,
        every_k_layers=1,
        capacity_factor=1.25,
        dispatch="persistent_a2a",
        a2a_variant="fence",
    ),
    max_seq=32768,
    source="arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924",
)
