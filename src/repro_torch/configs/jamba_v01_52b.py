"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE
[arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2 on
every other layer, attention on 1 of every 8 layers (position 4 in each
8-layer Jamba block), Mamba elsewhere.  No explicit positional encoding
(rope_theta=None) — Mamba carries position.  Sub-quadratic: runs long_500k
(mamba state decode + sequence-sharded KV for the 4 attention layers).

A copy of ``repro.configs.jamba_v01_52b``.
"""

from .base import MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=None,
    tie_embeddings=False,
    attn_every=8,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(
        n_experts=16,
        top_k=2,
        d_expert=14336,
        every_k_layers=2,
        capacity_factor=1.25,
        dispatch="persistent_a2a",
        a2a_variant="fence",
    ),
    max_seq=524288,
    source="arXiv:2403.19887; hf:ai21labs/Jamba-v0.1",
)
