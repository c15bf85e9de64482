"""whisper-base [audio] — enc-dec, conv frontend stub
[arXiv:2212.04356; unverified].

6L (per stack) d_model=512 8H (kv=8) d_ff=2048 vocab=51865.  The two-conv1d
audio frontend is a STUB per the assignment — ``input_specs`` supplies
precomputed frame embeddings [B, T, 512].  Encoder: sinusoidal positions,
bidirectional.  Decoder: learned positions, causal + cross-attention, tied
embeddings.  Enc-dec: ``decode_*`` shapes lower the decoder step (self-attn
KV cache at seq_len + cross KV over the encoder output).

A copy of ``repro.configs.whisper_base``.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    n_enc_layers=6,
    encdec=True,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_head=64,
    d_ff=2048,
    vocab_size=51865,
    norm="layernorm",
    activation="gelu",
    rope_theta=None,
    tie_embeddings=True,
    frontend="audio_frames",
    frontend_dim=512,
    max_seq=448,
    source="arXiv:2212.04356 (unverified tier)",
)
