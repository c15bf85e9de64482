"""xlstm-125m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

12L d_model=768 4H d_ff=0 vocab=50304.  Alternating mLSTM / sLSTM blocks
(xLSTM[1:1] at this scale); mLSTM blocks carry their own up/down projection
(no separate FFN — d_ff=0), sLSTM keeps the residual width.  Sub-quadratic:
runs the long_500k cell (recurrent-state decode).

A copy of ``repro.configs.xlstm_125m``.
"""

from .base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_head=192,
    d_ff=0,
    vocab_size=50304,
    norm="layernorm",
    activation="gelu",
    rope_theta=None,
    tie_embeddings=True,
    xlstm=XLSTMConfig(slstm_every=2, qk_dim_factor=0.5, proj_factor=4.0 / 3.0),
    max_seq=524288,
    source="arXiv:2405.04517 (unverified tier)",
)
