"""Model / run configuration dataclasses (port of ``repro.configs.base``).

A copy of the JAX package's ``MoEConfig``, ``MambaConfig``,
``XLSTMConfig``, ``ModelConfig``, ``ShapeConfig``, ``SHAPES`` and
``reduced``, with the same fields and defaults, so a config carries across
the two packages unchanged.  ``torch_dtype`` maps a config's
``param_dtype`` string to its torch dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # FFN hidden size per expert
    every_k_layers: int = 1       # MoE layer cadence (jamba: 2)
    n_shared_experts: int = 0     # moonshot/deepseek-style shared experts
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2
    # dispatch implementation: persistent_a2a (paper technique) |
    # nonpersistent_a2a (per-call metadata baseline) | gspmd
    dispatch: str = "persistent_a2a"
    # fence | lock | fence_hierarchy | auto
    a2a_variant: str = "fence"
    # Chunked dispatch->expert-FFN->combine pipeline depth (clamped at plan
    # build; any depth is bit-identical to depth 1).
    overlap_chunks: int = 1
    # Wire codec for the dispatch/combine exchange ("identity", "bf16",
    # "int8", "fp8") and its declared error tolerance, which a lossy codec
    # needs.
    wire_codec: str = "identity"
    codec_tol: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    # block pattern: 1 = sLSTM, 0 = mLSTM; xLSTM[7:1] paper notation
    slstm_every: int = 2           # every 2nd block is sLSTM
    qk_dim_factor: float = 0.5
    proj_factor: float = 1.3333


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None   # default d_model // n_heads
    norm: str = "rmsnorm"          # rmsnorm | layernorm | nonparametric_ln
    activation: str = "swiglu"     # swiglu | squared_relu | gelu
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    attn_every: int = 1            # hybrid (jamba): attention layer cadence (8)
    rope_theta: Optional[float] = 10000.0   # None = no positional encoding
    max_seq: int = 8192
    tie_embeddings: bool = False
    embed_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    qk_norm: bool = False
    encdec: bool = False
    n_enc_layers: int = 0
    frontend: str = "none"
    frontend_dim: int = 0
    frontend_len: int = 0
    param_dtype: str = "bfloat16"
    source: str = ""               # provenance note [arXiv / hf]

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding/logits tables padded to 256; logits of pad ids are
        masked in lm_logits."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def layer_kind(self, i: int) -> str:
        """Block type at depth i, covering dense/moe/hybrid interleaves."""
        if self.family == "ssm":
            assert self.xlstm is not None
            return "slstm" if (i % self.xlstm.slstm_every) == (self.xlstm.slstm_every - 1) else "mlstm"
        if self.family == "hybrid":
            return "attn" if (i % self.attn_every) == (self.attn_every // 2) else "mamba"
        return "attn"

    def is_moe_layer(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.every_k_layers) == (self.moe.every_k_layers - 1)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant: same family/block structure, tiny dimensions."""
    small: dict = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else 8),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        max_seq=256,
        param_dtype="float32",
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2), d_expert=64)
    if cfg.frontend != "none":
        small["frontend_dim"] = 64
        small["frontend_len"] = 16
    if cfg.encdec:
        small["n_enc_layers"] = 2
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.param_dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown param_dtype {name!r}")
    return dtype
