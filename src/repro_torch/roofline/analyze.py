"""Roofline terms of a step from the port's step counter (port of
``repro.roofline.analyze``).

    compute term    = FLOPs / peak bf16 FLOP/s             (per card)
    memory term     = bytes accessed / HBM bytes/s         (per card)
    collective term = wire bytes / NVLink bytes/s          (per card)

The inputs come from ``roofline.trace.StepCounter`` (the dry run traces a
step on the ``meta`` device): counts per card, as the JAX package's
``cost_analysis()`` of an SPMD module is per device.  ``model_flops`` is
6*N_active*D per training token and 2*N_active*D per served token, so the
useful-compute ratio exposes recomputation and redundant work.  ``mfu`` is
the model FLOPs' share of what the card could do in a measured step
(``Roofline.with_step``): only a run on the card gives that time.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..configs.base import ModelConfig, ShapeConfig
from . import hw
from .trace import CollectiveStats


def count_params(cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameter counts from the config arithmetic (the
    JAX package's, term for term)."""
    d, v = cfg.d_model, cfg.vocab_size
    dh = cfg.head_dim
    embed = v * d * (1 if cfg.tie_embeddings else 2)
    total = embed
    active = embed
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            blk = d * cfg.n_heads * dh * 2 + d * cfg.n_kv_heads * dh * 2
        elif kind == "mamba":
            mc = cfg.mamba
            di = d * mc.expand
            dtr = max(1, -(-d // 16))
            blk = d * 2 * di + di * (dtr + 2 * mc.d_state) + dtr * di + di * d
        elif kind == "mlstm":
            xc = cfg.xlstm
            d_up = int(d * xc.proj_factor)
            d_up -= d_up % cfg.n_heads
            dk = int(d_up * xc.qk_dim_factor)
            blk = d * 2 * d_up + d_up * (2 * dk + d_up) + d_up * d
        elif kind == "slstm":
            blk = d * 4 * d + 4 * d * (d // cfg.n_heads) + d * d
        else:
            blk = 0
        total += blk
        active += blk
        if cfg.is_moe_layer(i):
            m = cfg.moe
            expert = 3 * d * m.d_expert
            total += m.n_experts * expert + d * m.n_experts
            active += m.top_k * expert + d * m.n_experts
            if m.n_shared_experts:
                sh = 3 * d * (m.d_expert * m.n_shared_experts)
                total += sh
                active += sh
        elif cfg.d_ff > 0:
            n_mat = 3 if cfg.activation == "swiglu" else 2
            total += n_mat * d * cfg.d_ff
            active += n_mat * d * cfg.d_ff
    if cfg.encdec:
        # encoder layers + decoder cross-attn (approx: same attn+mlp block)
        enc = cfg.n_enc_layers * (4 * d * d + (3 if cfg.activation == "swiglu"
                                               else 2) * d * cfg.d_ff)
        cross = cfg.n_layers * 4 * d * d
        total += enc + cross
        active += enc + cross
    return int(total), int(active)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    peak_memory_bytes: Optional[float]
    collectives: dict
    step_seconds: Optional[float] = None
    mfu: Optional[float] = None

    def with_step(self, step_seconds: float) -> "Roofline":
        """This roofline with a measured step time and its ``mfu``: model
        FLOPs per card / (step seconds x peak bf16 FLOP/s)."""
        return dataclasses.replace(
            self, step_seconds=float(step_seconds),
            mfu=self.model_flops / (step_seconds * hw.PEAK_FLOPS_BF16))

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N_active*D for a training step, 2*N_active*D for serving (D the
    prompt tokens of a prefill, one token per sequence of a decode)."""
    _, active_p = count_params(cfg)
    if shape.kind == "train":
        return 6.0 * active_p * shape.global_batch * shape.seq_len
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "prefill"
                                   else 1)
    return 2.0 * active_p * tokens


def analyze(cfg: ModelConfig, shape: ShapeConfig, mesh_name: str, chips: int,
            cost: dict, collective_stats: CollectiveStats,
            peak_memory: Optional[float] = None) -> Roofline:
    """The three terms from per-card ``cost`` (``"flops"``, ``"bytes
    accessed"``) and collective stats, against this card's constants."""
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    wire = float(collective_stats.total_wire_bytes)

    compute_s = flops / hw.PEAK_FLOPS_BF16
    memory_s = bytes_acc / hw.HBM_BW
    coll_s = wire / hw.NVLINK_BW
    dominant = max(
        (("compute", compute_s), ("memory", memory_s), ("collective", coll_s)),
        key=lambda kv: kv[1])[0]

    model_flops_per_chip = model_flops(cfg, shape) / chips
    useful = model_flops_per_chip / flops if flops > 0 else 0.0

    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_chip=flops, hbm_bytes_per_chip=bytes_acc,
        wire_bytes_per_chip=wire,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dominant, model_flops=model_flops_per_chip,
        useful_ratio=useful, peak_memory_bytes=peak_memory,
        collectives=collective_stats.to_json(),
    )
