"""Family-dispatched model API used by the launchers and tests (port of
``repro.models.api``): the decoder-only families (dense, MoE, the
state-space ``ssm`` and ``hybrid`` stacks, the ``vlm`` with its
projector) through ``transformer``, the ``audio`` encoder-decoder through
``whisper``."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..configs.base import ModelConfig, torch_dtype
from . import moe as moe_mod
from . import transformer, vlm, whisper


class TensorSpec(NamedTuple):
    """Shape and dtype of one batch entry (``jax.ShapeDtypeStruct``'s
    stand-in)."""
    shape: tuple
    dtype: torch.dtype


def init_model(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Returns (params, logical_specs), drawn from ``generator`` on
    ``device`` (default: the generator's device)."""
    if cfg.family == "audio":
        return whisper.init_whisper(cfg, generator, device)
    return transformer.init_lm(cfg, generator, device)


def build_moe_plan(cfg: ModelConfig, tokens_per_dp_shard: int, mesh,
                   store=None, hier_leader_perm=None):
    """One plan-backed EP dispatch plan per (config geometry, mesh): the
    model-INIT half of the persistent MoE dispatch.  The backing
    ``AlltoallvPlan`` is built here, once, and every step replays its
    embedded epoch.  None for models without MoE layers."""
    if cfg.moe is None:
        return None
    return moe_mod.MoEDispatchPlan.build(
        cfg.moe, tokens_per_dp_shard, mesh, d_model=cfg.d_model,
        dtype=torch_dtype(cfg.param_dtype), store=store,
        hier_leader_perm=hier_leader_perm)


def model_loss(params, cfg: ModelConfig, batch: dict, *,
               moe_plan=None, remat: bool = True):
    """Family-dispatched training loss: (scalar, metrics dict)."""
    if cfg.family == "audio":
        return whisper.whisper_loss(params, cfg, batch, remat=remat)
    if cfg.family == "vlm":
        return vlm.vlm_loss(params, cfg, batch, moe_plan=moe_plan, remat=remat)
    return transformer.lm_loss(params, cfg, batch, moe_plan=moe_plan,
                               remat=remat)


def batch_spec(cfg: ModelConfig, batch_size: int, seq_len: int,
               dtype=torch.int32) -> dict:
    """``TensorSpec``s of one training batch: the tokens, and the stub
    frontend's frames (audio: the encoder sees ``seq_len`` frames, the
    decoder trains on ``min(max_seq, 448)`` tokens) or patches (vlm:
    ``frontend_len`` of them, ``seq_len`` minus those text tokens)."""
    if cfg.family == "audio":
        return {"frames": TensorSpec((batch_size, seq_len, cfg.d_model),
                                     torch.bfloat16),
                "tokens": TensorSpec((batch_size, min(cfg.max_seq, 448)),
                                     dtype)}
    if cfg.family == "vlm":
        n_img = cfg.frontend_len
        return {"patches": TensorSpec((batch_size, n_img, cfg.frontend_dim),
                                      torch.bfloat16),
                "tokens": TensorSpec((batch_size, seq_len - n_img), dtype)}
    return {"tokens": TensorSpec((batch_size, seq_len), dtype)}


def _to_tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: no numpy twin
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_jax(tree, device, dtype=None):
    """The JAX package's parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's: the same keys and
    layouts, as tensors on ``device``, cast to ``dtype`` if given.  Every
    key carries over as it is: ``attn``, ``moe`` (with the shared experts'
    ``sh_gate``/``sh_up``/``sh_down``), ``mlp`` (``w_gate``/``w_up`` or
    ``w_in``, and ``w_down``), ``mamba`` (``a_log``, ``dt_bias``,
    ``conv_w``, ...), ``mlstm``/``slstm``, Whisper's stacked ``enc``/``dec``
    and ``pos_embed``, the VLM ``projector`` (``ln_scale``, ``w1``,
    ``w2``), the norms (none under OLMo's ``nonparametric_ln``), the
    embedding and the head."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    return _to_tensor(tree, device, dtype)


def opt_state_from_jax(state, device):
    """The JAX package's optimizer state (``init_opt_state``'s dict, as
    numpy: ``m``, ``v``, ``count`` and, where present, ``master`` and
    ``grad_err``) as the port's, on ``device``.  Dtypes are kept: fp32
    moments, an int32 count."""
    return params_from_jax(state, device)
