"""VLM (InternVL2-style) wrapper: stub vision frontend + LM backbone (port
of ``repro.models.vlm``).

The ViT is a stub, as in the JAX package: the caller supplies patch
embeddings ``[B, N_patch, frontend_dim]`` (InternViT's hidden size).  The
model owns the MLP projector (frontend_dim -> d_model, RMS-normalised in
float32 first) and the decoder; the projected patches are prepended to the
token embeddings (``transformer.forward(extra_embeds=...)``) and the loss
covers text positions only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..parallel.sharding import ScopedFactory, normal_init, ones_init
from . import transformer


def init_projector(f: ScopedFactory, d_vit: int, d_model: int) -> None:
    f.param("ln_scale", (d_vit,), ("embed",), ones_init())
    f.param("w1", (d_vit, d_model), ("embed", "ff"), normal_init(d_vit ** -0.5))
    f.param("w2", (d_model, d_model), ("ff", "embed"), normal_init(d_model ** -0.5))


def project_patches(params: dict, patches: torch.Tensor) -> torch.Tensor:
    x32 = patches.float()
    var = x32.square().mean(-1, keepdim=True)
    x = (x32 * torch.rsqrt(var + 1e-5)
         * params["ln_scale"].float()).to(patches.dtype)
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(x @ params["w1"].to(x.dtype), approximate="tanh")
    return h @ params["w2"].to(x.dtype)


def vlm_loss(params: dict, cfg: ModelConfig, batch: dict, *,
             moe_plan=None, remat: bool = True):
    """batch: {"patches": [B, N_p, d_vit], "tokens": [B, S_text]}."""
    tokens = batch["tokens"]
    img = project_patches(params["projector"], batch["patches"])
    hidden, aux, _ = transformer.forward(
        params, cfg, tokens, moe_plan=moe_plan, extra_embeds=img, remat=remat,
        return_hidden=True)
    total, denom = transformer.chunked_nll(params, cfg, hidden, tokens,
                                           offset=img.shape[1])
    loss = total / denom
    metrics = {"nll": loss, "loss": loss}
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss * aux[0] + cfg.moe.router_z_loss * aux[1]
        metrics.update({"moe_lb": aux[0], "moe_z": aux[1], "loss": loss})
    return loss, metrics
