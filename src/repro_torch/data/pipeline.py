"""Host -> device data feed with a checkpointable position (port of
``repro.data.pipeline``).

The batches are the JAX package's, drawn by the same numpy generator from
(seed, step); the JAX package places them with ``NamedSharding``, here
they go whole to the mesh's device, where the virtual ranks share them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .synthetic import DataConfig, SyntheticTokens, stub_frontend_batch


class DataPipeline:
    """Yields device batches; ``state`` is just the step index."""

    def __init__(self, cfg: ModelConfig, seq_len: int, global_batch: int,
                 mesh=None, seed: int = 1234):
        self.model_cfg = cfg
        self.mesh = mesh
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.tokens = SyntheticTokens(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=self._token_len(),
            global_batch=global_batch, seed=seed))
        self.step = 0

    def _token_len(self) -> int:
        cfg = self.model_cfg
        if cfg.family == "audio":
            return min(cfg.max_seq, 448)
        if cfg.family == "vlm":
            return self.seq_len - cfg.frontend_len
        return self.seq_len

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        return t if self.mesh is None else t.to(self.mesh.device)

    def batch_at(self, step: int) -> dict:
        cfg = self.model_cfg
        out = {"tokens": self._put(self.tokens.batch_at(step))}
        if cfg.family == "audio":
            out["frames"] = self._put(stub_frontend_batch(
                step, self.global_batch, self.seq_len, cfg.d_model))
        elif cfg.family == "vlm":
            out["patches"] = self._put(stub_frontend_batch(
                step, self.global_batch, cfg.frontend_len, cfg.frontend_dim))
        return out

    def __next__(self) -> dict:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    # -- checkpointable state --
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
