"""Token sampling for the serving path (port of ``repro.serve.sampler``).
Random draws come from an explicit ``torch.Generator``; they are not the
JAX package's draws for the same seed."""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: torch.Generator,
           temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """Temperature + optional top-k sampling; temperature 0 = greedy."""
    if temperature <= 0.0:
        return greedy(logits)
    l32 = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(l32, top_k, dim=-1).values[..., -1:]
        l32 = torch.where(l32 < kth, float("-inf"), l32)
    probs = torch.softmax(l32, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0].to(torch.int32)
