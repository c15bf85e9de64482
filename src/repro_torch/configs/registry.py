"""Architecture registry of the port: ``--arch <id>`` resolution.

It holds the ported architectures only.  An architecture the JAX package
has but the port does not yet raises ``NotImplementedError`` naming its
ROADMAP.md item; any other name is unknown.
"""

from __future__ import annotations

from ..core.plan import not_ported
from .base import ModelConfig, reduced
from .olmoe_1b_7b import CONFIG as OLMOE_1B_7B

ARCHS: dict[str, ModelConfig] = {c.name: c for c in [OLMOE_1B_7B]}

# The JAX package's other architectures (``repro.configs.registry.ARCHS``).
NOT_PORTED = ("deepseek-67b", "internvl2-26b", "jamba-v0.1-52b", "minicpm-2b",
              "moonshot-v1-16b-a3b", "nemotron-4-15b", "olmo-1b",
              "whisper-base", "xlstm-125m")


def get(arch_id: str) -> ModelConfig:
    key = arch_id.replace("_", "-")
    if key in ARCHS:
        return ARCHS[key]
    if key in NOT_PORTED:
        raise not_ported(f"arch {key!r}", "item 6c, the other model families")
    raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")


def get_reduced(arch_id: str, **overrides) -> ModelConfig:
    return reduced(get(arch_id), **overrides)


def list_archs() -> list[str]:
    return sorted(ARCHS)
