"""Architecture registry of the port: ``--arch <id>`` resolution.

It holds the ported architectures only.  An architecture the JAX package
has but the port does not yet raises ``NotImplementedError`` naming its
ROADMAP.md item; any other name is unknown.
"""

from __future__ import annotations

from ..core.plan import not_ported
from .base import ModelConfig, reduced
from .deepseek_67b import CONFIG as DEEPSEEK_67B
from .minicpm_2b import CONFIG as MINICPM_2B
from .moonshot_v1_16b_a3b import CONFIG as MOONSHOT_V1_16B_A3B
from .nemotron_4_15b import CONFIG as NEMOTRON_4_15B
from .olmo_1b import CONFIG as OLMO_1B
from .olmoe_1b_7b import CONFIG as OLMOE_1B_7B

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        DEEPSEEK_67B, NEMOTRON_4_15B, MINICPM_2B, OLMO_1B, OLMOE_1B_7B,
        MOONSHOT_V1_16B_A3B,
    ]
}

# The JAX package's other architectures (``repro.configs.registry.ARCHS``):
# the state-space, hybrid, vision and audio families.
NOT_PORTED = ("internvl2-26b", "jamba-v0.1-52b", "whisper-base", "xlstm-125m")


def get(arch_id: str) -> ModelConfig:
    key = arch_id.replace("_", "-")
    if key in ARCHS:
        return ARCHS[key]
    if key in NOT_PORTED:
        raise not_ported(f"arch {key!r}", "item 6c, the state-space, "
                         "audio and vision families")
    raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")


def get_reduced(arch_id: str, **overrides) -> ModelConfig:
    return reduced(get(arch_id), **overrides)


def list_archs() -> list[str]:
    return sorted(ARCHS)
