"""Architecture registry of the port: ``--arch <id>`` resolution and the
shape-cell catalogue (port of ``repro.configs.registry``).

It holds every architecture of the JAX package's registry
(``repro.configs.registry.ARCHS``); any other name is unknown.  The 40
assigned cells are 10 architectures x 4 shapes; a cell whose shape does
not apply to the family (quadratic attention at 524k) is a skip with its
reason, as in the JAX package.
"""

from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeConfig, reduced
from .deepseek_67b import CONFIG as DEEPSEEK_67B
from .internvl2_26b import CONFIG as INTERNVL2_26B
from .jamba_v01_52b import CONFIG as JAMBA_V01_52B
from .minicpm_2b import CONFIG as MINICPM_2B
from .moonshot_v1_16b_a3b import CONFIG as MOONSHOT_V1_16B_A3B
from .nemotron_4_15b import CONFIG as NEMOTRON_4_15B
from .olmo_1b import CONFIG as OLMO_1B
from .olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from .whisper_base import CONFIG as WHISPER_BASE
from .xlstm_125m import CONFIG as XLSTM_125M

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        DEEPSEEK_67B, NEMOTRON_4_15B, MINICPM_2B, OLMO_1B, INTERNVL2_26B,
        OLMOE_1B_7B, MOONSHOT_V1_16B_A3B, XLSTM_125M, JAMBA_V01_52B,
        WHISPER_BASE,
    ]
}


def get(arch_id: str) -> ModelConfig:
    key = arch_id.replace("_", "-")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[key]


def get_reduced(arch_id: str, **overrides) -> ModelConfig:
    return reduced(get(arch_id), **overrides)


def list_archs() -> list[str]:
    return sorted(ARCHS)


def shape_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    """None if the (arch, shape) cell runs; else the documented skip reason."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return ("full quadratic attention at 524k context is a degenerate "
                "port; long_500k runs only for SSM/hybrid archs per spec")
    return None


def cells(include_skipped: bool = False):
    """All 40 assigned (arch, shape, skip reason) cells, in the JAX
    package's order; skipped cells only with ``include_skipped``."""
    out = []
    for name in list_archs():
        cfg = ARCHS[name]
        for sname, shape in SHAPES.items():
            reason = shape_skip_reason(cfg, shape)
            if reason is None or include_skipped:
                out.append((cfg, shape, reason))
    return out
