"""Model configurations of the port (port of ``repro.configs``)."""

from .base import SHAPES, ModelConfig, MoEConfig, ShapeConfig, reduced, torch_dtype
from .registry import get, get_reduced, list_archs
