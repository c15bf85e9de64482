"""Model configurations of the port (port of ``repro.configs``)."""

from .base import (SHAPES, MambaConfig, ModelConfig, MoEConfig, ShapeConfig,
                   XLSTMConfig, reduced, torch_dtype)
from .registry import cells, get, get_reduced, list_archs, shape_skip_reason
