"""Architecture registry: one module per ported architecture."""

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeConfig, SHAPES, ARCHS, register, get_config,
)

# import for registration side effects
from repro_torch.configs import deepseek_7b, lulesh_dash, picolm  # noqa: F401, E402
