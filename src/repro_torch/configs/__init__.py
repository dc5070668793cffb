"""Architecture registry: one module per ported architecture."""

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeConfig, SHAPES, ARCHS, register, get_config,
)

# import for registration side effects
from repro_torch.configs import (  # noqa: F401, E402
    dbrx_132b, deepseek_7b, granite_moe_3b_a800m, llava_next_34b,
    lulesh_dash, mistral_large_123b, nemotron_4_340b, picolm,
    stablelm_1_6b, whisper_tiny, xlstm_1_3b, zamba2_7b,
)
