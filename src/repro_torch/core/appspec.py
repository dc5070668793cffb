"""AppSpec — the portable application description (port of the part of
``repro/core/appspec.py`` the serving engine uses: the arch, the shape
and the shape's overrides).  Appfile parsing, config overrides and the
injection directives come with the deployment layers (ROADMAP slice
C)."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, get_config


@dataclasses.dataclass
class AppSpec:
    arch: str
    shape: str
    shape_overrides: dict = dataclasses.field(default_factory=dict)

    @property
    def model_config(self) -> ModelConfig:
        return get_config(self.arch)

    @property
    def shape_config(self) -> ShapeConfig:
        sc = SHAPES[self.shape]
        return dataclasses.replace(sc, **self.shape_overrides) \
            if self.shape_overrides else sc
