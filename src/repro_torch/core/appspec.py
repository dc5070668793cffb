"""AppSpec — the portable application description (Dockerfile analogue),
port of ``repro/core/appspec.py``.

The paper's EASEY client consumes a Dockerfile with injection hooks
(``###includelocalmpi###``).  This client consumes an **Appfile**: a small
line-oriented spec naming the architecture, the input shape and the
execution, with the same hook mechanism — directives the BuildService
replaces with target-specific bricks:

    FROM arch:lulesh-dash
    SHAPE train_4k
    ###include_local_kernels###      <- the target's hand-written kernels
    ###include_local_collectives###  <- target mesh binding
    RUN lulesh -i 1000 -s 13

An AppSpec can equally be constructed programmatically.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, get_config

KNOWN_DIRECTIVES = (
    "###include_local_kernels###",
    "###include_local_collectives###",
    "###include_local_optimizer###",
    "###includelocalmpi###",   # accepted for paper compatibility
)


@dataclasses.dataclass
class AppSpec:
    arch: str
    shape: str
    run: str = "train --steps 10"
    directives: tuple[str, ...] = KNOWN_DIRECTIVES[:3]
    overrides: dict = dataclasses.field(default_factory=dict)
    shape_overrides: dict = dataclasses.field(default_factory=dict)

    @property
    def model_config(self) -> ModelConfig:
        cfg = get_config(self.arch)
        return cfg.replace(**self.overrides) if self.overrides else cfg

    @property
    def shape_config(self) -> ShapeConfig:
        sc = SHAPES[self.shape]
        return dataclasses.replace(sc, **self.shape_overrides) \
            if self.shape_overrides else sc

    def content_hash(self) -> str:
        payload = json.dumps(
            {"arch": self.arch, "shape": self.shape, "run": self.run,
             "directives": list(self.directives),
             "overrides": {k: str(v) for k, v in self.overrides.items()}},
            sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def to_appfile(self) -> str:
        lines = [f"FROM arch:{self.arch}", f"SHAPE {self.shape}"]
        lines += list(self.directives)
        for k, v in self.overrides.items():
            lines.append(f"SET {k}={v}")
        lines.append(f"RUN {self.run}")
        return "\n".join(lines) + "\n"


def parse_appfile(text: str) -> AppSpec:
    arch = shape = None
    run = "train --steps 10"
    directives: list[str] = []
    overrides: dict = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") and not line.startswith("###"):
            continue
        if line.startswith("###"):
            if line not in KNOWN_DIRECTIVES:
                raise ValueError(f"unknown directive {line!r}")
            directives.append(line)
        elif line.startswith("FROM "):
            ref = line[5:].strip()
            if not ref.startswith("arch:"):
                raise ValueError(f"FROM must reference arch:<name>, got {ref!r}")
            arch = ref[5:]
        elif line.startswith("SHAPE "):
            shape = line[6:].strip()
        elif line.startswith("SET "):
            k, v = line[4:].split("=", 1)
            try:
                overrides[k.strip()] = json.loads(v)
            except json.JSONDecodeError:
                overrides[k.strip()] = v.strip()
        elif line.startswith("RUN "):
            run = line[4:].strip()
        else:
            raise ValueError(f"unparseable Appfile line: {raw!r}")
    if arch is None or shape is None:
        raise ValueError("Appfile must contain FROM arch:<name> and SHAPE <name>")
    if shape not in SHAPES:
        raise ValueError(f"unknown shape {shape!r}; known: {sorted(SHAPES)}")
    return AppSpec(arch=arch, shape=shape, run=run,
                   directives=tuple(directives), overrides=overrides)
