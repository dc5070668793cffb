"""Declarative parameter tables (port of ``repro/models/params.py``).

Models declare parameters as ``ParamDef`` entries (shape + logical axes +
init law).  From one table the port derives ``param_count`` and the
materialized weights.  Shapes are the reference's (``wq`` is
``(layers, d, H, dh)``, and so on), so the reference's weights load with
a dtype cast and are never re-drawn (``params_from_jax``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...]
    dtype: Any = torch.bfloat16
    init: str = "normal"        # normal | zeros | ones | embed
    scale: float | None = None  # None -> fan-in 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(
                f"shape {self.shape} vs logical axes {self.logical_axes}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


ParamTable = dict  # nested dict[str, ParamDef | ParamTable]


def _map_table(table: ParamTable, fn: Callable[[ParamDef], Any]):
    out = {}
    for k, v in table.items():
        out[k] = fn(v) if isinstance(v, ParamDef) else _map_table(v, fn)
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def param_count(table: ParamTable) -> int:
    return sum(_leaves(_map_table(table, lambda d: d.size)))


def init_params(table: ParamTable, generator: torch.Generator,
                device: torch.device | str, dtype=None):
    """Materialize weights on ``device`` from a seeded ``generator`` (which
    must live on the same device).  The init law is the reference's
    (normal x fan-in scale, embed 0.02, ones, zeros); the draws are
    torch's own, so they differ from the reference's bits — parity tests
    load the reference's weights instead (``params_from_jax``)."""

    def one(d: ParamDef):
        dt = dtype or d.dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        if d.scale is not None:
            scale = d.scale
        elif d.init == "embed":
            scale = 1.0
        else:
            fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[-1], 1)
            scale = 1.0 / math.sqrt(fan_in)
        w = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(dt)

    return _map_table(table, one)


def params_from_jax(tree, device: torch.device | str = "cpu"):
    """Load a reference parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) bit for bit.  bf16 arrives as
    ``ml_dtypes.bfloat16``; it is reinterpreted through ``int16``, never
    converted, so every weight crosses unchanged.  A loader, not an entry
    point: it leaves the tensors on the CPU unless given ``device``, and
    the caller moves them with the rest of its state."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)
