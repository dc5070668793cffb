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


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more trees of dicts and lists of
    the same structure, as ``jax.tree.map``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaf_items(tree, is_leaf=lambda x: not isinstance(x, dict),
               path=()) -> list:
    """(path, leaf) pairs of a tree of dicts in sorted-key order, the
    order of ``jax.tree.leaves`` and of the reference's global norm."""
    if is_leaf(tree):
        return [(path, tree)]
    return [item for k in sorted(tree)
            for item in leaf_items(tree[k], is_leaf, path + (k,))]


def get_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def param_count(table: ParamTable) -> int:
    return sum(_leaves(_map_table(table, lambda d: d.size)))


def init_params(table: ParamTable, generator: torch.Generator,
                device: torch.device | str, dtype=None):
    """Materialize weights on ``device`` from a seeded ``generator`` (which
    must live on the same device).  The init law is the reference's
    (normal x fan-in scale, embed 0.02, ones, zeros), the fan-in taken
    from the whole leaf's ``shape[0]`` (a stacked leaf's layer count);
    the draws are torch's own, so they differ from the reference's bits —
    parity tests load the reference's weights instead (``params_from_jax``).

    A stacked leaf (leading ``layers`` axis) is drawn one layer at a time
    in f32, straight into its slice of the leaf, so the peak is the
    weights plus one layer's f32 draw (a whole-leaf f32 draw of a 34 B
    model's MLP leaves alone would be 33 GiB)."""

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
        w = torch.empty(d.shape, dtype=dt, device=device)
        stacked = d.logical_axes[:1] == ("layers",)
        for part in (w.unbind(0) if stacked else (w,)):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32,
                                   device=device).mul_(scale))
        return w

    return _map_table(table, one)


def partition_specs(table: ParamTable, mesh, rules=None,
                    fallbacks: list[str] | None = None):
    """The spec tree of a table on ``mesh`` (``sharding.rules.
    logical_to_spec`` of every leaf), each fallback appended to
    ``fallbacks``."""
    from repro_torch.sharding.rules import DEFAULT_RULES, logical_to_spec
    rules = rules or DEFAULT_RULES
    return _map_table(table, lambda d: logical_to_spec(
        d.logical_axes, d.shape, mesh, rules, fallbacks))


def replicated_specs(tree, mesh):
    """Every leaf of ``tree`` replicated (on any mesh)."""
    from repro_torch.sharding.rules import PartitionSpec
    return tree_map(lambda _: PartitionSpec(), tree)


def bytes_of(tree) -> int:
    """Total bytes of a tree of tensors or ParamDefs."""
    return sum(math.prod(leaf.shape) * leaf.dtype.itemsize
               for _, leaf in leaf_items(tree))


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
