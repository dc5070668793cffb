"""Logical-axis sharding rules with divisibility fallback (port of
``repro/sharding/rules.py``).

A portable model declares *logical* axis names on every parameter and
activation dimension, and the deployment layer maps them onto the
target's mesh.  The rules engine drops mesh axes that do not divide the
concrete dimension (e.g. 2 KV heads on a 4-way model axis fall back to
replication) and records every fallback for the tuning report.

``logical_to_spec`` reads only the mesh's axis names and sizes, so a
mesh description with no process group (``launch.mesh.Mesh``) serves
the rules, the build and the tests.  A spec is a ``PartitionSpec``: one
entry per tensor dimension, ``None``, a mesh axis name, or a tuple of
names that shard the dimension jointly, major first (the reference's
``jax.sharding.PartitionSpec``, entry for entry).  ``placements`` turns
a spec into DTensor placements on a live mesh, and ``distribute`` puts a
full tensor, held alike by every rank, onto the mesh as the rank's
shard, sending nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import torch

# Logical axis vocabulary.
#   parameters:  "embed", "mlp", "heads", "kv_heads", "head_dim", "vocab",
#                "experts", "layers", "conv", "state"
#   activations: "act_batch", "act_seq", "act_embed", "act_heads",
#                "act_kv_heads", "act_vocab", "act_experts"
LOGICAL_AXES = (
    "embed", "mlp", "heads", "kv_heads", "head_dim", "vocab", "experts",
    "layers", "conv", "state", "vocab_in", "embed_feat",
    "act_batch", "act_seq", "act_embed", "act_heads", "act_kv_heads",
    "act_vocab", "act_experts", "act_state", "act_mlp",
    # LULESH / stencil domain axes
    "grid_x", "grid_y", "grid_z", "act_grid_x", "act_grid_y", "act_grid_z",
)


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor: ``None``, a name or a tuple
    of names (major first); equal to the reference's ``PartitionSpec``
    with the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis -> tuple of candidate mesh axes (priority order).

    Each logical axis may list several mesh axes; they are applied jointly
    (a tuple entry) when all of them divide the dimension and none has
    been consumed by an earlier dimension of the same spec.
    """

    rules: Mapping[str, tuple[str, ...]]

    def get(self, logical: str | None) -> tuple[str, ...]:
        if logical is None:
            return ()
        return tuple(self.rules.get(logical, ()))

    def replace(self, **updates: tuple[str, ...]) -> "AxisRules":
        merged = dict(self.rules)
        merged.update(updates)
        return AxisRules(rules=merged)


# Baseline rules for the production meshes ("pod", "data", "model").
# FSDP: parameter "embed" dim over the data axis (ZeRO-3 storage sharding);
# TP: "mlp"/"heads"/"vocab" over the model axis; DP: batch over (pod, data).
DEFAULT_RULES = AxisRules(rules={
    "embed": ("data",),
    "vocab_in": (),            # input embedding: vocab replicated (I3)
    "embed_feat": ("model",),  # input embedding: features TP-sharded (I3)
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "vocab": ("model",),
    "experts": ("model",),
    "layers": (),
    "conv": (),
    "state": (),
    "act_batch": ("pod", "data"),
    "act_seq": (),
    "act_embed": (),
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_vocab": ("model",),
    "act_experts": ("model",),
    "act_state": (),
    "act_mlp": ("model",),
    "grid_x": ("data",),
    "grid_y": ("model",),
    "grid_z": (),
    "act_grid_x": ("data",),
    "act_grid_y": ("model",),
    "act_grid_z": (),
})

# Sequence-parallel variant: long activations sharded along the model axis.
SEQUENCE_PARALLEL_RULES = DEFAULT_RULES.replace(
    act_seq=("model",),
    act_heads=(),
    act_kv_heads=(),
)

# Decode-cache variant (the reference's perf iteration I1): when
# num_kv_heads doesn't divide the model axis the default rules replicate
# the KV cache; sharding the cache SEQUENCE axis instead distributes it.
DECODE_SEQ_CACHE_RULES = DEFAULT_RULES.replace(
    act_seq=("model",),
    act_kv_heads=(),
    act_heads=(),
)


def axis_sizes(mesh) -> dict[str, int]:
    """Mesh axis name -> size, of a ``launch.mesh.Mesh``."""
    return dict(zip(mesh.axis_names, mesh.shape))


def logical_to_spec(
    logical_axes: Sequence[str | None],
    dim_sizes: Sequence[int],
    mesh,
    rules: AxisRules,
    fallbacks: list[str] | None = None,
) -> PartitionSpec:
    """Translate per-dimension logical axes into a PartitionSpec.

    A mesh axis is used on a dimension only if (a) it exists on the mesh,
    (b) it has not been consumed by an earlier dimension of this spec, and
    (c) the product of chosen axis sizes divides the dimension size.  Axes
    failing (c) are dropped (replication fallback) and reported.
    """
    if len(logical_axes) != len(dim_sizes):
        raise ValueError(
            f"logical axes {logical_axes} do not match rank {len(dim_sizes)}")
    used: set[str] = set()
    entries: list = []
    sizes = axis_sizes(mesh)
    for logical, dim in zip(logical_axes, dim_sizes):
        chosen: list[str] = []
        prod = 1
        for mesh_axis in rules.get(logical):
            if mesh_axis not in sizes or mesh_axis in used:
                continue
            nxt = prod * sizes[mesh_axis]
            if dim % nxt == 0:
                chosen.append(mesh_axis)
                prod = nxt
            elif fallbacks is not None:
                fallbacks.append(
                    f"{logical}:{mesh_axis} dropped (dim {dim} % {nxt} != 0)")
        used.update(chosen)
        if not chosen:
            entries.append(None)
        elif len(chosen) == 1:
            entries.append(chosen[0])
        else:
            entries.append(tuple(chosen))
    return PartitionSpec(*entries)


def spec_for(logical_axes: Sequence[str | None], dim_sizes: Sequence[int],
             mesh, rules: AxisRules | None = None) -> PartitionSpec:
    """The spec under ``rules`` (default: DEFAULT_RULES).  The reference
    wraps it in a ``NamedSharding``; here the mesh travels beside it."""
    return logical_to_spec(logical_axes, dim_sizes, mesh,
                           rules or DEFAULT_RULES)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: PartitionSpec, mesh) -> list:
    """DTensor placements of ``spec``: for each mesh dimension, ``Shard(d)``
    where the spec puts that mesh axis on tensor dimension d, else
    ``Replicate()``.  A tuple entry shards one dimension over several mesh
    dimensions; DTensor orders them by mesh dimension, so the tuple must
    name them in the mesh's order (major first, as JAX orders them)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.axis_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise NotImplementedError(
                f"spec entry {entry} names mesh axes out of the mesh's "
                f"order {names}: DTensor shards a dimension major first in "
                f"mesh order")
        for i in pos:
            out[i] = Shard(d)
    return out


def shard_index(shape: Sequence[int], placements_: Sequence,
                mesh_shape: Sequence[int],
                coordinate: Sequence[int]) -> tuple[slice, ...]:
    """The index of the shard that the rank at ``coordinate`` (one index
    per mesh dimension) holds of a tensor of ``shape`` under DTensor
    ``placements_``: a dimension sharded over mesh dimensions (a, b, ...)
    is cut into ``prod(sizes)`` equal blocks, and the rank holds block
    ``i``, ``i`` row-major over its coordinates on them."""
    n, i = [1] * len(shape), [0] * len(shape)
    for m, pl in enumerate(placements_):
        if pl.is_shard():
            n[pl.dim] *= mesh_shape[m]
            i[pl.dim] = i[pl.dim] * mesh_shape[m] + coordinate[m]
    out = []
    for dim, k, j in zip(shape, n, i):
        if dim % k:
            raise ValueError(f"dimension {dim} does not split over {k} "
                             f"ranks")
        out.append(slice(j * (dim // k), (j + 1) * (dim // k)))
    return tuple(out)


def local_slices(spec: PartitionSpec, shape: Sequence[int], mesh,
                 coordinate: Sequence[int]) -> tuple[slice, ...]:
    """``shard_index`` of ``spec``'s placements on ``mesh``."""
    return shard_index(shape, placements(spec, mesh), mesh.shape,
                       coordinate)


def contiguous_stride(shape: Sequence[int]) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (a DTensor made
    from local shards is told its global shape and these)."""
    stride, n = [], 1
    for dim in reversed(shape):
        stride.insert(0, n)
        n *= dim
    return tuple(stride)


def distribute(full: torch.Tensor, spec: PartitionSpec, mesh):
    """``full``, held whole by every rank, on ``mesh`` under ``spec``: a
    DTensor whose local part is this rank's slice (``local_slices``), so
    nothing is sent.  The mesh must be live (``mesh.device_mesh``) and
    hold this rank."""
    from torch.distributed.tensor import DTensor
    dm = mesh.device_mesh
    coord = dm.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    local = full[local_slices(spec, full.shape, mesh, coord)].contiguous()
    return DTensor.from_local(local, dm, placements(spec, mesh),
                              run_check=False, shape=full.shape,
                              stride=contiguous_stride(full.shape))


def zeros_at_rest(shape: Sequence[int], dtype, spec: PartitionSpec, mesh,
                  device):
    """Zeros of ``shape`` on ``mesh`` under ``spec``, as ``distribute``
    would place them, with this rank's shard all that is allocated."""
    from torch.distributed.tensor import DTensor
    dm = mesh.device_mesh
    coord = dm.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    local = [s.stop - s.start
             for s in local_slices(spec, shape, mesh, coord)]
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              dm, placements(spec, mesh), run_check=False,
                              shape=tuple(shape),
                              stride=contiguous_stride(shape))


def data_parallel_dims(rows: int, mesh) -> list[int]:
    """The mesh dimensions of more than one rank that split a batch of
    ``rows`` rows (``act_batch``'s spec, divisibility fallback
    included)."""
    pls = placements(spec_for(("act_batch",), (rows,), mesh), mesh)
    return [m for m, pl in enumerate(pls)
            if pl.is_shard() and mesh.shape[m] > 1]


def shard_constraint(x, logical_axes: Sequence[str | None], mesh,
                     rules: AxisRules | None = None):
    """Redistribute a DTensor to the placements its logical axes give on
    ``mesh``.  The identity off-mesh (``mesh`` None), on a one-device mesh
    and for a plain tensor, so the same code runs on one device and on a
    mesh."""
    from torch.distributed.tensor import DTensor
    if mesh is None or math.prod(mesh.shape) == 1 or \
            not isinstance(x, DTensor):
        return x
    spec = spec_for(logical_axes, x.shape, mesh, rules)
    return x.redistribute(mesh.device_mesh, placements(spec, mesh))
