"""Elastic scaling: re-mesh after node loss and continue training (port
of ``repro/runtime/elastic.py``).

Checkpoints are mesh-agnostic (full host arrays), so elasticity is:

    detect loss -> rebuild the mesh without the lost data slice(s)
    -> re-derive the specs with the SAME rules engine (the divisibility
       fallback absorbs the smaller axis) -> place each leaf -> resume.

The global batch is kept by rebalancing the per-replica batch (the
pipeline is keyed by the global step, so the data order is stable
across the transition).  The serving router's autoscaler resizes its
per-replica admission cap with the same keep-the-global-batch rule.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.params import ParamDef, partition_specs, tree_map
from repro_torch.sharding.rules import DEFAULT_RULES, distribute


def _host_tensor(x, d: ParamDef) -> torch.Tensor:
    """A host leaf (a numpy array, bf16 as its raw 16-bit integers or as
    ``ml_dtypes.bfloat16``, or a CPU tensor) as a tensor of the table's
    dtype, bit for bit."""
    if not torch.is_tensor(x):
        a = np.asarray(x)
        a = a if a.flags.c_contiguous else a.copy()
        if d.dtype == torch.bfloat16 and a.dtype.itemsize == 2:
            x = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            x = torch.from_numpy(a)
    if x.dtype != d.dtype or tuple(x.shape) != tuple(d.shape):
        raise ValueError(f"host leaf {x.dtype} {tuple(x.shape)} is not the "
                         f"table's {d.dtype} {tuple(d.shape)}")
    return x


def reshard_state(state, state_table, new_mesh, rules=None,
                  fallbacks: list | None = None):
    """Place a host-restored state (full leaves, as ``Checkpointer``
    restores them) onto a (possibly degraded) mesh under the table's
    specs.  On a one-device mesh each leaf becomes a plain tensor on that
    device (``new_mesh.device``, the card unless it is a CPU mesh); on a
    mesh of ranks, a DTensor holding this rank's shard, sliced from the
    host array every rank holds, so nothing is sent."""
    rules = rules or DEFAULT_RULES
    specs = partition_specs(state_table, new_mesh, rules,
                            [] if fallbacks is None else fallbacks)

    def place(d, x, spec):
        t = _host_tensor(x, d)
        if new_mesh.device_mesh is None:
            return t.to(new_mesh.device)
        return distribute(t.to(new_mesh.device), spec, new_mesh)
    return tree_map(place, state_table, state, specs)


def rebalance_batch_size(global_batch: int, old_data: int, new_data: int,
                         *, allow_shrink: bool = False) -> tuple[int, int]:
    """Keep the global batch; per-replica batch grows on the survivors.

    Returns ``(per_replica, adjusted_global)``.  When ``global_batch``
    does not divide evenly over ``new_data`` replicas the only way to
    keep per-replica batches equal is to shrink the global batch to the
    largest divisible value — a change the caller must opt into with
    ``allow_shrink=True``; otherwise this raises ``ValueError``.
    """
    if new_data <= 0:
        raise ValueError(f"new_data must be positive, got {new_data}")
    adjusted = global_batch
    if adjusted % new_data:
        if not allow_shrink:
            raise ValueError(
                f"global batch {global_batch} does not divide over "
                f"{new_data} replicas (was {old_data}); pass "
                f"allow_shrink=True to shrink to the largest divisible "
                f"global batch")
        adjusted = (adjusted // new_data) * new_data
    return adjusted // new_data, adjusted
