"""Deterministic, restart-safe data pipeline (port of
``repro/data/pipeline.py``).

Batches are a pure function of (seed, step): after a failure the training
loop resumes from checkpoint step k and regenerates batch k+1 bit for
bit.  ``SyntheticSource`` draws the reference's arrays exactly (the
same ``RandomState`` stream over the same declarative batch table, in
its insertion order); ``DataPipeline`` moves them to the training device
and, on a mesh of several ranks, keeps each rank's shard (``shard_batch``:
every rank draws the whole batch, so nothing is sent).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.models.params import ParamDef, _map_table


@dataclasses.dataclass
class SyntheticSource:
    """Language-modeling stream: labels are tokens shifted by one."""
    vocab_size: int
    seed: int = 0

    def batch(self, table: dict, step: int) -> dict:
        """The reference's arrays for ``table`` at ``step``: numpy for an
        int32 leaf, a CPU tensor for a float one (numpy has no bf16)."""
        rng = np.random.RandomState((self.seed * 1_000_003 + step)
                                    % (2**31 - 1))

        def gen(d: ParamDef):
            if d.dtype == torch.int32:
                hi = max(self.vocab_size - 1, 2)
                return rng.randint(1, hi, size=d.shape).astype(np.int32)
            if not d.dtype.is_floating_point:
                raise ValueError(f"no synthetic draw for {d.dtype} inputs")
            # float64 draws rounded to f32, then to the leaf's dtype: the
            # reference's ``astype`` (ml_dtypes rounds through f32 too)
            x = torch.from_numpy(rng.randn(*d.shape) * 0.02)
            return x.to(torch.float32).to(d.dtype)

        out = _map_table(table, gen)
        # make labels the next-token shift of tokens (real LM objective)
        if "tokens" in out and "labels" in out:
            t = out["tokens"]
            out["labels"] = np.concatenate(
                [t[:, 1:], np.ones_like(t[:, :1])], axis=1)
        return out


def shard_batch(batch: dict, table: dict, mesh, rules=None) -> dict:
    """A batch on ``mesh`` under the table's logical axes: on a live mesh
    of several ranks each leaf is a DTensor holding this rank's rows
    (``act_batch`` -> ``("pod", "data")``); off-mesh or on one device the
    batch as it is."""
    if mesh is None or mesh.device_mesh is None:
        return batch
    from repro_torch.sharding.rules import (DEFAULT_RULES, distribute,
                                            logical_to_spec)
    rules = rules or DEFAULT_RULES
    return {k: distribute(v, logical_to_spec(
        table[k].logical_axes, table[k].shape, mesh, rules), mesh)
        for k, v in batch.items()}


class DataPipeline:
    """Pipeline facade used by the training driver: the model's batch
    table for ``shape``, drawn by ``SyntheticSource``, put on ``device``
    and sharded over ``mesh`` (``shard_batch``)."""

    def __init__(self, model, shape: ShapeConfig, seed: int = 0,
                 device: torch.device | str = "cpu", mesh=None):
        self.table = model.batch_table(shape)
        self.source = SyntheticSource(model.cfg.vocab_size or 256, seed)
        self.device = torch.device(device)
        self.mesh = mesh

    def batch_at(self, step: int) -> dict:
        return shard_batch(to_device(self.source.batch(self.table, step),
                                     self.device), self.table, self.mesh)


def to_device(batch: dict, device) -> dict:
    """A ``SyntheticSource`` batch (numpy arrays and tensors) on
    ``device``."""
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(v)).to(device)
            for k, v in batch.items()}
