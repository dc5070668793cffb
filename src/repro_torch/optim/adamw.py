"""AdamW with declarative state tables (port of ``repro/optim/adamw.py``).

Two variants, selected by the EASEY AutoTuner from memory napkin math:

* ``AdamW``      — f32 moments.
* ``AdamW8bit``  — row-wise dynamically quantized int8 moments (m:
  symmetric int8, v: int8 of sqrt(v)), each row over the last axis.

The update is the reference's, operation for operation, but it runs in
place, leaf by leaf, and within a leaf slice by slice (``slices``): a
stacked block weight layer by layer, a large unstacked one (the
embedding tables) in chunks of rows.  Both variants are elementwise or
row-wise over the last axis, so the slicing leaves every bit as it is;
it bounds each f32 temporary to one slice (a whole stacked ``mlp.wi`` of
``deepseek-7b`` is 1.35 B elements: 5.4 GB an f32 temporary).  The
global norm is taken over every gradient before any slice is updated.

Gradients come as the tree of the parameters, a stacked leaf's either
stacked or as a list of per-layer tensors (as the per-layer autograd
leaves of ``DenseLM.train_leaves`` give them): a list is the leaf's
layers in row-major order over its leading stacked axes (one axis for
the dense blocks, two for the xLSTM and Zamba2 stacks), and the leaf is
updated layer by layer over them.

In a train step split over a mesh (``sharding.split.active()``) the
parameters, gradients and moments are the rank's shards and the update
runs on them: the global norm sums each shard's f32 squares over the
ranks that split its leaf (a shard held alike by several ranks counts
once), and ``AdamW8bit``'s row scale over the last axis is a max over
the ranks that split that axis, so the int8 moments are one device's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.params import (ParamDef, _map_table, get_path,
                                      leaf_items)
from repro_torch.sharding import split as _split

# elements of one slice of an unstacked leaf (256 MB of f32)
SLICE_ELEMS = 1 << 26


def slices(path: tuple, shape: tuple) -> list:
    """Index objects that cut a leaf into the pieces it is updated by:
    one per layer for a stacked block weight (``blocks/...``), chunks of
    whole rows for a large unstacked one, else the whole leaf."""
    if path and path[0] == "blocks":
        return list(range(shape[0]))
    if len(shape) >= 2 and math.prod(shape) > SLICE_ELEMS:
        rows = max(SLICE_ELEMS // math.prod(shape[1:]), 1)
        return [slice(r, r + rows) for r in range(0, shape[0], rows)]
    return [slice(None)]


def layers_of(t: torch.Tensor, layer_shape: tuple) -> torch.Tensor:
    """A stacked leaf (or its moment) as a (layers, ...) view: its
    leading stacked axes flattened into one, ``layer_shape`` (one layer's
    shape, of the leaf itself) left as it is."""
    lead = len(t.shape) - len(layer_shape)
    return t.reshape((-1,) + tuple(t.shape[lead:]))


def global_norm(grads, shards=None) -> torch.Tensor:
    """sqrt of the sum of every gradient's f32 squares (the leaves in
    sorted-key order, each summed slice by slice in ``slices`` order, so
    a stacked gradient and its per-layer list give the same bits).  With
    ``shards`` (a ``Split``) each gradient is this rank's shard: the sums
    of the leaves split over the same mesh dimensions are all-reduced
    over those dimensions, one call for each set of them."""
    totals = {}
    for path, g in leaf_items(grads, lambda x: not isinstance(x, dict)):
        leaf = None
        for ix in (range(len(g)) if isinstance(g, list)
                   else slices(path, tuple(g.shape))):
            part = g[ix].float().square().sum()
            leaf = part if leaf is None else leaf + part
        dims = shards.dims_of(path) if shards is not None else ()
        totals[dims] = totals.get(dims, 0) + leaf
    for dims, t in totals.items():
        if dims:
            shards.sum_over(t, dims)
    total = 0
    for t in totals.values():
        total = total + t
    return torch.sqrt(total)


# ---------------------------------------------------------------------------
# row-wise int8 quantization helpers


def _q8(x: torch.Tensor, row_amax=None):
    """Symmetric row-wise int8: (q int8, f32 scale over the last axis).
    ``row_amax`` (a split step's) takes the rows' amax over the ranks
    that hold the other pieces of each row, in place."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    if row_amax is not None:
        row_amax(amax)
    scale = amax.clamp_min(1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    name: str = "adamw"

    # -- declarative state (mirrors the param table) --
    def state_table(self, param_table) -> dict:
        def mom(d: ParamDef) -> dict:
            f32 = dataclasses.replace(d, dtype=torch.float32, init="zeros")
            return {"m": f32, "v": f32}
        return {"moments": _map_table(param_table, mom),
                "count": ParamDef((), (), torch.int32, "zeros")}

    def _moments(self, p: torch.Tensor) -> dict:
        return {"m": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)}

    def init(self, params) -> dict:
        def walk(t):
            return {k: walk(v) for k, v in t.items()} \
                if isinstance(t, dict) else self._moments(t)
        dev = leaf_items(params)[0][1].device
        return {"moments": walk(params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def _moment_update(self, g, mom, row_amax=None):
        """New (m, v) in f32 and writes the stored moments."""
        m = self.b1 * mom["m"] + (1 - self.b1) * g
        v = self.b2 * mom["v"] + (1 - self.b2) * torch.square(g)
        mom["m"].copy_(m)
        mom["v"].copy_(v)
        return m, v

    def update_slice(self, p, g, mom, scale, c1, c2, lr,
                     row_amax=None) -> None:
        """One slice of one leaf, in place: p, and the moments ``mom``
        (views of the stored ones at the same slice); ``row_amax`` as
        ``_q8``'s."""
        g = g.float() * scale
        m, v = self._moment_update(g, mom, row_amax)
        mh, vh = m / c1, v / c2
        step = mh / (torch.sqrt(vh) + self.eps) + \
            self.weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        """Clip by the global norm and update ``params`` and ``state`` in
        place; returns (params, state, {"grad_norm"}), the reference's
        shape of result.  In a split step (``split.active()``) every
        tensor is the rank's shard."""
        shards = _split.active()
        count = state["count"] + 1
        gnorm = global_norm(grads, shards)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        c1 = 1 - self.b1 ** count.float()
        c2 = 1 - self.b2 ** count.float()
        for path, p in leaf_items(params):
            g = get_path(grads, path)
            mom = get_path(state["moments"], path)
            over = shards.last_dims(path) if shards is not None else ()
            row_amax = (lambda t, over=over: shards.max_over(t, over)) \
                if over else None
            if isinstance(g, list):     # per-layer gradients
                shape = tuple(g[0].shape)
                p = layers_of(p, shape)
                mom = {k: layers_of(v, shape[:-1] + tuple(v.shape[-1:]))
                       for k, v in mom.items()}
            for ix in (range(len(g)) if isinstance(g, list)
                       else slices(path, tuple(p.shape))):
                self.update_slice(p[ix], g[ix],
                                  {k: v[ix] for k, v in mom.items()},
                                  scale, c1, c2, lr, row_amax)
        state["count"] = count
        return params, state, {"grad_norm": gnorm}


@dataclasses.dataclass(frozen=True)
class AdamW8bit(AdamW):
    name: str = "adamw8bit"

    def state_table(self, param_table) -> dict:
        def mom(d: ParamDef) -> dict:
            q = dataclasses.replace(d, dtype=torch.int8, init="zeros")
            sshape = d.shape[:-1] + (1,) if d.shape else ()
            saxes = d.logical_axes[:-1] + (None,) if d.shape else ()
            s = ParamDef(sshape, saxes, torch.float32, "zeros")
            return {"m_q": q, "m_s": s, "v_q": q, "v_s": s}
        return {"moments": _map_table(param_table, mom),
                "count": ParamDef((), (), torch.int32, "zeros")}

    def _moments(self, p: torch.Tensor) -> dict:
        sshape = tuple(p.shape[:-1]) + (1,) if p.dim() else ()
        q = torch.zeros(p.shape, dtype=torch.int8, device=p.device)
        s = torch.zeros(sshape, dtype=torch.float32, device=p.device)
        return {"m_q": q, "m_s": s, "v_q": q.clone(), "v_s": s.clone()}

    def _moment_update(self, g, mom, row_amax=None):
        m_prev = _dq8(mom["m_q"], mom["m_s"])
        v_prev = torch.square(_dq8(mom["v_q"], mom["v_s"]))  # stored sqrt(v)
        m = self.b1 * m_prev + (1 - self.b1) * g
        v = self.b2 * v_prev + (1 - self.b2) * torch.square(g)
        for (qk, sk), x in ((("m_q", "m_s"), m), (("v_q", "v_s"),
                                                   torch.sqrt(v))):
            q, s = _q8(x, row_amax)
            mom[qk].copy_(q)
            mom[sk].copy_(s)
        return m, v


def make_optimizer(name: str, **kw):
    return {"adamw": AdamW, "adamw8bit": AdamW8bit}[name](**kw)
