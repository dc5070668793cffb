"""Dot FLOPs and least bytes of one call of a step, counted as it runs:
the port's counterpart of what ``repro/analysis/hlo.py`` measures.

The reference parses the HLO text of its compiled step.  PyTorch runs
eagerly and has no such program, so ``measure`` runs the step once and
counts what it dispatches:

* ``flops``: dot FLOPs from ``torch.utils.flop_counter.FlopCounterMode``,
  2 x output elements x contracted elements a matrix product (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, ...), the convention of ``hlo.py``'s
  ``_dot_flops``; ``dot_count`` is the number of products.
* ``hbm_bytes``: the least bytes the step moves, ``read_bytes`` +
  ``write_bytes``.  Each input tensor (the weights, the cache, the batch)
  is read once: the union of the element ranges the step reads of it,
  at most its storage; a table read only through a gather (an embedding,
  a learned position table) counts each distinct row gathered once.
  Each output is written once; an output that shares its storage with an
  input (a cache written in place) counts the elements written into it.
  Intermediates count nothing: they are the step's own business.
* ``wire_bytes``: zero on one card (no collective runs).
* ``peak_bytes``: the most bytes the step's own allocations held at once
  (the storages its operations made and still referenced; inputs, and
  writes into them, count nothing): what the caching allocator's
  ``max_memory_allocated`` reads above the inputs, up to its rounding.

``trace`` runs ``measure`` with no data: the inputs are ``meta`` tensors
(shapes and dtypes only), made from the declarative tables, so a step of
any size is costed without a device, as the reference lowers a step it
never runs.  Each operation still dispatches, so the FLOPs, the least
bytes and the peak are the same counts; a gather's rows cannot be told
apart without their values, so on ``meta`` each gathered index counts one
row, at most the table's.  The hand-written kernels cannot run on
``meta``: their plain versions run in their place (``kernels/ops.py``),
the same arithmetic.  The host values a step reads (a whole-batch
cache's 0-d index, a prompt's last position) stay on the host.

``Reckoning`` reckons the collectives of the port's mesh steps
(``training/steps.py``), per call as ``Collectives`` counts them on live
ranks, with each call's ring wire bytes.  The split steps (every
family's) send their collectives where their layers run: each layer's
``data`` gathers, the model axis's all-reduces of each row-parallel
output, the vocabulary's gathers (serving) or max and sums (training),
a sequence-split cache's heads (an all-to-all), and in training the
gathers' reduce-scatters, each column-parallel input's gradient's
all-reduce and the router's statistics, per microbatch and again in the
remat recompute; so they are counted from the step itself, traced on
``meta`` shards by a rank of the described mesh
(``steps.described_rank_step``, ``steps.described_serve_step``;
``meta_shards``), whose collectives send nothing and count all the
same.

Neither counter sees into a hand-written kernel.  The port's CUDA kernels
are ``ctypes`` calls made outside the dispatcher (``kernels/_build.py``),
so ``FlopCounterMode`` counts none of their work, and their operands
count as read only where another operation reads them too.  ``hlo.py``
likewise counts the ``dot`` instructions of the program and of the
computations a fusion or call names; a Pallas kernel compiled for the TPU
is a ``custom-call`` whose body is a serialized Mosaic module, not a
called computation, so its FLOPs are not counted either (in interpret
mode on the CPU the kernel lowers to ordinary HLO, and its dots are).
A step with a kernel on its path reads low; the Whisper steps have none.
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

aten = torch.ops.aten

@dataclasses.dataclass
class StepCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    dot_count: int = 0
    read_bytes: float = 0.0
    write_bytes: float = 0.0
    peak_bytes: float = 0.0
    collective_breakdown: dict = dataclasses.field(default_factory=dict)


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _key(t: torch.Tensor):
    # the storage's own identity: every meta storage's data pointer is 0
    return (t.device, t.untyped_storage()._cdata)


def _span(t: torch.Tensor) -> tuple[int, int]:
    """[first, last + 1) of the elements a view reaches in its storage."""
    last = sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return t.storage_offset(), t.storage_offset() + last + 1


def _union(spans) -> int:
    total, end = 0, None
    for a, b in sorted(spans):
        if end is None or a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class _Traffic(TorchDispatchMode):
    """Records, per input storage, the element ranges the step reads, the
    rows it gathers, and the elements it writes in place; and counts the
    matrix products."""

    def __init__(self, inputs):
        super().__init__()
        self.size = {_key(t): t.untyped_storage().nbytes() for t in inputs
                     if t.numel()}
        self.item = {_key(t): t.element_size() for t in inputs
                     if t.numel()}
        self.spans = {k: [] for k in self.size}
        self.rows = {k: {} for k in self.size}     # row start -> row bytes
        self.written = 0
        self.dots = 0

    def _ours(self, a):
        return isinstance(a, torch.Tensor) and a.numel() and \
            _key(a) in self.size

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.overloadpacket in flop_registry:
            self.dots += 1
        schema = func._schema
        # a view or an alias reads nothing; what reads it counts
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in schema.returns):
            return out
        written = [a for arg, a in zip(schema.arguments, args)
                   if arg.alias_info is not None and arg.alias_info.is_write
                   and self._ours(a)]
        if written:
            if func is aten.index_put_.default:
                self.written += args[2].numel() * args[2].element_size()
            else:
                self.written += sum(a.numel() * a.element_size()
                                    for a in written)
        if func is aten.index.Tensor and self._ours(args[0]):
            self._gather(args[0], args[1])
            operands = args[1:]
        else:
            operands = args
        for a in _tensors(list(operands) + list(kwargs.values())):
            if self._ours(a) and not any(a is w for w in written):
                self.spans[_key(a)].append(_span(a))
        return out

    def _gather(self, table, index):
        """Rows of a table indexed along its first axis (``table[ids]``,
        how the port gathers embeddings) count once each; any other
        indexing reads the table's whole view."""
        k = _key(table)
        ids = index[0] if len(index) == 1 else None
        if ids is None or ids.dtype == torch.bool or table.dim() < 2:
            self.spans[k].append(_span(table))
            return
        row = table[0].numel() * table.element_size()
        if ids.device.type == "meta":
            # no values: each index one row, at most the table's rows
            n = self.rows[k].get("meta", 0) // row + ids.numel()
            self.rows[k]["meta"] = min(n, table.shape[0]) * row
            return
        for r in torch.unique(ids).tolist():
            self.rows[k][table.storage_offset() + r * table.stride(0)] = row

    def read_bytes(self) -> int:
        total = 0
        for k, size in self.size.items():
            spanned = _union(self.spans[k]) * self.item[k]
            total += min(size, spanned + sum(self.rows[k].values()))
        return total


class _Peak(TorchDispatchMode):
    """The bytes of the storages the step's operations make, while they
    live: each new storage counts from the operation that makes it until
    it is freed (a weak reference's finaliser); the peak of the sum."""

    def __init__(self, inputs):
        super().__init__()
        self.known = {_key(t) for t in inputs}
        self.live = self.peak = 0

    def _free(self, key, nbytes):
        self.known.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            st = t.untyped_storage()
            key = (t.device, st._cdata)
            if key in self.known:
                continue
            self.known.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


def measure(fn, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` once, counting: (its result, a
    ``StepCost``).  Tensors anywhere in the arguments (dicts, lists and
    tuples of them) are the step's inputs."""
    inputs = _tensors(list(args) + list(kwargs.values()))
    traffic = _Traffic(inputs)
    counter = FlopCounterMode(display=False)
    peak = _Peak(inputs)
    with counter, traffic, peak:
        out = fn(*args, **kwargs)
    seen, written = set(), traffic.written
    for t in _tensors(out):
        k = (_key(t), t.storage_offset(), tuple(t.shape))
        if not t.numel() or _key(t) in traffic.size or k in seen:
            continue
        seen.add(k)
        written += t.numel() * t.element_size()
    read = traffic.read_bytes()
    cost = StepCost(flops=float(counter.get_total_flops()),
                    hbm_bytes=float(read + written), dot_count=traffic.dots,
                    read_bytes=float(read), write_bytes=float(written),
                    peak_bytes=float(peak.peak))
    return out, cost


def trace(fn, *args, **kwargs) -> tuple:
    """``measure`` of ``fn`` on ``meta`` tensors (``meta_tree``): (its
    result, of meta tensors, and its cost).  Every input holding data
    must be a 0-d host value the step reads (an index)."""
    for t in _tensors(list(args) + list(kwargs.values())):
        if t.device.type != "meta" and t.dim():
            raise ValueError(f"a {tuple(t.shape)} input on {t.device}: a "
                             f"trace takes meta tensors")
    return measure(fn, *args, **kwargs)


def meta_tree(table, rows: int = 1, index: int | None = None):
    """Meta tensors of a declarative (ParamDef) table, each leaf's
    ``act_batch`` axis divided by ``rows`` (one rank's rows of it); a 0-d
    ``index`` leaf is a host tensor holding ``index`` (a whole-batch
    cache's length, which the step reads)."""
    from repro_torch.models.params import ParamDef

    def make(path, d):
        if path[-1] == "index" and not d.shape and index is not None:
            return torch.tensor(index, dtype=d.dtype)
        shape = list(d.shape)
        if "act_batch" in d.logical_axes:
            shape[d.logical_axes.index("act_batch")] //= rows
        return torch.empty(shape, dtype=d.dtype, device="meta")

    def walk(t, path=()):
        if isinstance(t, ParamDef):
            return make(path, t)
        return {k: walk(v, path + (k,)) for k, v in t.items()}
    return walk(table)


# ---------------------------------------------------------------------------
# the collectives of the mesh steps, reckoned from the specs

_WIRE = {"all_gather": lambda g: g - 1,        # x the bytes a rank hands
         "all_reduce": lambda g: 2 * (g - 1) / g,
         "reduce_scatter": lambda g: (g - 1) / g,
         "all_to_all": lambda g: (g - 1) / g}


class Reckoning:
    """Collective calls as ``training.steps.Collectives`` counts them
    (calls, and the bytes this rank hands each), plus each call's ring
    wire bytes: an all-gather of L bytes a rank over g ranks sends
    (g - 1) L, an all-reduce of B bytes 2 (g - 1) / g B, a
    reduce-scatter or an all-to-all of B bytes (g - 1) / g B."""

    def __init__(self):
        self.counts = {k: {"calls": 0, "bytes": 0} for k in _WIRE}
        self.wire_bytes = 0.0
        self.breakdown: dict = {}

    @classmethod
    def of_calls(cls, calls) -> "Reckoning":
        """The reckoning of a log of (kind, bytes, group size) calls, as
        ``Collectives.calls`` keeps them."""
        r = cls()
        for kind, nbytes, group in calls:
            r.call(kind, nbytes, group)
        return r

    def call(self, kind: str, nbytes: int, group: int) -> None:
        self.counts[kind]["calls"] += 1
        self.counts[kind]["bytes"] += int(nbytes)
        wire = _WIRE[kind](group) * nbytes
        self.wire_bytes += wire
        d = self.breakdown.setdefault(kind.replace("_", "-"),
                                      {"count": 0, "wire_bytes": 0.0})
        d["count"] += 1
        d["wire_bytes"] += wire


def _local_bytes(shape, dtype, pls, mesh_shape) -> int:
    n = [1] * len(shape)
    for m, pl in enumerate(pls):
        if pl.is_shard():
            n[pl.dim] *= mesh_shape[m]
    elems = math.prod(d // k for d, k in zip(shape, n))
    return elems * dtype.itemsize


def spec_bytes(table, specs, mesh) -> int:
    """The bytes one rank holds of a table at rest under its specs (a
    dimension split over k ranks holds 1/k of it)."""
    from repro_torch.models.params import leaf_items
    from repro_torch.sharding.rules import placements
    total = 0
    for (_, d), (_, spec) in zip(leaf_items(table), leaf_items(specs)):
        total += _local_bytes(d.shape, d.dtype, placements(spec, mesh),
                              mesh.shape)
    return total


def shard_table(table, specs, mesh):
    """The declarative table of one rank's shards of ``table`` at rest
    under its specs: each ParamDef with its shard's shape (a dimension
    split over k ranks holds 1/k of it)."""
    import dataclasses
    from repro_torch.models.params import ParamDef, leaf_items
    from repro_torch.sharding.rules import placements
    spec_of = dict(leaf_items(specs))

    def walk(t, path=()):
        if not isinstance(t, ParamDef):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        n = [1] * len(t.shape)
        for m, pl in enumerate(placements(spec_of[path], mesh)):
            if pl.is_shard():
                n[pl.dim] *= mesh.shape[m]
        return dataclasses.replace(
            t, shape=tuple(d // k for d, k in zip(t.shape, n)))
    return walk(table)


def meta_shards(table, specs, mesh):
    """Meta tensors of one rank's shards of a declarative table at rest
    under its specs (``shard_table``)."""
    return meta_tree(shard_table(table, specs, mesh))
