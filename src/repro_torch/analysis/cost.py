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
    return (t.device, t.untyped_storage().data_ptr())


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
        for r in torch.unique(ids).tolist():
            self.rows[k][table.storage_offset() + r * table.stride(0)] = row

    def read_bytes(self) -> int:
        total = 0
        for k, size in self.size.items():
            spanned = _union(self.spans[k]) * self.item[k]
            total += min(size, spanned + sum(self.rows[k].values()))
        return total


def measure(fn, *args, **kwargs) -> tuple:
    """Run ``fn(*args, **kwargs)`` once, counting: (its result, a
    ``StepCost``).  Tensors anywhere in the arguments (dicts, lists and
    tuples of them) are the step's inputs."""
    inputs = _tensors(list(args) + list(kwargs.values()))
    traffic = _Traffic(inputs)
    counter = FlopCounterMode(display=False)
    with counter, traffic:
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
                    read_bytes=float(read), write_bytes=float(written))
    return out, cost
