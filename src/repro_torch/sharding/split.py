"""One rank's part of a train or serve step split over a mesh: the
collectives the step sends, counted (``Collectives``), and the rank's
place on the mesh with the functions that split a model's products over
it (``Split``, autograd functions for training; ``ServeSplit``, plain
collectives for serving).

The dense and MoE train steps on a mesh of ranks keep every leaf of the
state as the shard its spec gives it, as the reference's GSPMD step does
under ``DEFAULT_RULES`` (``embed`` over ``data``; ``heads``,
``kv_heads``, ``mlp``, ``vocab`` and ``experts`` over ``model``):

* a weight is gathered along its ``data`` split (the ``embed`` axis)
  where a layer uses it, and dropped when the layer is done
  (``Split.use``); the backward of that gather sums its gradient over
  the data-parallel mesh dimensions and keeps the rank's piece (a
  reduce-scatter), so every gradient comes out as the rank's shard;
* a product whose weight is split along ``model`` runs on the rank's
  shard: column-parallel where the output axis is split (its input goes
  through ``copy_in``, the identity whose backward all-reduces the
  input's gradient over ``model``), row-parallel where the contracted
  axis is split (the f32 partial sums all-reduced by ``reduce_out``,
  then cast once), the unembedding by ``vocab`` with the softmax cross
  entropy reduced over ``model`` (``vocab_nll``);
* statistics of the whole batch (the MoE router's per-expert counts)
  are all-reduced over the data-parallel dimensions (``dp_sum``).

The serve steps split the same way, forward only (``ServeSplit``: the
same functions as plain collectives, no autograd on the path): a layer's
weights gathered along ``data`` for the layer alone, its heads, ``mlp``
columns, experts and vocabulary columns along ``model``, and a decode's
KV cache read where it rests: a rank's own KV heads, the KV heads its
query heads read of a pool that keeps them all, or, for a cache split
along its sequence, those heads' sequence shards gathered for one layer
(``gather_seq``).

The recurrent blocks (xLSTM's mLSTM and sLSTM, Mamba2) hold projections
whose output columns are not the parts a rank computes with (``w_up``'s
``[xb | z]``, ``w_in``'s ``[z | x | B | C | dt]`` and the conv over
``[x | B | C]`` are cut into equal contiguous shards): the rank's shard
of the product is gathered along ``model`` (``gather_out``: an
activation, never a weight) and each rank cuts the parts it computes
with (``cut``: the backward sums the pieces' gradients over ``model``,
so every rank holds the whole gradient of what the ranks hold alike).

On a mesh dimension of one rank nothing is gathered or sent and every
function is the identity, so on a one-rank mesh the step is the
one-device step, bit for bit.  A ``Split`` whose groups are None stands
for one rank of a mesh described without ranks (the dry run's trace on
the ``meta`` device): its collectives send nothing and return tensors of
the shapes they would, and are counted all the same.

The update runs on the shards too (``optim.adamw``): the global norm
sums each shard's squares once over the ranks, and ``AdamW8bit``'s row
scales and ``ef_int8``'s amax take a cross-rank max where a row or a
leaf is split.  ``active()`` is the split of the step that is running
(None off a mesh), which the update reads.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("split",
                                                         default=None)


def active():
    """The ``Split`` of the train step running in this context, or None."""
    return _ACTIVE.get()


class Collectives:
    """The collectives one step issues, counted per kind: calls, and the
    bytes this rank hands each call (an all-gather's local shard, an
    all-reduce's or a reduce-scatter's whole buffer).  ``calls`` keeps
    each call's kind, bytes and group size.  Mesh dimensions of one rank
    issue none.  A call given no group (``None``) sends nothing: it
    stands for a rank of a mesh described without ranks, its output
    shaped as the collective's."""

    KINDS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")

    def __init__(self):
        self.counts = {k: {"calls": 0, "bytes": 0} for k in self.KINDS}
        self.calls: list[tuple[str, int, int]] = []

    def _count(self, kind: str, t: torch.Tensor, size: int) -> None:
        n = t.numel() * t.element_size()
        self.counts[kind]["calls"] += 1
        self.counts[kind]["bytes"] += n
        self.calls.append((kind, n, size))

    def all_gather(self, t: torch.Tensor, dim: int, group,
                   size: int) -> torch.Tensor:
        t = t.contiguous()
        self._count("all_gather", t, size)
        if group is None:
            return torch.cat([t] * size, dim=dim)
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    def all_reduce(self, t: torch.Tensor, group, size: int = 0,
                   op: str = "sum") -> None:
        """``t`` reduced in place (``op``: ``sum`` or ``max``)."""
        self._count("all_reduce", t, size)
        if group is None:
            return
        import torch.distributed as dist
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)

    def all_to_all(self, t: torch.Tensor, group, size: int) -> torch.Tensor:
        """``t[j]`` (its first axis of ``size``) sent to rank j of the
        group; returns what each rank sent this one, in rank order."""
        t = t.contiguous()
        self._count("all_to_all", t, size)
        if group is None:
            return t.clone()
        import torch.distributed as dist
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    def reduce_scatter(self, t: torch.Tensor, dim: int, group, size: int,
                       index: int) -> torch.Tensor:
        """The sum over the group of ``t``, cut into ``size`` pieces
        along ``dim``: piece ``index`` (this rank's)."""
        t = t.movedim(dim, 0).contiguous()
        self._count("reduce_scatter", t, size)
        if group is None:
            out = t.chunk(size)[index].clone()
        else:
            import torch.distributed as dist
            out = t.new_empty((t.shape[0] // size,) + tuple(t.shape[1:]))
            dist.reduce_scatter_tensor(out, t, group=group)
        return out.movedim(0, dim)


class _Use(torch.autograd.Function):
    """A shard gathered whole along ``gather`` (pairs of mesh dimension
    and tensor dimension, minor mesh dimensions first, so a dimension
    split over several is rebuilt major first); the backward sums the
    gradient in f32 over the data-parallel dimensions, keeps the rank's
    piece along the gathered ones, and hands it back in the shard's
    dtype."""

    @staticmethod
    def forward(ctx, shard, split, gather):
        ctx.split, ctx.gather, ctx.dtype = split, gather, shard.dtype
        out = shard
        for m, dim in gather:
            out = split.comm.all_gather(out, dim, split.groups[m],
                                        split.shape[m])
        return out

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        g = g.float()
        for m, dim in reversed(ctx.gather):
            if m in s.dp:
                g = s.comm.reduce_scatter(g, dim, s.groups[m], s.shape[m],
                                          s.coord[m])
            else:
                g = g.chunk(s.shape[m], dim)[s.coord[m]]
        g = g.contiguous()
        gathered = {m for m, _ in ctx.gather}
        for m in s.dp:
            if m not in gathered:
                s.comm.all_reduce(g, s.groups[m], s.shape[m])
        return g.to(ctx.dtype), None, None


class _CopyIn(torch.autograd.Function):
    """The identity; its backward all-reduces the gradient over the model
    axis in f32 (the input of a column-parallel product, or a leaf each
    model rank uses a part of)."""

    @staticmethod
    def forward(ctx, x, split):
        ctx.split = split
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        t = g.float().contiguous().clone()
        s.comm.all_reduce(t, s.groups[s.tp_dim], s.tp)
        return t.to(g.dtype), None


class _ReduceOut(torch.autograd.Function):
    """The sum over the model axis of the f32 partials of a row-parallel
    product; its backward hands each rank the whole gradient."""

    @staticmethod
    def forward(ctx, x, split):
        t = x.contiguous().clone()
        split.comm.all_reduce(t, split.groups[split.tp_dim], split.tp)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOut(torch.autograd.Function):
    """The model ranks' pieces of an activation, all-gathered along
    ``dim``; the backward keeps this rank's piece of a gradient that
    every model rank holds whole."""

    @staticmethod
    def forward(ctx, x, split, dim):
        ctx.split, ctx.dim = split, dim
        return split.comm.all_gather(x, dim, split.groups[split.tp_dim],
                                     split.tp)

    @staticmethod
    def backward(ctx, g):
        s = ctx.split
        return g.chunk(s.tp, ctx.dim)[s.tp_rank].contiguous(), None, None


class _Cut(torch.autograd.Function):
    """Pieces ``[a, b)`` along ``dim`` of an activation the model ranks
    hold alike, each rank cutting the ranges its own computation reads;
    the backward lays the pieces' gradients into zeros of the whole, sums
    them over the model axis in f32 and hands every rank the whole
    gradient (as the ranks computing alike from it must hold it), in the
    activation's dtype."""

    @staticmethod
    def forward(ctx, x, split, dim, ranges):
        ctx.split, ctx.dim, ctx.ranges = split, dim, ranges
        ctx.shape, ctx.dtype = x.shape, x.dtype
        return tuple(x.narrow(dim, a, b - a) for a, b in ranges)

    @staticmethod
    def backward(ctx, *gs):
        s = ctx.split
        t = torch.zeros(ctx.shape, dtype=torch.float32, device=gs[0].device)
        for (a, b), g in zip(ctx.ranges, gs):
            if g is not None:
                t.narrow(ctx.dim, a, b - a).add_(g.float())
        s.comm.all_reduce(t, s.groups[s.tp_dim], s.tp)
        return t.to(ctx.dtype), None, None, None


class _VocabNLL(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` of f32 logits
    whose vocabulary is split over the model axis (this rank's columns
    start at ``v0``): the max and the sum of exponentials all-reduced
    over ``model``, the label's logit from the rank that holds it.  The
    backward is autograd's through ``logsumexp`` and the label's gather:
    ``exp(logits - lse) g``, less g at the label."""

    @staticmethod
    def forward(ctx, logits, labels, split):
        s = split
        group, V = s.groups[s.tp_dim], logits.shape[-1]
        local = labels.long() - s.tp_rank * V
        here = (local >= 0) & (local < V)
        local = local.clamp(0, V - 1)
        m = logits.amax(-1)
        s.comm.all_reduce(m, group, s.tp, op="max")
        total = torch.exp(logits - m[..., None]).sum(-1)
        s.comm.all_reduce(total, group, s.tp)
        lse = torch.log(total) + m
        gold = torch.where(here, logits.gather(-1, local[..., None])[..., 0],
                           torch.zeros_like(m))
        s.comm.all_reduce(gold, group, s.tp)
        ctx.save_for_backward(logits, lse, local, here)
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, here = ctx.saved_tensors
        d = torch.exp(logits - lse[..., None]) * g[..., None]
        d.scatter_add_(-1, local[..., None],
                       torch.where(here, -g, torch.zeros_like(g))[..., None])
        return d, None, None


class Split:
    """One rank of a train step split over a mesh: the mesh's ``shape``,
    the rank's ``coord``, each mesh dimension's process ``groups`` (None
    for a rank of a description), the step's ``comm``, the data-parallel
    dimensions ``dp`` that split the microbatches' rows, and ``pls``:
    params path -> the placements of that weight (a stacked block
    weight's of one layer, its layer axis dropped) and its tensor rank.
    The ``model`` axis (``tp_dim``, when it has more than one rank)
    splits the products."""

    def __init__(self, shape, coord, groups, comm: Collectives, dp,
                 pls: dict, axis_names):
        self.shape, self.coord = tuple(shape), tuple(coord)
        self.groups, self.comm, self.dp = list(groups), comm, list(dp)
        self.pls = pls
        m = list(axis_names).index("model") if "model" in axis_names \
            else None
        self.tp_dim = m if m is not None and self.shape[m] > 1 else None
        self.tp = 1 if self.tp_dim is None else self.shape[self.tp_dim]
        self.tp_rank = 0 if self.tp_dim is None else self.coord[self.tp_dim]

    @contextlib.contextmanager
    def engaged(self):
        """This split is ``active()`` for the update inside."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    # -- the shards in use --
    def _gathers(self, path) -> list:
        """(mesh dimension, tensor dimension) of each split of the weight
        at ``path`` the layer gathers: every one but ``model``'s, minor
        mesh dimensions first."""
        return [(m, pl.dim) for m, pl in reversed(list(enumerate(
            self.pls[path][0]))) if pl.is_shard() and self.shape[m] > 1
            and m != self.tp_dim]

    def use(self, tree, prefix: tuple):
        """The weights of ``tree`` (at params path ``prefix``) as a layer
        uses them: gathered along ``data``, kept split along ``model``;
        their gradients come back as the rank's shards, summed over the
        data-parallel ranks."""
        if isinstance(tree, dict):
            return {k: self.use(v, prefix + (k,)) for k, v in tree.items()}
        gather = self._gathers(prefix)
        if not gather and not self.dp:
            return tree
        return gather_leaf(tree, self, tuple(gather))

    def dims_of(self, path) -> tuple:
        """The mesh dimensions of more than one rank that split the
        weight at ``path``."""
        return tuple(m for m, pl in enumerate(self.pls[path][0])
                     if pl.is_shard() and self.shape[m] > 1)

    def last_dims(self, path) -> tuple:
        """The mesh dimensions that split the last axis of the weight at
        ``path``."""
        pls, ndim = self.pls[path]
        return tuple(m for m, pl in enumerate(pls)
                     if pl.is_shard() and pl.dim == ndim - 1
                     and self.shape[m] > 1)

    # -- model-axis functions (identities on one model rank) --
    def copy_in(self, x):
        return x if self.tp == 1 else _CopyIn.apply(x, self)

    def reduce_out(self, x):
        return x if self.tp == 1 else _ReduceOut.apply(x, self)

    def gather_out(self, x, dim: int):
        return x if self.tp == 1 else _GatherOut.apply(x, self, dim)

    def cut(self, x, dim: int, ranges) -> tuple:
        """The pieces ``[a, b)`` of ``ranges`` along ``dim`` of ``x``, an
        activation every model rank holds alike, that this rank's own
        computation reads (``_Cut``; plain slices on one model rank)."""
        ranges = tuple((int(a), int(b)) for a, b in ranges)
        if self.tp == 1:
            return tuple(x.narrow(dim, a, b - a) for a, b in ranges)
        return _Cut.apply(x, self, dim, ranges)

    def own(self, n: int, whole: int) -> tuple[int, int]:
        """``[lo, hi)`` of this model rank's shard of an axis of ``whole``
        entries that it holds ``n`` of (the whole axis where ``n`` is
        ``whole``: the rules keep it whole)."""
        if n == whole:
            return 0, whole
        if n * self.tp != whole:
            raise NotImplementedError(f"{n} of {whole} entries a rank on a "
                                      f"{self.tp}-way model axis")
        return self.tp_rank * n, (self.tp_rank + 1) * n

    def vocab_nll(self, logits, labels):
        return _VocabNLL.apply(logits, labels, self)

    def vocab_rows(self, table, tokens):
        """The tokens' rows of an embedding table split by vocabulary
        over the model axis: each rank's own rows (zeros elsewhere),
        summed over ``model`` (one rank holds each row, so the sum is
        exact)."""
        V = table.shape[0]
        local = tokens.long() - self.tp_rank * V
        here = (local >= 0) & (local < V)
        rows = table[local.clamp(0, V - 1).reshape(-1)].reshape(
            *tokens.shape, -1)
        rows = torch.where(here[..., None], rows, torch.zeros_like(rows))
        return self.reduce_out(rows.float()).to(table.dtype)

    def kv_range(self, cfg, heads: int, rank: int | None = None
                 ) -> tuple[int, int]:
        """The KV heads ``[lo, hi)`` the ``heads`` query heads of this
        model rank (or of ``rank``) read where the rules keep
        ``kv_heads`` whole: each KV head's query heads all on the rank
        (``heads`` a multiple of the group G) or all of the rank's in one
        KV head.  A run whose groups are uneven has no such range and
        raises."""
        G = cfg.num_heads // cfg.num_kv_heads
        first = (self.tp_rank if rank is None else rank) * heads
        lo, hi = first // G, (first + heads - 1) // G + 1
        if heads % G and hi - lo > 1:
            raise NotImplementedError(
                f"{heads} query heads a rank from head {first} read "
                f"{hi - lo} KV heads of {G} unevenly")
        return lo, hi

    def kv_for_heads(self, t, cfg, heads: int):
        """The K or V heads (``t``: (b, s, K, dh), every KV head, computed
        by every model rank) that this rank's ``heads`` query heads read,
        where the rules keep ``kv_heads`` whole (it does not divide the
        model axis) and split ``heads``: under GQA query head h reads KV
        head h // G, a run of consecutive KV heads, or one per query head
        where the run's groups are uneven.  In f32, through ``copy_in``:
        the ranks' gradients of a KV head shared by their query heads are
        summed in f32 and rounded once, as one device sums its query
        heads' in f32 before rounding."""
        G = cfg.num_heads // cfg.num_kv_heads
        first = self.tp_rank * heads
        lo, hi = first // G, (first + heads - 1) // G + 1
        t = self.copy_in(t.float())
        if heads % G == 0 or hi - lo == 1:
            return t.narrow(2, lo, hi - lo)
        return t.index_select(2, torch.div(
            torch.arange(first, first + heads, device=t.device), G,
            rounding_mode="floor"))

    # -- the data-parallel dimensions --
    def dp_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data-parallel ranks (no gradient)."""
        t = t.detach().clone()
        for m in self.dp:
            self.comm.all_reduce(t, self.groups[m], self.shape[m])
        return t

    def sum_over(self, t: torch.Tensor, dims) -> None:
        for m in dims:
            self.comm.all_reduce(t, self.groups[m], self.shape[m])

    def max_over(self, t: torch.Tensor, dims) -> None:
        for m in dims:
            self.comm.all_reduce(t, self.groups[m], self.shape[m], op="max")


class ServeSplit(Split):
    """One rank of a serve step split over a mesh: ``Split``'s functions
    forward only, under no_grad, each a plain collective (no autograd
    function on the path).  ``dp`` is empty: serving sums no statistic
    over the data-parallel ranks (an MoE router's aux loss is not
    computed)."""

    def __init__(self, shape, coord, groups, comm: Collectives, pls: dict,
                 axis_names):
        super().__init__(shape, coord, groups, comm, (), pls, axis_names)

    def use(self, tree, prefix: tuple):
        """The weights of ``tree`` gathered along ``data`` for one layer
        (the caller drops them when the layer is done), kept split along
        ``model``."""
        if isinstance(tree, dict):
            return {k: self.use(v, prefix + (k,)) for k, v in tree.items()}
        gather = self._gathers(prefix)
        return serve_gather(tree, self, tuple(gather)) if gather else tree

    def copy_in(self, x):
        return x

    def reduce_out(self, x):
        """``x`` (a row-parallel product's f32 partials, a tensor of the
        caller's own) summed over ``model`` in place."""
        if self.tp == 1:
            return x
        t = x.contiguous()
        self.comm.all_reduce(t, self.groups[self.tp_dim], self.tp)
        return t

    def gather_out(self, x, dim: int):
        if self.tp == 1:
            return x
        return self.comm.all_gather(x, dim, self.groups[self.tp_dim],
                                    self.tp)

    def cut(self, x, dim: int, ranges) -> tuple:
        return tuple(x.narrow(dim, int(a), int(b) - int(a))
                     for a, b in ranges)

    def gather_seq(self, x, read=None):
        """A (b, t, K, dh) cache block split along its sequence (axis 1)
        over the model axis, every KV head in each rank's shard ``x`` ->
        the whole sequence of the KV heads this rank reads: ``read`` is
        (lo, hi, every model rank's (lo, hi)), None for every head.  Each
        rank sends each other its heads of its own shard (an all-to-all;
        an all-gather where every rank reads every head), so only the
        heads read move."""
        if read is None:
            return self.gather_out(x.contiguous(), 1)
        lo, hi, peers = read
        if self.tp == 1:
            return x[..., lo:hi, :]
        parts = torch.stack([x[..., a:b, :] for a, b in peers])
        got = self.comm.all_to_all(parts, self.groups[self.tp_dim], self.tp)
        b_, tl = x.shape[0], x.shape[1]
        return got.transpose(0, 1).reshape(b_, self.tp * tl,
                                           *got.shape[3:])

    def gather_rows(self, x, dims, axis: int = 0):
        """Every rank's rows of ``x``, all-gathered along ``axis`` over
        the mesh dimensions ``dims`` that split them (minor first, so
        rows split over several come back major first)."""
        for m in reversed(list(dims)):
            x = self.comm.all_gather(x, axis, self.groups[m], self.shape[m])
        return x


def serve_gather(shard, split: Split, gather: tuple):
    """One weight shard gathered along ``gather``'s (mesh dimension,
    tensor dimension) pairs, minor mesh dimensions first, for a serve step
    (a module function, so a test can watch what each gather leaves
    alive)."""
    out = shard
    for m, dim in gather:
        out = split.comm.all_gather(out, dim, split.groups[m],
                                    split.shape[m])
    return out


def gather_leaf(shard, split: Split, gather: tuple):
    """``_Use`` of one shard (a module function, so a test can watch
    what each gather leaves alive)."""
    return _Use.apply(shard, split, gather)


# the stacked weights, by their params key: how many leading layer axes
# they carry (the dense blocks and the enc-dec's two stacks one; the
# mLSTM's (groups, m_per) and the Mamba2's (segs, per) two)
STACKED = {"blocks": 1, "mlstm": 2, "slstm": 1, "mamba": 2, "mamba_tail": 1,
           "enc_blocks": 1, "dec_blocks": 1}


def layer_axes(path) -> int:
    """The leading layer axes of the weight at params ``path``."""
    return STACKED.get(path[0], 0) if path else 0


def layer_placements(pls: list, lead: int = 1) -> list:
    """A stacked weight's placements with its ``lead`` leading layer axes
    dropped (the rules never split ``layers``)."""
    from torch.distributed.tensor import Shard
    out = []
    for pl in pls:
        if pl.is_shard():
            if pl.dim < lead:
                raise ValueError("a stacked weight split along its layers")
            out.append(Shard(pl.dim - lead))
        else:
            out.append(pl)
    return out


def weight_placements(items) -> dict:
    """params path -> (placements, tensor rank), as ``Split`` reads them,
    from each weight's (path, placements, tensor rank): a stacked block
    weight's of one layer."""
    return {path: (layer_placements(pls, layer_axes(path)),
                   n - layer_axes(path)) for path, pls, n in items}


def params_placements(spec_tree, mesh_names, mesh_shape) -> dict:
    """``weight_placements`` of each weight under its spec."""
    from repro_torch.models.params import leaf_items
    from repro_torch.sharding.rules import placements

    class _Names:
        axis_names = tuple(mesh_names)
        shape = tuple(mesh_shape)
    return weight_placements((path, placements(spec, _Names), len(spec))
                             for path, spec in leaf_items(spec_tree))
