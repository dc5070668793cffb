"""Step builders: train (gradient accumulation, error-feedback int8
compression, the schedule, the update), prefill, chunk, decode and
verify (port of ``repro/training/steps.py``).

``build_train_step`` takes each microbatch's gradients with autograd
over the model's per-layer leaves (``DenseLM.train_leaves``) and updates
the state in place: parameters, moments, error feedback and step.  On a
mesh of ranks it computes what one device computes, the state sharded at
rest and during the step (``sharding.split``); ``Collectives`` counts
what it sends.

The serve builders close over the model and return a plain function of
``params`` and the step's inputs that runs without autograd.  The decode,
verify and chunk steps write K/V in place into the pool tensors they are
given and return the same tensors (the reference donates them instead).
Each comes for the contiguous slot pool and for the paged pool
(``_paged``); a pool's cache names its layout, and a step given another
layout's cache raises.  ``build_decode_step`` is the legacy fixed-batch
path's: the whole batch at one length, over a prefill's cache.  Every
serve builder takes ``mesh=None``, as the reference's do: off a mesh or
on a one-device mesh it returns the one-device step; on a mesh of ranks
the step each rank runs on its rows, split along ``model`` (see
"serving on a mesh" below); on a description of
several devices a step that refuses to run.  ``described_serve_step`` is
the split prefill or whole-batch decode that one rank of a described
mesh runs on its shards (the dry run's).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.core.plan import DeploymentPlan
from repro_torch.models.params import (ParamDef, _map_table, leaf_items,
                                      tree_map)
from repro_torch.optim.adamw import layers_of
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.sharding import split as _split
from repro_torch.sharding.rules import (DEFAULT_RULES, contiguous_stride,
                                        data_parallel_dims, local_slices,
                                        logical_to_spec, placements,
                                        shard_index, spec_for)
from repro_torch.sharding.split import Collectives, Split

# the families whose train and serve steps on a mesh run split
# (``sharding.split``): every family the port has
SPLIT_FAMILIES = ("dense", "vlm", "moe", "ssm_xlstm", "hybrid_mamba",
                  "encdec")


def _accum_dtype(plan: DeploymentPlan) -> torch.dtype:
    return torch.bfloat16 if plan.grad_accum_dtype == "bfloat16" \
        else torch.float32


def _ef_int8(g: torch.Tensor, err: torch.Tensor,
             amax: torch.Tensor | None = None):
    """Error-feedback int8 quantization of a gradient contribution (it
    models a compressed cross-replica reduction): returns (the
    dequantized f32 gradient, the new error).  ``amax`` is the whole
    leaf's max |g + err| when g is one slice of it."""
    x = g.float() + err
    if amax is None:
        amax = x.abs().amax()
    scale = amax.clamp_min(1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127)
    deq = q * scale
    return deq, x - deq


def _ef_compress(grads, ef, shards=None, path=()):
    """``_ef_int8`` over every leaf, a stacked one layer by layer with its
    whole-leaf amax; ``ef`` (the tree of errors) is updated in place.
    Returns the gradients dequantized, each leaf as it came (a tensor or a
    per-layer list).  With ``shards`` (a split step's) each leaf is the
    rank's shard, its amax a max over the ranks that split it."""
    if isinstance(grads, dict):
        return {k: _ef_compress(v, ef[k], shards, path + (k,))
                for k, v in grads.items()}
    dims = shards.dims_of(path) if shards is not None else ()
    if not isinstance(grads, list):
        amax = None
        if dims:
            amax = (grads.float() + ef).abs().amax()
            shards.max_over(amax, dims)
        deq, new = _ef_int8(grads, ef, amax)
        ef.copy_(new)
        return deq
    ef = layers_of(ef, tuple(grads[0].shape))
    amax = torch.stack([(g.float() + ef[i]).abs().amax()
                        for i, g in enumerate(grads)]).amax()
    if dims:
        shards.max_over(amax, dims)
    out = []
    for i, g in enumerate(grads):
        deq, new = _ef_int8(g, ef[i], amax)
        ef[i].copy_(new)
        out.append(deq)
    return out


def _grad(leaf: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(leaf) if leaf.grad is None else leaf.grad


def loss_and_grads(model, params, batch, weight=None):
    """(loss, metrics, grads) of one batch: autograd over the model's
    per-layer leaves; grads has the tree of ``params``, a stacked leaf's
    gradient as a list of per-layer tensors in the parameter's dtype.
    ``weight`` goes to the model's loss (a split step's share)."""
    leaves = model.train_leaves(params)
    loss, metrics = model.loss(leaves, batch) if weight is None \
        else model.loss(leaves, batch, weight=weight)
    loss.backward()
    # a stacked leaf's per-layer trees -> one tree of per-layer lists
    grads = {k: tree_map(lambda *ls: list(map(_grad, ls)), *v)
             if isinstance(v, list) else tree_map(_grad, v)
             for k, v in leaves.items()}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _microbatches(batch: dict, M: int) -> list[dict]:
    """``batch`` cut into ``M`` equal microbatches along its first axis."""
    b = batch["tokens"].shape[0]
    if b % M:
        raise ValueError(f"batch {b} does not split into {M} microbatches")
    n = b // M
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(M)]


def _batch_grads(model, params, mbs: list, acc_dt, weights=None,
                 weigh_loss: bool = False):
    """(loss, metrics, grads) of the microbatches ``mbs``: one
    microbatch's ``loss_and_grads``, or M microbatches' gradients
    accumulated in ``acc_dt`` from zeros and their mean taken in f32, the
    loss the f32 mean of theirs.  ``weights`` (a mesh step's: one f32
    factor per microbatch) scale each microbatch: inside the model's loss
    with ``weigh_loss`` (the split step, whose gradients come back in the
    parameters' dtype), else its loss and f32 gradient after the fact
    (the gradients then come back in f32)."""
    def one(i):
        if weights is None or weigh_loss:
            return loss_and_grads(model, params, mbs[i],
                                  None if weights is None else weights[i])
        l, _, g = loss_and_grads(model, params, mbs[i])
        l = l * weights[i]
        return l, {"loss": l}, tree_map(lambda t: t.float() * weights[i],
                                        g)
    if len(mbs) == 1:
        loss, metrics, grads = one(0)
        return loss, (metrics if weights is None else {"loss": loss}), grads
    M = len(mbs)
    acc, lsum = None, None
    for i in range(M):
        l, _, g = one(i)
        if acc is None:
            acc = tree_map(lambda t: torch.zeros(
                t.shape, dtype=acc_dt, device=t.device), g)
            lsum = torch.zeros((), dtype=torch.float32, device=l.device)
        tree_map(lambda a, t: a.add_(t.to(a.dtype)), acc, g)
        lsum = lsum + l
    loss = lsum / M
    return loss, {"loss": loss}, tree_map(lambda t: (t / M).float(), acc)


def _gather(x, comm: Collectives):
    """The whole of a DTensor, gathered over each mesh dimension that
    shards it, the minor ones first (so a dimension sharded over several
    mesh dimensions is rebuilt major first).  A plain tensor is taken as
    the whole."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    dm, out = x.device_mesh, x.to_local()
    for m in reversed(range(dm.ndim)):
        pl = x.placements[m]
        if pl.is_shard() and dm.size(m) > 1:
            out = comm.all_gather(out, pl.dim, dm.get_group(m), dm.size(m))
    return out


def _rows(batch: dict, mesh) -> tuple[dict, list[int]]:
    """This rank's rows of each batch leaf (``act_batch`` over the mesh)
    and the data-parallel mesh dimensions: those of more than one rank
    that split the rows.  A whole tensor is sliced (every rank draws the
    whole batch, so nothing is sent); a DTensor of
    ``DataPipeline(mesh=)`` holds the same slice already."""
    from torch.distributed.tensor import DTensor
    rows, dims = {}, []
    for k, x in batch.items():
        spec = spec_for(("act_batch",) + (None,) * (x.dim() - 1), x.shape,
                        mesh)
        pls = placements(spec, mesh)
        if isinstance(x, DTensor):
            if list(x.placements) != pls:
                raise ValueError(f"batch leaf {k} is split as "
                                 f"{x.placements}, not by its rows {pls}")
            rows[k] = x.to_local()
        else:
            rows[k] = x[local_slices(spec, x.shape, mesh,
                                     mesh.coordinate())]
        dims = [m for m, pl in enumerate(pls)
                if pl.is_shard() and mesh.shape[m] > 1]
    return rows, dims


def _tokens_of(mb: dict) -> torch.Tensor:
    """The loss's denominator on a microbatch: the tokens its mask keeps
    (unclamped), or all of its labels."""
    mask = mb.get("loss_mask")
    if mask is not None:
        return mask.float().sum()
    return torch.tensor(float(mb["labels"].numel()),
                        device=mb["labels"].device)


def _rank_microbatches(batch: dict, mesh, M: int,
                       comm: Collectives) -> tuple[list, list[int]]:
    """This rank's rows of each of the ``M`` microbatches, and the
    data-parallel mesh dimensions that split them: the whole batch cut
    into M along its rows as one device cuts it (microbatch j is rows
    ``[j B/M, (j+1) B/M)``, as the reference's scan takes them), then each
    microbatch's rows split over the mesh as ``act_batch``'s spec splits
    them.  A batch held as DTensors (``DataPipeline(mesh=)``, each rank
    its block of rows) is all-gathered whole first, unless M is 1."""
    if M == 1:
        rows, dp = _rows(batch, mesh)
        return [rows], dp
    whole = {k: _gather(x, comm) for k, x in batch.items()}
    out, dp = [], []
    for mb in _microbatches(whole, M):
        rows, dp = _rows(mb, mesh)
        out.append(rows)
    return out, dp


def _token_weights(mbs: list, total_of) -> list:
    """Each microbatch's weight on a mesh: the loss is a mean over all
    ranks' tokens, so a rank's share of microbatch j is its tokens over
    all ranks' (``total_of`` sums the counts over the data-parallel
    ranks)."""
    denom = torch.stack([_tokens_of(mb) for mb in mbs])
    total = total_of(denom)
    return list(denom.clamp_min(1.0) / total.clamp_min(1.0))


def _local(x):
    """A DTensor's local shard (call under no_grad: the tensor itself, so
    an update in place is the DTensor's), a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _placements_tree(tree, ndim: int) -> dict:
    """``split.weight_placements`` of a state's params (a plain tensor
    replicated)."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.sharding.split import weight_placements
    return weight_placements(
        (path, x.placements if isinstance(x, DTensor)
         else [Replicate()] * ndim, x.dim()) for path, x in leaf_items(tree))


def split_for(mesh, params, dp=(), comm: Collectives | None = None):
    """The ``Split`` of this rank of a live ``mesh`` for a step on a
    state's ``params`` (DTensors at rest; a plain tensor is replicated),
    its rows split over the mesh dimensions ``dp``."""
    dm = mesh.device_mesh
    return Split(mesh.shape, mesh.coordinate(),
                 [dm.get_group(m) for m in range(dm.ndim)],
                 comm or Collectives(), dp,
                 _placements_tree(params, dm.ndim), mesh.axis_names)


def split_train_body(model, plan: DeploymentPlan, update):
    """One rank's step of the split train step: ``body(state, mbs,
    split)`` updates ``state`` (the rank's shards as plain tensors, in
    place) from its microbatches ``mbs`` under ``split`` (a
    ``sharding.split.Split``) and returns the metrics.  The dry run
    traces it on ``meta`` shards under a split without ranks."""
    acc_dt = _accum_dtype(plan)

    def body(state, mbs, split):
        weights = _token_weights(mbs, split.dp_sum)
        params = state["params"]
        model.tp = split
        try:
            with split.engaged():
                loss, metrics, grads = _batch_grads(
                    model, params, mbs, acc_dt, weights, weigh_loss=True)
                loss = split.dp_sum(loss.reshape(1))[0]
                return update(state, params, grads, dict(metrics, loss=loss))
        finally:
            model.tp = None
    return body


def _split_step(model, plan: DeploymentPlan, mesh, update):
    """The split train step on a mesh of ranks (see ``build_train_step``):
    each leaf stays the rank's shard; the step's body is
    ``split_train_body``'s."""
    from torch.distributed.tensor import DTensor
    body = split_train_body(model, plan, update)

    def train_step(state, batch):
        if mesh.coordinate() is None:
            raise ValueError("this rank is not on the mesh: it sits the "
                             "step out")
        comm = Collectives()
        dm = mesh.device_mesh
        mbs, dp = _rank_microbatches(batch, mesh, plan.microbatches, comm)
        split = split_for(mesh, state["params"], dp, comm)
        with torch.no_grad():
            local = tree_map(_local, state)
        before = tree_map(lambda t: t, local)
        metrics = body(local, mbs, split)

        def back(x, old, new):
            # a leaf updated in place stays; one replaced (the counters)
            # goes back at rest as its DTensor was
            if new is old:
                return x
            if not isinstance(x, DTensor):
                return new
            return DTensor.from_local(new, dm, x.placements,
                                      run_check=False, shape=x.shape,
                                      stride=x.stride())
        return tree_map(back, state, before, local), dict(
            metrics, collectives=comm.counts)

    return train_step


def build_train_step(model, opt, plan: DeploymentPlan, mesh=None,
                     peak_lr: float = 3e-4, warmup_steps: int = 100,
                     total_steps: int = 10_000):
    """Returns train_step(state, batch) -> (state, metrics), which updates
    ``state = {"params", "opt", "ef" (optional), "step"}``.

    ``plan.microbatches`` > 1 splits the batch into that many equal
    microbatches along its first axis and accumulates their gradients in
    ``plan.grad_accum_dtype`` from zeros, then takes their mean in f32;
    the loss is the f32 mean of theirs.  ``ef_int8`` compression, the
    warm-up cosine learning rate at ``state["step"]`` and the optimizer's
    update follow, as in the reference.  ``metrics["collectives"]``
    counts the step's collectives (``Collectives``).

    Off-mesh (``mesh`` None) or on a one-device mesh the step updates
    ``state`` in place and issues no collective.  On a mesh of ranks
    (``launch.mesh``) it computes what one device computes, as the
    reference's GSPMD step does:

    * at rest every leaf of the state is a DTensor with the placements of
      its spec in the train-state table (``runtime.elastic.
      reshard_state``);
    * microbatch j is the whole batch's rows ``[j B/M, (j+1) B/M)``, each
      rank computing its rows of it (ranks that differ only along
      ``model`` hold the same rows); the loss is the mean over all ranks'
      tokens, so each rank's loss is weighted by its share of each
      microbatch's tokens (an MoE router's aux loss is summed over the
      ranks instead: ``models.moe``);
    * every family runs split (``sharding.split``): each leaf stays the
      rank's shard, gathered along ``data`` only for the layer that uses
      it (Zamba2's shared block once a step, for all its applications),
      the products split along ``model``, every gradient the rank's shard
      summed over the data-parallel ranks, and the update on the shards,
      its global norm, 8-bit row scales and error-feedback amax reduced
      across ranks (``optim.adamw``).

    On a mesh whose dimensions are all of one rank nothing is sent and
    the step is the one-device step, bit for bit.  The reference's
    ``param_specs`` pins XLA's gradient layout; the port reads each
    leaf's placements instead.  A mesh of several devices with no ranks
    behind it (a description) refuses to run."""
    acc_dt = _accum_dtype(plan)
    update = _updater(opt, plan, peak_lr, warmup_steps, total_steps)
    if mesh is not None and mesh.device_mesh is not None:
        return _split_step(model, plan, mesh, update)
    if mesh is not None and mesh.size > 1:
        def refuse(state, batch):
            raise no_ranks(mesh)
        return refuse

    def train_step(state, batch):
        params = state["params"]
        loss, metrics, grads = _batch_grads(
            model, params, _microbatches(batch, plan.microbatches), acc_dt)
        metrics = update(state, params, grads, metrics)
        return state, dict(metrics, collectives=Collectives().counts)

    return train_step


def _updater(opt, plan: DeploymentPlan, peak_lr: float, warmup_steps: int,
             total_steps: int):
    """``update(state, params, grads, metrics)``: ``ef_int8``, the
    schedule's learning rate and the optimizer's update, in place."""
    use_ef = plan.grad_compression == "ef_int8"

    def update(state, params, grads, metrics):
        if use_ef:
            grads = _ef_compress(grads, state["ef"], _split.active())
        lr = warmup_cosine(state["step"], peak_lr=peak_lr,
                           warmup_steps=warmup_steps,
                           total_steps=total_steps)
        _, _, opt_metrics = opt.update(grads, state["opt"], params, lr)
        state["step"] = state["step"] + 1
        return dict(metrics, lr=lr, **opt_metrics)
    return update


def described_rank_step(model, opt, plan: DeploymentPlan, mesh,
                        params_specs, rows: int, peak_lr: float = 3e-4,
                        warmup_steps: int = 100, total_steps: int = 10_000):
    """The split train step that one rank (coordinate 0) of ``mesh``, a
    mesh described without ranks, runs on its shards, for the dry run's
    trace on ``meta``: ``step(state, batch)`` takes the rank's shards
    and its rows of an ``rows``-row batch, cuts them into the plan's
    microbatches and returns (state, metrics), the metrics'
    ``collective_calls`` each collective's (kind, bytes, group size), sent
    nowhere (``Collectives`` with no groups); the schedule's arguments are
    ``build_train_step``'s."""
    from repro_torch.sharding.split import params_placements
    M = plan.microbatches
    dp = data_parallel_dims(rows // M, mesh)
    pls = params_placements(params_specs, mesh.axis_names, mesh.shape)
    body = split_train_body(model, plan, _updater(
        opt, plan, peak_lr, warmup_steps, total_steps))

    def step(state, batch):
        comm = Collectives()
        split = Split(mesh.shape, (0,) * len(mesh.shape),
                      [None] * len(mesh.shape), comm, dp, pls,
                      mesh.axis_names)
        metrics = body(state, _microbatches(batch, M), split)
        return state, dict(metrics, collectives=comm.counts,
                           collective_calls=comm.calls)
    return step


def init_train_state(model, opt, params, plan: DeploymentPlan) -> dict:
    """{"params", "opt", "step"} (+ "ef", f32 zeros, under ef_int8), on
    the parameters' device."""
    dev = leaf_items(params)[0][1].device
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if plan.grad_compression == "ef_int8":
        state["ef"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


def train_state_table(model, opt, plan: DeploymentPlan) -> dict:
    """Declarative (ParamDef) state table — dry-run path, no allocation."""
    ptable = model.param_table()
    t = {"params": ptable, "opt": opt.state_table(ptable),
         "step": ParamDef((), (), torch.int32, "zeros")}
    if plan.grad_compression == "ef_int8":
        t["ef"] = _map_table(ptable, lambda d: dataclasses.replace(
            d, dtype=torch.float32, init="zeros"))
    return t


def _of_layout(cache: dict, layout: str) -> dict:
    """``cache`` stamped with the step's ``layout``: a pool's cache names
    its own, which must agree; a bare dict of tensors takes the step's."""
    if cache.get("layout", layout) != layout:
        raise ValueError(f"a {layout} step was given a {cache['layout']} "
                         f"pool's cache")
    return dict(cache, layout=layout)


# ---------------------------------------------------------------------------
# serving on a mesh
#
# Each rank computes what one device computes, on its own rows (as the
# train step does): the rank takes its rows of the batch along the
# data-parallel mesh dimensions of ``act_batch`` (a batch whose rows do
# not divide, such as one slot's prompt chunk, is replicated and every
# rank computes it) and every rank ends with the whole batch's logits.
#
# Every family (``SPLIT_FAMILIES``) serves split, as the reference's GSPMD
# serve steps do
# (``sharding.split.ServeSplit``): the weights stay the rank's shards,
# each layer's gathered along ``data`` for that layer alone (Zamba2's
# shared block once a step); the rank computes its heads, its MLP columns
# (or its experts, or a recurrent block's heads and channels) and its
# vocabulary columns, whose logits the step gathers along ``model``, then
# the rows along ``data``; and it reads its shard of the cache where it
# rests (``models.layers``): its own KV heads, of a cache that keeps
# every KV head (``kv_heads`` does not divide the model axis) the heads
# its query heads read, of a cache split along its sequence
# (``DECODE_SEQ_CACHE_RULES``) those heads' shards gathered one layer at
# a time; a recurrent state its heads' and conv channels' shard; an
# enc-dec's cross K/V as its self K/V.  A
# contiguous cache's rows rest split along ``data`` as the batch's are; a
# prompt chunk (one row) gathers its slot's row along ``data`` alone, and
# the ranks holding it write it back.  A paged pool is
# whole along ``data`` (split by KV heads along ``model`` where they
# divide it): after a decode or verify step the K/V entries each rank
# wrote are all-gathered along ``data`` into every rank's pool, in the
# one device's write order, so each pool equals one device's.
# ``step.collectives`` holds the counts of the last call (``Collectives``).


def no_ranks(mesh) -> RuntimeError:
    """The refusal of a step on a mesh of several devices that this
    process holds no ranks of."""
    return RuntimeError(
        f"mesh {mesh.shape} over {mesh.axis_names} has no ranks: build it "
        f"with launch.mesh.mesh_for_target in each of {mesh.size} "
        f"processes of an initialized process group")


def _on_mesh(mesh, plain, mesh_step):
    """The step a builder returns: ``plain`` off a mesh or on a one-device
    mesh, ``mesh_step()`` on a mesh of ranks, a refusal on a description
    of several devices."""
    if mesh is None or (mesh.device_mesh is None and mesh.size == 1):
        return plain
    if mesh.device_mesh is None:
        def refuse(*args, **kwargs):
            raise no_ranks(mesh)
        return refuse
    return mesh_step()


class _Share:
    """This rank's rows of an ``n``-row batch on a mesh: the data-parallel
    mesh dimensions that split them (``act_batch``'s spec, divisibility
    fallback included) and this rank's slice."""

    def __init__(self, n: int, mesh):
        if mesh.coordinate() is None:
            raise ValueError("this rank is not on the mesh: it sits the "
                             "step out")
        self.mesh = mesh
        self.dp = data_parallel_dims(n, mesh)
        self.rows = local_slices(spec_for(("act_batch",), (n,), mesh), (n,),
                                 mesh, mesh.coordinate())[0]

    def take(self, x, axis: int = 0):
        """This rank's rows of a whole tensor (every rank holds it)."""
        if not self.dp:
            return x
        return x[(slice(None),) * axis + (self.rows,)]


@contextlib.contextmanager
def _serving(model, split):
    """``split`` is the model's ``tp`` inside."""
    model.tp = split
    try:
        yield split
    finally:
        model.tp = None


def _whole_logits(model, split, logits, dp):
    """The rank's logits (its rows, its vocabulary columns where the
    unembedding is split) -> the whole batch's: the columns all-gathered
    along ``model``, then the rows along the data-parallel dimensions
    ``dp``."""
    if logits.shape[-1] < model.cfg.vocab_size:
        logits = split.gather_out(logits, -1)
    return split.gather_rows(logits, dp)


class _SplitServe:
    """What a split serve step on a live mesh keeps between calls: the
    rank's shards of the weights at rest (DTensors) as plain tensors and
    their placements, rebuilt only when the weights change, so the
    model's per-layer views of them are built once."""

    def __init__(self, model, mesh):
        self.model, self.mesh = model, mesh
        self.last = ([], None, None)

    @contextlib.contextmanager
    def __call__(self, params, comm: Collectives):
        """(the rank's shards of ``params``, its ``ServeSplit``), the
        model's ``tp`` inside."""
        from repro_torch.sharding.split import ServeSplit
        leaves = [x for _, x in leaf_items(params)]
        old, local, pls = self.last
        if local is None or len(old) != len(leaves) or \
                not all(a is b for a, b in zip(old, leaves)):
            with torch.no_grad():
                local = tree_map(_local, params)
            pls = _placements_tree(params, len(self.mesh.shape))
            self.last = (leaves, local, pls)
        dm = self.mesh.device_mesh
        split = ServeSplit(self.mesh.shape, self.mesh.coordinate(),
                           [dm.get_group(m) for m in range(dm.ndim)], comm,
                           pls, self.mesh.axis_names)
        with _serving(self.model, split):
            yield local, split


# the axes of a (layers, rows, seq, kv heads, dh) K/V cache leaf, a paged
# pool's (layers, pages, page_size, kv heads, dh)
_ROWS, _SEQ, _HEADS = 1, 2, 3
# the K/V leaves of a cache: the self K/V, and an enc-dec's cross K/V
_KV = ("k", "v", "xk", "xv")


def _cache_split(x, split, paged: bool) -> tuple[list, bool]:
    """How a K/V leaf at rest is split: (the mesh dimensions that split
    its rows, whether the model axis splits its sequence).  Its KV heads
    may be split along ``model`` too; any other split raises."""
    from torch.distributed.tensor import DTensor
    rows, seq = [], False
    if not isinstance(x, DTensor):
        return rows, seq
    for m, pl in enumerate(x.placements):
        if not pl.is_shard() or split.shape[m] == 1:
            continue
        if pl.dim == _ROWS and not paged and m != split.tp_dim:
            rows.append(m)
        elif pl.dim == _SEQ and not paged and m == split.tp_dim:
            seq = True
        elif pl.dim != _HEADS or m != split.tp_dim:
            raise NotImplementedError(
                f"a {'paged ' if paged else ''}cache split as {x.placements}")
    return rows, seq


# the cache axes a split step's model axis may split besides a K/V's
# sequence: a rank's heads, KV heads or conv channels
_MODEL_CACHE_AXES = ("act_heads", "act_kv_heads", "act_mlp")


def _local_leaf(x, d: ParamDef, share: _Share, split) -> tuple:
    """A recurrent cache leaf at rest (its table entry ``d``) -> (the
    rank's part, in place, whether the model axis splits its sequence): a
    DTensor's local shard (its rows split as the batch is, the model axis
    splitting its heads or channels, or a K/V's sequence), a plain
    tensor's rows."""
    axes = d.logical_axes
    row = axes.index("act_batch") if "act_batch" in axes else None
    if not hasattr(x, "to_local"):
        return (x if row is None else share.take(x, row)), False
    rows, seq = [], False
    for m, pl in enumerate(x.placements):
        if not pl.is_shard() or split.shape[m] == 1:
            continue
        if pl.dim == row and m != split.tp_dim:
            rows.append(m)
        elif m == split.tp_dim and axes[pl.dim] == "act_seq":
            seq = True
        elif m != split.tp_dim or axes[pl.dim] not in _MODEL_CACHE_AXES:
            raise NotImplementedError(f"a cache leaf split as "
                                      f"{x.placements} over {axes}")
    if rows != share.dp:
        raise NotImplementedError(
            f"a cache split over {x.placements} along its rows, the batch "
            f"over mesh dimensions {share.dp}")
    return x.to_local(), seq


def _local_cache(cache, share: _Share, split, paged: bool = False,
                 table: dict | None = None) -> dict:
    """A cache at rest -> the rank's part as the split step reads it, in
    place: each K/V leaf's local shard (an enc-dec's cross K/V as its
    self K/V; a plain tensor is whole on every rank: its rows taken),
    split along the rows as the batch is, along the KV heads or the
    sequence (``seq_split``) by the model axis; the
    rank's rows of a per-slot index; a recurrent model's nested leaves
    (its states, a hybrid's shared K/V) each by its entry in the cache's
    ``table`` (``_local_leaf``)."""
    out = dict(cache)
    for key, sub in cache.items():
        if isinstance(sub, dict):
            seq = []
            out[key] = _cache_map(sub, lambda p, x: seq.append(
                _local_leaf(x, table[(key,) + p], share, split)) or
                seq[-1][0])
            if any(s for _, s in seq):
                out["seq_split"] = True
    for key in _KV:
        if key not in cache:
            continue
        x = cache[key]
        rows, seq = _cache_split(x, split, paged)
        if not hasattr(x, "to_local"):
            out[key] = x if paged else share.take(x, _ROWS)
            continue
        if not paged and rows != share.dp:
            raise NotImplementedError(
                f"a cache split over {x.placements} along its rows, the "
                f"batch over mesh dimensions {share.dp}")
        out[key] = x.to_local()
        if seq:
            out["seq_split"] = True
    idx = cache["index"]
    out["index"] = share.take(idx) if idx.dim() == 1 else idx
    return out


def _split_cache_step(model, mesh, inner, row_extras: int = 0):
    """``inner(params, cache, tokens, *extras)`` -> (logits, cache) split
    on a mesh of ranks (a contiguous slot-wise decode or verify, the
    legacy whole-batch decode, a paged pool's prompt chunk): the rank's
    rows of the tokens, of the first ``row_extras`` extras and of the
    cache, read and written in place where they rest (``_local_cache``);
    the whole logits and the index of every row back."""
    serve = _SplitServe(model, mesh)
    table = dict(leaf_items(model.cache_table(1, 1)))

    @torch.no_grad()
    def step(params, cache, tokens, *extras):
        comm = Collectives()
        share = _Share(tokens.shape[0], mesh)
        ex = [share.take(e) for e in extras[:row_extras]] + \
            list(extras[row_extras:])
        with serve(params, comm) as (local, split):
            rows = _local_cache(cache, share, split,
                                cache.get("layout") == "paged", table)
            logits, new = inner(local, rows, share.take(tokens), *ex)
            logits = _whole_logits(model, split, logits, share.dp)
            idx = new["index"]
            if idx.dim() == 1:
                idx = split.gather_rows(idx, share.dp)
        step.collectives = comm.counts
        return logits, dict(cache, index=idx)

    step.collectives = Collectives().counts
    return step


def _split_chunk_step(model, mesh, inner):
    """``inner(params, cache, tokens, slot, *rest)`` (a prompt chunk into
    a contiguous pool: one row, which every rank computes) split on a
    mesh of ranks: the slot's row of each K/V leaf gathered along the
    ``data`` dimensions that split the rows (each rank hands its row at
    the slot's local offset; the owner's is kept), its shard along
    ``model`` as it rests, run as a one-slot pool and written back in
    place by the ranks that hold it."""
    serve = _SplitServe(model, mesh)

    @torch.no_grad()
    def step(params, cache, tokens, slot, *rest):
        comm = Collectives()
        coord = mesh.coordinate()
        with serve(params, comm) as (local, split):
            rows, back = dict(cache), []
            for key in ("k", "v"):
                x = cache[key]
                dims, seq = _cache_split(x, split, False)
                x = x.to_local() if hasattr(x, "to_local") else x
                n = x.shape[_ROWS]
                row = x.narrow(_ROWS, slot % n, 1)
                if dims:
                    owner = 0
                    for m in dims:
                        owner = owner * split.shape[m] + coord[m]
                    if owner == slot // n:
                        back.append((row, key))
                    row = split.gather_rows(row, dims, _ROWS).narrow(
                        _ROWS, slot // n, 1)
                rows[key] = row
                if seq:
                    rows["seq_split"] = True
            rows["index"] = cache["index"].narrow(0, slot, 1)
            logits, _ = inner(local, rows, tokens, 0, *rest)
            logits = _whole_logits(model, split, logits, ())
        for row, key in back:
            row.copy_(rows[key])
        step.collectives = comm.counts
        return logits, cache

    step.collectives = Collectives().counts
    return step


def _split_paged_step(model, mesh, inner):
    """``inner(params, cache, tokens, active, pages)`` (a paged decode or
    verify step) split on a mesh of ranks: every rank holds the pool whole
    along ``data`` (its KV heads' shard along ``model``); it runs its rows,
    then every row's writes (the positions the one device writes, from
    the whole index, activity and page table) are all-gathered along
    ``data`` and put into every rank's pool in the one device's order,
    layer by layer."""
    from repro_torch.models.layers import paged_positions, write_pool
    serve = _SplitServe(model, mesh)

    @torch.no_grad()
    def step(params, cache, tokens, active, pages):
        comm = Collectives()
        share = _Share(tokens.shape[0], mesh)
        with serve(params, comm) as (local, split):
            rows = _local_cache(cache, share, split, paged=True)
            logits, new = inner(local, rows, share.take(tokens),
                                share.take(active), share.take(pages))
            logits = _whole_logits(model, split, logits, share.dp)
            if share.dp:
                s = tokens.shape[1]
                safe = torch.where(active.bool()[:, None], pages,
                                   torch.zeros_like(pages))
                fpos = paged_positions(safe, cache["index"], s,
                                       rows["k"].shape[2])
                mine = share.take(fpos).reshape(-1).long()
                for pool in (rows["k"], rows["v"]):
                    n_layers, n_pages, psize, kh, dh = pool.shape
                    flat = pool.view(n_layers, n_pages * psize, kh, dh)
                    held = flat[:, mine].reshape(n_layers, -1, s, kh, dh)
                    every = split.gather_rows(held.contiguous(), share.dp, 1)
                    every = every.reshape(n_layers, -1, kh, dh)
                    for i in range(n_layers):
                        write_pool(pool[i], fpos.reshape(-1), every[i])
            idx = split.gather_rows(new["index"], share.dp)
        step.collectives = comm.counts
        return logits, dict(cache, index=idx)

    step.collectives = Collectives().counts
    return step


def _split_prefill_step(model, mesh, inner, rules):
    """``inner(params, batch)`` -> (logits, cache) split on a mesh of
    ranks: the rank's rows of every batch leaf, the whole logits, and the
    fresh cache at rest under the specs its table's axes give on the
    whole batch under ``rules``: what the rank computed (its rows, its KV
    heads or every KV head, a recurrent state's heads and conv channels)
    is its shard, or holds it (the whole sequence, of a cache the rules
    split along it: the rank keeps its block), nothing is sent."""
    from torch.distributed.tensor import DTensor
    table = dict(leaf_items(model.cache_table(1, 1)))
    serve = _SplitServe(model, mesh)

    def rest(path, x, share):
        if path not in table or "act_batch" not in table[path].logical_axes:
            return x
        axes = table[path].logical_axes
        shape = list(x.shape)
        for m in share.dp:
            shape[axes.index("act_batch")] *= mesh.shape[m]
        # a split axis's whole size is the config's (the table's)
        for i, ax in enumerate(axes):
            if ax in _MODEL_CACHE_AXES:
                shape[i] = table[path].shape[i]
        pls = placements(logical_to_spec(axes, shape, mesh, rules), mesh)
        dm = mesh.device_mesh
        idx = shard_index(shape, pls, tuple(dm.shape), dm.get_coordinate())
        for i, (s, n) in enumerate(zip(idx, x.shape)):
            if s.stop - s.start == n:
                continue
            # an axis the rank computed whole, which the rules split
            if n != shape[i]:
                raise NotImplementedError(
                    f"a fresh cache leaf of {tuple(x.shape)} a rank under "
                    f"{pls}")
            x = x.narrow(i, s.start, s.stop - s.start)
        return DTensor.from_local(x.contiguous(), dm, pls, run_check=False,
                                  shape=tuple(shape),
                                  stride=contiguous_stride(shape))

    @torch.no_grad()
    def step(params, batch):
        comm = Collectives()
        share = _Share(batch["tokens"].shape[0], mesh)
        with serve(params, comm) as (local, split):
            logits, new = inner(local, {k: share.take(v) if
                                        isinstance(v, torch.Tensor) else v
                                        for k, v in batch.items()})
            logits = _whole_logits(model, split, logits, share.dp)
        step.collectives = comm.counts
        return logits, _cache_map(new, lambda p, x: rest(p, x, share))

    step.collectives = Collectives().counts
    return step


def described_serve_step(model, mesh, params_specs, kind: str, rows: int,
                         cache_specs=None):
    """The split serve step that one rank (coordinate 0) of ``mesh``, a
    mesh described without ranks, runs on its shards, for the dry run's
    trace on ``meta`` (and a card's run of one rank): ``kind`` is
    ``prefill`` (``step(params, batch)``, the rank's rows of an
    ``rows``-row batch) or ``decode`` (the legacy whole-batch decode,
    ``step(params, cache, tokens)`` over the rank's shard of a cache at
    rest under ``cache_specs``).  Returns (the whole batch's logits, the
    rank's cache), its collectives sent nowhere (``Collectives`` with no
    groups) and kept on the step: ``step.collectives`` and
    ``step.collective_calls`` (each call's kind, bytes and group size)."""
    from repro_torch.sharding.split import ServeSplit, params_placements
    pls = params_placements(params_specs, mesh.axis_names, mesh.shape)
    dp = data_parallel_dims(rows, mesh)
    seq = False
    # a K/V cache leaf (a hybrid's shared block's K/V nests), whose
    # sequence may be split along the model axis
    kv = cache_specs.get("k", cache_specs.get("shared_kv", {}).get("k")) \
        if kind == "decode" else None
    if kv is not None:
        model_dim = list(mesh.axis_names).index("model") \
            if "model" in mesh.axis_names else None
        seq = any(m == model_dim and mesh.shape[m] > 1 for m, pl in
                  enumerate(placements(kv, mesh))
                  if pl.is_shard() and pl.dim == _SEQ)

    @torch.no_grad()
    def step(params, *args):
        comm = Collectives()
        split = ServeSplit(mesh.shape, (0,) * len(mesh.shape),
                           [None] * len(mesh.shape), comm, pls,
                           mesh.axis_names)
        with _serving(model, split):
            if kind == "prefill":
                logits, cache = model.prefill(params, args[0])
            else:
                cache, tokens = args
                extra = {"seq_split": True} if seq else {}
                logits, cache = model.decode_step(
                    params, dict(cache, layout="contiguous", **extra), tokens)
            logits = _whole_logits(model, split, logits, dp)
        step.collectives, step.collective_calls = comm.counts, comm.calls
        return logits, cache
    return step


def _cache_map(cache, fn, path=()):
    """``fn(path, tensor)`` over the tensors of a (nested) cache dict;
    other entries (the layout, flags) pass through."""
    if isinstance(cache, dict):
        return {k: _cache_map(v, fn, path + (k,)) for k, v in cache.items()}
    if isinstance(cache, torch.Tensor):
        return fn(path, cache)
    return cache


def build_prefill_step(model, mesh=None, cache_rules=None):
    """Whole-prompt prefill: (params, {"tokens", "last"?}) -> (logits,
    cache).  On a mesh of ranks each rank prefills its rows, split along
    ``model``, and its cache rests under the specs ``cache_rules``
    (DEFAULT_RULES by default) give the cache table's axes."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return _on_mesh(mesh, prefill_step, lambda: _split_prefill_step(
        model, mesh, prefill_step, cache_rules or DEFAULT_RULES))


def build_prefill_chunk_step(model, mesh=None):
    """Chunked prefill straight into a contiguous KV pool: ``cache`` holds
    K/V ``(layers, num_slots, max_len, kv_heads, head_dim)`` and the
    per-slot index; the chunk's K/V land at ``[slot, offset:offset+c)``
    and the chunk attends over the slot's first ``kv_bound`` positions.
    On a mesh every rank computes the chunk (one row) over its shard of
    the slot's row, gathered along ``data``; the ranks holding that row
    keep what it wrote (``_split_chunk_step``)."""
    @torch.no_grad()
    def chunk_step(params, cache, tokens, slot, offset, n_valid, kv_bound):
        return model.chunk_prefill(params, _of_layout(cache, "contiguous"),
                                   tokens, slot, offset, n_valid, kv_bound)
    return _on_mesh(mesh, chunk_step, lambda: _split_chunk_step(
        model, mesh, chunk_step))


def build_prefill_chunk_step_paged(model, mesh=None):
    """Chunked prefill straight into a paged KV pool.

    ``cache`` holds the page pool ``(layers, num_pages, page_size,
    kv_heads, head_dim)`` and the per-slot index; ``pages_row`` is the
    slot's ``(max_pages,)`` page-table row: chunk token at global
    position j lands in page ``pages_row[j // page_size]`` at offset
    ``j % page_size`` — its final resting place, one write.  Pages must
    be reserved by the pool before the call; rows past the reserved
    region (bucket padding) fall into the junk page 0.  On a mesh every
    rank computes the chunk (one row) into its pool, its KV heads where
    the pool is split by them.
    """
    @torch.no_grad()
    def chunk_step(params, cache, tokens, slot, offset, n_valid, kv_bound,
                   pages_row):
        return model.chunk_prefill(params, _of_layout(cache, "paged"),
                                   tokens, slot, offset, n_valid, kv_bound,
                                   pages_row)
    return _on_mesh(mesh, chunk_step, lambda: _split_cache_step(
        model, mesh, chunk_step))


def build_decode_step(model, mesh=None):
    """Whole-batch decode, the legacy fixed-batch serve path's step:
    ``cache`` is a prefill's contiguous cache, its sequence axis padded
    for the tokens to come and its 0-d index the whole batch's length;
    each row's token is written at that index in place.  Returns the
    logits and the cache with the index advanced.  On a mesh each rank
    decodes its rows of the cache where it rests, split along
    ``model``."""
    @torch.no_grad()
    def decode_step(params, cache, tokens):
        if cache["index"].dim() != 0:
            raise ValueError("the whole-batch step takes a 0-d index; a "
                             "pool's slot-wise cache goes to "
                             "build_decode_step_slots")
        return model.decode_step(params, _of_layout(cache, "contiguous"),
                                 tokens)
    return _on_mesh(mesh, decode_step, lambda: _split_cache_step(
        model, mesh, decode_step))


def build_decode_step_slots(model, mesh=None):
    """Slot-wise decode over a contiguous KV pool.  Inactive slots ride
    through the step (each writes only its own row, at its own stale
    index) but their lengths do not advance."""
    @torch.no_grad()
    def decode_step(params, cache, tokens, active):
        cache = _of_layout(cache, "contiguous")
        logits, new_cache = model.decode_step(params, cache, tokens)
        new_index = torch.where(active.bool(), new_cache["index"],
                                cache["index"])
        return logits, dict(cache, index=new_index)
    return _on_mesh(mesh, decode_step, lambda: _split_cache_step(
        model, mesh, decode_step, row_extras=1))


def build_decode_step_slots_paged(model, mesh=None, use_kernel: bool = False):
    """Slot-wise decode over a paged KV pool.

    ``active`` flags the slots holding a live request; the
    ``(num_slots, max_pages)`` int32 page table arrives each step.
    Inactive rows (freed slots, or slots mid-prefill whose index is
    stale) must not write through their page table — with a shared
    prefix a stale write would land in a page others attend — so their
    rows divert to the reserved junk page 0, and their lengths do not
    advance.  ``use_kernel=True`` attends through the CUDA paged-decode
    kernel (its plain version for CPU tensors) instead of the gather
    path; on a mesh each rank's kernel runs on its rows.
    """
    @torch.no_grad()
    def decode_step(params, cache, tokens, active, pages):
        cache = _of_layout(cache, "paged")
        keep = active.bool()
        safe_pages = torch.where(keep[:, None], pages, torch.zeros_like(pages))
        dcache = dict(cache, pages=safe_pages, use_kernel=use_kernel)
        logits, new_cache = model.decode_step(params, dcache, tokens)
        new_index = torch.where(keep, new_cache["index"], cache["index"])
        return logits, dict(cache, index=new_index)
    return _on_mesh(mesh, decode_step, lambda: _split_paged_step(
        model, mesh, decode_step))


def build_verify_step_slots(model, mesh=None):
    """Speculative verify step over a contiguous KV pool: ``tokens`` is
    ``(num_slots, k+1)`` — each row's pending token and its k drafts —
    and the step returns logits at every position ``(num_slots, k+1,
    vocab)``.  Positions past a slot's max_len are dropped; a rejected
    draft's KV is overwritten before any causal mask admits it.  The
    returned index is the one given: how many positions became tokens is
    the host's decision (``pool.sync_index``)."""
    @torch.no_grad()
    def verify_step(params, cache, tokens, active):
        cache = _of_layout(cache, "contiguous")
        logits, _ = model.decode_step(params, cache, tokens)
        return logits, cache
    return _on_mesh(mesh, verify_step, lambda: _split_cache_step(
        model, mesh, verify_step, row_extras=1))


def build_verify_step_slots_paged(model, mesh=None):
    """Speculative verify step over a paged KV pool: as
    ``build_verify_step_slots`` plus the page table; inactive rows divert
    to the junk page 0 as in ``build_decode_step_slots_paged``, and each
    position's page lookup keeps the junk-page ok-guard, so a burst past
    a slot's page run never writes into a live page.  The burst always
    reads through the gather path (the paged-decode kernel takes single
    tokens)."""
    @torch.no_grad()
    def verify_step(params, cache, tokens, active, pages):
        cache = _of_layout(cache, "paged")
        keep = active.bool()
        safe_pages = torch.where(keep[:, None], pages, torch.zeros_like(pages))
        logits, _ = model.decode_step(params, dict(cache, pages=safe_pages),
                                      tokens)
        return logits, cache
    return _on_mesh(mesh, verify_step, lambda: _split_paged_step(
        model, mesh, verify_step))
