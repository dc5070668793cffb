"""Shared neural-net layers of the port (port of ``repro/models/layers.py``).

Plain functions over parameter dicts whose tensors have the reference's
shapes.  Every rounding point of the reference is kept, so on the same
weights the port agrees with it bit for bit in almost every element:
bf16 projections, the f32 RMSNorm and LayerNorm, f32 RoPE, attention
with f32 scores and probabilities rounded to bf16 before the PV product,
a SiLU and a tanh-form GELU whose steps each round to bf16 the way XLA
rounds the reference's ``jax.nn.silu`` and ``jax.nn.gelu`` on bf16, and
a squared ReLU rounded once, after the square.  Positions are RoPE,
learned (a ``pos_embedding`` table) or sinusoidal (f32, as the
reference computes them).

Attention runs in four modes: ``full`` (training: causal, no cache),
``prefill`` (causal, returns fresh K/V), ``decode`` (slot-wise: one
token per row, or a speculative verify burst of s tokens, over a paged
or a contiguous pool; or the whole batch at one length, over a prefill's
padded cache) and ``chunk`` (chunked prefill written straight into the
pool).  Decode and chunk write K/V **in place** into the pool's
storage: a functional copy of the pool per layer and tick would cost
more than the tick itself.

Everything is differentiable for training: the RMSNorm kernel through
its ``torch.autograd.Function`` (``kernels/ops.py``), the rest through
autograd.  Under grad the embedding gathers by indexing, whose backward
sums a repeated token's gradients in a fixed order on the card.

A step split over a mesh passes ``tp`` (a ``sharding.split.Split``, or
a serve step's ``ServeSplit``) to its layers, with weights split along
the model axis: attention (cross-attention too) by heads, the MLP by
``mlp``, the embedding and the unembedding by vocabulary.  A layer whose weight is whole (one
model rank, or a dimension the axis does not divide) computes as on one
device.  A split decode or chunk step reads the KV cache where it
rests: the rank's own KV heads; of a cache that keeps every KV head
(``kv_heads`` does not divide the model axis: every rank computes them
all, as in training, and writes them all) the heads its query heads
read (``Split.kv_range``); of a cache split along its sequence over the
model axis (``seq_split``: each rank writes the positions it holds),
those heads' shards gathered for the layer (``ServeSplit.gather_seq``).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops, ref
from repro_torch.models.params import ParamDef

# ---------------------------------------------------------------------------
# Norms


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """f32 RMSNorm cast to ``out_dtype`` (default: x's dtype) — the
    hand-written kernel on the card, its plain version on the CPU (same
    math either way)."""
    return ops.rmsnorm(x, scale, eps, out_dtype=out_dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """LayerNorm in f32 with scale and bias, cast to ``out_dtype``
    (default: x's dtype) — plain PyTorch on every device (the RMSNorm
    kernel does not compute it)."""
    dt = out_dtype or x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def add_norm(p: dict, x: torch.Tensor, a: torch.Tensor | None, kind: str,
             *, norm_of_rounded: bool = True
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The residual add ``x + a`` and the norm of the sum:
    ``(stream, normed)``, the sum rounded to x's dtype and its norm in
    x's dtype.  The norm reads the rounded sum, or with
    ``norm_of_rounded=False`` the unrounded f32 sum.  ``a=None``: x is
    the stream as it is, and only the norm runs.  RMSNorm runs as one
    kernel on the card; LayerNorm is a plain add, then the norm."""
    if kind == "rmsnorm":
        if a is None:
            return x, rmsnorm(x, p["scale"])
        return ops.add_rmsnorm(x, a, p["scale"],
                               norm_of_rounded=norm_of_rounded)
    if kind != "layernorm":
        raise ValueError(f"norm kind {kind!r}")
    if a is None:
        return x, layernorm(x, p["scale"], p["bias"])
    total = x.float() + a.float()
    stream = total.to(x.dtype)
    normed = layernorm(stream if norm_of_rounded else
                       _GradIn.apply(total, x.dtype), p["scale"],
                       p["bias"], out_dtype=x.dtype)
    return stream, normed


def apply_norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """The norm of ``kind`` over x (RMSNorm: the kernel on the card)."""
    return add_norm(p, x, None, kind)[1]


class _GradIn(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to ``dtype``: the
    norm of the f32 sum hands back its input's gradient in the stream's
    dtype before it meets the stream's own, as the reference's norms do
    (``_match_dgrad_dtype``)."""

    @staticmethod
    def forward(ctx, t, dtype):
        ctx.dtype = dtype
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).to(g.dtype), None


def norm_defs(d_model: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamDef((d_model,), ("embed",), init="ones")}
    return {"scale": ParamDef((d_model,), ("embed",), init="ones"),
            "bias": ParamDef((d_model,), ("embed",), init="zeros")}


# ---------------------------------------------------------------------------
# Rotary position embeddings


def rope_frequencies(head_dim: int, fraction: float, theta: float) -> int:
    """Number of rotated dims (even)."""
    rot = int(head_dim * fraction)
    return rot - rot % 2


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               fraction: float = 1.0, theta: float = 10000.0) -> torch.Tensor:
    """x: (b, s, heads, head_dim); positions: (b, s) integer."""
    head_dim = x.shape[-1]
    rot = rope_frequencies(head_dim, fraction, theta)
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    freqs = torch.exp(-torch.arange(0, rot, 2, dtype=torch.float32,
                                    device=x.device) * (math.log(theta) / rot))
    angles = positions[..., None].float() * freqs           # (b, s, rot/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
    o1 = x1 * cos - x2 * sin                                 # f32
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x_rot.shape).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < head_dim else out


def _sinusoid(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """f32 sinusoids of f32 positions ``pos`` (..., 1): sin in the even
    features, cos in the odd ones, each angle ``pos / 10000^(i / d)``."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=pos.device)
    angle = pos / torch.pow(10000.0, dim / d_model)
    pe = torch.zeros(angle.shape[:-1] + (d_model,), dtype=torch.float32,
                     device=pos.device)
    pe[..., 0::2] = torch.sin(angle)
    pe[..., 1::2] = torch.cos(angle)
    return pe


def sinusoidal_positions(seq_len: int, d_model: int,
                         device=None) -> torch.Tensor:
    """The (seq_len, d_model) f32 table of sinusoidal positions."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)
    return _sinusoid(pos[:, None], d_model)


# ---------------------------------------------------------------------------
# Attention (GQA)

_Q_CHUNK = 1024


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """exp(x - max) / sum, the formula of ``jax.nn.softmax``."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _attn_one_chunk(q, k, v, mask, scale, dtype=None):
    """q: (b,K,G,qc,dh)  k/v: (b,t,K,dh)  mask: (b or 1, qc, t) bool.
    The probabilities and the output are rounded to ``dtype`` (default
    v's)."""
    dtype = dtype or v.dtype
    scores = torch.einsum("bkgqd,btkd->bkgqt", q.float(), k.float()) * scale
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = _softmax(scores).to(dtype)
    out = torch.einsum("bkgqt,btkd->bkgqd", probs.float(), v.float())
    return out.to(dtype)


def _rows(v):
    """A per-row length/offset vector as a (b, 1, 1) tensor; ints pass."""
    return v.reshape(-1, 1, 1) if isinstance(v, torch.Tensor) else v


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, q_offset: torch.Tensor | int = 0,
                  kv_len: torch.Tensor | int | None = None,
                  q_chunk: int = _Q_CHUNK, dtype=None) -> torch.Tensor:
    """Grouped-query attention.

    q: (b, s, H, dh); k/v: (b, t, K, dh) with H % K == 0.
    causal: query i attends keys j <= i + q_offset.
    kv_len: optional valid length of the kv sequence.
    q_offset / kv_len may be (b,) tensors — per-row lengths for the
    continuous-batching slot decode.  Long sequences are processed in
    q-chunks so the live score buffer is (b, H, q_chunk, t).  ``dtype``
    rounds the probabilities and the output (default v's: a split step
    hands f32 K/V of bf16 values).
    """
    b, s, H, dh = q.shape
    t, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, s, K, G, dh).permute(0, 2, 3, 1, 4)    # b,K,G,s,dh
    kv_pos = torch.arange(t, device=q.device)[None, None, :]

    def mask_for(q_pos):
        m = torch.ones((1, q_pos.shape[0], t), dtype=torch.bool,
                       device=q.device)
        if kv_len is not None:
            m = m & (kv_pos < _rows(kv_len))
        if causal:
            m = m & (kv_pos <= q_pos[None, :, None] + _rows(q_offset))
        return m

    def one(start):
        stop = min(start + q_chunk, s)
        q_pos = torch.arange(start, stop, device=q.device)
        return _attn_one_chunk(qg[:, :, :, start:stop], k, v,
                               mask_for(q_pos), scale, dtype)

    # under grad, a chunk's (q_chunk x t) scores are recomputed in the
    # backward instead of kept for every chunk, as the reference
    # checkpoints its chunk body
    if s > q_chunk and torch.is_grad_enabled():
        outs = [checkpoint(one, start, use_reentrant=False)
                for start in range(0, s, q_chunk)]
    else:
        outs = [one(start) for start in range(0, s, q_chunk)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, H, dh)


def attention_defs(cfg) -> dict:
    dh = cfg.head_dim
    d = {
        "wq": ParamDef((cfg.d_model, cfg.num_heads, dh), ("embed", "heads", "head_dim")),
        "wk": ParamDef((cfg.d_model, cfg.num_kv_heads, dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((cfg.d_model, cfg.num_kv_heads, dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((cfg.num_heads, dh, cfg.d_model), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        d["bq"] = ParamDef((cfg.num_heads, dh), ("heads", "head_dim"), init="zeros")
        d["bk"] = ParamDef((cfg.num_kv_heads, dh), ("kv_heads", "head_dim"), init="zeros")
        d["bv"] = ParamDef((cfg.num_kv_heads, dh), ("kv_heads", "head_dim"), init="zeros")
    return d


def write_pool(pool: torch.Tensor, fpos: torch.Tensor,
                kv: torch.Tensor) -> None:
    """Scatter (n, K, dh) rows into a (num_pages, page_size, K, dh) pool at
    flat token positions ``fpos``, in place."""
    n_pages, psize, Kh, dh = pool.shape
    pool.view(n_pages * psize, Kh, dh).index_put_((fpos.long(),), kv)


def paged_positions(pages: torch.Tensor, idx: torch.Tensor, s: int,
                    psize: int) -> torch.Tensor:
    """The flat pool positions ``(slots, s)`` that s tokens per row write
    to from each row's index through its page-table row; positions past
    the row's page run go to the reserved junk page 0, never wrapped into
    its last page."""
    max_pages = pages.shape[1]
    pos = idx[:, None] + torch.arange(s, device=idx.device)[None, :]
    logical_page = pos // psize
    ok = logical_page < max_pages
    dest = pages.gather(1, logical_page.clamp(max=max_pages - 1).long())
    return torch.where(ok, dest * psize + pos % psize, pos % psize)


def _heads(t, read):
    """The KV heads ``read`` (``(lo, hi, ...)``: ``[lo, hi)``; None: all)
    of a (..., K, dh) cache tensor, in place."""
    return t if read is None else t[..., read[0]:read[1], :]


def _seq_view(t, read, tp, seq: bool):
    """A (b, t, K, dh) cache row block as a layer reads it: its heads
    ``read``, and where the cache is split along its sequence over the
    model axis (``seq``) every model rank's shard of those heads
    (``ServeSplit.gather_seq``)."""
    return tp.gather_seq(t, read) if seq else _heads(t, read)


def _owned(ok, pos, t_local: int, tp, seq: bool):
    """(the positions ``ok`` this rank writes, their local index) of
    global sequence positions ``pos``: all of them, or of a cache split
    along its sequence those in this rank's block of ``t_local``."""
    if not seq:
        return ok, pos
    return ok & (pos // t_local == tp.tp_rank), pos % t_local


def _paged_decode(q, k, v, cache, read=None):
    """Paged slot-wise decode of s tokens per row: scatter each row's new
    K/V to its own pages/offsets through the page table (positions past
    the row's page run go to the reserved junk page 0, never wrapped into
    its last page), then attend.  A single token (s == 1) attends in the
    CUDA kernel (``use_kernel``) or through the gather path, which is the
    kernel's plain version ``ref.paged_attention_ref`` on any device; a
    verify burst (s > 1) always gathers the rows' page runs and attends
    with ``dot_attention``, as the reference does.  ``read``: the KV heads
    ``[lo, hi)`` the queries read of a pool holding more (the kernel
    reads them in place)."""
    pages, idx = cache["pages"], cache["index"]
    ck, cv = cache["k"], cache["v"]
    psize, Kh, dh = ck.shape[1], ck.shape[2], ck.shape[3]
    slots, s = q.shape[0], q.shape[1]
    max_pages = pages.shape[1]
    fpos = paged_positions(pages, idx, s, psize)
    write_pool(ck, fpos.reshape(-1), k.reshape(-1, Kh, dh))
    write_pool(cv, fpos.reshape(-1), v.reshape(-1, Kh, dh))
    if s == 1:
        attend = ops.paged_attention if cache.get("use_kernel") \
            else ref.paged_attention_ref
        heads = () if read is None else (read[0], read[1] - read[0])
        return attend(q[:, 0].contiguous(), ck, cv, pages, idx + 1,
                      *heads)[:, None]
    rows = pages.long()
    kg = _heads(ck[rows], read).reshape(slots, max_pages * psize, -1, dh)
    vg = _heads(cv[rows], read).reshape(slots, max_pages * psize, -1, dh)
    return dot_attention(q, kg, vg, causal=True, q_offset=idx, kv_len=idx + s)


def _slot_decode(q, k, v, cache, read=None, tp=None):
    """Contiguous slot-wise decode of s tokens per row: each row's new K/V
    land at its own positions ``index .. index + s - 1`` of its
    ``(max_len, K, dh)`` row (positions past max_len are dropped, as the
    reference's one-hot select and ``mode="drop"`` scatter drop them),
    then the row attends its own prefix with a per-row causal mask.  On a
    split step ``read`` and the cache's ``seq_split`` say what the rank
    reads (see the module's docstring)."""
    idx, ck, cv = cache["index"], cache["k"], cache["v"]
    seq = bool(cache.get("seq_split"))
    slots, s = q.shape[0], q.shape[1]
    t = ck.shape[1] * (tp.tp if seq else 1)
    pos = idx[:, None].long() + torch.arange(s, device=q.device)[None, :]
    rows = torch.arange(slots, device=q.device)[:, None].expand(slots, s)
    ok, at = _owned(pos < t, pos, ck.shape[1], tp, seq)
    ck.index_put_((rows[ok], at[ok]), k[ok])
    cv.index_put_((rows[ok], at[ok]), v[ok])
    return dot_attention(q, _seq_view(ck, read, tp, seq),
                         _seq_view(cv, read, tp, seq), causal=True,
                         q_offset=idx, kv_len=idx + s)


def _batch_decode(q, k, v, cache, window=None, read=None, tp=None):
    """Whole-batch decode at one length (a 0-d index, on the host): every
    row's s new K/V land at positions ``index .. index + s - 1``, then
    each row attends its prefix causally.  With a ``window`` at least the
    cache's length, the cache is a ring buffer of the last t positions:
    the write lands at ``index mod t`` and every valid position is
    attended (keys carry their RoPE phase from write time, so order in
    the ring does not matter), the reference's branch; a ring split
    along its sequence is written by the rank that holds ``index mod
    t``.  A write past the
    cache's end raises: the reference's ``dynamic_update_slice`` would
    clamp it onto the last positions, overwriting them silently (the
    legacy path grows the cache by the tokens it decodes).  On a split
    step ``read`` and the cache's ``seq_split`` say what the rank reads
    (see the module's docstring)."""
    at, ck, cv = int(cache["index"]), cache["k"], cache["v"]
    seq = bool(cache.get("seq_split"))
    tl = ck.shape[1]
    s, t = q.shape[1], tl * (tp.tp if seq else 1)
    ring = window is not None and t <= window
    start = at % t if ring else at
    if start + s > t:
        raise ValueError(f"decode write at {start}..{start + s - 1} falls "
                         f"past a cache of {t} positions")
    lo = start - (tp.tp_rank * tl if seq else 0)
    a, b = max(lo, 0), min(lo + s, tl)
    if a < b:
        ck[:, a:b] = k[:, a - lo:b - lo]
        cv[:, a:b] = v[:, a - lo:b - lo]
    kc, vc = (_seq_view(c, read, tp, seq) for c in (ck, cv))
    if ring:
        return dot_attention(q, kc, vc, causal=False, kv_len=min(at + s, t))
    return dot_attention(q, kc, vc, causal=True, q_offset=at, kv_len=at + s)


def _chunk(q, k, v, cache, read=None, tp=None):
    """Chunked prefill straight into the pool: the chunk's K/V land at
    their final positions, then the chunk attends causally over the
    slot's first ``kv_bound`` positions read back through the same
    indirection.  Paged: through the slot's page-table row, bucket
    padding past the row's pages falling into the junk page 0.
    Contiguous: the slot's row, positions past max_len dropped.  The
    pool's ``layout`` picks which.  On a split step ``read`` and the
    cache's ``seq_split`` say what the rank reads (see the module's
    docstring)."""
    off, bound = cache["offset"], cache["kv_bound"]
    ck, cv = cache["k"], cache["v"]
    Kh, dh = ck.shape[2], ck.shape[3]
    s = q.shape[1]
    pos = off + torch.arange(s, device=q.device)
    if cache["layout"] == "paged":
        pages_row = cache["pages_row"]
        psize = ck.shape[1]
        max_pages = pages_row.shape[0]
        logical = pos // psize
        ok = logical < max_pages
        dest = pages_row[logical.clamp(max=max_pages - 1)]
        fpos = torch.where(ok, dest * psize + pos % psize, pos % psize)
        write_pool(ck, fpos, k[0])
        write_pool(cv, fpos, v[0])
        B = min(-(-bound // psize), max_pages)
        held = pages_row[:B].long()
        kg = _heads(ck[held], read).reshape(1, B * psize, -1, dh)
        vg = _heads(cv[held], read).reshape(1, B * psize, -1, dh)
    else:
        slot, seq = cache["slot"], bool(cache.get("seq_split"))
        t = ck.shape[1] * (tp.tp if seq else 1)
        ok, at = _owned(pos < t, pos, ck.shape[1], tp, seq)
        ck[slot, at[ok]] = k[0][ok]
        cv[slot, at[ok]] = v[0][ok]
        L = min(bound, t)
        kg, vg = (_seq_view(c[slot:slot + 1], read, tp, seq)[:, :L]
                  for c in (ck, cv))
    return dot_attention(q, kg, vg, causal=True, q_offset=off, kv_len=off + s)


def _windowed_attention(q, k, v, window: int, dtype=None) -> torch.Tensor:
    """Sliding-window causal attention by q-chunks: each chunk of
    ``min(_Q_CHUNK, s)`` queries attends only the kv slice [chunk start -
    window, chunk end), query i the keys j with i - window < j <= i.
    Under grad a chunk's scores are recomputed in the backward, as
    ``dot_attention`` does.  ``dtype`` rounds the probabilities and the
    output, as ``dot_attention``'s (a split step's KV heads kept whole
    come as f32 K/V of bf16 values)."""
    b, s, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(dh)
    qc = min(_Q_CHUNK, s)
    assert s % qc == 0, (s, qc)
    span = qc + window
    qg = q.reshape(b, s, K, G, dh).permute(0, 2, 3, 1, 4)    # b,K,G,s,dh
    pad = k.new_zeros((b, window) + k.shape[2:])
    k_pad, v_pad = torch.cat([pad, k], dim=1), torch.cat([pad, v], dim=1)
    rel = torch.arange(span, device=q.device)[None, :] - window

    def one(start):
        # in padded coordinates the chunk's window begins at ``start``
        q_pos = start + torch.arange(qc, device=q.device)[:, None]
        kv_pos = start + rel
        m = (kv_pos <= q_pos) & (kv_pos > q_pos - window) & (kv_pos >= 0)
        return _attn_one_chunk(qg[:, :, :, start:start + qc],
                               k_pad[:, start:start + span],
                               v_pad[:, start:start + span], m[None], scale,
                               dtype)

    if torch.is_grad_enabled():
        outs = [checkpoint(one, start, use_reentrant=False)
                for start in range(0, s, qc)]
    else:
        outs = [one(start) for start in range(0, s, qc)]
    out = torch.cat(outs, dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, H, dh)


def attention(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              mode: str, cache: dict | None = None,
              window: int | None = None, kv_source=None, tp=None):
    """mode: 'full' (training: causal, no cache), 'prefill' (causal,
    returns the fresh K/V), 'decode' (slot-wise, one token or a verify
    burst per row, through the page table or the slot rows as the pool's
    ``cache["layout"]`` says, or the whole batch at a 0-d index; in-place
    write), 'chunk' (chunked prefill into the pool, in-place).  A
    ``window`` (sliding-window attention) applies where the reference
    applies it: a full or prefill pass longer than the window attends by
    q-chunks over its band (``_windowed_attention``), and a whole-batch
    decode over a cache no longer than the window treats it as a ring
    buffer.

    ``kv_source`` makes it cross-attention: K and V come from the source,
    a (b, t, d) encoder output (projected here, biases included) or a
    (k, v) pair projected already (a decode step's cached cross K/V).
    Every query attends every source position, with no RoPE, in any
    mode; a prefill returns the projected K/V as its fresh cache.

    With ``tp`` and the heads split over the model axis, this rank's
    heads: the K/V heads they read, ``wo`` row-parallel; a prefill's
    fresh K/V are the heads the rank computed (every KV head where they
    are kept whole), a decode or chunk reads the cache where it rests
    (see the module's docstring).  Cross-attention splits the same way:
    the rank's query heads over the K/V heads they read, projected from
    the source on the rank's KV heads (every KV head where they are kept
    whole) or read from a cached pair that holds those heads, or every
    KV head.  Returns (out, fresh_cache or None)."""
    dt = x.dtype
    split = tp is not None and p["wq"].shape[1] < cfg.num_heads
    # the K/V heads whole where ``kv_heads`` does not divide the model
    # axis: every model rank computes them all, as one device does
    shared_kv = split and p["wk"].shape[1] == cfg.num_kv_heads

    def proj(eq, t, w, whole=False):
        return split_product(tp, eq, t, w) if split and not whole \
            else torch.einsum(eq, t, w)
    q = proj("bse,ehd->bshd", x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if isinstance(kv_source, tuple):
        k, v = kv_source
    else:
        src = x if kv_source is None else kv_source
        k = proj("bte,ekd->btkd", src, p["wk"], shared_kv)
        v = proj("bte,ekd->btkd", src, p["wv"], shared_kv)
        if "bk" in p:
            k = k + p["bk"]
            v = v + p["bv"]
    new_cache = None
    if kv_source is not None:
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
        # the KV heads the rank's queries read of every KV head: of a
        # cached pair, its range; of the fresh projections, as training
        # reads them (``kv_for_heads``)
        if shared_kv and isinstance(kv_source, tuple):
            read = tp.kv_range(cfg, q.shape[2])
            k, v = _heads(k, read), _heads(v, read)
        elif shared_kv:
            k, v = (tp.kv_for_heads(t, cfg, q.shape[2]) for t in (k, v))
        out = dot_attention(q, k, v, causal=False, dtype=dt)
        return _out(p, out, dt, tp, split), new_cache
    if cfg.pos == "rope":
        q = apply_rope(q, positions, fraction=cfg.rope_fraction,
                       theta=cfg.rope_theta)
        k = apply_rope(k, positions, fraction=cfg.rope_fraction,
                       theta=cfg.rope_theta)
    if mode in ("decode", "chunk"):
        # a cache that keeps every KV head (its rules keep them whole, as
        # the sequence-parallel rules do) beside this rank's own KV heads:
        # the new K/V gathered along the model axis, each rank writing
        # every head of the positions it holds
        keep_all = split and not shared_kv and \
            cache["k"].shape[-2] == cfg.num_kv_heads > k.shape[2]
        if keep_all:
            k, v = tp.gather_out(k, 2), tp.gather_out(v, 2)
        # the KV heads read: this rank's and every model rank's range
        read = tp.kv_range(cfg, q.shape[2]) + (
            [tp.kv_range(cfg, q.shape[2], j) for j in range(tp.tp)],) \
            if shared_kv or keep_all else None
        if split and cache["k"].shape[-2] != k.shape[2]:
            raise NotImplementedError(
                f"a cache of {cache['k'].shape[-2]} KV heads a rank beside "
                f"{k.shape[2]} computed")
        if mode == "chunk":
            out = _chunk(q, k, v, cache, read, tp)
        elif cache["layout"] == "paged":
            out = _paged_decode(q, k, v, cache, read)
        elif cache["index"].dim() == 0:
            out = _batch_decode(q, k, v, cache, window, read, tp)
        else:
            out = _slot_decode(q, k, v, cache, read, tp)
    elif mode in ("prefill", "full"):
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
        if shared_kv:
            k, v = (tp.kv_for_heads(t, cfg, q.shape[2]) for t in (k, v))
        if window is not None and q.shape[1] > window and cfg.causal:
            out = _windowed_attention(q, k, v, window, dt)
        else:
            out = dot_attention(q, k, v, causal=cfg.causal, dtype=dt)
    else:
        raise ValueError(f"attention mode {mode!r}")
    return _out(p, out, dt, tp, split), new_cache


def _out(p: dict, out: torch.Tensor, dt, tp, split: bool) -> torch.Tensor:
    """The heads' outputs through ``wo``: on a split step the f32 partial
    sums over this rank's heads, summed over the model axis and rounded
    once."""
    if split:
        return split_rows(tp, "bshd,hde->bse", out, p["wo"], dt)
    return torch.einsum("bshd,hde->bse", out, p["wo"])


# ---------------------------------------------------------------------------
# Products split over the model axis


def split_input(tp, x: torch.Tensor) -> torch.Tensor:
    """The input of column-parallel products on a split step: x in f32
    through ``copy_in``, so each model rank's partial gradient of it stays
    f32 until the sum over the model axis, and is rounded once."""
    return tp.copy_in(x.float())


def split_product(tp, eq: str, x: torch.Tensor, w: torch.Tensor,
                  dtype=None) -> torch.Tensor:
    """A column-parallel ``einsum(eq, x, w)`` on a split step: x through
    its own ``split_input`` and the weight shard in f32, the product
    rounded once to ``dtype`` (default x's; one device's bf16 product
    accumulates in f32 and rounds once too).  Each product's input
    gradient is summed over the model axis alone and rounded once, then
    added to the other products' in x's dtype, as one device adds its
    products'."""
    return torch.einsum(eq, split_input(tp, x), w.float()).to(
        dtype or x.dtype)


def split_rows(tp, eq: str, x: torch.Tensor, w: torch.Tensor,
               dtype) -> torch.Tensor:
    """A row-parallel ``einsum(eq, x, w)`` on a split step: the f32
    partial sums over this rank's shard of the contracted axis, summed
    over the model axis and rounded once to ``dtype`` (one device's
    product rounds once)."""
    return tp.reduce_out(torch.einsum(eq, x.float(), w.float())).to(dtype)


# ---------------------------------------------------------------------------
# MLP


def mlp_defs(cfg) -> dict:
    gated = cfg.activation in ("silu", "geglu")
    d = {"wi": ParamDef((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
         "wo": ParamDef((cfg.d_ff, cfg.d_model), ("mlp", "embed"))}
    if gated:
        d["wg"] = ParamDef((cfg.d_model, cfg.d_ff), ("embed", "mlp"))
    return d


class _SiLU(torch.autograd.Function):
    """SiLU with the reference's gradient: with s the sigmoid of the
    forward, ``g * s + (g * x) * (s * (1 - s))``, each step rounded to
    x's dtype, as XLA evaluates the transpose of ``jax.nn.silu``'s JVP on
    bf16 (autograd through the forward's steps rounds otherwise)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * (1 / (1 + torch.exp(-x)))

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        s = 1 / (1 + torch.exp(-x))
        return g * s + (g * x) * (s * (1 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * 1 / (1 + exp(-x)), each step rounded to x's dtype — how XLA
    evaluates the reference's ``jax.nn.silu`` on bf16."""
    return _SiLU.apply(x)


def sq_relu(x: torch.Tensor) -> torch.Tensor:
    """relu(x)², rounded once to x's dtype after the square, as XLA
    evaluates the reference's ``jnp.square(jax.nn.relu(h))`` on bf16."""
    r = torch.relu(x)
    return r * r


def _gelu_consts(dtype) -> tuple[float, float]:
    """0.044715 and sqrt(2 / pi) in ``dtype``: ``jax.nn.gelu`` takes its
    constants in x's dtype (0.044677734375 and 0.796875 in bf16)."""
    return tuple(float(torch.tensor(c, dtype=dtype))
                 for c in (0.044715, math.sqrt(2 / math.pi)))


class _GeLU(torch.autograd.Function):
    """GELU's tanh form, ``x * 0.5 * (1 + tanh(c2 * (x + c1 * x^3)))``,
    each step rounded to x's dtype, as XLA evaluates the reference's
    ``jax.nn.gelu`` (``approximate=True``) on bf16, and its gradient in
    the steps and roundings of XLA's transpose of that chain."""

    @staticmethod
    def forward(ctx, x):
        c1, c2 = _gelu_consts(x.dtype)
        x2 = x * x
        t = torch.tanh((x + (x2 * x) * c1) * c2)
        ctx.save_for_backward(x, x2, t)
        return x * ((t + 1) * 0.5)

    @staticmethod
    def backward(ctx, g):
        x, x2, t = ctx.saved_tensors
        c1, c2 = _gelu_consts(x.dtype)
        direct = g * ((t + 1) * 0.5)                  # d/dx of x in x * cdf
        p = ((x * g) * 0.5) * (1 - t)
        db = (p + p * t) * c2                         # through tanh
        return (direct + db) + (db * c1) * (x2 * 3)   # through x + c1 x^3


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu`` (the tanh form), rounded step by
    step as XLA rounds it on bf16 (torch's ``F.gelu`` defaults to the erf
    form, another function)."""
    return _GeLU.apply(x)


def mlp(p: dict, x: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    """The MLP; with ``tp`` and ``mlp`` split over the model axis, this
    rank's columns, ``wo`` row-parallel (f32 partials summed, rounded
    once)."""
    dt = x.dtype
    split = tp is not None and p["wi"].shape[-1] < cfg.d_ff

    def proj(w):
        return split_product(tp, "bse,ef->bsf", x, w) if split \
            else torch.einsum("bse,ef->bsf", x, w)
    h = proj(p["wi"])
    if cfg.activation == "silu":
        h = silu(proj(p["wg"])) * h if "wg" in p else silu(h)
    elif cfg.activation == "gelu":
        h = gelu(h)
    elif cfg.activation == "sq_relu":
        h = sq_relu(h)
    else:
        raise ValueError(f"activation {cfg.activation!r}")
    if split:
        return split_rows(tp, "bsf,fe->bse", h, p["wo"], dt)
    return torch.einsum("bsf,fe->bse", h, p["wo"])


# ---------------------------------------------------------------------------
# Embedding / unembedding


def embed_defs(cfg) -> dict:
    d = {"embedding": ParamDef((cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        d["unembed"] = ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    if cfg.pos == "learned":
        d["pos_embedding"] = ParamDef((cfg.max_position, cfg.d_model),
                                      (None, "embed"), init="embed",
                                      scale=0.02)
    return d


def _take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table``'s rows at the integer ``ids``, shaped (*ids.shape, -1).
    Indexing, not index_select: index_select's backward adds a repeated
    id's rows with atomics on the card, in no fixed order; indexing's
    sorts them first."""
    return table[ids.reshape(-1).long()].reshape(*ids.shape, -1)


def embed(p: dict, tokens: torch.Tensor, cfg,
          positions: torch.Tensor | None = None, tp=None) -> torch.Tensor:
    """The tokens' embeddings in the activation dtype, plus the positions'
    (a ``learned`` table's rows, or ``sinusoidal`` f32 rows cast down)
    where the config adds them; RoPE configs add none here.  With ``tp``
    and the table split by vocabulary, each model rank's rows, summed."""
    table = p["embedding"]
    rows = tp.vocab_rows(table, tokens) \
        if tp is not None and table.shape[0] < cfg.vocab_size \
        else _take_rows(table, tokens)
    x = rows.to(cfg.activation_dtype)
    if cfg.pos in ("learned", "sinusoidal") and positions is None:
        raise ValueError(f"{cfg.pos} positions need ``positions``")
    if cfg.pos == "learned":
        x = x + _take_rows(p["pos_embedding"], positions).to(x.dtype)
    elif cfg.pos == "sinusoidal":
        x = x + _sinusoid(positions.float()[..., None],
                          cfg.d_model).to(x.dtype)
    elif cfg.pos not in ("rope", "none"):
        raise ValueError(f"position embedding {cfg.pos!r}")
    return x


def unembed(p: dict, x: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    """Logits of the stream; with ``tp`` and the table split by
    vocabulary, this rank's columns of them (``softmax_xent`` with the
    same ``tp`` reduces over the model axis)."""
    w = p["embedding"] if cfg.tie_embeddings else p["unembed"]
    if tp is not None and w.shape[0 if cfg.tie_embeddings else 1] \
            < cfg.vocab_size:
        eq = "bse,ve->bsv" if cfg.tie_embeddings else "bse,ev->bsv"
        return split_product(tp, eq, x, w)
    if cfg.tie_embeddings:
        return torch.einsum("bse,ve->bsv", x, p["embedding"].to(x.dtype))
    return torch.einsum("bse,ev->bsv", x, p["unembed"])


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None, tp=None) -> torch.Tensor:
    """Mean per-token cross entropy in f32 (``logsumexp`` of the f32
    logits less the label's logit); with ``mask``, the mean over the
    tokens it keeps.  labels: integer (b, s).  ``tp``: the logits are
    this rank's vocabulary columns (``unembed``'s split), the max and
    the sum of exponentials reduced over the model axis."""
    logits = logits.float()
    if tp is not None:
        nll = tp.vocab_nll(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[..., None].long())[..., 0]
        nll = lse - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
