"""Shared neural-net layers of the port (port of ``repro/models/layers.py``).

Plain functions over parameter dicts whose tensors have the reference's
shapes.  Every rounding point of the reference is kept, so on the same
weights the port agrees with it bit for bit in almost every element:
bf16 projections, the f32 RMSNorm, f32 RoPE, attention with f32 scores
and probabilities rounded to bf16 before the PV product, and a SiLU
whose steps each round to bf16 the way XLA rounds the reference's
``jax.nn.silu`` on bf16.

Attention runs in three modes: ``prefill`` (causal, returns fresh K/V),
``decode`` (the paged slot-wise single-token arm) and ``chunk`` (chunked
prefill written straight into the page pool).  Decode and chunk write
K/V **in place** into the pool's storage: a functional copy of the pool
per layer and tick would cost more than the tick itself.
"""

from __future__ import annotations

import math

import torch

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


def norm_defs(d_model: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamDef((d_model,), ("embed",), init="ones")}
    return {"scale": ParamDef((d_model,), ("embed",), init="ones"),
            "bias": ParamDef((d_model,), ("embed",), init="zeros")}


def apply_norm(p: dict, x: torch.Tensor, kind: str,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(
            f"norm {kind!r} is not ported yet (ROADMAP: other arch configs)")
    return rmsnorm(x, p["scale"], out_dtype=out_dtype)


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


# ---------------------------------------------------------------------------
# Attention (GQA)

_Q_CHUNK = 1024


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """exp(x - max) / sum, the formula of ``jax.nn.softmax``."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _attn_one_chunk(q, k, v, mask, scale):
    """q: (b,K,G,qc,dh)  k/v: (b,t,K,dh)  mask: (b or 1, qc, t) bool."""
    scores = torch.einsum("bkgqd,btkd->bkgqt", q.float(), k.float()) * scale
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, -1e30))
    probs = _softmax(scores).to(v.dtype)
    out = torch.einsum("bkgqt,btkd->bkgqd", probs.float(), v.float())
    return out.to(v.dtype)


def _rows(v):
    """A per-row length/offset vector as a (b, 1, 1) tensor; ints pass."""
    return v.reshape(-1, 1, 1) if isinstance(v, torch.Tensor) else v


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, q_offset: torch.Tensor | int = 0,
                  kv_len: torch.Tensor | int | None = None,
                  q_chunk: int = _Q_CHUNK) -> torch.Tensor:
    """Grouped-query attention.

    q: (b, s, H, dh); k/v: (b, t, K, dh) with H % K == 0.
    causal: query i attends keys j <= i + q_offset.
    kv_len: optional valid length of the kv sequence.
    q_offset / kv_len may be (b,) tensors — per-row lengths for the
    continuous-batching slot decode.  Long sequences are processed in
    q-chunks so the live score buffer is (b, H, q_chunk, t).
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

    outs = []
    for start in range(0, s, q_chunk):
        stop = min(start + q_chunk, s)
        q_pos = torch.arange(start, stop, device=q.device)
        outs.append(_attn_one_chunk(qg[:, :, :, start:stop], k, v,
                                    mask_for(q_pos), scale))
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


def _write_pool(pool: torch.Tensor, fpos: torch.Tensor,
                kv: torch.Tensor) -> None:
    """Scatter (n, K, dh) rows into a (num_pages, page_size, K, dh) pool at
    flat token positions ``fpos``, in place."""
    n_pages, psize, Kh, dh = pool.shape
    pool.view(n_pages * psize, Kh, dh).index_put_((fpos.long(),), kv)


def _paged_decode(q, k, v, cache):
    """Paged slot-wise decode: scatter each row's new K/V to its own
    page/offset, then attend through the page table — in the CUDA kernel
    (``use_kernel``) or by gathering the rows' page runs and attending
    over them with ``dot_attention``'s recipe (the gather path, which is
    the kernel's plain version ``ref.paged_attention_ref`` on any
    device)."""
    if q.shape[1] != 1:
        raise NotImplementedError(
            "multi-token verify bursts come with speculative decoding "
            "(ROADMAP: spec/verify)")
    pages, idx = cache["pages"], cache["index"]
    ck, cv = cache["k"], cache["v"]
    psize = ck.shape[1]
    max_pages = pages.shape[1]
    logical_page = idx // psize
    ok = logical_page < max_pages
    dest = pages.gather(1, logical_page.clamp(max=max_pages - 1)
                        .long()[:, None])[:, 0]
    # out-of-range writes (a slot already at its page-run capacity) route
    # to the reserved junk page 0, never wrapped into the slot's last page
    fpos = torch.where(ok, dest * psize + idx % psize, idx % psize)
    _write_pool(ck, fpos, k[:, 0])
    _write_pool(cv, fpos, v[:, 0])
    attend = ops.paged_attention if cache.get("use_kernel") \
        else ref.paged_attention_ref
    return attend(q[:, 0].contiguous(), ck, cv, pages, idx + 1)[:, None]


def _paged_chunk(q, k, v, cache):
    """Chunked prefill straight into the page pool: the chunk's K/V land at
    their final page/offset through the slot's page-table row, then the
    chunk attends causally over the slot's first ``kv_bound`` positions
    read back through the same row.  Bucket-padding rows past the row's
    pages fall into the junk page 0."""
    off, bound = cache["offset"], cache["kv_bound"]
    pages_row = cache["pages_row"]
    ck, cv = cache["k"], cache["v"]
    psize, Kh, dh = ck.shape[1], ck.shape[2], ck.shape[3]
    max_pages = pages_row.shape[0]
    s = q.shape[1]
    pos = off + torch.arange(s, device=q.device)
    logical = pos // psize
    ok = logical < max_pages
    dest = pages_row[logical.clamp(max=max_pages - 1)]
    fpos = torch.where(ok, dest * psize + pos % psize, pos % psize)
    _write_pool(ck, fpos, k[0])
    _write_pool(cv, fpos, v[0])
    B = min(-(-bound // psize), max_pages)
    read = pages_row[:B].long()
    kg = ck[read].reshape(1, B * psize, Kh, dh)
    vg = cv[read].reshape(1, B * psize, Kh, dh)
    return dot_attention(q, kg, vg, causal=True, q_offset=off, kv_len=off + s)


def attention(p: dict, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              mode: str, cache: dict | None = None):
    """mode: 'prefill' (causal, returns the fresh K/V), 'decode' (paged
    slot-wise single token, in-place pool write), 'chunk' (chunked prefill
    into the page pool, in-place).  Returns (out, fresh_cache or None)."""
    q = torch.einsum("bse,ehd->bshd", x, p["wq"])
    k = torch.einsum("bte,ekd->btkd", x, p["wk"])
    v = torch.einsum("bte,ekd->btkd", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.pos == "rope":
        q = apply_rope(q, positions, fraction=cfg.rope_fraction,
                       theta=cfg.rope_theta)
        k = apply_rope(k, positions, fraction=cfg.rope_fraction,
                       theta=cfg.rope_theta)
    new_cache = None
    if mode == "decode":
        out = _paged_decode(q, k, v, cache)
    elif mode == "chunk":
        out = _paged_chunk(q, k, v, cache)
    elif mode == "prefill":
        out = dot_attention(q, k, v, causal=cfg.causal)
        new_cache = {"k": k, "v": v}
    else:
        raise ValueError(f"attention mode {mode!r}")
    y = torch.einsum("bshd,hde->bse", out, p["wo"])
    return y, new_cache


# ---------------------------------------------------------------------------
# MLP


def mlp_defs(cfg) -> dict:
    gated = cfg.activation in ("silu", "geglu")
    d = {"wi": ParamDef((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
         "wo": ParamDef((cfg.d_ff, cfg.d_model), ("mlp", "embed"))}
    if gated:
        d["wg"] = ParamDef((cfg.d_model, cfg.d_ff), ("embed", "mlp"))
    return d


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * 1 / (1 + exp(-x)), each step rounded to x's dtype — how XLA
    evaluates the reference's ``jax.nn.silu`` on bf16."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.activation != "silu":
        raise NotImplementedError(
            f"activation {cfg.activation!r} is not ported yet "
            f"(ROADMAP: other arch configs)")
    h = torch.einsum("bse,ef->bsf", x, p["wi"])
    h = silu(torch.einsum("bse,ef->bsf", x, p["wg"])) * h \
        if "wg" in p else silu(h)
    return torch.einsum("bsf,fe->bse", h, p["wo"])


# ---------------------------------------------------------------------------
# Embedding / unembedding


def embed_defs(cfg) -> dict:
    d = {"embedding": ParamDef((cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        d["unembed"] = ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return d


def embed(p: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.pos not in ("rope", "none"):
        raise NotImplementedError(
            f"position embedding {cfg.pos!r} is not ported yet "
            f"(ROADMAP: other arch configs)")
    flat = p["embedding"].index_select(0, tokens.reshape(-1).long())
    return flat.reshape(*tokens.shape, -1).to(cfg.activation_dtype)


def unembed(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("bse,ve->bsv", x, p["embedding"].to(x.dtype))
    return torch.einsum("bse,ev->bsv", x, p["unembed"])
