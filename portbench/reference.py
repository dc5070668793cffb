"""The plain reference of the benchmark's models, and their weights.

A decoder-only LM in float32 PyTorch: token embedding, pre-norm blocks
(RMSNorm or LayerNorm), rotary GQA attention, a gated SiLU MLP or a
token-choice top-k mixture of experts with a per-chunk capacity, a final
norm and an unembedding.  It imports nothing of the program under test:
the model is described by a configuration file's ``model`` mapping, and
the weights are drawn here from the seed.

``layout(model)`` lists every weight (path, shape, init); ``make_weights``
draws them all from one seeded generator in one call, in bfloat16, the
dtype they are served in.  The harness hands the same tensors to the
program; the reference draws them again for its own check, so it reads
nothing the program may have touched.

``forward`` runs one request's prompt and served tokens at once, causal,
and returns the logits at the positions asked for.  The mixture of
experts is computed group by group, a group being the tokens that shared
one step of the program: each prompt chunk, and each decoded token
alone.  Within a group, assignments past an expert's capacity are
dropped in token order.  ``quant="fp8"`` rounds every projection's
input rows and weight columns to float8 e4m3 with a scale each: the
lower-precision control.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0          # largest finite float8 e4m3fn
_F32_TINY = torch.finfo(torch.float32).tiny
_Q_CHUNK = 1024          # query rows per attention block


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["heads"]


def layout(m: dict) -> list[tuple[tuple[str, ...], tuple[int, ...], str, float]]:
    """(path, shape, init, scale) of every weight, in a fixed order.

    ``init`` is ``normal`` (scale times a standard normal: the inverse
    square root of the product's fan-in), ``ones`` or ``zeros``."""
    L, d, H, K = m["layers"], m["d_model"], m["heads"], m["kv_heads"]
    dh, f, V = head_dim(m), m["d_ff"], m["vocab"]
    out = [(("embed", "embedding"), (V, d), "normal", 1.0),
           (("embed", "unembed"), (d, V), "normal", d ** -0.5)]

    def norm(prefix, lead):
        out.append((prefix + ("scale",), lead + (d,), "ones", 1.0))
        if m["norm"] == "layernorm":
            out.append((prefix + ("bias",), lead + (d,), "zeros", 1.0))

    b = ("blocks",)
    norm(b + ("ln1",), (L,))
    out += [(b + ("attn", "wq"), (L, d, H, dh), "normal", d ** -0.5),
            (b + ("attn", "wk"), (L, d, K, dh), "normal", d ** -0.5),
            (b + ("attn", "wv"), (L, d, K, dh), "normal", d ** -0.5),
            (b + ("attn", "wo"), (L, H, dh, d), "normal", (H * dh) ** -0.5)]
    norm(b + ("ln2",), (L,))
    if m.get("experts"):
        E = m["experts"]
        out += [(b + ("mlp", "router"), (L, d, E), "normal", d ** -0.5),
                (b + ("mlp", "wg"), (L, E, d, f), "normal", d ** -0.5),
                (b + ("mlp", "wi"), (L, E, d, f), "normal", d ** -0.5),
                (b + ("mlp", "wo"), (L, E, f, d), "normal", f ** -0.5)]
    else:
        out += [(b + ("mlp", "wg"), (L, d, f), "normal", d ** -0.5),
                (b + ("mlp", "wi"), (L, d, f), "normal", d ** -0.5),
                (b + ("mlp", "wo"), (L, f, d), "normal", f ** -0.5)]
    norm(("ln_f",), ())
    return out


def make_weights(m: dict, seed: int, device) -> dict:
    """Every weight of ``layout(m)`` as views of one bfloat16 buffer drawn
    by one ``torch.randn`` call from a generator seeded with ``seed`` on
    ``device``: the same seed gives the same bits."""
    lay = layout(m)
    total = sum(math.prod(shape) for _, shape, _, _ in lay)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, dtype=torch.bfloat16,
                       device=device)
    tree: dict = {}
    at = 0
    for path, shape, init, scale in lay:
        n = math.prod(shape)
        w = flat[at:at + n].view(shape)
        at += n
        if init == "ones":
            w.fill_(1.0)
        elif init == "zeros":
            w.zero_()
        elif scale != 1.0:
            w.mul_(scale)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = w
    return tree


def leaves(tree, path=()) -> list[tuple[tuple[str, ...], torch.Tensor]]:
    """(path, tensor) pairs of a tree of dicts, in sorted-key order."""
    if not isinstance(tree, dict):
        return [(path, tree)]
    return [item for k in sorted(tree) for item in leaves(tree[k], path + (k,))]


# ---------------------------------------------------------------------------
# the forward pass


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (its largest magnitude maps to 448), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Mat:
    """Projections in float32, or through the fp8 control."""

    def __init__(self, quant: str | None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}")
        self.quant = quant

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., k) times w (k, n), both float32."""
        if self.quant == "fp8":
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w


def _norm(x, p, m, i=None):
    scale = p["scale"] if i is None else p["scale"][i]
    if m["norm"] == "rmsnorm":
        y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + m["norm_eps"])
        return y * scale.float()
    bias = p["bias"] if i is None else p["bias"][i]
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + m["norm_eps"]) * scale.float() \
        + bias.float()


def _rope(x: torch.Tensor, m: dict) -> torch.Tensor:
    """Rotary embedding of x (s, heads, dh) at positions 0..s-1: the
    first ``rope_fraction`` of each head's dims, rotated in adjacent
    pairs."""
    s, _, dh = x.shape
    rot = int(dh * m["rope_fraction"])
    rot -= rot % 2
    if rot == 0:
        return x
    freqs = torch.exp(-torch.arange(0, rot, 2, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(m["rope_theta"]) / rot))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                      dim=-1).reshape(s, -1, rot)
    return torch.cat([out, x[..., rot:]], dim=-1)


def _attention(h, p, i, m, mat):
    s = h.shape[0]
    H, K, dh = m["heads"], m["kv_heads"], head_dim(m)
    d = m["d_model"]
    q = mat(h, p["wq"][i].float().reshape(d, H * dh)).reshape(s, H, dh)
    k = mat(h, p["wk"][i].float().reshape(d, K * dh)).reshape(s, K, dh)
    v = mat(h, p["wv"][i].float().reshape(d, K * dh)).reshape(s, K, dh)
    q, k = _rope(q, m), _rope(k, m)
    G = H // K
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    out = torch.empty_like(q)
    pos = torch.arange(s, device=h.device)
    for a in range(0, s, _Q_CHUNK):
        b = min(a + _Q_CHUNK, s)
        sc = torch.einsum("qhd,thd->hqt", q[a:b], k[:b]) / math.sqrt(dh)
        sc = sc.masked_fill(pos[None, a:b, None] < pos[None, None, :b],
                            float("-inf"))
        out[a:b] = torch.einsum("hqt,thd->qhd", torch.softmax(sc, -1), v[:b])
    return mat(out.reshape(s, H * dh), p["wo"][i].float().reshape(H * dh, d))


def _mlp(h, p, i, mat):
    g = mat(h, p["wg"][i].float())
    u = mat(h, p["wi"][i].float())
    return mat(torch.nn.functional.silu(g) * u, p["wo"][i].float())


def expert_capacity(m: dict, S: int) -> int:
    """Assignments an expert takes from a group padded to S tokens: the
    capacity factor's share, at least 1, rounded up to a multiple of 8."""
    c = max(int(m["capacity_factor"] * m["top_k"] * S / m["experts"]), 1)
    return -(-c // 8) * 8


def route(logits: torch.Tensor, m: dict, capacity: int | None):
    """Top-k routing of one group's router logits (n, E): (experts (n, k),
    gates (n, k) renormalized over the k, keep (n, k)).  Ties rank the
    lower expert first; probabilities below float32's smallest normal
    count as zero; an expert takes assignments in token order, then rank
    order, up to ``capacity`` (None: all of them)."""
    k, E = m["top_k"], m["experts"]
    probs = torch.softmax(logits, -1)
    probs = probs.masked_fill(probs < _F32_TINY, 0.0)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = ranked[:, :k], order[:, :k]
    total = gates[:, 0]
    for j in range(1, k):
        total = total + gates[:, j]
    gates = gates / total.clamp_min(1e-9)[:, None]
    if capacity is None:
        return experts, gates, torch.ones_like(experts, dtype=torch.bool)
    onehot = torch.nn.functional.one_hot(experts.reshape(-1), E)
    rank_in_e = (onehot.cumsum(0) - onehot).gather(
        1, experts.reshape(-1, 1))[:, 0]
    keep = (rank_in_e < capacity).reshape(experts.shape)
    return experts, gates, keep


def _moe(h, p, i, m, groups, mat):
    """The experts' output for every row of h (s, d), routed group by
    group ``(start, stop, capacity)`` (the groups tile the rows)."""
    logits = mat(h, p["router"][i].float())
    routed = [route(logits[a:b], m, capacity) for a, b, capacity in groups]
    experts, gates, keep = (torch.cat(t) for t in zip(*routed))
    w = gates * keep
    y = torch.zeros_like(h)
    for e in range(m["experts"]):
        rows, slot = torch.nonzero((experts == e) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        g = mat(x, p["wg"][i, e].float())
        u = mat(x, p["wi"][i, e].float())
        out = mat(torch.nn.functional.silu(g) * u, p["wo"][i, e].float())
        y.index_add_(0, rows, out * w[rows, slot][:, None])
    return y


def step_groups(m: dict, prompt_len: int, total: int,
                chunks: list[tuple[int, int, int]]):
    """The routing groups of a request of ``total`` tokens whose prompt
    of ``prompt_len`` went through the program in ``chunks`` (offset,
    tokens, padded size): each chunk with the capacity of its padded
    size, then the decoded tokens, each alone in its step (an expert
    takes at most one assignment from one token, so no capacity binds
    and they route as one group)."""
    if not m.get("experts"):
        return []
    groups = [(off, off + n, expert_capacity(m, S)) for off, n, S in chunks]
    if sum(n for _, n, _ in chunks) != prompt_len or any(
            a != b for (a, _, _), (_, b, _) in zip(groups[1:], groups)):
        raise ValueError(f"chunks {chunks} do not tile a prompt of "
                         f"{prompt_len}")
    if total > prompt_len:
        groups.append((prompt_len, total, None))
    return groups


def forward(weights: dict, m: dict, tokens: torch.Tensor, groups,
            at: torch.Tensor, quant: str | None = None) -> torch.Tensor:
    """Float32 logits (len(at), vocab) at positions ``at`` of the causal
    forward over ``tokens`` (s,).  ``groups`` is the list of (start,
    stop, capacity) of the steps the tokens shared, for the mixture of
    experts (ignored by a dense model); see ``step_groups``."""
    mat = _Mat(quant)
    blocks = weights["blocks"]
    x = weights["embed"]["embedding"][tokens.long()].float()
    for i in range(m["layers"]):
        x = x + _attention(_norm(x, blocks["ln1"], m, i), blocks["attn"], i,
                           m, mat)
        h = _norm(x, blocks["ln2"], m, i)
        x = x + (_moe(h, blocks["mlp"], i, m, groups, mat)
                 if m.get("experts") else _mlp(h, blocks["mlp"], i, mat))
    h = _norm(x[at], weights["ln_f"], m)
    return mat(h, weights["embed"]["unembed"].float())


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's logit lies below the row's best (>= 0)."""
    best = ref_logits.amax(-1)
    return best - ref_logits.gather(1, tokens.long()[:, None])[:, 0]
