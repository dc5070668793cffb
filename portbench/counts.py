"""The yardstick's arithmetic: the chip's peaks, percentiles, and the
operations and bytes of the work a run did, from the configuration's
shapes.

The peaks are the published figures of one NVIDIA H100 SXM (dense
rates, without sparsity), as the program's own roofline module states
them; they are copied here so that no change to the program moves them.
"""

from __future__ import annotations

import math

import numpy as np

PEAK_BF16_FLOPS = 989e12      # FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12     # bytes/s

BF16 = 2                      # bytes


def percentile(values, q: float) -> float | None:
    """The q-th percentile by linear interpolation (numpy's default);
    None of an empty list."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def rate(count: float, seconds: float) -> float | None:
    return None if seconds <= 0 else count / seconds


def dims(m: dict) -> tuple[int, int, int, int, int, int, int]:
    """(layers, d_model, heads, kv_heads, head_dim, d_ff, vocab)."""
    dh = m.get("head_dim") or m["d_model"] // m["heads"]
    return (m["layers"], m["d_model"], m["heads"], m["kv_heads"], dh,
            m["d_ff"], m["vocab"])


def dense_flops_per_token(m: dict) -> float:
    """Model FLOPs of one token's products outside attention's scores:
    2 per multiply-add of each weight the token uses (the q, k, v and
    output projections, the MLP or its ``top_k`` experts and the router,
    the unembedding)."""
    L, d, H, K, dh, f, V = dims(m)
    attn = d * (H + 2 * K) * dh + H * dh * d
    if m.get("experts"):
        mlp = m["top_k"] * 3 * d * f + d * m["experts"]
    else:
        mlp = 3 * d * f
    return 2.0 * (L * (attn + mlp) + d * V)


def attention_flops(m: dict, context: float) -> float:
    """FLOPs of one token's scores and weighted sum over ``context``
    keys in every layer: 2 x 2 x heads x head_dim per key."""
    L, _, H, _, dh, _, _ = dims(m)
    return 4.0 * L * H * dh * context


def prefill_flops(m: dict, offset: int, n: int) -> float:
    """n prompt tokens at positions offset .. offset + n - 1, each over
    its causal prefix (the keys up to and including itself)."""
    keys = n * offset + n * (n + 1) / 2
    return n * dense_flops_per_token(m) + attention_flops(m, keys)


def decode_flops(m: dict, tokens: int, resident: int) -> float:
    """``tokens`` decoded tokens whose rows hold ``resident`` keys in
    all (each over its own row, the new key included)."""
    return tokens * dense_flops_per_token(m) + attention_flops(m, resident)


def k1_bytes(m: dict, slots: int, resident: int) -> float:
    """Bytes one paged-decode attention call must move: each resident
    key and value row of the live slots read once (bf16), each query
    read once and each output written once, and the page-table entries
    and lengths of those slots (int32)."""
    _, _, H, K, dh, _, _ = dims(m)
    return resident * 2 * K * dh * BF16 + slots * 2 * H * dh * BF16 \
        + 4 * (slots + math.ceil(resident / 16))


def k1_flops(m: dict, resident: int) -> float:
    _, _, H, _, dh, _, _ = dims(m)
    return 4.0 * H * dh * resident


def k1_bound_s(m: dict, slots: int, resident: int) -> float:
    """The least time one call could take on the card: the larger of its
    bytes at the memory rate and its FLOPs at the bf16 peak."""
    return max(k1_bytes(m, slots, resident) / HBM_BYTES_PER_S,
               k1_flops(m, resident) / PEAK_BF16_FLOPS)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total
