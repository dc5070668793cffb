"""Per-request sampling for the slot-wise decode loop (port of
``repro/serving/sampling.py``).

Each draw is keyed by ``fold_in(fold_in(PRNGKey(seed), rid), step)``,
``step`` being how many tokens the request has generated so far, so a
request draws the same stream whatever its slot, its admission order or
its preemptions, and a speculative verify burst re-draws the sequential
stream position by position.

The reference draws with JAX's threefry2x32 generator; this module
computes the same bits with exact integer operations on int64 tensors
masked to 32 bits, on the logits' device:

* ``PRNGKey(seed)`` is the key ``(0, seed)`` (a 32-bit seed);
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
* the random bits of a draw over a vocabulary of V are
  ``x0 ^ x1`` of ``threefry2x32(key, (0, i))`` for i in [0, V): the
  counter layout of JAX with ``jax_threefry_partitionable`` on, its
  default since JAX 0.5 (with the flag off the bits differ);
* a uniform in [tiny, 1) is ``bits >> 9 | 0x3F800000`` read as a float,
  less one, times (1 - tiny), plus tiny, at least tiny; Gumbel noise is
  ``-log(-log(u))`` and a categorical draw is ``argmax(gumbel + logits)``.

The row math mirrors the reference: logits in f32; greedy is
``argmax`` (the first maximum); top-k masks logits below the k-th
largest (k capped at ``effective_top_k``); top-p keeps the smallest
probability-sorted set whose mass reaches p (every token whose
probability mass above it is below p, ties at the cut kept), applied
only for 0 < p < 1; the draw divides by ``max(temperature, 1e-6)``; a
row with temperature 0 or ``top_k == 1`` takes the argmax.
"""

from __future__ import annotations

import torch

K_CAP = 64

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = torch.finfo(torch.float32).tiny


def effective_top_k(top_k: int, vocab_size: int, k_cap: int = K_CAP) -> int:
    """The k the sampler actually applies for a request's ``top_k``:
    0 (filter off) or min(top_k, K_CAP, vocab)."""
    if top_k <= 0:
        return 0
    return min(top_k, k_cap, vocab_size)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counters (x0, x1) under
    the key (k0, k1), elementwise over broadcast int64 tensors holding
    values in [0, 2^32)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _MASK
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & _MASK
    return x0, x1


def fold_in(key: tuple, data: torch.Tensor) -> tuple:
    """``jax.random.fold_in`` for a batch of keys and 32-bit data."""
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def gumbel(key: tuple, n: int) -> torch.Tensor:
    """(rows, n) f32 Gumbel noise of ``jax.random.gumbel(key, (n,))`` per
    row, for keys given as two (rows,) tensors."""
    counter = torch.arange(n, dtype=torch.int64, device=key[0].device)
    b0, b1 = threefry2x32(key[0][:, None], key[1][:, None],
                          torch.zeros_like(counter), counter)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.tensor(TINY, dtype=torch.float32, device=floats.device)
    u = torch.maximum(tiny, floats * (1.0 - tiny) + tiny)
    return -torch.log(-torch.log(u))


def make_sampler(seed: int, k_cap: int = K_CAP):
    """(logits, temperature, top_k, top_p, rids, steps) -> (rows,) int32.

    logits: (rows, vocab); temperature/top_p f32 (rows,); top_k/rids/steps
    int (rows,), all on the logits' device.  Serves the full pool, the
    single-row first-token draw and the flattened speculative verify batch
    alike."""
    if not 0 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} must fit 32 bits")

    @torch.no_grad()
    def sample(logits, temperature, top_k, top_p, rids, steps):
        lg = logits.float()
        rows, vocab = lg.shape
        dev = lg.device
        greedy = lg.argmax(dim=-1).to(torch.int32)
        zero = torch.zeros((rows,), dtype=torch.int64, device=dev)
        key = fold_in((zero, zero + seed), rids.to(torch.int64) & _MASK)
        key = fold_in(key, steps.to(torch.int64) & _MASK)
        cap = min(k_cap, vocab)
        kk = top_k.to(torch.int64).clamp(0, cap)
        vals = torch.topk(lg, cap, dim=-1).values
        kth = vals.gather(1, (kk - 1).clamp_min(0)[:, None])
        neg_inf = torch.full_like(lg, float("-inf"))
        masked = torch.where((kk[:, None] > 0) & (lg < kth), neg_inf, lg)
        # nucleus on the k-filtered logits (probabilities as jax.nn.softmax)
        e = torch.exp(masked - masked.amax(dim=-1, keepdim=True))
        probs = e / e.sum(dim=-1, keepdim=True)
        sp = probs.sort(dim=-1, descending=True).values
        prior = sp.cumsum(dim=-1) - sp        # mass strictly above each
        p = top_p.float()[:, None]
        cut = torch.where(prior < p, sp, torch.full_like(sp, float("inf"))
                          ).amin(dim=-1, keepdim=True)
        nucleus = torch.where(probs >= cut, masked, neg_inf)
        masked = torch.where((p > 0) & (p < 1), nucleus, masked)
        temp = temperature.float()[:, None]
        scaled = masked / torch.clamp_min(temp, 1e-6)
        drawn = (gumbel(key, vocab) + scaled).argmax(dim=-1).to(torch.int32)
        return torch.where((temperature > 0) & (kk != 1), drawn, greedy)

    return sample
