"""The split-KV recipe of the paged-decode kernel, emulated in plain
PyTorch, against the JAX reference on the CPU.

``csrc/paged_attention.cu`` cuts each (slot, kv head) pair into splits of
whole live pages.  Each split computes its scores and a local max; every
split then takes the global max m as the max of the local maxima, sums
the denominator l over all the pair's scores in one fixed order, rounds
``bf16(exp(s - m) / l)`` for its own tokens and writes an f32 P.V
partial; the partials are summed in split order.  The CUDA kernel runs
only on the card, so its arithmetic is proven here: the emulation below
follows that recipe step for step and is held against the reference's
``repro.kernels.ref.paged_attention_ref`` and the port's plain version
on numpy inputs from a seed, within the bound that two bf16 roundings
(of each probability and of the output) allow.  Emulations with one
split's partial left out, or a split boundary one token off, must break
that bound: the gate ``chip_smoke.py`` holds the kernel to on the card
is then strong enough to see such faults.
"""

import math

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_jax
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import num_splits
from repro_torch.models.params import params_from_jax

BF16 = ml_dtypes.bfloat16
SMS = 132                      # an H100's SM count, as the wrapper reads it


def tt(a):
    return params_from_jax(np.asarray(a))


def make_case(seed, lens, page_size, max_pages, K, G, dh, poison=1e4):
    """Random bf16 pool, shuffled page tables holding ``lens`` tokens per
    slot (0 = freed: zeroed row), the junk page 0 filled with ``poison``."""
    rng = np.random.default_rng(seed)
    held = [min(-(-n // page_size), max_pages) if n else 0 for n in lens]
    num_pages = sum(held) + 1
    order = rng.permutation(np.arange(1, num_pages, dtype=np.int32))
    table = np.zeros((len(lens), max_pages), np.int32)
    i = 0
    for s, h in enumerate(held):
        table[s, :h] = order[i:i + h]
        i += h
    q = rng.standard_normal((len(lens), K * G, dh)).astype(BF16)
    kp = rng.standard_normal((num_pages, page_size, K, dh)).astype(BF16)
    vp = rng.standard_normal((num_pages, page_size, K, dh)).astype(BF16)
    kp[0] = poison
    vp[0] = poison
    return q, kp, vp, table, np.asarray(lens, np.int32)


def emulate_split(q, kp, vp, table, kv_len, nsplit, *, drop=None, shift=0):
    """The kernel's split recipe in plain PyTorch (torch tensors in, bf16
    out).  ``drop``: a split whose partial the combine leaves out;
    ``shift``: tokens added to the end of every split but the last, so
    that neighbouring splits overlap (> 0) or leave a gap (< 0) (both are
    faults, for the gate's sake)."""
    slots, H, dh = q.shape
    _, ps, K, _ = kp.shape
    G, mp = H // K, table.shape[1]
    out = torch.zeros((slots, K, G, dh))
    for s in range(slots):
        n = max(0, min(int(kv_len[s]), mp * ps))
        P = -(-n // ps)
        cuts = [min(i * P // nsplit * ps, n) for i in range(nsplit)] + [n]
        ends = [min(max(c + shift, 0), n) for c in cuts[1:-1]] + [n]
        pos = torch.arange(n)
        page = table[s, pos // ps].long()
        live = page != 0
        k = kp[page, pos % ps].float()                     # (n, K, dh)
        v = vp[page, pos % ps].float()
        qg = q[s].reshape(K, G, dh).float()
        sc = torch.einsum("kgd,nkd->kgn", qg, k) * (1.0 / math.sqrt(dh))
        sc = torch.where(live, sc, torch.full_like(sc, -math.inf))
        # (a) local maxima; (b) the global m, one fixed-order l
        m = torch.full((K, G), -math.inf)
        for i in range(nsplit):
            if ends[i] > cuts[i]:
                m = torch.maximum(m, sc[..., cuts[i]:ends[i]].amax(-1))
        e = torch.where(live, torch.exp(sc - m[..., None]), torch.zeros(()))
        l = e.sum(-1, keepdim=True)
        p = torch.where(live, (e / l).to(torch.bfloat16).float(),
                        torch.zeros(()))
        # (b) f32 partials, (c) summed in split order
        acc = torch.zeros((K, G, dh))
        for i in range(nsplit):
            a, b = cuts[i], ends[i]
            if i == drop or b <= a:
                continue
            acc = acc + torch.einsum("kgn,nkd->kgd", p[..., a:b], v[a:b])
        out[s] = acc
    return out.reshape(slots, H, dh).to(torch.bfloat16)


def rounding_ratio(got, want, spread):
    """max |got - want| / (2^-7 (spread (1 + 2^-7) + |want|) + 1e-6): at
    most 1 where the two differ only by a bf16 rounding of each
    probability and of the output (``chip_smoke._rounding_diff``)."""
    g, w = got.float(), want.float()
    bound = 2.0 ** -7 * (spread.float() * (1 + 2.0 ** -7) + w.abs()) + 1e-6
    return float(((g - w).abs() / bound).max())


def hold(case, got):
    """The ratio of ``got`` to the reference's and to the port's plain
    version's outputs on ``case``; both must be at most 1."""
    q, kp, vp, table, kv_len = case
    want_jax = torch.from_numpy(np.asarray(
        ref_jax.paged_attention_ref(q, kp, vp, table, kv_len), np.float32))
    args = [tt(a) for a in case]
    want = ref.paged_attention_ref(*args)
    spread = ref.paged_attention_ref(args[0], args[1], args[2].abs(),
                                     *args[3:])
    return (rounding_ratio(got, want_jax, spread),
            rounding_ratio(got, want, spread))


# (page_size, max_pages, K, G, dh, lens): tests/test_torch_kernels.py's
# shapes in bf16, then a small main-path-like one (8 slots, lengths
# inside the first page, on and one past page and split boundaries, a
# freed slot) at G 1 and 4, and one long slot
SHAPES = [
    (8, 4, 2, 2, 32, [32, 17, 8, 1]),
    (4, 4, 1, 4, 32, [16, 3, 0, 9]),
    (16, 2, 4, 1, 16, [32, 31, 30, 5]),
    (8, 8, 2, 4, 64, [64, 1, 40, 0, 23]),
    (4, 8, 2, 1, 32, [3, 4, 5, 16, 17, 0, 31, 32]),
    (4, 8, 2, 4, 32, [3, 4, 5, 16, 17, 0, 31, 32]),
    (8, 32, 2, 1, 32, [256]),
]


@pytest.mark.parametrize("psize,mp,K,G,dh,lens", SHAPES)
@pytest.mark.parametrize("nsplit", [1, 2, 3, "card"])
def test_split_recipe_matches_reference(psize, mp, K, G, dh, lens, nsplit):
    if nsplit == "card":
        nsplit = num_splits(len(lens) * K, mp, SMS)
    case = make_case(11, lens, psize, mp, K, G, dh)
    got = emulate_split(*(tt(a) for a in case), nsplit)
    r_jax, r_plain = hold(case, got)
    assert r_jax <= 1 and r_plain <= 1, (r_jax, r_plain)
    freed = [i for i, n in enumerate(lens) if n == 0]
    assert bool((got[freed] == 0).all())


def test_split_recipe_freed_row_stale_length_and_junk_blind():
    """A slot whose row was zeroed with its length left gives exact zeros;
    the junk page's contents never reach an output."""
    outs = []
    for poison in (0.0, 1e4):
        q, kp, vp, table, kv_len = make_case(5, [9, 13, 20], 4, 8, 2, 4, 32,
                                             poison=poison)
        table = table.copy()
        table[1] = 0
        outs.append(emulate_split(tt(q), tt(kp), tt(vp), tt(table),
                                  tt(kv_len), 3))
    assert bool((outs[1][1] == 0).all())
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("fault", ["drop", "shift+1", "shift-1"])
def test_gate_rejects_faulty_split_recipes(fault):
    """One split's partial left out, or every split but the last ending one
    token late (overlap) or early (gap), break the two-rounding bound on the main-path-like
    shape; the sound recipe holds it on the same inputs."""
    case = make_case(13, [3, 4, 5, 16, 17, 0, 31, 32], 4, 8, 2, 1, 32)
    args = [tt(a) for a in case]
    kw = {"drop": 1} if fault == "drop" else \
        {"shift": 1 if fault == "shift+1" else -1}
    assert max(hold(case, emulate_split(*args, 3))) <= 1
    assert min(hold(case, emulate_split(*args, 3, **kw))) > 1


def test_num_splits_fills_the_card():
    """About four blocks per SM at 8 slots and at 1, never more splits than
    pages in the row."""
    assert num_splits(8 * 32, 32, SMS) == 3
    assert num_splits(1 * 32, 256, SMS) == 17
    assert num_splits(1 * 32, 4, SMS) == 4
    assert num_splits(10_000, 8, SMS) == 1
