"""Shapes the port's kernels take beyond their first slices, on the CPU
against the JAX reference: the paged-decode kernel (K1) at G > 8 query
heads per kv head, flash attention (K3) at head dims 16, 112 and 192, and
LULESH states that default to the card.

K1 takes any H % K == 0, as the reference's kernel asserts, and reads a
range of the pool's kv heads in place (a rank of a mesh whose model
axis the kv heads do not divide keeps them all): a block holds
at most 8 query heads (``paged_attention.head_chunk``), so G = 12 runs as
three chunks of 4 over the same kv head, and G = 11 as 4, 4 and a short
chunk of 3.  K3 takes any dh % 8 == 0 up to
256.  Here the plain versions are held against the reference's Pallas
kernels in interpret mode (their CPU form) at those shapes, with the
reference's own tolerances (2e-5 f32, 2e-2 bf16), and the shape
predicates are checked; the kernels themselves run on the card (cases
marked ``cuda``, skipped here; ``chip_smoke.py`` holds them there).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref
from repro_torch.models import lulesh
from repro_torch.models.params import params_from_jax

BF16 = ml_dtypes.bfloat16


def tt(a):
    """numpy (bf16 via ml_dtypes included) -> torch, bit for bit."""
    return params_from_jax(np.asarray(a))


def tol(dtype):
    return 2e-2 if dtype == BF16 else 2e-5


def paged_case(seed, lens, page_size, max_pages, K, G, dh, dtype,
               poison=1e4):
    """A random page pool, shuffled page tables holding ``lens`` tokens per
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
    q = rng.standard_normal((len(lens), K * G, dh)).astype(dtype)
    kp = rng.standard_normal((num_pages, page_size, K, dh)).astype(dtype)
    vp = rng.standard_normal((num_pages, page_size, K, dh)).astype(dtype)
    kp[0] = poison
    vp[0] = poison
    return q, kp, vp, table, np.asarray(lens, np.int32)


# (K, G, dh, dtype): mistral-large / nemotron-4's G = 12 (96 heads over 8)
# and G = 16, at small widths
LARGE_G = [(2, 12, 32, np.float32), (1, 16, 16, BF16), (2, 12, 64, BF16)]


@pytest.mark.parametrize("K,G,dh,dtype", LARGE_G)
def test_plain_paged_attention_matches_pallas_at_large_G(K, G, dh, dtype):
    q, kp, vp, table, kv_len = paged_case(G, [19, 0, 8, 32], 8, 4, K, G, dh,
                                          dtype)
    got = ref.paged_attention_ref(tt(q), tt(kp), tt(vp), tt(table),
                                  tt(kv_len)).float().numpy()
    want = np.asarray(paged_attention_pallas(q, kp, vp, table, kv_len,
                                             interpret=True), np.float32)
    np.testing.assert_allclose(got, want, rtol=tol(dtype), atol=tol(dtype))


@pytest.mark.parametrize("G", [11, 12, 16])
def test_head_chunks_are_gqa_problems_of_their_own(G):
    """What the kernel does at G > 8: each chunk of ``head_chunk(G)`` query
    heads attends its kv head alone, and q and the output keep their
    (slots, H, dh) layout.  A short last chunk (G = 11) runs with zero q
    vectors in place of its missing heads, whose outputs are dropped.
    The plain version on each chunk's heads gives that chunk's slice of
    the whole output."""
    K, dh, gc = 2, 32, pa.head_chunk(G)
    q, kp, vp, table, kv_len = (tt(a) for a in paged_case(
        3, [21, 7, 32], 8, 4, K, G, dh, np.float32))
    whole = ref.paged_attention_ref(q, kp, vp, table, kv_len).reshape(
        3, K, G, dh)
    q = q.reshape(3, K, G, dh)
    for c in range(pa.head_chunks(G)):
        h0, h1 = c * gc, min(G, (c + 1) * gc)
        qc = torch.zeros((3, K, gc, dh), dtype=q.dtype)
        qc[:, :, :h1 - h0] = q[:, :, h0:h1]
        part = ref.paged_attention_ref(qc.reshape(3, K * gc, dh), kp, vp,
                                       table, kv_len)
        torch.testing.assert_close(
            part.reshape(3, K, gc, dh)[:, :, :h1 - h0],
            whole[:, :, h0:h1], rtol=1e-6, atol=1e-6)


# (Kp, kv0, K, G, dh, dtype): a rank of a mesh whose model axis the pool's
# Kp kv heads do not divide reads the K heads from kv0 its query heads
# use: nemotron-4-340b's and mistral-large-123b's 6 of 96 query heads on
# one of 8 kv heads (16 model ranks), dbrx-132b's 3 of 48, the smoke
# granite's 1 of 4 on one of 2, and two heads of eight from head 3
KV_RANGES = [(8, 5, 1, 6, 32, BF16), (8, 0, 1, 3, 16, np.float32),
             (2, 1, 1, 1, 16, BF16), (8, 3, 2, 4, 32, BF16)]


@pytest.mark.parametrize("Kp,kv0,K,G,dh,dtype", KV_RANGES)
def test_plain_paged_attention_reads_a_kv_head_range(Kp, kv0, K, G, dh,
                                                     dtype):
    """The plain version reading kv heads [kv0, kv0 + K) of a pool of Kp
    in place, against the reference's Pallas kernel (interpret mode) on
    a pool of those heads alone, with the reference's tolerances."""
    q, kp, vp, table, kv_len = paged_case(Kp + G, [19, 0, 8, 32], 8, 4, Kp,
                                          G, dh, dtype)
    q = q[:, :K * G]
    got = ref.paged_attention_ref(tt(q), tt(kp), tt(vp), tt(table),
                                  tt(kv_len), kv0, K).float().numpy()
    heads = slice(kv0, kv0 + K)
    want = np.asarray(paged_attention_pallas(
        q, np.ascontiguousarray(kp[:, :, heads]),
        np.ascontiguousarray(vp[:, :, heads]), table, kv_len,
        interpret=True), np.float32)
    np.testing.assert_allclose(got, want, rtol=tol(dtype), atol=tol(dtype))
    # the same as the plain version on the copied heads, bit for bit
    whole = ref.paged_attention_ref(
        tt(q), tt(np.ascontiguousarray(kp[:, :, heads])),
        tt(np.ascontiguousarray(vp[:, :, heads])), tt(table),
        tt(kv_len)).float().numpy()
    np.testing.assert_array_equal(got, whole)


def test_paged_kernel_takes_any_gqa_grouping():
    for shape in [(96, 8, 128), (96, 8, 192), (32, 32, 128), (32, 1, 64),
                  (8, 8, 8), (4, 1, 256)]:
        assert pa.kernel_takes(*shape), shape
    for shape in [(96, 7, 128), (32, 32, 132), (8, 8, 264), (8, 0, 64)]:
        assert not pa.kernel_takes(*shape), shape
    for G in range(1, 41):
        gc, n = pa.head_chunk(G), pa.head_chunks(G)
        # every head in a chunk, no chunk empty, one chunk up to MAX_G
        assert 1 <= gc <= pa.MAX_G and (n - 1) * gc < G <= n * gc
        assert (gc, n) == (G, 1) or (G > pa.MAX_G and n == -(-G // 4))
    assert [pa.head_chunk(G) for G in (11, 12, 16)] == [4, 4, 4]


# (b, s, t, H, K, dh, causal, dtype): the smoke configs' head dim 16,
# zamba2-7b's 112 and nemotron-4-340b's 192, at small sizes
HEAD_DIMS = [
    (1, 64, 64, 4, 2, 16, True, np.float32),
    (1, 128, 128, 2, 1, 16, False, BF16),
    (1, 64, 64, 2, 2, 112, True, np.float32),
    (1, 128, 128, 4, 2, 112, True, BF16),
    (1, 64, 64, 2, 1, 192, True, np.float32),
    (1, 128, 128, 2, 2, 192, False, BF16),
]


@pytest.mark.parametrize("b,s,t,H,K,dh,causal,dtype", HEAD_DIMS)
def test_plain_flash_matches_pallas_at_head_dims(b, s, t, H, K, dh, causal,
                                                 dtype):
    rng = np.random.RandomState(dh + s)
    q, k, v = (rng.standard_normal(shape).astype(dtype)
               for shape in ((b, s, H, dh), (b, t, K, dh), (b, t, K, dh)))
    for kv_len in (None, t // 4):
        got = ref.flash_attention_ref(tt(q), tt(k), tt(v), causal=causal,
                                      kv_len=kv_len)
        want = flash_attention_pallas(q, k, v, causal=causal, block_q=64,
                                      block_k=64, kv_len=kv_len,
                                      interpret=True)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol(dtype), atol=tol(dtype))


def test_flash_kernel_takes_every_head_dim_of_the_configs():
    for H, K, dh in [(96, 8, 192), (32, 32, 112), (4, 2, 16), (32, 32, 128),
                     (16, 16, 64), (8, 8, 32), (8, 1, 8), (2, 2, 256),
                     (4, 4, 40)]:
        assert fa.kernel_takes(H, K, dh), (H, K, dh)
    for H, K, dh in [(4, 4, 12), (4, 4, 264), (6, 4, 64), (4, 0, 64)]:
        assert not fa.kernel_takes(H, K, dh), (H, K, dh)


def test_lulesh_states_default_to_the_card(monkeypatch):
    """``device=None`` means the card, and raises where there is none; the
    CPU is taken only when named."""
    cfg = lulesh.LuleshConfig(grid=4)
    arrays = lulesh.state_to_numpy(lulesh.init_state(cfg, "cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lulesh.init_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        lulesh.state_from_numpy(arrays)
    back = lulesh.state_from_numpy(arrays, "cpu")
    assert all(back[k].device.type == "cpu" for k in back)


# ---------------------------------------------------------------------------
# on the card (skipped without CUDA)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("K,G,dh", [(8, 12, 128), (8, 12, 192), (2, 16, 64),
                                    (1, 10, 32), (2, 11, 64)])
def test_cuda_paged_attention_at_large_G_matches_plain(cuda, K, G, dh):
    """Within two bf16 roundings (of each probability and of the output) of
    the plain version, element by element; two calls bitwise equal; freed
    slots exact zeros."""
    case = [tt(a).to(cuda) for a in paged_case(G, [300, 5, 0, 17, 129, 64],
                                               16, 32, K, G, dh, BF16)]
    got = pa.paged_attention_cuda(*case)
    want = ref.paged_attention_ref(*case).float()
    spread = ref.paged_attention_ref(case[0], case[1], case[2].abs(),
                                     *case[3:]).float()
    bound = 2.0 ** -7 * (spread * (1 + 2.0 ** -7) + want.abs()) + 1e-6
    assert bool(((got.float() - want).abs() <= bound).all())
    assert torch.equal(got, pa.paged_attention_cuda(*case))
    assert not bool(got[2].ne(0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("Kp,kv0,K,G,dh,dtype", KV_RANGES)
def test_cuda_paged_attention_reads_a_kv_head_range(cuda, Kp, kv0, K, G, dh,
                                                    dtype):
    """The kernel reading kv heads [kv0, kv0 + K) of the pool in place
    within two bf16 roundings of the plain version, two calls bitwise
    equal."""
    q, kp, vp, table, kv_len = [tt(a).to(cuda) for a in paged_case(
        Kp + G, [300, 5, 0, 17], 16, 32, Kp, G, dh, BF16)]
    case = (q[:, :K * G].contiguous(), kp, vp, table, kv_len, kv0, K)
    got = pa.paged_attention_cuda(*case)
    want = ref.paged_attention_ref(*case).float()
    spread = ref.paged_attention_ref(case[0], kp, vp.abs(),
                                     *case[3:]).float()
    bound = 2.0 ** -7 * (spread * (1 + 2.0 ** -7) + want.abs()) + 1e-6
    assert bool(((got.float() - want).abs() <= bound).all())
    assert torch.equal(got, pa.paged_attention_cuda(*case))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [8, 16, 40, 112, 192, 200, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_at_head_dims_matches_plain(cuda, dh, dtype):
    """f32 within the reference's 2e-5; bf16 (the tensor cores) within one
    bf16 step of each value; kv_len t / 4 and 0 too."""
    gen = torch.Generator(device=cuda).manual_seed(dh)
    b, s, t, H, K = 1, 200, 200, 4, 2
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, s, H, dh), (b, t, K, dh), (b, t, K, dh)))
    for kv_len in (None, t // 4, 0):
        got = fa.flash_attention_cuda(q, k, v, causal=True, kv_len=kv_len)
        want = ref.flash_attention_ref(q, k, v, causal=True,
                                       kv_len=kv_len).float()
        err = (got.float() - want).abs()
        if dtype == torch.float32:
            assert bool((err <= 2e-5 + 2e-5 * want.abs()).all())
        else:
            assert bool((err <= 1e-4 + 2.0 ** -7 * want.abs()).all())
