"""The port's kernels (``repro_torch.kernels``) against the JAX reference.

On the CPU the port runs each kernel's plain PyTorch version, so these
tests hold the plain versions against the reference's Pallas kernels
(interpret mode) and its gather path, over a reduced
``test_kernels_paged.py`` sweep with a poisoned junk page.  The CUDA
kernels themselves run only on the card: their cases are marked ``cuda``
and skip here; ``chip_smoke.py`` holds them against the plain versions
on the card.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.models.layers import dot_attention as ref_dot_attention
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.models.params import params_from_jax

BF16 = ml_dtypes.bfloat16


def tt(a):
    """numpy (bf16 via ml_dtypes included) -> torch, bit for bit."""
    return params_from_jax(np.asarray(a))


def make_case(seed, lens, page_size, max_pages, K, G, dh, dtype, poison=0.0):
    """A random page pool + shuffled page tables holding `lens` tokens per
    slot (0 = freed slot: zeroed row); `poison` fills the junk page 0."""
    rng = np.random.default_rng(seed)
    slots = len(lens)
    held = [min(-(-n // page_size), max_pages) if n else 0 for n in lens]
    num_pages = sum(held) + 1
    order = rng.permutation(np.arange(1, num_pages, dtype=np.int32))
    table = np.zeros((slots, max_pages), np.int32)
    i = 0
    for s, h in enumerate(held):
        table[s, :h] = order[i:i + h]
        i += h
    q = rng.standard_normal((slots, K * G, dh)).astype(dtype)
    kp = rng.standard_normal((num_pages, page_size, K, dh)).astype(dtype)
    vp = rng.standard_normal((num_pages, page_size, K, dh)).astype(dtype)
    kp[0] = poison
    vp[0] = poison
    return q, kp, vp, table, np.asarray(lens, np.int32)


def _tol(dtype):
    # bf16: the reference's own kernel tolerance (one bf16 rounding step
    # of probabilities and outputs); f32: summation order only
    return 2e-2 if dtype == BF16 else 2e-5


CASES = [
    # (page_size, max_pages, K, G, dh, lens, dtype)
    (8, 4, 2, 2, 32, [32, 17, 8, 1], np.float32),
    (4, 4, 1, 4, 32, [16, 3, 0, 9], np.float32),         # MQA + freed slot
    (16, 2, 4, 1, 16, [32, 31, 30, 5], BF16),            # MHA, bf16 pool
    (8, 8, 2, 4, 64, [64, 1, 40, 0, 23], BF16),
]


@pytest.mark.parametrize("psize,mp,K,G,dh,lens,dtype", CASES)
def test_plain_paged_attention_matches_reference(psize, mp, K, G, dh, lens,
                                                 dtype):
    q, kp, vp, table, kv_len = make_case(7, lens, psize, mp, K, G, dh, dtype,
                                         poison=1e4)
    got = ref.paged_attention_ref(tt(q), tt(kp), tt(vp), tt(table),
                                  tt(kv_len)).float().numpy()
    # the reference's Pallas kernel, in interpret mode (its CPU form)
    want = np.asarray(ref_ops.paged_attention(q, kp, vp, table, kv_len,
                                              interpret=True), np.float32)
    np.testing.assert_allclose(got, want, rtol=_tol(dtype), atol=_tol(dtype))
    # the reference's gather path: the same KV laid out per slot, attended
    # with per-row lengths (live slots only: a fully-masked row of the
    # gather path softmaxes to uniform and is discarded upstream)
    t = mp * psize
    kc = kp[table].reshape(len(lens), t, K, dh)
    vc = vp[table].reshape(len(lens), t, K, dh)
    cont = np.asarray(ref_dot_attention(q[:, None], kc, vc, causal=True,
                                        q_offset=kv_len - 1,
                                        kv_len=kv_len)[:, 0], np.float32)
    live = kv_len > 0
    np.testing.assert_allclose(got[live], cont[live], rtol=_tol(dtype),
                               atol=_tol(dtype))


def test_plain_paged_attention_freed_slot_zero_and_junk_blind():
    """A freed slot (zeroed row, stale nonzero length) outputs exact zeros,
    and live outputs are bitwise independent of the junk page."""
    lens = [24, 13, 7]
    clean = make_case(3, lens, 8, 4, 2, 2, 32, np.float32, poison=0.0)
    dirty = make_case(3, lens, 8, 4, 2, 2, 32, np.float32, poison=1e6)
    outs = []
    for q, kp, vp, table, kv_len in (clean, dirty):
        table = table.copy()
        table[1] = 0                      # freed mid-flight; length stays
        outs.append(ref.paged_attention_ref(tt(q), tt(kp), tt(vp), tt(table),
                                            tt(kv_len)))
    assert torch.all(outs[1][1] == 0)
    assert torch.equal(outs[0], outs[1])


def test_ops_dispatch_cpu_to_plain_versions_without_launching():
    q, kp, vp, table, kv_len = make_case(5, [9, 0, 16], 8, 2, 2, 2, 32, BF16,
                                         poison=1e4)
    args = (tt(q), tt(kp), tt(vp), tt(table), tt(kv_len))
    x = tt(np.random.default_rng(0).standard_normal((5, 64)).astype(BF16))
    w = tt(np.ones((64,), BF16))
    before = (paged_attention_cuda.launches, rmsnorm_cuda.launches)
    assert torch.equal(ops.paged_attention(*args),
                       ref.paged_attention_ref(*args))
    assert torch.equal(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w))
    assert (paged_attention_cuda.launches, rmsnorm_cuda.launches) == before


@pytest.mark.parametrize("rows,d", [(1, 64), (8, 4096), (33, 256)])
def test_plain_rmsnorm_matches_reference_kernel(rows, d):
    rng = np.random.default_rng(rows)
    x = (3 * rng.standard_normal((rows, d))).astype(BF16)
    w = (1 + 0.1 * rng.standard_normal((d,))).astype(BF16)
    got = ref.rmsnorm_ref(tt(x), tt(w)).float().numpy()
    want = np.asarray(ref_ops.rmsnorm(x, w, interpret=True), np.float32)
    # one bf16 rounding of the same f32 math: at most one step apart
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


def test_plain_rmsnorm_f32_input_rounds_once_to_bf16():
    """The f32-input form (the unrounded residual sum the model hands its
    second norm) is the reference's f32 RMSNorm rounded once to bf16."""
    rng = np.random.default_rng(1)
    x = (300 * rng.standard_normal((6, 128))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal((128,))).astype(BF16)
    got = ref.rmsnorm_ref(tt(x), tt(w), out_dtype=torch.bfloat16)
    want = np.asarray(ref_ops.rmsnorm(x, w.astype(np.float32),
                                      interpret=True)).astype(BF16)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=2 ** -7, atol=1e-6)


def test_cuda_wrappers_reject_cpu_tensors():
    """No fallback: the CUDA wrappers take CUDA tensors or raise."""
    q, kp, vp, table, kv_len = make_case(2, [4, 8], 4, 2, 1, 1, 16, BF16)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(tt(q), tt(kp), tt(vp), tt(table), tt(kv_len))
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(tt(q[0]), tt(q[0, 0]))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


def test_kernel_sources_export_their_launchers():
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert 'extern "C"' in src and f"int {name}_launch(" in src
        assert _build.library_path(name).name.startswith(f"lib{name}-")


# ---------------------------------------------------------------------------
# on the card (skipped without CUDA)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("psize,mp,K,G,dh,lens,dtype",
                         [c for c in CASES if c[6] == BF16 and c[4] % 8 == 0])
def test_cuda_paged_attention_matches_plain(cuda, psize, mp, K, G, dh, lens,
                                            dtype):
    case = [tt(a).to(cuda) for a in make_case(7, lens, psize, mp, K, G, dh,
                                              dtype, poison=1e4)]
    got = paged_attention_cuda(*case)
    want = ref.paged_attention_ref(*case)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 8, 128, 1000])
def test_cuda_rmsnorm_matches_plain(cuda, rows):
    x = torch.randn((rows, 4096), device=cuda).to(torch.bfloat16)
    w = torch.randn((4096,), device=cuda).to(torch.bfloat16)
    torch.testing.assert_close(rmsnorm_cuda(x, w).float(),
                               ref.rmsnorm_ref(x, w).float(),
                               rtol=2e-2, atol=2e-2)
