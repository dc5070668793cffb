"""The port's flash attention (``repro_torch.kernels``: the op, its plain
version and the kernel bench) against the JAX reference on the CPU.

Inputs are drawn with numpy; bf16 crosses as ml_dtypes bits.  On the CPU
``ops.flash_attention`` runs the kernel's plain version
``ref.flash_attention_ref``, held against the reference's Pallas kernel
in interpret mode (its CPU form) at every shape of
``tests/test_kernels_flash.py``, with that file's tolerances (2e-5 f32,
2e-2 bf16).  The CUDA kernel's own cases are in
``tests/test_torch_kernels.py`` (marked ``cuda``, skipped here);
``chip_smoke.py`` holds it against the plain version on the card.  The
bf16 tensor-core body's rounding recipe (p split into two bf16 terms) is
emulated here in plain PyTorch and held against the plain version.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_jax
from repro.kernels.ops import flash_attention as ref_flash
from repro_torch.kernels import bench, ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.models.params import params_from_jax

BF16 = ml_dtypes.bfloat16

CASES = [
    # (b, s, t, H, K, dh, bq, bk, causal, dtype): tests/test_kernels_flash.py
    (1, 128, 128, 4, 4, 64, 64, 64, True, np.float32),
    (2, 256, 256, 4, 2, 64, 128, 64, True, np.float32),
    (1, 128, 128, 8, 1, 32, 64, 128, True, np.float32),   # MQA
    (2, 128, 128, 4, 4, 64, 128, 128, False, np.float32),
    (1, 256, 256, 6, 2, 64, 64, 64, True, BF16),
    (1, 64, 64, 2, 2, 128, 64, 64, True, BF16),
    (2, 512, 512, 2, 2, 64, 128, 128, True, np.float32),
]


def tt(a):
    """numpy (bf16 via ml_dtypes included) -> torch, bit for bit."""
    return params_from_jax(np.asarray(a))


def qkv(seed, b, s, t, H, K, dh, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((b, s, H, dh)).astype(dtype),
            rng.standard_normal((b, t, K, dh)).astype(dtype),
            rng.standard_normal((b, t, K, dh)).astype(dtype))


def tol(dtype):
    return 2e-2 if dtype == BF16 else 2e-5


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("b,s,t,H,K,dh,bq,bk,causal,dtype", CASES)
def test_plain_flash_matches_reference_kernel(b, s, t, H, K, dh, bq, bk,
                                              causal, dtype):
    q, k, v = qkv(s + H, b, s, t, H, K, dh, dtype)
    got = ops.flash_attention(tt(q), tt(k), tt(v), causal=causal,
                              block_q=bq, block_k=bk)
    assert got.dtype == tt(q).dtype and got.shape == (b, s, H, dh)
    want = ref_flash(q, k, v, causal=causal, block_q=bq, block_k=bk)
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol(dtype),
                               atol=tol(dtype))
    # at s == t the full-softmax oracle agrees too (test_kernels_flash.py)
    np.testing.assert_allclose(
        f32(ref.attention_ref(tt(q), tt(k), tt(v), causal=causal)),
        f32(want), rtol=tol(dtype), atol=tol(dtype))


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_reference_oracle(causal):
    q, k, v = qkv(3, 2, 64, 96, 4, 2, 32)
    np.testing.assert_allclose(
        f32(ref.attention_ref(tt(q), tt(k), tt(v), causal=causal)),
        f32(ref_jax.attention_ref(q, k, v, causal=causal)),
        rtol=2e-5, atol=2e-5)


def test_causal_s_ne_t_is_top_left_aligned():
    """With s != t the kernel's causal mask (query i sees keys j <= i) is
    not the oracle's (j <= i + t - s): the port's plain version follows
    the kernel, and both differ from the oracle."""
    q, k, v = qkv(4, 1, 128, 256, 4, 2, 64)
    got = f32(ops.flash_attention(tt(q), tt(k), tt(v), causal=True,
                                  block_q=64, block_k=64))
    want = f32(ref_flash(q, k, v, causal=True, block_q=64, block_k=64))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    oracle = f32(ref.attention_ref(tt(q), tt(k), tt(v), causal=True))
    assert np.abs(got - oracle).max() > 0.1
    np.testing.assert_allclose(
        oracle, f32(ref_jax.attention_ref(q, k, v, causal=True)),
        rtol=2e-5, atol=2e-5)


def test_short_kv_len_masks_garbage_exactly():
    """kv_len=32 with 64-key blocks (test_kernels_flash.py's regression):
    the padded cache attends like a 32-long one, and garbage past kv_len
    is invisible bit for bit."""
    q, k, v = qkv(5, 1, 128, 128, 4, 2, 64)
    args = dict(causal=True, block_q=64, block_k=64, kv_len=32)
    got = ops.flash_attention(tt(q), tt(k), tt(v), **args)
    want = ref_flash(q, k, v, **args)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)
    k_dirty, v_dirty = k.copy(), v.copy()
    k_dirty[:, 32:] = 1e4
    v_dirty[:, 32:] = 1e4
    dirty = ops.flash_attention(tt(q), tt(k_dirty), tt(v_dirty), **args)
    assert torch.equal(got, dirty)


def test_kv_len_zero_yields_exact_zeros():
    q, k, v = qkv(6, 1, 64, 64, 2, 2, 32)
    out = ops.flash_attention(tt(q), tt(k), tt(v), causal=False,
                              block_q=64, block_k=64, kv_len=0)
    assert torch.all(out == 0)
    assert np.all(f32(ref_flash(q, k, v, causal=False, block_q=64,
                                block_k=64, kv_len=0)) == 0)


def test_rejects_blocks_that_do_not_divide():
    q = torch.zeros((1, 100, 2, 16))
    with pytest.raises(AssertionError):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1], block_q=64,
                            block_k=64)
    with pytest.raises(AssertionError):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1], block_q=100,
                            block_k=100, kv_len=101)
    # the blocks select checks only: any dividing pair gives one result
    q, k, v = qkv(7, 1, 128, 128, 2, 1, 32)
    outs = [ops.flash_attention(tt(q), tt(k), tt(v), block_q=bq, block_k=bk)
            for bq, bk in ((32, 128), (128, 64), (256, 256))]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_cpu_tensors_never_reach_the_kernel():
    q, k, v = qkv(8, 1, 64, 64, 2, 2, 32)
    before = flash_attention_cuda.launches
    ops.flash_attention(tt(q), tt(k), tt(v))
    assert flash_attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(tt(q), tt(k), tt(v))


def test_kernel_bench_rows_on_the_cpu():
    """The kernel bench writes the reference's row names, ``_cuda`` in
    place of ``_pallas_interp``, with the reference's byte estimates; on
    the CPU every row says so."""
    rows = []
    bench.run(lambda name, us, note: rows.append((name, us, note)),
              device="cpu")
    assert [r[0] for r in rows] == [
        "kernel_flash_ref", "kernel_flash_cuda", "kernel_paged_decode_gather",
        "kernel_paged_decode_fused", "kernel_rmsnorm_ref",
        "kernel_rmsnorm_cuda", "kernel_sedov_ref", "kernel_sedov_cuda"]
    assert all(us > 0 and note.endswith("device=cpu") for _, us, note in rows)
    # (2H + 2K) b s dh 4 bytes fused against 12 H b s^2 unfused; three
    # passes over 18 held pages against the gathered 4 x 8 pages twice
    assert rows[0][2] == "bytes=12582912,device=cpu"
    assert rows[1][2] == "bytes=1572864,traffic_reduction=8.0x,device=cpu"
    assert rows[2][2] == "bytes=524288,device=cpu"
    assert rows[3][2] == "bytes=442368,traffic_reduction=1.2x,device=cpu"


# ---------------------------------------------------------------------------
# the tensor-core body's rounding recipe (csrc/flash_attention.cu, bf16),
# emulated in plain PyTorch on the CPU


def _split_recipe(q, k, v, *, causal=True, keep_lo=True, block_k=128):
    """The bf16 kernel's numerics, tile by tile: bf16 q.k products summed
    in f32 and scaled after the dot (log2(e) folded into the scale), an
    online softmax in exp2 over 128-key tiles with masked p exactly 0,
    p split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), each multiplied
    with bf16 V in f32 into one f32 accumulator, divided by
    max(l, 1e-20).  Returns the f32 output, before the one rounding to
    bf16."""
    b, s, H, dh = q.shape
    t, K = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, s, K, H // K, dh)
    scale_log2 = (1.0 / dh ** 0.5) * 1.4426950408889634
    m = torch.full((b, K, H // K, s, 1), -1e30)
    l = torch.zeros((b, K, H // K, s, 1))
    o = torch.zeros((b, K, H // K, s, dh))
    rows = torch.arange(s)[:, None]
    for k0 in range(0, t, block_k):
        kt = k[:, k0:k0 + block_k].float()
        vt = v[:, k0:k0 + block_k].float()
        x = torch.einsum("bskgd,btkd->bkgst", qf, kt) * scale_log2
        keys = torch.arange(k0, k0 + kt.shape[1])[None, :]
        valid = (keys <= rows) if causal else torch.ones_like(keys <= rows)
        x = torch.where(valid, x, torch.full_like(x, -torch.inf))
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        p_lo = (p - p_hi).to(torch.bfloat16).float()
        pv = torch.einsum("bkgst,btkd->bkgsd", p_hi, vt)
        if keep_lo:
            pv = pv + torch.einsum("bkgst,btkd->bkgsd", p_lo, vt)
        o = o * corr + pv
        m = m_new
    out = o / l.clamp_min(1e-20)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, H, dh)


def _recipe_inputs():
    q, k, v = qkv(14, 1, 512, 512, 4, 2, 128, BF16)
    return tt(q), tt(k), tt(v)


def test_split_recipe_holds_one_bf16_step_of_the_plain_version():
    """The recipe rounded once to bf16 sits within one bf16 step of each
    value of ``ref.flash_attention_ref`` (chip_smoke.py's full-width
    limit, 1e-4 + 2^-7 |plain|), and before that rounding within 1e-5 of
    the plain version's f32 output: p_hi + p_lo carries p to ~16
    significant bits, so the split keeps P.V at f32 grade."""
    q, k, v = _recipe_inputs()
    got32 = _split_recipe(q, k, v)
    want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                     causal=True)
    np.testing.assert_allclose(got32.numpy(), want32.numpy(), rtol=0,
                               atol=1e-5)
    got = got32.to(torch.bfloat16).float()
    want = ref.flash_attention_ref(q, k, v, causal=True).float()
    assert bool(((got - want).abs() <= 1e-4 + 2.0 ** -7 * want.abs()).all())


def test_split_recipe_without_p_lo_loses_f32_grade():
    """What the split buys: with p rounded to bf16 alone (p_lo dropped)
    the f32 output leaves the 1e-5 band around the plain version's."""
    q, k, v = _recipe_inputs()
    want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                     causal=True)
    err_split = (_split_recipe(q, k, v) - want32).abs().max().item()
    err_hi = (_split_recipe(q, k, v, keep_lo=False) - want32).abs().max()
    assert err_split <= 1e-5 < err_hi.item()
