"""The residual add fused into RMSNorm (``ops.add_rmsnorm``, the second
entry of ``csrc/rmsnorm.cu``) on the CPU, against the composition it
replaces and against the JAX reference.

The model's layer loop hands each residual add to the norm that reads
its sum: ``norm_of_rounded=False`` at the block's second norm (the
unrounded f32 sum, as XLA evaluates the reference's ``x + attn_out``
there) and ``True`` at the next block's first norm and at ``ln_f`` (the
rounded stream the reference's layer scan carries).  On the CPU the plain
version runs, which is the old composition op for op, so the port's
logits are bit for bit what they were; the model test below holds the
restructured loop to the old unfused one.  Against the reference the
norm agrees within two bf16 steps (XLA's CPU rsqrt is not correctly
rounded; tests/test_torch_model.py), the residual bit for bit.  The
kernel's own cases are marked ``cuda`` and skip here; ``chip_smoke.py``
holds it on the card.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import layers as ref_layers
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rmsnorm import (MAX_THREADS, add_rmsnorm_cuda,
                                         plan, rmsnorm_cuda)
from repro_torch.models import layers
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.models.transformer import model_for

BF16 = ml_dtypes.bfloat16
# the chip gate's shapes: decode (1, 8 rows), a verify burst (40), a
# prefill chunk (128) and a long prefill (1000), at the widths of the
# smoke configs and of deepseek-7b, mistral-large and nemotron-4
ROWS = (1, 8, 40, 128, 1000)
WIDTHS = (64, 4096, 12288, 18432)


def tt(a):
    """numpy (bf16 via ml_dtypes included) -> torch, bit for bit."""
    return params_from_jax(np.asarray(a))


def operands(seed, rows, d):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((rows, d))).astype(BF16)
    a = rng.standard_normal((rows, d)).astype(BF16)
    w = (1 + 0.1 * rng.standard_normal((d,))).astype(BF16)
    return x, a, w


def bits(t):
    return t.view(torch.int16)


def bf16_steps(got: np.ndarray, want: np.ndarray) -> float:
    """The largest |got - want| in bf16 steps of the larger of the two
    (a step of v in [2^(e-1), 2^e) is 2^(e-8))."""
    _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
    return float((np.abs(got - want) / np.ldexp(1.0, e - 8)).max())


@pytest.mark.parametrize("rows,d", [(1, 64), (8, 4096), (5, 256)])
@pytest.mark.parametrize("rounded", [False, True])
def test_plain_add_rmsnorm_is_the_old_composition_bit_for_bit(rows, d,
                                                              rounded):
    x, a, w = (tt(v) for v in operands(rows + d, rows, d))
    r, y = ref.add_rmsnorm_ref(x, a, w, norm_of_rounded=rounded)
    if rounded:       # the MLP's bf16 add, then the next block's norm
        r_old = x + a
        y_old = ref.rmsnorm_ref(r_old, w)
    else:             # the f32 sum into the second norm, then rounded
        s = x.float() + a.float()
        r_old, y_old = s.to(x.dtype), ref.rmsnorm_ref(
            s, w, out_dtype=x.dtype)
    assert r.dtype == y.dtype == torch.bfloat16
    assert torch.equal(bits(r), bits(r_old))
    assert torch.equal(bits(y), bits(y_old))


@pytest.mark.parametrize("rows,d", [(1, 64), (8, 4096), (40, 512)])
@pytest.mark.parametrize("rounded", [False, True])
def test_plain_add_rmsnorm_matches_reference(rows, d, rounded):
    """The reference's ``x + a`` then ``layers.rmsnorm`` under ``jax.jit``:
    XLA keeps the sum in f32 where it feeds the norm in the same program
    (the block's second norm), and the norm of the rounded stream is the
    norm of a rounded input.  The residual agrees bit for bit; the norm
    within two bf16 steps of each value (XLA's CPU rsqrt is within one f32
    step of exact and rounds a value to the neighbouring bf16 step now and
    then; tests/test_torch_model.py)."""
    x, a, w = operands(rows * d, rows, d)
    if rounded:
        r_ref = jax.jit(lambda x, a: x + a)(x, a)
        y_ref = jax.jit(ref_layers.rmsnorm)(r_ref, w)
    else:
        r_ref, y_ref = jax.jit(
            lambda x, a, w: (x + a, ref_layers.rmsnorm(x + a, w)))(x, a, w)
    r, y = ops.add_rmsnorm(tt(x), tt(a), tt(w), norm_of_rounded=rounded)
    assert np.array_equal(bits(r).numpy(), np.asarray(r_ref).view(np.int16))
    assert bf16_steps(y.float().numpy(), np.asarray(y_ref, np.float32)) <= 2


def test_ops_add_rmsnorm_runs_the_plain_version_on_the_cpu():
    x, a, w = (tt(v) for v in operands(0, 6, 128))
    before = (add_rmsnorm_cuda.launches, rmsnorm_cuda.launches)
    for rounded in (False, True):
        got = ops.add_rmsnorm(x, a, w, norm_of_rounded=rounded)
        want = ref.add_rmsnorm_ref(x, a, w, norm_of_rounded=rounded)
        assert all(torch.equal(g, h) for g, h in zip(got, want))
    assert (add_rmsnorm_cuda.launches, rmsnorm_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        add_rmsnorm_cuda(x, a, w, norm_of_rounded=True)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d", WIDTHS)
def test_plan_covers_the_row_and_splits_few_rows(rows, d):
    """At every row count one CTA takes a row (the grid is ``rows``
    CTAs): whole warps, at most 512 threads, the fewest vectors per
    thread that hold the row, no thread without a vector."""
    threads, nv = plan(d)
    assert nv in (1, 2, 4, 8) and threads % 32 == 0
    assert 32 <= threads <= MAX_THREADS
    assert threads * nv * 8 >= d > (threads - 32) * nv * 8
    assert nv == 1 or MAX_THREADS * nv // 2 * 8 < d
    assert rows * threads * nv * 8 >= rows * d


def test_plan_at_the_edges_of_what_a_cta_holds():
    assert plan(8) == (32, 1)
    assert plan(4096) == (512, 1) and plan(4104) == (288, 2)
    assert plan(32768) == (512, 8)
    with pytest.raises(ValueError, match="wider"):
        plan(32776)


# ---------------------------------------------------------------------------
# the model's layer loop against the unfused composition it replaces


def unfused_logits(model, params, x, positions, mode, cache_of):
    """Logits of every position by the old layer loop: each norm its own
    call, the residual adds apart (``block_apply`` before the fused
    kernel), on the port's own layers."""
    cfg = model.cfg
    for i, lp in enumerate(model.layer_params(params)):
        h = layers.rmsnorm(x, lp["ln1"]["scale"])
        attn_out, _ = layers.attention(lp["attn"], h, cfg, positions=positions,
                                       mode=mode, cache=cache_of(i))
        x_mid = x.float() + attn_out.float()
        h = layers.rmsnorm(x_mid, lp["ln2"]["scale"], out_dtype=x.dtype)
        x = x_mid.to(x.dtype) + layers.mlp(lp["mlp"], h, cfg)
    return layers.unembed(params["embed"],
                          layers.rmsnorm(x, params["ln_f"]["scale"]), cfg)


@pytest.fixture(scope="module")
def smoke():
    model = model_for(get_config("deepseek-7b-smoke"))
    gen = torch.Generator().manual_seed(0)
    return model, init_params(model.param_table(), gen, "cpu")


def test_fused_prefill_logits_equal_the_unfused_loop(smoke):
    model, params = smoke
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        1, 255, (2, 9)), dtype=torch.int32)
    got, _ = model.prefill(params, {"tokens": toks})
    x = layers.embed(params["embed"], toks, model.cfg)
    pos = torch.arange(9).expand(2, 9)
    want = unfused_logits(model, params, x, pos, "prefill", lambda i: None)
    assert torch.equal(got, want[:, -1:])


def test_fused_paged_decode_logits_equal_the_unfused_loop(smoke):
    """A decode tick of 3 slots over a shuffled page table, on two copies
    of one random pool (the tick writes K/V in place)."""
    model, params = smoke
    cfg = model.cfg
    rng = np.random.default_rng(2)
    shape = (cfg.num_layers, 13, 4, cfg.num_kv_heads, cfg.head_dim)
    pool = {n: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(torch.bfloat16) for n in ("k", "v")}
    pages = torch.as_tensor(rng.permutation(np.arange(1, 13)).reshape(3, 4),
                            dtype=torch.int32)
    idx = torch.tensor([5, 11, 2], dtype=torch.int32)
    toks = torch.tensor([[7], [3], [250]], dtype=torch.int32)

    def cache():
        return {"k": pool["k"].clone(), "v": pool["v"].clone(),
                "index": idx.clone(), "layout": "paged", "pages": pages,
                "use_kernel": True}
    got, _ = model.decode_step(params, cache(), toks)
    c = cache()
    x = layers.embed(params["embed"], toks, cfg)
    want = unfused_logits(
        model, params, x, idx[:, None], "decode",
        lambda i: {"k": c["k"][i], "v": c["v"][i], "index": idx,
                   "layout": "paged", "pages": pages, "use_kernel": True})
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# on the card (skipped without CUDA)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rounded", [False, True])
def test_cuda_add_rmsnorm_matches_plain(cuda, rows, d, rounded):
    """The residual bit for bit, the norm within one bf16 step of each value
    (both compute in f32 and round once; only the sum's order differs), and
    two calls bitwise equal."""
    x, a, w = (tt(v).to(cuda) for v in operands(rows + d, rows, d))
    r, y = add_rmsnorm_cuda(x, a, w, norm_of_rounded=rounded)
    r_want, y_want = ref.add_rmsnorm_ref(x, a, w, norm_of_rounded=rounded)
    assert torch.equal(bits(r), bits(r_want))
    err = (y.float() - y_want.float()).abs()
    assert bool((err <= 1e-4 + 2.0 ** -7 * y_want.float().abs()).all())
    r2, y2 = add_rmsnorm_cuda(x, a, w, norm_of_rounded=rounded)
    assert torch.equal(bits(r2), bits(r)) and torch.equal(bits(y2), bits(y))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("d", WIDTHS)
def test_cuda_rmsnorm_at_every_plan_matches_plain(cuda, rows, d):
    x, _, w = (tt(v).to(cuda) for v in operands(rows * d, rows, d))
    got = rmsnorm_cuda(x, w)
    err = (got.float() - ref.rmsnorm_ref(x, w).float()).abs()
    want = ref.rmsnorm_ref(x, w).float().abs()
    assert bool((err <= 1e-4 + 2.0 ** -7 * want).all())
    assert torch.equal(bits(got), bits(rmsnorm_cuda(x, w)))
