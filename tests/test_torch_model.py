"""The port's DenseLM (``repro_torch.models``) against the JAX reference
on the same weights.

The reference's ``deepseek-7b-smoke`` parameters cross into the port bit
for bit (``params_from_jax``); the same numpy-seeded tokens then go
through both packages' prefill, chunked prefill into a paged pool with a
shuffled page table, and teacher-forced paged decode.  The port mirrors
every rounding point of the reference (see models/layers.py), so logits
agree to bf16 resolution: within two bf16 rounding steps of the
compared tensor's largest entry (``close``).  Exact agreement is not
promised: XLA evaluates a few transcendentals (RoPE's sin/cos) with
shape-dependent code, so rare elements differ by one rounding step.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.params import init_params as ref_init
from repro.models.params import param_count as ref_param_count
from repro.models.transformer import model_for as ref_model_for
from repro.training.steps import (
    build_decode_step_slots_paged as ref_decode_builder,
    build_prefill_chunk_step_paged as ref_chunk_builder)
from repro_torch.configs import get_config
from repro_torch.models.params import (ParamDef, param_count,
                                       params_from_jax)
from repro_torch.models.transformer import model_for
from repro_torch.serving.prefill import bucket_len
from repro_torch.training.steps import (build_decode_step_slots_paged,
                                        build_prefill_chunk_step_paged)

ARCH = "deepseek-7b-smoke"
PAGE, MAX_PAGES, NUM_PAGES = 8, 8, 40
BF16_STEP = 2.0 ** -7    # two bf16 rounding steps, relative


def close(got: torch.Tensor, want, what: str = "") -> None:
    """Agreement to within two bf16 rounding steps of the largest entry."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_STEP,
                               atol=BF16_STEP * float(np.abs(want).max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, port model, the same params)."""
    rm = ref_model_for(ref_config(ARCH), remat="none")
    rp = ref_init(rm.param_table(), jax.random.PRNGKey(0))
    pm = model_for(get_config(ARCH))
    pp = params_from_jax(jax.tree.map(np.asarray, rp))
    return rm, rp, pm, pp


def _tokens(n, seed):
    return np.random.default_rng(seed).integers(1, 255, (1, n)).astype(np.int32)


def test_param_tables_match_reference(pair):
    rm, _, pm, _ = pair

    def desc(table, is_def):
        out = {}

        def walk(t, path):
            for k, v in t.items():
                if is_def(v):
                    out[path + (k,)] = (tuple(v.shape), tuple(v.logical_axes),
                                        v.init, v.scale)
                else:
                    walk(v, path + (k,))
        walk(table, ())
        return out

    ref_t = desc(rm.param_table(), lambda v: hasattr(v, "logical_axes"))
    port_t = desc(pm.param_table(), lambda v: isinstance(v, ParamDef))
    assert port_t == ref_t
    assert param_count(pm.param_table()) == ref_param_count(rm.param_table())


def test_params_cross_bit_exact(pair):
    _, rp, _, pp = pair
    flat_ref = jax.tree_util.tree_flatten_with_path(rp)[0]

    def count(tree):
        return sum(count(v) for v in tree.values()) \
            if isinstance(tree, dict) else 1
    assert len(flat_ref) == count(pp)
    for path, leaf in flat_ref:
        t = pp
        for key in path:
            t = t[key.key]
        a = np.asarray(leaf)
        assert t.dtype == torch.bfloat16 and a.dtype == ml_dtypes.bfloat16
        assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))


def test_prefill_logits_and_cache_match_reference(pair):
    rm, rp, pm, pp = pair
    toks = _tokens(24, 0)
    rl, rc = jax.jit(lambda p, b: rm.prefill(p, b, None))(
        rp, {"tokens": jnp.asarray(toks), "last": jnp.int32(20)})
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks), "last": 20})
    close(pl, rl, "prefill logits")
    close(pc["k"], rc["k"], "prefill K")
    close(pc["v"], rc["v"], "prefill V")


def _shuffled_row(seed, n_pages):
    order = np.random.default_rng(seed).permutation(
        np.arange(1, NUM_PAGES, dtype=np.int32))
    row = np.zeros((MAX_PAGES,), np.int32)
    row[:n_pages] = order[:n_pages]
    return row


def _ref_pool(cfg, slots):
    shape = (cfg.num_layers, NUM_PAGES, PAGE, cfg.num_kv_heads, cfg.head_dim)
    return {"k": jnp.zeros(shape, jnp.bfloat16),
            "v": jnp.zeros(shape, jnp.bfloat16),
            "index": jnp.zeros((slots,), jnp.int32)}


def _port_pool(cfg, slots):
    shape = (cfg.num_layers, NUM_PAGES, PAGE, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.bfloat16),
            "v": torch.zeros(shape, dtype=torch.bfloat16),
            "index": torch.zeros((slots,), dtype=torch.int32)}


def _ingest(rm, rp, pm, pp, rcache, pcache, prompt, slot, row, chunk):
    """Chunk a prompt into both pools the way PrefillManager does
    (power-of-two buckets, power-of-two KV bound); returns the last
    chunk's logits from each package."""
    rstep = jax.jit(ref_chunk_builder(rm), static_argnums=(6,))
    pstep = build_prefill_chunk_step_paged(pm)
    done, n = 0, len(prompt)
    while done < n:
        c = min(chunk, n - done)
        b = bucket_len(c)
        toks = np.zeros((1, b), np.int32)
        toks[0, :c] = prompt[done:done + c]
        bound = min(bucket_len(done + c), MAX_PAGES * PAGE)
        rl, rcache = rstep(rp, rcache, jnp.asarray(toks), jnp.int32(slot),
                           jnp.int32(done), jnp.int32(c), bound,
                           jnp.asarray(row))
        pl, pcache = pstep(pp, pcache, torch.from_numpy(toks), slot, done, c,
                           bound, torch.from_numpy(row))
        done += c
    return rl, rcache, pl, pcache


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_prefill_into_shuffled_pages_matches_reference(pair, chunk):
    rm, rp, pm, pp = pair
    cfg = pm.cfg
    prompt = _tokens(37, chunk)[0]
    row = _shuffled_row(chunk, -(-37 // PAGE))
    rl, rcache, pl, pcache = _ingest(rm, rp, pm, pp, _ref_pool(cfg, 2),
                                     _port_pool(cfg, 2), prompt, 1, row,
                                     chunk)
    close(pl, rl, "chunked-prefill logits")
    # the prompt's K/V sit in the same pages at the same offsets
    pos = np.arange(37)
    page, off = row[pos // PAGE], pos % PAGE
    for name in ("k", "v"):
        close(pcache[name][:, page, off],
              np.asarray(rcache[name], np.float32)[:, page, off], name)
    assert int(pcache["index"][1]) == int(rcache["index"][1]) == 37


def test_teacher_forced_paged_decode_matches_reference(pair):
    """Three slots at different lengths share one pool (slot 2 inactive);
    the reference ingests their prompts and its pool crosses into the port
    bit for bit, then six teacher-forced ticks through both packages'
    paged decode steps — the port's gather path and its kernel dispatch
    (the plain paged-decode version on the CPU) — give the reference's
    logits for the active slots, and the same lengths."""
    rm, rp, pm, pp = pair
    lens = [19, 5, 11]
    rows = np.zeros((3, MAX_PAGES), np.int32)
    order = np.random.default_rng(9).permutation(
        np.arange(1, NUM_PAGES, dtype=np.int32))
    rcache, scratch = _ref_pool(pm.cfg, 3), _port_pool(pm.cfg, 3)
    used = 0
    for slot, n in enumerate(lens):
        need = -(-(n + 6) // PAGE)
        rows[slot, :need] = order[used:used + need]
        used += need
        _, rcache, _, scratch = _ingest(rm, rp, pm, pp, rcache, scratch,
                                        _tokens(n, 20 + slot)[0], slot,
                                        rows[slot], 16)
    active = np.array([1, 1, 0], np.int32)
    rstep = jax.jit(ref_decode_builder(rm, None, use_kernel=False))
    steps = {"gather": build_decode_step_slots_paged(pm, use_kernel=False),
             "kernel": build_decode_step_slots_paged(pm, use_kernel=True)}
    pcaches = {name: params_from_jax(jax.tree.map(np.asarray, rcache))
               for name in steps}
    feed = np.random.default_rng(5).integers(1, 255, (6, 3, 1)).astype(np.int32)
    for t in range(6):
        rl, rcache = rstep(rp, rcache, jnp.asarray(feed[t]),
                           jnp.asarray(active), jnp.asarray(rows))
        want = np.asarray(rl, np.float32)[active == 1]
        for name, step in steps.items():
            pl, pcaches[name] = step(pp, pcaches[name],
                                     torch.from_numpy(feed[t]),
                                     torch.from_numpy(active),
                                     torch.from_numpy(rows))
            close(pl[active == 1], want, f"{name} tick {t}")
            assert pcaches[name]["index"].tolist() == \
                np.asarray(rcache["index"]).tolist()
