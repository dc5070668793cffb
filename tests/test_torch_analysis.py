"""The port's roofline analysis (``repro_torch/analysis/``) against the
JAX reference's on the CPU.

* ``cells`` lists the reference's (arch, shape, skipped) cells, and
  ``model_flops`` equals the reference's exactly for every one of them
  (host arithmetic; ``include_skipped=True``).
* ``roofline.py`` holds the H100's data-sheet constants and no TPU
  constant; ``Roofline.finalize`` checked by hand on one record.
* ``cost.measure``'s dot FLOPs of the smoke prefill equal
  ``repro.analysis.hlo.analyze`` of the reference's compiled step:
  exactly for ``deepseek-7b-smoke``; for ``whisper-tiny-smoke`` the
  reference's count is higher by the cross K/V projections it makes
  twice in every decoder layer (inside ``attention`` and again for the
  cache, ``repro/models/encdec.py:125-130``; XLA keeps both dots), which
  the port makes once.
* ``hlo.analyze`` counts no FLOPs inside a custom-call (a Pallas kernel
  compiled for the TPU), as ``cost.measure`` counts none inside the
  port's ``ctypes`` kernels.
* ``cost.measure``'s bytes on a hand-made step: inputs read once, a
  gathered table's distinct rows once, in-place writes into an input,
  fresh outputs; a whisper decode step reads only the position rows it
  gathers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import flops as ref_flops
from repro.analysis import hlo
from repro.configs import get_config as ref_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import ShapeConfig as RefShape
from repro.configs.base import cells as ref_cells
from repro.data.pipeline import SyntheticSource as RefSource
from repro.models.params import init_params as ref_init
from repro.models.transformer import model_for as ref_model_for
from repro.training import steps as ref_steps
from repro_torch.analysis import cost, flops, roofline
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import cells
from repro_torch.models.params import params_from_jax
from repro_torch.models.transformer import model_for
from repro_torch.training import steps as port_steps


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cells_are_the_reference_s():
    assert cells(include_skipped=True) == ref_cells(include_skipped=True)
    assert cells() == ref_cells()
    assert ("whisper-tiny", "long_500k", True) in cells(include_skipped=True)


@pytest.mark.parametrize("arch,shape,skipped", ref_cells(include_skipped=True))
def test_model_flops_equal_the_reference_s(arch, shape, skipped):
    got = flops.model_flops(get_config(arch), SHAPES[shape])
    want = ref_flops.model_flops(ref_config(arch), REF_SHAPES[shape])
    assert got == want


def test_roofline_constants_are_the_h100_s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    assert roofline.NVLINK_BW == 450e9
    text = open(roofline.__file__).read()
    for tpu in ("197e12", "819e9", "50e9", "v5e", "ICI"):
        assert tpu not in text, tpu
    assert "H100" in text and "700 W" in text


def test_finalize_by_hand():
    rec = cost.StepCost(flops=2.0e12, hbm_bytes=6.7e9, wire_bytes=0.0)
    r = roofline.from_cost(rec)
    t_c, t_m = 2.0e12 / 989e12, 6.7e9 / 3.35e12       # 2.022 ms, 2.000 ms
    assert r.t_compute == pytest.approx(t_c, rel=1e-12)
    assert r.t_memory == pytest.approx(t_m, rel=1e-12)
    assert r.t_collective == 0.0
    assert r.bottleneck == "compute" and r.t_bound == r.t_compute
    mem = roofline.from_cost(dataclasses.replace(rec, hbm_bytes=1e10))
    assert mem.bottleneck == "memory"
    assert mem.t_bound == pytest.approx(1e10 / 3.35e12, rel=1e-12)
    wire = roofline.from_cost(dataclasses.replace(rec, wire_bytes=1e9))
    assert wire.bottleneck == "collective"
    assert wire.t_collective == pytest.approx(1e9 / 450e9, rel=1e-12)


def _prefill_flops(arch, s, b):
    """(the reference's compiled prefill's dot FLOPs, the port's)."""
    rm = ref_model_for(ref_config(arch), remat="none")
    rp = ref_init(rm.param_table(), jax.random.PRNGKey(0))
    batch = RefSource(rm.cfg.vocab_size, 0).batch(
        rm.batch_table(RefShape("p", s, b, "prefill")), 0)
    text = jax.jit(ref_steps.build_prefill_step(rm, None)).lower(
        rp, {k: jnp.asarray(v) for k, v in batch.items()}).compile().as_text()
    pm = model_for(get_config(arch), remat="none")
    _, got = cost.measure(port_steps.build_prefill_step(pm),
                          params_from_jax(jax.tree.map(np.asarray, rp)),
                          {k: params_from_jax(np.asarray(v))
                           for k, v in batch.items()})
    return hlo.analyze(text).flops, got


def test_dense_prefill_dot_flops_equal_the_hlo_count():
    want, got = _prefill_flops("deepseek-7b-smoke", 32, 2)
    assert got.flops == want
    assert got.dot_count > 0 and got.wire_bytes == 0.0


def test_whisper_prefill_dot_flops_against_the_hlo_count():
    """Term by term: the encoder, the decoder and the last position's
    unembedding are the same dots in both; the reference adds, per
    decoder layer, a second projection of the encoder output onto the
    cross K and V for its cache (2 x 2 b s d K dh)."""
    s, b = 32, 2
    want, got = _prefill_flops("whisper-tiny-smoke", s, b)
    cfg = get_config("whisper-tiny-smoke")
    twice = 2 * (2.0 * b * s * cfg.d_model * cfg.num_kv_heads *
                 cfg.head_dim) * cfg.num_layers
    assert got.flops + twice == want
    # and the port's count term by term from the shapes
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd = cfg.num_heads * cfg.head_dim
    t = b * s
    attn = 2 * 2.0 * b * cfg.num_heads * s * s * cfg.head_dim   # qk, pv
    enc = 4 * 2.0 * t * d * hd + attn + 2 * 2.0 * t * d * f
    dec = 8 * 2.0 * t * d * hd + 2 * attn + 2 * 2.0 * t * d * f
    assert got.flops == cfg.num_encoder_layers * enc + \
        cfg.num_layers * dec + 2.0 * b * d * v


def test_hlo_counts_nothing_inside_a_custom_call():
    """A Pallas kernel compiled for the TPU is a custom-call whose body
    is a serialized module, not a called computation: hlo.analyze counts
    the plain dot beside it and nothing of the kernel."""
    text = """HloModule m

ENTRY %main (p0: f32[4,8], p1: f32[8,16]) -> (f32[4,16], f32[4,16]) {
  %p0 = f32[4,8]{1,0} parameter(0)
  %p1 = f32[8,16]{1,0} parameter(1)
  %k = f32[4,16]{1,0} custom-call(%p0, %p1), custom_call_target="tpu_custom_call", backend_config="{\\"custom_call_config\\": {\\"body\\": \\"TUxJUgA=\\"}}"
  %d = f32[4,16]{1,0} dot(%p0, %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  ROOT %t = (f32[4,16]{1,0}, f32[4,16]{1,0}) tuple(%k, %d)
}
"""
    c = hlo.analyze(text)
    assert (c.flops, c.dot_count) == (2.0 * 4 * 16 * 8, 1)


def test_measure_counts_least_bytes_by_hand():
    """Weights read once whichever view reads them, a table's distinct
    gathered rows once, an in-place write into an input, a fresh
    output."""
    w = torch.randn(8, 16)                       # 512 B
    table = torch.randn(100, 4)                  # 1,600 B; 3 rows read
    cache = torch.zeros(2, 10, 16)               # written at one position

    def step(p, ids, cache, at):
        x = p["table"][ids]                      # (5, 4): rows 1, 7, 9
        y = x @ p["w"][:4]                       # half of w
        cache[:, at] = y[:2]
        return y.sum(0), cache

    ids = torch.tensor([7, 1, 9, 7, 1])
    out, c = cost.measure(step, {"w": w, "table": table}, ids, cache, 3)
    assert c.flops == 2.0 * 5 * 16 * 4 and c.dot_count == 1
    # reads: w's first 4 rows (256 B), 3 table rows (48 B), the ids (40 B)
    assert c.read_bytes == 256 + 3 * 16 + 40
    # writes: 2 x 16 into the cache in place, a fresh (16,) sum
    assert c.write_bytes == 2 * 16 * 4 + 16 * 4
    assert c.hbm_bytes == c.read_bytes + c.write_bytes


def test_whisper_decode_step_reads_its_position_rows_only():
    cfg = get_config("whisper-tiny-smoke")
    pm = model_for(cfg, remat="none")
    from repro_torch.models.params import init_params
    params = init_params(pm.param_table(),
                         torch.Generator().manual_seed(0), "cpu")
    rm = ref_model_for(ref_config("whisper-tiny-smoke"))
    batch = RefSource(cfg.vocab_size, 0).batch(
        rm.batch_table(RefShape("p", 16, 2, "prefill")), 0)
    with torch.no_grad():
        _, cache = pm.prefill(params, {k: params_from_jax(np.asarray(v))
                                       for k, v in batch.items()})
    from repro_torch.launch.serve import grow_kv
    cache = grow_kv(cache, 4)
    decode = port_steps.build_decode_step(pm)
    _, c = cost.measure(decode, params, cache,
                        torch.ones((2, 1), dtype=torch.int32))
    from repro_torch.models.params import leaf_items
    skip = ("enc_blocks", "enc_ln_f")
    unread = {("dec_blocks", "xattn", k) for k in ("wk", "wv", "bk", "bv")}
    weights = sum(t.numel() * t.element_size()
                  for path, t in leaf_items(params)
                  if path[0] not in skip and path not in unread and
                  path[-1] != "pos_embedding")
    kv = sum(cache[k].numel() * cache[k].element_size()
             for k in ("k", "v", "xk", "xv"))
    # the decoder's weights (not the encoder's, nor the cross K/V
    # projections: the cache holds their products), the embedding table
    # whole (the tied unembedding reads it; the gathered token row is
    # inside that), one row of the position table (position 16); the
    # whole cache (the self-attention reads its grown tail, masked); the
    # tokens and the host index
    assert c.read_bytes == weights + cfg.d_model * 2 + kv + 2 * 4 + 4
    # in place: each layer's new self K and V of 2 rows; fresh: the
    # logits and the advanced index
    row = cfg.num_kv_heads * cfg.head_dim * 2
    assert c.write_bytes == 2 * cfg.num_layers * 2 * row + \
        2 * cfg.vocab_size * 2 + 4
    # dot FLOPs by hand: per layer the self q, k, v, o and the cross q, o
    # projections of 2 tokens, attention over the grown cache (20) and
    # the encoder's 16 positions, the MLP; the unembedding
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.num_heads * cfg.head_dim
    per_layer = 6 * 2.0 * 2 * d * hd + 2 * 2.0 * 2 * hd * (20 + 16) + \
        2 * 2.0 * 2 * d * f
    assert c.flops == cfg.num_layers * per_layer + 2.0 * 2 * d * \
        cfg.vocab_size
