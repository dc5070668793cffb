"""The port's paged ServeEngine against the JAX reference's, on the CPU.

Both engines serve the same traces with the same weights (the
reference's, crossed bit for bit).  Scheduling counts are hardware-free
and must be equal; greedy streams must be identical.

* Case 1 is the serving benchmark's own cell (``BENCH_serving.json``
  ``paged_*``): ``deepseek-7b-smoke``, 8 slots x 128 under a budget
  target built like ``bench:serve-tight`` (``benchmarks/
  serving_throughput.py``), the 12-request Zipf trace — 31 decode steps,
  6.2581 tokens per step.
* Case 2 copies ``tests/test_serving_paged.py``'s scarce-page trace
  (page 8, 13 pages), where preemption happens.

The port's kernel dispatch (``kv_kernel="cuda"``, the plain paged-decode
version on the CPU) is held token-identical to its gather path, and the
tuner's serve plan to the reference's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core.target as ref_target
import repro_torch.core.target as port_target
from repro.configs import get_config as ref_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.core.tuning import kv_bytes_per_token, param_count_estimate
from repro.core.tuning import tune as ref_tune
from repro.serving import ServeEngine as RefEngine
from repro.serving import zipf_trace as ref_zipf
from repro_torch.configs import get_config
from repro_torch.configs.base import ARCHS, SHAPES
from repro_torch.core.tuning import tune
from repro_torch.models.params import params_from_jax
from repro_torch.serving import Request, ServeEngine, Tracer, zipf_trace

ARCH = "deepseek-7b-smoke"
TIGHT = "bench:serve-tight"
quiet = lambda *a, **k: None  # noqa: E731


def _tight_spec(module):
    """The serving benchmark's budget target: ~3.5 contiguous slots x 128
    of KV on top of the weights (benchmarks/serving_throughput.py)."""
    cfg = ref_config(ARCH)
    param_bytes = 2 * param_count_estimate(cfg)
    kv_budget = 3.5 * kv_bytes_per_token(cfg) * 128
    return module.TargetSpec(
        name=TIGHT, chip="cpu", mesh_shape=(1,), mesh_axes=("data",),
        peak_flops=5e10, hbm_bw=2e10,
        hbm_bytes=(param_bytes + kv_budget) / 0.85, ici_bw=1e9,
        scheduler="local", kernels="reference")


@pytest.fixture(scope="module", autouse=True)
def tight_target():
    for module in (ref_target, port_target):
        if TIGHT not in module.TARGETS:
            module.register(_tight_spec(module))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread while this module runs: the smoke model's steps
    are thousands of tiny ops, and with the suite's workers sharing the
    cores, OpenMP's barriers across threads cost more than the ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engines(**kw):
    """(reference engine, port gather engine, port kernel-dispatch engine)
    sharing the reference's weights."""
    ref = RefEngine(arch=ARCH, seed=0, kv_layout="paged", log=quiet, **kw)
    params = params_from_jax(jax.tree.map(np.asarray, ref.params))
    ports = []
    for kv_kernel in ("gather", "cuda"):
        eng = ServeEngine(arch=ARCH, seed=0, kv_kernel=kv_kernel, log=quiet,
                          device="cpu", **kw)
        eng.params = params
        ports.append(eng)
    return ref, *ports


@pytest.fixture(scope="module")
def bench():
    return _engines(target=TIGHT, num_slots=8, max_len=128)


@pytest.fixture(scope="module")
def scarce():
    return _engines(num_slots=4, max_len=64, page_size=8, num_pages=13)


def _streams(stats):
    return [r.tokens for r in sorted(stats.results, key=lambda r: r.rid)]


def _counts(stats):
    return {"decode_steps": stats.decode_steps,
            "tokens_per_step": round(
                stats.generated_tokens / max(stats.decode_steps, 1), 4),
            "generated_tokens": stats.generated_tokens,
            "preemptions": stats.preemptions,
            "peak_active": stats.peak_active,
            "peak_resident_tokens": stats.peak_resident_tokens,
            "mean_ttft_steps": stats.mean_ttft_steps,
            "prefill_chunks": stats.prefill_chunks,
            "prefill_tokens": stats.prefill_tokens,
            "overlap_steps": stats.overlap_steps,
            "occupancy": stats.occupancy}


def _check_equal(ref_stats, port_stats):
    assert _streams(port_stats) == _streams(ref_stats)
    assert _counts(port_stats) == _counts(ref_stats)
    assert port_stats.prefill_buckets == ref_stats.prefill_compiles
    assert [r.preemptions for r in port_stats.results] == \
        [r.preemptions for r in ref_stats.results]


@pytest.mark.parametrize("policy,prefill_chunk", [
    ("continuous", 0), ("static", 0), ("continuous", None)])
def test_bench_trace_matches_reference(bench, policy, prefill_chunk):
    ref, port, _ = bench
    assert (port.num_slots, port.num_pages, port.page_size) == \
        (ref.num_slots, ref.num_pages, ref.page_size)
    args = dict(n=12, vocab_size=256, max_prompt=48, max_new=32, alpha=1.3,
                seed=0)
    want = ref.run(ref_zipf(**args), policy=policy,
                   prefill_chunk=prefill_chunk)
    got = port.run(zipf_trace(**args), policy=policy,
                   prefill_chunk=prefill_chunk)
    _check_equal(want, got)
    if prefill_chunk == 0:
        # BENCH_serving.json's paged_static / paged_continuous cells
        assert _counts(got)["decode_steps"] == 31
        assert _counts(got)["tokens_per_step"] == 6.2581


def test_preemption_trace_matches_reference(scarce):
    ref, port, _ = scarce
    args = dict(n=12, vocab_size=256, max_prompt=24, max_new=32, seed=3)
    want = ref.run(ref_zipf(**args))
    got = port.run(zipf_trace(**args))
    assert got.preemptions > 0
    _check_equal(want, got)


@pytest.mark.parametrize("case", ["bench", "scarce"])
def test_kernel_dispatch_token_identical_to_gather(request, case):
    _, gather, kernel = request.getfixturevalue(case)
    assert (gather.kv_kernel, kernel.kv_kernel) == ("gather", "cuda")
    n, max_prompt, seed = (12, 48, 0) if case == "bench" else (12, 24, 3)
    trace = zipf_trace(n, 256, max_prompt=max_prompt, max_new=32, seed=seed)
    a, b = gather.run(trace), kernel.run(trace)
    assert _streams(a) == _streams(b)
    assert _counts(a) == _counts(b)


@pytest.mark.parametrize("target,slots,max_len,replicas,rep", [
    ("local:cpu", 8, 128, 1, 0.0), ("local:cpu", 4, 64, 1, 0.0),
    ("local:cpu", 8, 512, 3, 0.0), ("local:cpu", 2, 256, 1, 0.9),
    (TIGHT, 8, 128, 1, 0.0)])
def test_serve_plan_matches_reference(target, slots, max_len, replicas, rep):
    for arch in ("deepseek-7b-smoke", "deepseek-7b"):
        overrides = dict(seq_len=max_len, global_batch=slots * replicas,
                         serve_replicas=replicas, serve_repetitiveness=rep)
        want = ref_tune(ref_config(arch),
                        dataclasses.replace(REF_SHAPES["decode_32k"],
                                            **overrides),
                        ref_target.get_target(target))
        got = tune(get_config(arch),
                   dataclasses.replace(SHAPES["decode_32k"], **overrides),
                   port_target.get_target(target))
        for field in dataclasses.fields(got):
            if field.name.startswith("serve_") or field.name in (
                    "microbatches", "remat_policy", "kernels",
                    "sequence_parallel"):
                assert getattr(got, field.name) == \
                    getattr(want, field.name), (arch, field.name)


def test_configs_match_reference_field_for_field():
    for arch in ARCHS:
        port, ref = get_config(arch), ref_config(arch)
        for field in dataclasses.fields(port):
            a, b = getattr(port, field.name), getattr(ref, field.name)
            if field.name.endswith("_dtype"):
                assert str(a).split(".")[-1] == np.dtype(b).name
            else:
                assert a == b, (arch, field.name)


def test_h100_target_picks_the_cuda_kernel():
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=512,
                                global_batch=8)
    h100 = port_target.get_target("nvidia:h100")
    plan = tune(get_config("deepseek-7b"), shape, h100)
    assert (plan.kernels, plan.serve_kv_kernel) == ("cuda", "cuda")
    assert (plan.serve_num_pages, plan.serve_page_size,
            plan.serve_prefill_chunk) == (257, 16, 128)
    assert h100.smem_bytes == 232_448 and h100.peak_flops == 989e12
    assert tune(get_config("deepseek-7b"), shape,
                port_target.get_target("local:cpu")).serve_kv_kernel == \
        "gather"
    eng = ServeEngine(arch=ARCH, target="nvidia:h100", device="cpu",
                      log=quiet)
    assert eng.kv_kernel == "cuda"


def test_unported_options_raise():
    """Tracing raises; the prefix cache is served on the paged layout and
    refused (ValueError) on the contiguous one; the contiguous layout,
    spec decoding (explicit or the tuner's pick) and sampled requests are
    served."""
    def engine(**kw):
        return ServeEngine(arch=ARCH, device="cpu", log=quiet, **kw)
    with pytest.raises(ValueError, match="paged"):
        engine(prefix_cache=True, kv_layout="contiguous")
    assert engine(prefix_cache=True).make_pool().prefix_cache is not None
    for kw in (dict(kv_layout="contiguous"), dict(spec_k=2),
               dict(spec_k=None, repetitiveness=0.9)):
        engine(**kw)
    assert engine(spec_k=None, repetitiveness=0.9).spec_k > 0
    with pytest.raises(ValueError):
        engine(kv_layout="contiguous", kv_kernel="cuda")
    assert tune(get_config(ARCH), SHAPES["train_4k"],
                port_target.get_target("local:cpu")).optimizer == "adamw"
    eng = engine(num_slots=2, max_len=32)
    sampled = Request(rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                      max_new_tokens=2, temperature=0.7)
    assert eng.run([sampled]).generated_tokens == 2
    with pytest.raises(ValueError, match="top_k"):
        eng.run([dataclasses.replace(sampled, top_k=65)])
    tracer = Tracer()
    traced = eng.run([sampled], tracer=tracer)
    assert traced.results[0].tokens == eng.run([sampled]).results[0].tokens
    assert [s.phase for s in tracer.spans] == ["queued", "prefill_chunk",
                                               "decode"]
    assert eng.run([dataclasses.replace(sampled, top_k=1)]).generated_tokens \
        == 2
