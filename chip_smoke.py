#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device and build — the card's name and power limit, the torch/CUDA
   versions, and an ``nvcc`` build of every kernel in
   ``src/repro_torch/kernels/csrc`` for sm_90a;
2. every kernel against its plain PyTorch version on the card: a sweep
   of the paged-decode attention kernel (G in {1, 4}, shuffled page
   tables, lengths 0 / 1 / page boundary / full, a poisoned junk page 0)
   and of the RMSNorm kernel, plus both at the full-width main-path
   shapes;
3. stream identity at smoke size: ``deepseek-7b-smoke`` served through
   ``ServeEngine`` on the serving benchmark's trace (continuous and
   static batching, blocking and chunked prefill) and on a scarce-page
   trace that preempts, with the paged kernel and with the gather path —
   identical greedy streams, and the benchmark's scheduling counts;
4. the slice at full width: ``deepseek-7b`` (random weights from a seed)
   on one card, 8 greedy requests through the paged engine built with
   its defaults, with both kernels on every step, counted; then the same
   run teacher-forced, each tick's logits held against the gather path's
   on the same pool, and a free-running gather run whose streams are
   compared;
5. numbers (printed, nothing gated on them): kernel, plain-version and
   library-call times at the main-path shapes (RMSNorm's on the device,
   from a CUDA graph), the full-width decode tick, the chunked-prefill
   step and end-to-end tokens/s.

The second-to-last line of output is the card's ``name, power.limit``;
before it a JSON line lists every kernel with its launches on the
full-width run, error, times and bound; the last line is the ok JSON.
Without a CUDA device, or outside a checkout of the repository, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# bf16 tolerance of a kernel against its plain version (the reference's
# own paged-kernel tolerance, tests/test_kernels_paged.py): both round
# once to bf16 after f32 math summed in another order
KERNEL_ATOL = KERNEL_RTOL = 2e-2
# every decode tick's logits of the live slots, kernel vs gather at full
# width on the same pool.  Each K1 call must stay within what two bf16
# roundings of its probabilities and output allow; 30 random-weight
# layers then carry such differences to several percent of the largest
# logit.  The control measures that: the gather path with one bf16 step
# of noise at as many attention outputs as the kernel changed.  The
# kernel's worst tick may exceed the control's worst by at most this
# factor.
LOGITS_VS_CONTROL = 2.0
# H100 SXM data sheet: device memory rate and f32 rate outside the
# tensor cores (the kernels here run on CUDA cores in f32)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _timed(fn, *args, **kw):
    """(fn's result, host seconds it took) — advisory set-up timings."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def _events_ms(torch, fn, n: int, flush=None) -> float:
    """Mean device ms of ``fn`` over ``n`` runs after warm-up.  With
    ``flush``, each run is timed alone after evicting the L2 cache."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if flush is None:
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n
    total = 0.0
    for _ in range(n):
        flush()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / n


def _graph_ms(torch, fn, n: int) -> float:
    """Device ms per call of ``fn``: ``n`` calls captured in one CUDA graph
    and replayed, so the host's cost per call is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return _events_ms(torch, graph.replay, 10) / n


def _profile_ticks(torch, card: str, tick, n: int) -> None:
    """Where a decode tick's time goes: host wall time of ``n`` ticks
    against the device time the profiler attributes to kernels, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    def ticks():
        for _ in range(n):
            tick()
        torch.cuda.synchronize()
    ticks()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_s = _timed(ticks)
    # the kernels themselves (device-side events): host-side ops also
    # carry the device time of what they launched, which would count twice
    events = [e for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU]

    def device_us(e):
        return e.self_device_time_total
    busy_us = sum(device_us(e) for e in events)
    wall_us = wall_s * 1e6
    if busy_us <= 0:
        print(f"[profile] {card} decode tick: host {wall_us / n / 1e3:.3f} "
              f"ms; device time not measured (the profiler saw no device "
              f"activity)")
        return
    print(f"[profile] {card} decode tick: host {wall_us / n / 1e3:.3f} ms, "
          f"device busy {busy_us / n / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / wall_us:.3f} (profiler on)")
    for e in sorted(events, key=device_us, reverse=True)[:8]:
        print(f"[profile]   {device_us(e) / n / 1e3:8.3f} ms/tick "
              f"{e.count // n:5d} calls/tick  {e.key[:70]}")


def _paged_case(torch, rng, lens, page_size, max_pages, K, G, dh,
                num_pages=None, poison=1e4):
    """Pool, shuffled page table and lengths holding ``lens`` tokens per
    slot (0 = freed slot: zeroed row); junk page 0 filled with
    ``poison``."""
    slots = len(lens)
    held = [min(-(-n // page_size), max_pages) if n else 0 for n in lens]
    num_pages = num_pages or sum(held) + 1
    order = rng.permutation(range(1, num_pages))
    table = torch.zeros((slots, max_pages), dtype=torch.int32)
    i = 0
    for s, h in enumerate(held):
        table[s, :h] = torch.as_tensor(order[i:i + h], dtype=torch.int32)
        i += h
    dev = "cuda"
    q = torch.randn((slots, K * G, dh), device=dev).to(torch.bfloat16)
    kp = torch.randn((num_pages, page_size, K, dh), device=dev).to(torch.bfloat16)
    vp = torch.randn((num_pages, page_size, K, dh), device=dev).to(torch.bfloat16)
    kp[0] = poison
    vp[0] = poison
    return (q, kp, vp, table.to(dev),
            torch.as_tensor(lens, dtype=torch.int32, device=dev))


def _rounding_diff(torch, ref, args, got) -> dict:
    """How far the paged kernel's output ``got`` is from the plain
    version's on the same ``args``, against the most two bf16 roundings
    of every probability and of the output can make them differ:
    |got - want| <= 2^-7 (sum_t p_t |v_t| + |want|) elementwise (one bf16
    step is at most 2^-7 of the value it rounds).  Returns the largest
    ratio of the difference to that bound, the largest difference in bf16
    steps of the output, the largest absolute difference and the
    fraction of outputs that differ."""
    q, kp, vp, table, kv_len = args
    want = ref.paged_attention_ref(*args).float()
    # the same probabilities over |v|: sum_t p_t |v_t| per output column
    spread = ref.paged_attention_ref(q, kp, vp.abs(), table, kv_len).float()
    g = got.float()
    diff = (g - want).abs()
    bound = 2.0 ** -7 * (spread * (1 + 2.0 ** -7) + want.abs()) + 1e-6
    exp = torch.frexp(torch.maximum(g.abs(), want.abs())).exponent
    steps = diff / torch.ldexp(torch.ones_like(diff), exp - 8)
    return {"ratio": float((diff / bound).max()), "ulps": float(steps.max()),
            "abs": float(diff.max()),
            "frac": float((diff > 0).float().mean())}


def _one_step_noise(torch, out, frac, gen):
    """bf16 ``out`` with one bf16 step up or down at a random ``frac`` of
    its nonzero elements."""
    pick = (torch.rand(out.shape, generator=gen, device=out.device) < frac) \
        & (out != 0)
    up = torch.rand(out.shape, generator=gen, device=out.device) < 0.5
    step = torch.where(up, 1, -1).to(torch.int16) * pick
    return (out.view(torch.int16) + step).view(torch.bfloat16)


def _check_close(name, got, want, atol, rtol) -> float:
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    if not bool((err <= lim).all()):
        raise AssertionError(f"{name}: max abs err {err.max().item():.4g} "
                             f"over atol {atol} + rtol {rtol}")
    return float(err.max().item())


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.target import TargetSpec, get_target, register
    from repro_torch.core.tuning import (kv_bytes_per_token,
                                         param_count_estimate, tune)
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.serving import Request, ServeEngine, zipf_trace
    from repro_torch.training.steps import build_decode_step_slots_paged

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    card = f"[{smi}]"

    # ---- 1. device and build -------------------------------------------
    props = torch.cuda.get_device_properties(0)
    print(f"[device] {smi} | {props.name}, {props.multi_processor_count} SMs,"
          f" {props.total_memory / 1e9:.1f} GB | torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    logs, build_s = _timed(_build.build)
    print(f"[build] nvcc {', '.join(sorted(logs)) or '(already built)'} for "
          f"sm_90a in {build_s:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions -----------------------
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    k1_err = 0.0
    for G in (1, 4):
        for lens in ([0, 1, 16, 37, 64], [64, 2, 32, 0]):
            case = _paged_case(torch, rng, lens, 16, 4, 2, G, 128)
            got = paged_attention_cuda(*case)
            want = ref.paged_attention_ref(*case)
            k1_err = max(k1_err, _check_close(
                f"paged_attention G={G} lens={lens}", got, want,
                KERNEL_ATOL, KERNEL_RTOL))
            freed = [i for i, n in enumerate(lens) if n == 0]
            if bool(got[freed].ne(0).any()):
                raise AssertionError("freed slot did not write exact zeros")
            q, kp, vp, table, kv_len = case
            kp[0], vp[0] = -3e4, 5e3          # re-poison the junk page
            again = paged_attention_cuda(q, kp, vp, table, kv_len)
            if not torch.equal(got, again):
                raise AssertionError("output depends on the junk page 0")
    # a freed row with a stale nonzero length: still exact zeros
    q, kp, vp, table, kv_len = _paged_case(torch, rng, [24, 13, 7], 16, 2, 2,
                                           2, 128)
    table[1] = 0
    if bool(paged_attention_cuda(q, kp, vp, table, kv_len)[1].ne(0).any()):
        raise AssertionError("stale-length freed slot read the junk page")

    # the full-width main-path shapes: the tuner's pool for deepseek-7b on
    # one H100 with 8 slots x 512, slots mid-generation
    full = get_config("deepseek-7b")
    plan = tune(full, dataclasses.replace(SHAPES["decode_32k"], seq_len=512,
                                          global_batch=8),
                get_target("nvidia:h100"))
    prng = np.random.RandomState(0)
    plens = prng.randint(64, 385, size=8)
    main_lens = [int(n) + 16 for n in plens]
    k1_main = _paged_case(torch, rng, main_lens, plan.serve_page_size,
                          512 // plan.serve_page_size, full.num_kv_heads,
                          full.num_heads // full.num_kv_heads, full.head_dim,
                          num_pages=plan.serve_num_pages)
    k1_err = max(k1_err, _check_close(
        "paged_attention main path", paged_attention_cuda(*k1_main),
        ref.paged_attention_ref(*k1_main), KERNEL_ATOL, KERNEL_RTOL))
    print(f"[kernels] paged_attention vs plain: max abs err {k1_err:.4g} "
          f"(atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}), junk page ignored, "
          f"freed slots exact zeros")

    k2_err = 0.0
    d = full.d_model
    w = (1 + 0.1 * torch.randn(d, device="cuda")).to(torch.bfloat16)
    for rows in (1, 8, 128, 1000):
        x = (3 * torch.randn((rows, d), device="cuda")).to(torch.bfloat16)
        k2_err = max(k2_err, _check_close(
            f"rmsnorm rows={rows}", rmsnorm_cuda(x, w), ref.rmsnorm_ref(x, w),
            KERNEL_ATOL, KERNEL_RTOL))
    x32 = 300 * torch.randn((8, d), device="cuda")
    k2_err = max(k2_err, _check_close(
        "rmsnorm f32 input", rmsnorm_cuda(x32, w, out_dtype=torch.bfloat16),
        ref.rmsnorm_ref(x32, w, out_dtype=torch.bfloat16),
        KERNEL_ATOL, KERNEL_RTOL))
    print(f"[kernels] rmsnorm vs plain (rows 1/8/128/1000 x {d}, bf16 and "
          f"f32 input): max abs err {k2_err:.4g}")

    # ---- 3. stream identity at smoke size ------------------------------
    smoke = get_config("deepseek-7b-smoke")
    param_bytes = 2 * param_count_estimate(smoke)
    kv_budget = 3.5 * kv_bytes_per_token(smoke) * 128
    register(TargetSpec(
        name="bench:serve-tight", chip="cuda", mesh_shape=(1,),
        mesh_axes=("data",), peak_flops=5e10, hbm_bw=2e10,
        hbm_bytes=(param_bytes + kv_budget) / 0.85, ici_bw=1e9,
        scheduler="local", kernels="reference",
        description="the serving benchmark's tight budget (3 contiguous "
                    "slots x 128)"))
    quiet = lambda *a, **k: None  # noqa: E731

    def smoke_pair(**kw):
        return {kk: ServeEngine(arch="deepseek-7b-smoke", seed=0, kv_kernel=kk,
                                log=quiet, **kw) for kk in ("cuda", "gather")}

    def same_streams(eng, trace, what, **run):
        st = {kk: e.run(trace, **run) for kk, e in eng.items()}
        streams = {kk: [r.tokens for r in s.results] for kk, s in st.items()}
        if streams["cuda"] != streams["gather"]:
            raise AssertionError(f"smoke streams differ ({what}): kernel vs "
                                 f"gather")
        return st["cuda"]

    eng = smoke_pair(target="bench:serve-tight", num_slots=8, max_len=128)
    trace = zipf_trace(12, smoke.vocab_size, max_prompt=48, max_new=32,
                       alpha=1.3, seed=0)
    for policy, chunk in (("continuous", 0), ("static", 0),
                          ("continuous", None)):
        s = same_streams(eng, trace, f"{policy}, prefill_chunk={chunk}",
                         policy=policy, prefill_chunk=chunk)
        tps = round(s.generated_tokens / s.decode_steps, 4)
        if chunk == 0 and (s.decode_steps, tps) != (31, 6.2581):
            raise AssertionError(f"smoke schedule {s.decode_steps} steps, "
                                 f"{tps} tokens/step != 31, 6.2581")
    # scarce pages: the preemption trace of tests/test_serving_paged.py
    # (under the CPU target's plan, as the CPU tests run this trace)
    eng = smoke_pair(target="local:cpu", num_slots=4, max_len=64,
                     page_size=8, num_pages=13)
    s = same_streams(eng, zipf_trace(12, smoke.vocab_size, max_prompt=24,
                                     max_new=32, seed=3), "preemption")
    if s.preemptions == 0:
        raise AssertionError("the scarce-page trace did not preempt")
    print(f"[smoke] deepseek-7b-smoke: kernel == gather streams on the "
          f"benchmark trace (continuous and static, blocking and chunked "
          f"prefill; 31 decode steps, 6.2581 tokens/step) and under "
          f"{s.preemptions} preemptions")
    del eng

    # ---- 4. the slice at full width ------------------------------------
    reqs = [Request(rid=i, prompt=prng.randint(1, full.vocab_size - 1,
                                               size=(int(n),)).astype(np.int32),
                    max_new_tokens=32)
            for i, n in enumerate(plens)]

    def make_engine(**kw):
        return ServeEngine(arch="deepseek-7b", kv_layout="paged", num_slots=8,
                           max_len=512, seed=0, log=quiet, **kw)

    # every argument but the model's at its default: the card's own target
    eng_k, init_s = _timed(make_engine)
    if (eng_k.plan.target, eng_k.kv_kernel) != ("nvidia:h100", "cuda"):
        raise AssertionError(f"the default engine on the card took target "
                             f"{eng_k.plan.target!r}, kv_kernel "
                             f"{eng_k.kv_kernel!r}")
    print(f"[full] deepseek-7b on {card}: {eng_k.num_slots} slots, "
          f"{eng_k.num_pages} pages x {eng_k.page_size}, chunk "
          f"{eng_k.prefill_chunk}, engine built in {init_s:.1f} s")
    paged_attention_cuda.launches = 0
    rmsnorm_cuda.launches = 0
    st_k = eng_k.run(reqs)
    launches = {"paged_attention": paged_attention_cuda.launches,
                "rmsnorm": rmsnorm_cuda.launches}
    ticks, chunks = st_k.decode_steps, st_k.prefill_chunks
    want = {"paged_attention": full.num_layers * ticks,
            "rmsnorm": (2 * full.num_layers + 1) * (ticks + chunks)}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want}")
    for r, q_ in zip(st_k.results, reqs):
        if len(r.tokens) != q_.max_new_tokens or \
                not all(0 <= t < full.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.rid}: {len(r.tokens)} tokens, "
                                 f"range {min(r.tokens)}..{max(r.tokens)}")
    # teacher forcing: the kernel run again.  Every K1 call is held
    # against the plain version on its own inputs, and every tick is also
    # run on copies of the same pool, tokens and page table (a) through
    # the gather path and (b) through the gather path with one bf16 step
    # of noise at as many attention outputs as the kernel changed (the
    # control: how far the model carries rounding-sized differences).
    # Logit differences cannot compound across ticks.
    gather_step = build_decode_step_slots_paged(eng_k.model, use_kernel=False)
    noisy_step = build_decode_step_slots_paged(eng_k.model, use_kernel=True)
    kernel_step = eng_k._decode
    attend = ops.paged_attention
    noise = torch.Generator(device="cuda").manual_seed(0)
    tf, calls = [], []           # one record per decode tick / per K1 call

    def held(*args):
        got = attend(*args)
        calls.append(_rounding_diff(torch, ref, args, got))
        return got

    def teacher_forced(params, cache, tokens, active, pages):
        copies = [{n: t.clone() for n, t in cache.items()} for _ in range(2)]
        n0 = len(calls)
        ops.paged_attention = held
        try:
            out = kernel_step(params, cache, tokens, active, pages)
        finally:
            ops.paged_attention = attend
        frac = sum(c["frac"] for c in calls[n0:]) / (len(calls) - n0)
        want = gather_step(params, copies[0], tokens, active, pages)[0]
        ops.paged_attention = lambda *a: _one_step_noise(
            torch, ref.paged_attention_ref(*a), frac, noise)
        try:
            ctrl = noisy_step(params, copies[1], tokens, active, pages)[0]
        finally:
            ops.paged_attention = attend
        # live rows only: a dead row's logits are discarded
        live = active.bool()
        got, want, ctrl = (t[live].float() for t in (out[0], want, ctrl))
        flips = got.argmax(-1) != want.argmax(-1)
        # how far the gather path's own pick stands above the kernel's
        # pick where the two differ: a near tie if within the diff
        gap = (want.amax(-1) - want.gather(
            -1, got.argmax(-1, keepdim=True))[..., 0])[flips]
        scale = float(want.abs().max())
        tf.append(dict(live=int(live.sum()), frac=frac,
                       rel=float((got - want).abs().max()) / scale,
                       ctrl=float((ctrl - want).abs().max()) / scale,
                       flips=int(flips.sum()),
                       gap=float(gap.max()) if gap.numel() else 0.0,
                       finite=bool(torch.isfinite(got).all())))
        return out
    eng_k._decode = teacher_forced
    st_tf = eng_k.run(reqs)
    eng_k._decode = kernel_step
    if not all(t["finite"] for t in tf):
        raise AssertionError("non-finite logits")
    full_ticks = sum(t["live"] == len(reqs) for t in tf)
    same = [r.tokens for r in st_tf.results] == \
        [r.tokens for r in st_k.results]
    nl = full.num_layers
    print(f"[full] {card} teacher-forced, {len(tf)} ticks ({full_ticks} "
          f"with all {len(reqs)} slots live): K1 vs plain on the main "
          f"path's own inputs, {len(calls)} calls: max "
          f"{max(c['ratio'] for c in calls):.4g} of the two-rounding bound, "
          f"{max(c['ulps'] for c in calls):.3g} bf16 steps, "
          f"{max(c['abs'] for c in calls):.4g} abs, outputs changed "
          f"{min(t['frac'] for t in tf):.3g}..{max(t['frac'] for t in tf):.3g}"
          f" per tick; per layer, max share of the bound "
          f"{[round(max(c['ratio'] for c in calls[i::nl]), 3) for i in range(nl)]}"
          f" and max abs "
          f"{[round(max(c['abs'] for c in calls[i::nl]), 4) for i in range(nl)]}")
    print(f"[full] {card} teacher-forced logits, max |diff| / max |logit| "
          f"per tick: kernel vs gather "
          f"{[round(t['rel'], 4) for t in tf]}; control (gather with "
          f"one-step noise) vs gather {[round(t['ctrl'], 4) for t in tf]}; "
          f"{sum(t['flips'] for t in tf)} of {sum(t['live'] for t in tf)} "
          f"greedy picks differ, the gather path's own pick above the "
          f"kernel's by at most {max(t['gap'] for t in tf):.4g}; the rerun "
          f"repeats the counted run's streams: {same}")
    if not full_ticks:
        raise AssertionError(f"no tick had all {len(reqs)} slots live")
    if max(c["ratio"] for c in calls) > 1:
        raise AssertionError("paged_attention on the main path differs from "
                             "its plain version by more than two bf16 "
                             "roundings allow")
    worst = max(tf, key=lambda t: t["rel"])
    ctrl = max(t["ctrl"] for t in tf)
    if worst["rel"] > LOGITS_VS_CONTROL * ctrl:
        raise AssertionError(f"teacher-forced logits differ by "
                             f"{worst['rel']:.4g} of max |logit| on a tick "
                             f"with {worst['live']} live rows > "
                             f"{LOGITS_VS_CONTROL} x the control's {ctrl:.4g}")

    eng_g = make_engine(kv_kernel="gather")
    st_g = eng_g.run(reqs)
    mism = sum(a != b for rk, rg in zip(st_k.results, st_g.results)
               for a, b in zip(rk.tokens, rg.tokens))
    # where each request's two free-running streams part
    first_diff = [next((i for i, (a, b) in enumerate(zip(rk.tokens,
                                                         rg.tokens))
                        if a != b), None)
                  for rk, rg in zip(st_k.results, st_g.results)]
    print(f"[full] {card} 8 requests x 32 tokens (prompts "
          f"{sorted(int(n) for n in plens)}): {ticks} decode ticks, {chunks} "
          f"prefill chunks, launches {launches}; free-running kernel vs "
          f"gather: {mism} of {8 * 32} stream tokens differ, first at token "
          f"{first_diff} per request")
    del eng_g
    torch.cuda.empty_cache()

    # ---- 5. numbers ------------------------------------------------------
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    q, kp, vp, table, kv_len = k1_main
    slots, H, dh = q.shape
    Kh = kp.shape[2]
    toks = int(kv_len.sum())
    k1_bytes = 2 * q.numel() * 2 + table.numel() * 4 + kv_len.numel() * 4 + \
        2 * toks * Kh * dh * 2
    k1_flops = 4 * H * dh * toks
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S, k1_flops / F32_FLOPS) * 1e3
    k1_ms = _events_ms(torch, lambda: paged_attention_cuda(*k1_main), 50, flush)
    # the plain version is the engine's gather path
    k1_plain = _events_ms(torch, lambda: ref.paged_attention_ref(*k1_main),
                          20, flush)
    T = table.shape[1] * kp.shape[1]
    kg = kp[table.long()].reshape(slots, T, Kh, dh).transpose(1, 2)
    vg = vp[table.long()].reshape(slots, T, Kh, dh).transpose(1, 2)
    mask = (torch.arange(T, device="cuda")[None] < kv_len[:, None])[:, None, None]
    k1_lib = _events_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kg, vg, attn_mask=mask), 50, flush)
    print(f"[numbers] {card} paged_attention {slots} slots x {H} heads x "
          f"{dh}, {toks} held tokens, L2 flushed: kernel {k1_ms:.4f} ms, "
          f"plain (the gather path) {k1_plain:.4f} ms, SDPA over "
          f"pre-gathered KV {k1_lib:.4f} ms, bound {k1_bound:.4f} ms "
          f"({k1_bytes / 1e6:.2f} MB)")

    # K2 is far shorter than its host call: device time per call from a
    # CUDA graph of back-to-back calls, host time per call beside it
    k2 = {}
    rms_norm = getattr(torch.nn.functional, "rms_norm", None)
    for rows in (8, 128):
        x = torch.randn((rows, d), device="cuda").to(torch.bfloat16)
        byt = 2 * rows * d * 2 + d * 2
        fns = {"ms": lambda: rmsnorm_cuda(x, w),
               "plain": lambda: ref.rmsnorm_ref(x, w)}
        if rms_norm:
            fns["lib"] = lambda: rms_norm(x, (d,), w, 1e-6)
        k2[rows] = {k: _graph_ms(torch, fn, 100) for k, fn in fns.items()}
        k2[rows].setdefault("lib", None)
        k2[rows]["host"] = _events_ms(torch, fns["ms"], 200)
        k2[rows]["bound"] = max(byt / HBM_BYTES_PER_S,
                                4 * rows * d / F32_FLOPS) * 1e3
        print(f"[numbers] {card} rmsnorm ({rows}, {d}) bf16, device ms per "
              f"call in a CUDA graph: kernel {k2[rows]['ms']:.5f} ms, plain "
              f"{k2[rows]['plain']:.5f} ms, F.rms_norm {k2[rows]['lib']} ms, "
              f"bound {k2[rows]['bound']:.5f} ms; kernel call back to back "
              f"from the host {k2[rows]['host']:.5f} ms")

    # decode tick / chunk step at full width on a pool mid-generation
    pool = eng_k.make_pool()
    for i, n in enumerate(main_lens):
        slot = pool.alloc()
        pool.reserve_prefix(slot, n)
        pool.set_length(slot, n - 1)
    pool.cache["index"].copy_(torch.as_tensor(pool.lengths, dtype=torch.int32))
    tok = torch.ones((8, 1), dtype=torch.int32, device="cuda")
    act = torch.ones((8,), dtype=torch.int32, device="cuda")
    pages = torch.as_tensor(pool.page_table, device="cuda")
    tick_k = _events_ms(torch, lambda: eng_k.decode_fn(
        pool.cache, tok, act, pages), 20)
    tick_g = _events_ms(torch, lambda: gather_step(
        eng_k.params, pool.cache, tok, act, pages), 20)
    ctoks = torch.ones((1, eng_k.prefill_chunk), dtype=torch.int32,
                       device="cuda")
    row = pages[0].contiguous()
    chunk_ms = _events_ms(torch, lambda: eng_k.chunk_fn(
        pool.cache, ctoks, 0, 0, eng_k.prefill_chunk, eng_k.prefill_chunk,
        row), 20)
    _profile_ticks(torch, card, lambda: eng_k.decode_fn(
        pool.cache, tok, act, pages), n=5)
    st_warm = eng_k.run(reqs)
    print(f"[numbers] {card} deepseek-7b decode tick (8 slots, "
          f"{sum(main_lens)} held tokens): {tick_k:.3f} ms with the kernel, "
          f"{tick_g:.3f} ms gather; chunked-prefill step "
          f"({eng_k.prefill_chunk} tokens): {chunk_ms:.3f} ms; end to end "
          f"{st_warm.generated_tokens} tokens in {st_warm.wall_s:.3f} s = "
          f"{st_warm.tokens_per_s:.1f} tokens/s ({st_warm.decode_steps} ticks, "
          f"{st_warm.prefill_chunks} chunks); peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:197",
         "launches": launches["paged_attention"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": "bytes" if k1_bytes / HBM_BYTES_PER_S >=
         k1_flops / F32_FLOPS else "operations",
         "library_ms": k1_lib},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:38",
         "launches": launches["rmsnorm"], "max_abs_err": k2_err,
         "ms": k2[8]["ms"], "plain_ms": k2[8]["plain"],
         "bound_ms": k2[8]["bound"], "bound_by": "bytes",
         "library_ms": k2[8]["lib"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
