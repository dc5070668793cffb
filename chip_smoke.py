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
   library-call times at the main-path shapes (device time per call from
   CUDA graphs: K1 and SDPA of flush + call pairs less the flushes alone,
   RMSNorm of back-to-back calls), the full-width decode tick, the
   chunked-prefill step and end-to-end tokens/s;
6. the Sedov stencil kernel against its plain version on the card: grids
   8, 13, 16, 24, 32, 64 and 256, each on a developed blast state and on
   a rough state (every zone different, so that every tile seam sees
   varied data), one step and ten, every zone of every field held to
   rtol 1e-6 (the kernel rounds as the plain version does); ten kernel
   steps also against ten oracle steps (n = 16 and 256);
7. the LULESH path at full size: ``run_easey`` deploys ``lulesh-dash``
   (``lulesh -i 1000 -s 256``) with the paper's Listing 1.5 job to
   ``nvidia:h100`` twice (the first run is warm-up); each run must end
   ``finished`` with exactly 1000 stencil launches, a batch file and a
   package that passes its integrity check, and a final state that
   passes the reference's blast-wave checks and equals 1000 plain fused
   steps zone by zone; one more kernel step on that state, where the
   wave has crossed many tiles on every axis, is held against the plain
   version;
8. LULESH numbers (printed, nothing gated on them): stencil, plain-step
   and CFL-reduction times at n = 256 against their bounds, the time per
   step of ``run``, the FOM of ``lulesh.run`` called directly and through
   ``run_easey`` (the same window: the state built before the clock
   starts), and how far the 1000-step kernel state is from 1000 oracle
   steps.

The second-to-last line of output is the card's ``name, power.limit``;
before it a JSON line lists every kernel with its launches on its path's
full-size run, error, times and bound; the last line is the ok JSON.
Without a CUDA device, or outside a checkout of the repository, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
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
# the stencil kernel (f32, built with -fmad=false) against its plain
# version: each zone of every field within this rtol, with no absolute
# slack, after any number of steps (each operation rounds once in both,
# in the same order).  Against the oracle step, whose order differs:
# scale-relative error per field after one step and after ten
# (tests/test_kernels_stencil.py)
STENCIL_ELEM_RTOL = 1e-6
STENCIL_TOL_1, STENCIL_TOL_10 = 1e-5, 1e-4
STENCIL_FIELDS = ("rho", "e", "v", "t")
# the LULESH run: the paper's Listing 1.5 at a single-GPU grid
LULESH_ITERS, LULESH_GRID = 1000, 256
# f32 operations of one fused step per zone (sedov_stencil.cu, counted
# once per zone: EOS 2, div 8, q 4, pq 1, 1/rho 2, momentum 15, div 8,
# energy 5, mass 4)
STENCIL_FLOPS_PER_ZONE = 49


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


def _graph_pairs_ms(torch, fn, flush, n: int) -> float:
    """Device ms per call of ``fn`` run on a cold L2: ``n`` (flush, fn)
    pairs in one CUDA graph, less ``n`` flushes alone in another, so
    neither the host's launch delay nor the flush is in the time."""
    return _graph_ms(torch, lambda: (flush(), fn()), n) - \
        _graph_ms(torch, flush, n)


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


def _rel_err(got, want) -> dict:
    """Scale-relative error per field: max |got - want| / max |want|."""
    return {f: float((got[f] - want[f]).abs().max()
                     / (want[f].abs().max() + 1e-12)) for f in STENCIL_FIELDS}


def _hold_zones(name, got, want) -> float:
    """Every zone of every field of a stencil state within
    STENCIL_ELEM_RTOL of the plain version's; the max abs error."""
    return max(_check_close(f"{name}: {f}", got[f], want[f], 0.0,
                            STENCIL_ELEM_RTOL) for f in STENCIL_FIELDS)


def _fused_run(ref, st, iters):
    """``iters`` plain fused steps: the CFL reduction, then the plain
    version of the stencil kernel (what ``ops.sedov_step_kernel`` does
    with the kernel)."""
    for _ in range(iters):
        st = ref.sedov_step_ref(st, ref.cfl_dt(st))
    return st


def _rough_state(np, lulesh, n, seed, device):
    """A state with every zone different (rho, e and v drawn from a seed),
    so that each tile seam sees varied data: a wrong neighbour there gives
    wrong numbers, where on the early blast's uniform gas it would give
    the same ones."""
    rng = np.random.default_rng(seed)
    return lulesh.state_from_numpy({
        "rho": rng.uniform(0.5, 2.0, (n, n, n)).astype(np.float32),
        "e": rng.uniform(5e3, 2e4, (n, n, n)).astype(np.float32),
        "v": rng.normal(0.0, 10.0, (3, n, n, n)).astype(np.float32),
        "t": np.float32(0.0)}, device)


def _stencil_checks(np, lulesh, ref, step_fn, grids, ten_grids,
                    device="cuda"):
    """The stencil kernel ``step_fn(state, dt)`` against its plain version
    on developed blast states and rough states: one step at each of
    ``grids``, ten at each of ``ten_grids``.  Raises on a difference;
    returns (max abs error, max scale-relative error, ten-step
    scale-relative error against the oracle per grid)."""
    def developed(n, warm):
        """A state after ``warm`` plain steps, taken through numpy as the
        tests take the reference's."""
        cfg = lulesh.LuleshConfig(grid=n)
        st = lulesh.run(lulesh.init_state(cfg, device), cfg, warm)
        return lulesh.state_from_numpy(lulesh.state_to_numpy(st), device)

    def kernel_run(st, iters):
        for _ in range(iters):
            st = step_fn(st, ref.cfl_dt(st))
        return st

    err, rel, ten = 0.0, 0.0, {}
    for i, n in enumerate(grids):
        for kind, st in (("developed", developed(n, i % 5)),
                         ("rough", _rough_state(np, lulesh, n, n, device))):
            dt = ref.cfl_dt(st)
            got, want = step_fn(st, dt), ref.sedov_step_ref(st, dt)
            err = max(err, _hold_zones(f"sedov_stencil n={n} {kind}, one "
                                       f"step", got, want))
            e1 = _rel_err(got, want)
            if max(e1.values()) > STENCIL_TOL_1:
                raise AssertionError(f"sedov_stencil n={n} {kind}, one step:"
                                     f" scale-relative error {e1} > "
                                     f"{STENCIL_TOL_1}")
            rel = max(rel, *e1.values())
    for n in ten_grids:
        cfg = lulesh.LuleshConfig(grid=n)
        for kind, st in (("developed", developed(n, 0)),
                         ("rough", _rough_state(np, lulesh, n, n, device))):
            got = kernel_run(st, 10)
            err = max(err, _hold_zones(f"sedov_stencil n={n} {kind}, ten "
                                       f"steps", got, _fused_run(ref, st, 10)))
            if kind == "developed":
                ten[n] = _rel_err(got, lulesh.run(st, cfg, 10))
                if max(ten[n].values()) > STENCIL_TOL_10:
                    raise AssertionError(f"sedov_stencil n={n}, ten steps "
                                         f"vs the oracle step: {ten[n]} > "
                                         f"{STENCIL_TOL_10}")
    return err, rel, ten


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.appspec import AppSpec
    from repro_torch.core.jobs import JobState
    from repro_torch.core.jobspec import lulesh_example, parse_jobspec
    from repro_torch.core.package import extract_package
    from repro_torch.core.target import TargetSpec, get_target, register
    from repro_torch.core.tuning import (kv_bytes_per_token,
                                         param_count_estimate, tune)
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.core.workflow import run_easey
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.kernels.sedov_stencil import sedov_step_cuda
    from repro_torch.models import lulesh
    from repro_torch.serving import Request, ServeEngine, zipf_trace
    from repro_torch.training.steps import build_decode_step_slots_paged

    wrappers = {"paged_attention": paged_attention_cuda,
                "rmsnorm": rmsnorm_cuda, "sedov_stencil": sedov_step_cuda}

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

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
    reset_counts()
    st_k = eng_k.run(reqs)
    launches = counts()
    ticks, chunks = st_k.decode_steps, st_k.prefill_chunks
    want = {"paged_attention": full.num_layers * ticks,
            "rmsnorm": (2 * full.num_layers + 1) * (ticks + chunks),
            "sedov_stencil": 0}
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
    k1_ms = _graph_pairs_ms(torch, lambda: paged_attention_cuda(*k1_main),
                            flush, 50)
    # the plain version is the engine's gather path
    k1_plain = _events_ms(torch, lambda: ref.paged_attention_ref(*k1_main),
                          20, flush)
    T = table.shape[1] * kp.shape[1]
    kg = kp[table.long()].reshape(slots, T, Kh, dh).transpose(1, 2)
    vg = vp[table.long()].reshape(slots, T, Kh, dh).transpose(1, 2)
    mask = (torch.arange(T, device="cuda")[None] < kv_len[:, None])[:, None, None]
    k1_lib = _graph_pairs_ms(
        torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kg, vg, attn_mask=mask), flush, 50)
    print(f"[numbers] {card} paged_attention {slots} slots x {H} heads x "
          f"{dh}, {toks} held tokens, L2 flushed: kernel {k1_ms:.4f} ms and "
          f"SDPA over pre-gathered KV {k1_lib:.4f} ms (device, CUDA graph "
          f"of flush + call pairs less the flushes), plain (the gather "
          f"path, CUDA events) {k1_plain:.4f} ms, bound {k1_bound:.4f} ms "
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

    # ---- 6. the stencil against its plain version ------------------------
    grids = (8, 13, 16, 24, 32, 64, LULESH_GRID)
    k4_err, k4_rel, ten = _stencil_checks(np, lulesh, ref, sedov_step_cuda,
                                          grids, (16, LULESH_GRID))
    print(f"[kernels] sedov_stencil vs plain, developed and rough states, one "
          f"step at n = {grids} and ten at n = {tuple(ten)}: every zone of "
          f"every field within rtol {STENCIL_ELEM_RTOL} (max abs "
          f"{k4_err:.4g}); one step max scale-relative error {k4_rel:.4g} "
          f"(limit {STENCIL_TOL_1}); ten kernel steps vs ten oracle steps: "
          f"{ {n: round(max(e.values()), 10) for n, e in ten.items()} } "
          f"(limit {STENCIL_TOL_10})")

    # ---- 7. the LULESH path at full size ---------------------------------
    iters, n = LULESH_ITERS, LULESH_GRID
    cmd = (f"ch-run -b ./data:/data lulesh.dash -- /built/lulesh.dash "
           f"-i {iters} -s {n}")
    app = AppSpec(arch="lulesh-dash", shape="train_4k",
                  run=f"lulesh -i {iters} -s {n}")
    easey = []
    with tempfile.TemporaryDirectory(prefix="easey_") as storage:
        for run_i in range(2):                 # the first run is warm-up
            job = lulesh_example()
            job["execution"][0]["mpi"]["command"] = cmd
            spec = parse_jobspec(job)
            root = Path(storage) / f"run{run_i}"
            reset_counts()
            (mw, jid, res), wall_s = _timed(run_easey, app, "nvidia:h100",
                                            spec, storage=root)
            got_counts = counts()
            state = mw.status(jid)
            if state is not JobState.FINISHED:
                raise AssertionError(f"EASEY run {run_i}: job {state.value}"
                                     f":\n{mw.logs(jid)[1]}")
            want = {"paged_attention": 0, "rmsnorm": 0,
                    "sedov_stencil": iters}
            if got_counts != want:
                raise AssertionError(f"EASEY run {run_i}: kernel launches "
                                     f"{got_counts} != {want}")
            workdir = root / "cluster" / spec.job_id
            if f"srun --ntasks=2197 {cmd}" not in \
                    (workdir / "batch.sh").read_text():
                raise AssertionError("batch.sh lacks the job's command")
            pkgs = list((root / "packages").glob("*.easey.tar"))
            if len(pkgs) != 1:
                raise AssertionError(f"packages written: {pkgs}")
            manifest = extract_package(pkgs[0], workdir / "check")
            if (res.plan.kernels, set(res.built), manifest["step"]) != \
                    ("cuda", {"sedov_stencil"}, "sedov_step"):
                raise AssertionError(f"build: kernels {res.plan.kernels}, "
                                     f"built {res.built}, step "
                                     f"{manifest['step']}")
            out = mw.scheduler.result(jid)[0]
            if (out["device"], out["kernels"]) != ("cuda", "cuda"):
                raise AssertionError(f"ran on {out['device']} with "
                                     f"{out['kernels']}")
            easey.append(out)
            print(f"[lulesh] {card} run_easey {run_i} "
                  f"({'warm-up' if run_i == 0 else 'measured'}): "
                  f"{state.value}, {got_counts['sedov_stencil']} stencil "
                  f"launches, build {res.timings.get('build_s', 0.0):.2f} s, "
                  f"run {out['seconds']:.4f} s, FOM {out['fom']:.1f} "
                  f"zone-iterations/s, whole deployment {wall_s:.2f} s")
    launches["sedov_stencil"] = got_counts["sedov_stencil"]
    fin = easey[-1]["state"]
    del easey[0]["state"]
    # the reference's blast-wave checks (tests/test_models_smoke.py)
    if not all(bool(torch.isfinite(fin[f]).all()) for f in ("rho", "e", "v")):
        raise AssertionError("non-finite LULESH state")
    if not (float(fin["e"][1, 0, 0]) > 1e3 and
            float((fin["rho"] - 1.0).abs().max()) > 1e-3 and
            float(fin["t"]) > 0):
        raise AssertionError(f"blast wave: e[1,0,0] {float(fin['e'][1, 0, 0])}"
                             f", max |rho - 1| "
                             f"{float((fin['rho'] - 1.0).abs().max())}, t "
                             f"{float(fin['t'])}")
    # how far the wave has gone along each axis: the last plane with v != 0
    moving = (fin["v"] != 0).any(0)
    reach = [int(m.nonzero().max()) for m in (
        moving.any(2).any(1), moving.any(2).any(0), moving.any(1).any(0))]
    # the kernel on the developed full-size state, and the whole run
    # against as many plain fused steps, zone by zone
    dt = ref.cfl_dt(fin)
    k4_err = max(k4_err, _hold_zones(
        f"sedov_stencil n={n} after {iters} steps, one step",
        sedov_step_cuda(fin, dt), ref.sedov_step_ref(fin, dt)))
    fused_fin = _fused_run(ref, lulesh.init_state(lulesh.LuleshConfig(
        grid=n), "cuda"), iters)
    k4_err = max(k4_err, _hold_zones(
        f"{iters} kernel steps vs {iters} plain fused steps", fin, fused_fin))
    del fused_fin
    print(f"[lulesh] {card} final state after {iters} steps on {n}^3: "
          f"finite, e[1,0,0] {float(fin['e'][1, 0, 0]):.6g}, max |rho - 1| "
          f"{float((fin['rho'] - 1.0).abs().max()):.6g}, t "
          f"{float(fin['t']):.6g}, v != 0 up to index {reach} along axes "
          f"0/1/2 (tiles 8 x 8 x 32); equal to {iters} plain fused steps "
          f"and one more kernel step equal to the plain one, every zone "
          f"within rtol {STENCIL_ELEM_RTOL}")

    # ---- 8. LULESH numbers -----------------------------------------------
    cfg = lulesh.LuleshConfig(grid=n)
    zones = n ** 3
    dt = ref.cfl_dt(fin)
    k4_ms = _events_ms(torch, lambda: sedov_step_cuda(fin, dt), 50)
    k4_plain = _events_ms(torch, lambda: ref.sedov_step_ref(fin, dt), 10)
    cfl_ms = _events_ms(torch, lambda: ref.cfl_dt(fin), 50)
    # five fields read and five written (dt, t in and t out beside them)
    k4_bytes = 10 * 4 * zones + 3 * 4
    k4_flops = STENCIL_FLOPS_PER_ZONE * zones
    k4_bound = max(k4_bytes / HBM_BYTES_PER_S, k4_flops / F32_FLOPS) * 1e3
    # rho, e and v read once; p 2, 1/rho-clamp 2, GAMMA p 1, sqrt 1,
    # |v|^2 5, sqrt 1, sums 2, max 1 operations per zone
    cfl_bytes = 5 * 4 * zones + 4
    cfl_bound = max(cfl_bytes / HBM_BYTES_PER_S,
                    15 * zones / F32_FLOPS) * 1e3
    print(f"[numbers] {card} sedov_stencil at {n}^3 (CUDA events, back to "
          f"back): kernel {k4_ms:.4f} ms, bound {k4_bound:.4f} ms "
          f"({k4_bytes / 1e6:.1f} MB), {k4_bound / k4_ms:.3f} of the bound; "
          f"plain fused step {k4_plain:.4f} ms; cfl_dt {cfl_ms:.4f} ms, "
          f"bound {cfl_bound:.4f} ms")

    def direct(state):
        out = lulesh.run(state, cfg, iters, use_kernel=True)
        torch.cuda.synchronize()
        return out
    fom_direct = []
    for _ in range(2):
        # the state is built before the clock starts, as run_command does
        state = lulesh.init_state(cfg, "cuda")
        torch.cuda.synchronize()
        _, secs = _timed(direct, state)
        fom_direct.append(lulesh.fom(zones, iters, secs))
    del state
    fom_easey = easey[-1]["fom"]
    step_ms = zones / fom_direct[0] * 1e3
    delta = fom_easey / fom_direct[0] - 1.0
    print(f"[numbers] {card} LULESH {n}^3 x {iters} steps: run "
          f"{step_ms:.4f} ms per step; FOM direct (lulesh.run) "
          f"{fom_direct[0]:.1f}, again {fom_direct[1]:.1f}; through "
          f"run_easey {fom_easey:.1f}; EASEY vs direct {delta:+.4%}")
    plain_fin = lulesh.run(lulesh.init_state(cfg, "cuda"), cfg, iters)
    drift = _rel_err(fin, plain_fin)
    print(f"[numbers] {card} {iters}-step kernel state vs {iters}-step plain "
          f"state, scale-relative: "
          f"{ {f: float(f'{e:.4g}') for f, e in drift.items()} }")
    del fin, plain_fin

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
        # no one PyTorch call computes the fused step: library_ms is null
        {"name": "sedov_stencil", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sedov_stencil.cu",
         "replaces": "src/repro/kernels/sedov_stencil.py:143",
         "launches": launches["sedov_stencil"], "max_abs_err": k4_err,
         "ms": k4_ms, "plain_ms": k4_plain, "bound_ms": k4_bound,
         "bound_by": "bytes" if k4_bytes / HBM_BYTES_PER_S >=
         k4_flops / F32_FLOPS else "operations",
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
