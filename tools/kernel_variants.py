#!/usr/bin/env python3
"""Variants of the paged-decode (K1), RMSNorm (K2) and Sedov stencil (K4)
kernels, timed in turns in one process on one card.

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 tools/kernel_variants.py [k1] [k1g] [k2] [k4]   (default: all)

Each variant is the shipped source with one edit, compiled with the
shipped flags into a scratch directory and loaded with ctypes beside the
others, so that every variant runs on the same card in the same process
(parent and variants in turns, four rounds).  K1 at the main-path shape
of ``chip_smoke.py`` (8 slots x 32 heads x 128), one slot of 4,096
tokens and 2 slots, L2 flushed before each call (CUDA graphs of flush +
call pairs less the flushes): the shipped kernel, two row loads in
flight per lane (``kUnroll`` 8 in place of 4), 8 blocks per SM in place
of 4, without programmatic dependent launch, and each of its two
kernels alone.  K4 at 256^3 after 200 plain steps (CUDA events, back to
back): the shipped kernel, chunks of 32 and 16 planes in place of 64,
IEEE division in place of the power-of-two multiplication, and 4-byte
copies in place of 16-byte ones; each also held bitwise against the
plain step.  K2 at (8, 40, 128) rows of 4,096, bf16, device ms per call
from CUDA graphs of 100 back-to-back calls: the fused add + norm as
shipped, at 128 rows also 256 and 128 threads holding 2 and 4 vectors
each, with programmatic dependent launch (w loaded before
griddepcontrol.wait), and an empty kernel (the floor, built by
``chip_smoke.py``); the plain norm entry as shipped and with x read again
from memory for the scaling (the earlier kernel's second pass); each
variant held against the plain version first.  Then K2 behind the GEMM
that feeds it on the decode path (x @ W with W 4,096 x 4,096, a CUDA
graph of 50 pairs) as shipped and with programmatic dependent launch,
and the GEMM alone; and the host's time per call back to back (CUDA
events, 200 calls): both shipped wrappers, the fused call through
``ops``, a wrapper that allocates each output and builds a stream object
per call (as the earlier wrapper did), and the unfused chain; and each
step of the fused wrapper alone on the host's clock.  K1 (``k1g``) at
G = 12 with 6, 4 (shipped), 3, 2 and 1 query heads a block, and at G =
11 with 4 (shipped: 4, 4 and 3), 6 (6 and 5) and 1.  Prints one line per
variant and case; gates nothing.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

K1_VARIANTS = {
    "shipped": {},
    "unroll 8": {"constexpr int kUnroll = 4;": "constexpr int kUnroll = 8;"},
    "no PDL": {"programmaticStreamSerializationAllowed = 1;":
               "programmaticStreamSerializationAllowed = 0;"},
    "(a) alone": {"  e = cudaLaunchKernelEx(&cfg, paged_pv_kernel<G>,":
                  "  if (false) e = cudaLaunchKernelEx(&cfg, paged_pv_kernel<G>,"},
    "(b) alone": {"  paged_scores_kernel<G><<<grid, kThreads, 0, stream>>>(":
                  "  if (false) paged_scores_kernel<G><<<grid, kThreads, 0, stream>>>("},
}
K4_VARIANTS = {
    "shipped": {},
    "chunk 32": {"constexpr int kChunk = 64;": "constexpr int kChunk = 32;"},
    "chunk 16": {"constexpr int kChunk = 64;": "constexpr int kChunk = 16;"},
    "IEEE division": {"const bool pow2 = two_dx > 0.f && frexpf(two_dx, &exp2) == 0.5f;":
                      "const bool pow2 = false;"},
    "4-byte copies": {"const bool vec = n % 4 == 0 &&": "const bool vec = false &&"},
}


def build(_build, name, variants, out: Path) -> dict:
    """Compile every variant of source ``name`` at once; {variant: CDLL}."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    procs = {}
    for i, (v, edits) in enumerate(variants.items()):
        src = text
        for old, new in edits.items():
            if src.count(old) != 1:
                raise RuntimeError(f"{name} / {v}: edit does not apply")
            src = src.replace(old, new)
        cu, so = out / f"{name}_{i}.cu", out / f"lib{name}_{i}.so"
        cu.write_text(src)
        procs[v] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.flags(name), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} / {v}:\n{log}")
        libs[v] = ctypes.CDLL(str(so))
    return libs


def turns(torch, fns: dict, timer, rounds: int = 4) -> dict:
    """{variant: [ms per round]}, the order reversed every other round."""
    res = {v: [] for v in fns}
    order = list(fns)
    for r in range(rounds):
        for v in (order if r % 2 == 0 else order[::-1]):
            res[v].append(timer(fns[v]))
    return res


K2_VARIANTS = {
    "shipped": {},
    # programmatic dependent launch: w (no kernel's output) loaded before
    # the wait for the previous kernel, x and a after it
    "PDL": {"  float t[NV][8];\n":
            "  asm volatile(\"griddepcontrol.wait;\" ::: \"memory\");\n"
            "  float t[NV][8];\n",
            "  norm_kernel<T, NV><<<rows, threads, 0, stream>>>(x, a, w, r_out, "
            "y_out, d,\n                                                   eps, "
            "norm_of_rounded);\n":
            "  cudaLaunchAttribute attr[1];\n"
            "  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
            "  attr[0].val.programmaticStreamSerializationAllowed = 1;\n"
            "  cudaLaunchConfig_t cfg = {};\n"
            "  cfg.gridDim = dim3(rows);\n"
            "  cfg.blockDim = dim3(threads);\n"
            "  cfg.stream = stream;\n"
            "  cfg.attrs = attr;\n"
            "  cfg.numAttrs = 1;\n"
            "  const cudaError_t e = cudaLaunchKernelEx(&cfg, norm_kernel<T, NV>, "
            "x, a, w, r_out, y_out, d, eps, norm_of_rounded);\n"
            "  if (e != cudaSuccess) return e;\n"},
    # the scaling pass reads x again (the norm entry only)
    "re-read x": {"  const float rs = rsqrtf(total / (float)d + eps);\n":
                  "  const float rs = rsqrtf(total / (float)d + eps);\n"
                  "  asm volatile(\"\" ::: \"memory\");\n"
                  "#pragma unroll\n"
                  "  for (int v = 0; v < NV; ++v) {\n"
                  "    const int col = col0 + v * nthreads * 8;\n"
                  "    if (col < d) load8(x + base + col, t[v]);\n"
                  "  }\n"},
}


def k2_section(torch, cs, card, tmp: Path) -> None:
    """K2's design points, timed in turns (see the module docstring)."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import rmsnorm as rn
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    empty_kernel = cs._empty_kernel_build(torch, _build)
    libs = build(_build, "rmsnorm", K2_VARIANTS, tmp)
    empty_cuda = empty_kernel()
    for lib in libs.values():
        lib.rmsnorm_launch.argtypes = [P, I, P, P, I, I, F, I, I, P]
        lib.add_rmsnorm_launch.argtypes = [P] * 5 + [I, I, F] + [I] * 3 + [P]
    d = 4096
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
        torch.bfloat16)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fused_call(lib, x, a, cfg):
        rows = x.shape[0]
        out = torch.empty((2, rows, d), dtype=torch.bfloat16, device="cuda")

        def call():
            rc = lib.add_rmsnorm_launch(
                x.data_ptr(), a.data_ptr(), w.data_ptr(), out.data_ptr(),
                out[1].data_ptr(), rows, d, 1e-6, 1, *cfg, stream())
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return out[0], out[1]
        return call

    def norm_call(lib, x, cfg):
        rows = x.shape[0]
        out = torch.empty((rows, d), dtype=torch.bfloat16, device="cuda")

        def call():
            rc = lib.rmsnorm_launch(x.data_ptr(), 0, w.data_ptr(),
                                    out.data_ptr(), rows, d, 1e-6, *cfg,
                                    stream())
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return out
        return call

    floor = None
    for rows in (8, 40, 128):
        x = (3 * torch.randn((rows, d), generator=gen, device="cuda")).to(
            torch.bfloat16)
        a = torch.randn((rows, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        shipped = rn.plan(d)
        fns = {f"fused, shipped (threads, nv) {shipped}":
               fused_call(libs["shipped"], x, a, shipped)}
        if rows == 128:
            for nv in (2, 4):
                cfg = (512 // nv, nv)
                fns[f"fused, {cfg}"] = fused_call(libs["shipped"], x, a, cfg)
        fns["fused, PDL"] = fused_call(libs["PDL"], x, a, shipped)
        r_want, y_want = ref.add_rmsnorm_ref(x, a, w, norm_of_rounded=True)
        for v, fn in fns.items():
            r, y = fn()
            err = (y.float() - y_want.float()).abs()
            if not torch.equal(r, r_want) or bool((err > cs.FLASH_FULL_ATOL +
                    cs.FLASH_FULL_RTOL * y_want.float().abs()).any()):
                raise AssertionError(f"K2 {v} ({rows} rows) differs")
        fns["norm entry, shipped"] = norm_call(libs["shipped"], x, shipped)
        fns["norm entry, re-read x"] = norm_call(libs["re-read x"], x,
                                                 shipped)
        y_want = ref.rmsnorm_ref(x, w).float()
        for v in ("norm entry, shipped", "norm entry, re-read x"):
            err = (fns[v]().float() - y_want).abs()
            if bool((err > cs.FLASH_FULL_ATOL +
                     cs.FLASH_FULL_RTOL * y_want.abs()).any()):
                raise AssertionError(f"K2 {v} ({rows} rows) differs")
        fns["empty kernel"] = empty_cuda
        res = turns(torch, fns, lambda f: cs._graph_ms(torch, f, 100))
        floor = res["empty kernel"]
        for v, ms in res.items():
            print(f"[variants] {card} K2 ({rows}, {d}) bf16, {v}: "
                  f"{[round(t, 5) for t in ms]} ms", flush=True)

    # behind the GEMM that produces a (the decode path's o-projection)
    for rows in (8, 128):
        x = torch.randn((rows, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        h = torch.randn((rows, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        W = (torch.randn((d, d), generator=gen, device="cuda") / 64).to(
            torch.bfloat16)
        cfg = rn.plan(d)
        outs = torch.empty((2, rows, d), dtype=torch.bfloat16, device="cuda")
        a = torch.empty((rows, d), dtype=torch.bfloat16, device="cuda")

        def pair(lib):
            def call():
                torch.matmul(h, W, out=a)
                rc = lib.add_rmsnorm_launch(
                    x.data_ptr(), a.data_ptr(), w.data_ptr(), outs.data_ptr(),
                    outs[1].data_ptr(), rows, d, 1e-6, 1, *cfg, stream())
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
            return call
        res = turns(torch, {"GEMM + K2, shipped": pair(libs["shipped"]),
                            "GEMM + K2, PDL": pair(libs["PDL"]),
                            "GEMM alone": lambda: torch.matmul(h, W, out=a)},
                    lambda f: cs._graph_ms(torch, f, 50))
        for v, ms in res.items():
            print(f"[variants] {card} K2 behind a ({rows}, {d}) x ({d}, {d})"
                  f" GEMM, {v}: {[round(t, 5) for t in ms]} ms", flush=True)

    # the host's time per call, back to back
    x = torch.randn((8, d), generator=gen, device="cuda").to(torch.bfloat16)
    a = torch.randn((8, d), generator=gen, device="cuda").to(torch.bfloat16)
    lib = rn._lib()

    def legacy():
        """The earlier wrapper's steps around the shipped launch: every
        check, one allocation per output, a stream object per call."""
        if not (x.is_cuda and a.is_cuda and w.is_cuda and
                x.device == a.device == w.device):
            raise ValueError("devices")
        if x.dtype != torch.bfloat16 or a.dtype != torch.bfloat16 or \
                w.dtype != torch.bfloat16 or w.shape != (d,) or d % 8:
            raise ValueError("types")
        if not (x.is_contiguous() and a.is_contiguous() and
                w.is_contiguous()):
            raise ValueError("layout")
        if x.data_ptr() % 16 or a.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("alignment")
        r = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
        y = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
        if x.device.index != torch.cuda.current_device():
            raise ValueError("device")
        rows = x.numel() // d
        rc = lib.add_rmsnorm_launch(
            x.data_ptr(), a.data_ptr(), w.data_ptr(), r.data_ptr(),
            y.data_ptr(), rows, d, 1e-6, 1, *rn.plan(d),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return r, y

    def chain():
        r = x + a
        return r, rn.rmsnorm_cuda(r, w)
    fns = {"add_rmsnorm_cuda": lambda: rn.add_rmsnorm_cuda(
               x, a, w, norm_of_rounded=True),
           "ops.add_rmsnorm": lambda: ops.add_rmsnorm(
               x, a, w, norm_of_rounded=True),
           "rmsnorm_cuda": lambda: rn.rmsnorm_cuda(x, w),
           "wrapper with an allocation per output": legacy,
           "unfused chain (add, rmsnorm_cuda)": chain,
           "empty kernel": empty_cuda}
    res = turns(torch, fns, lambda f: cs._events_ms(torch, f, 200))
    for v, ms in res.items():
        print(f"[variants] {card} host ms per call back to back, (8, {d}), "
              f"{v}: {[round(t, 5) for t in ms]} ms", flush=True)

    # where the wrapper's host time goes: each of its steps alone, host
    # clock over many repeats (the device is idle or far ahead)
    out = torch.empty((2, 8, d), dtype=torch.bfloat16, device="cuda")
    cfg = rn.plan(d)
    args = (x.data_ptr(), a.data_ptr(), w.data_ptr(), out.data_ptr(),
            out.data_ptr() + 2 * 8 * d, 8, d, 1e-6, 1, *cfg, stream())

    def checks():
        if not (x.is_cuda and a.device == x.device and w.device == x.device):
            raise ValueError("devices")
        if not (x.dtype == a.dtype == w.dtype == torch.bfloat16):
            raise ValueError("types")
        if a.shape != x.shape or w.shape != (d,) or d % 8:
            raise ValueError("shapes")
        if not (x.is_contiguous() and a.is_contiguous() and
                w.is_contiguous()):
            raise ValueError("layout")
        if (x.data_ptr() | a.data_ptr() | w.data_ptr()) % 16:
            raise ValueError("alignment")
    steps = {
        "whole add_rmsnorm_cuda": lambda: rn.add_rmsnorm_cuda(
            x, a, w, norm_of_rounded=True),
        "checks": checks,
        "torch.empty((2, 8, d))": lambda: torch.empty(
            (2, 8, d), dtype=torch.bfloat16, device=x.device),
        "out.unbind(0)": lambda: out.unbind(0),
        "out[0], out[1]": lambda: (out[0], out[1]),
        "_build.stream_of(x)": lambda: _build.stream_of(x),
        "current_stream().cuda_stream": lambda: stream(),
        "plan lookup": lambda: rn.plan(d),
        "ctypes launch, fixed arguments": lambda: lib.add_rmsnorm_launch(
            *args),
        "empty kernel through ctypes": empty_cuda,
    }
    for v, fn in steps.items():
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5000):
            fn()
        us = (time.perf_counter() - t0) / 5000 * 1e6
        torch.cuda.synchronize()
        print(f"[variants] {card} host us per call, {v}: {us:.3f}",
              flush=True)
    print(f"[variants] {card} K2 empty-kernel floor in a CUDA graph: "
          f"{floor} ms", flush=True)


def main(which) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    which = set(which or ("k1", "k1g", "k2", "k4"))
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import lulesh

    card = f"[{cs._smi()}]"
    if "k2" in which:
        with tempfile.TemporaryDirectory(prefix="kernel_variants_") as tmp:
            k2_section(torch, cs, card, Path(tmp))
    if "k1" in which:
        k1_section(np, torch, cs, card, _build, ref, pa)
    if "k1g" in which:
        k1g_section(np, torch, cs, card, ref, pa)
    if "k4" in which:
        k4_section(torch, cs, card, _build, ref, lulesh)
    return 0


def k1_section(np, torch, cs, card, _build, ref, pa) -> None:
    """K1's variants, timed in turns (see the module docstring)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory(prefix="kernel_variants_") as tmp:
        k1 = build(_build, "paged_attention", K1_VARIANTS, Path(tmp))
    for lib in k1.values():
        lib.paged_attention_launch.argtypes = [P] * 10 + [I] * 8 + \
            [ctypes.c_float, P]

    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda").zero_
    rng = np.random.default_rng(0)
    lens = [int(n) + 16 for n in np.random.RandomState(0).randint(64, 385,
                                                                  size=8)]
    cases = {
        "main path": cs._paged_case(torch, rng, lens, 16, 32, 32, 1, 128,
                                    num_pages=257),
        "1 slot x 4096": cs._paged_case(torch, rng, [4096], 16, 256, 32, 1,
                                        128),
        "2 slots": cs._paged_case(torch, rng, [130, 77], 16, 32, 32, 1, 128)}
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def k1_call(lib, case, blocks_per_sm):
        q, kp, vp, table, kv_len = case
        slots, H, dh = q.shape
        _, ps, K, _ = kp.shape
        mp = table.shape[1]
        ns = max(1, min(mp, -(-blocks_per_sm * sms // (slots * K))))
        out = torch.empty_like(q)
        bufs = pa._scratch(q.device, slots, K, H // K, dh, mp * ps, ns)

        def call():
            rc = lib.paged_attention_launch(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
                kv_len.data_ptr(), out.data_ptr(),
                *(b.data_ptr() for b in bufs), slots, K, H // K,
                pa.head_chunk(H // K), dh, ps, mp, ns, 1.0 / math.sqrt(dh),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return out
        return call

    for cname, case in cases.items():
        fns = {v: k1_call(lib, case, pa.BLOCKS_PER_SM)
               for v, lib in k1.items()}
        fns["8 blocks per SM"] = k1_call(k1["shipped"], case, 8)
        for v in ("shipped", "unroll 8", "no PDL", "8 blocks per SM"):
            d = cs._rounding_diff(torch, ref, case, fns[v]().clone())
            if d["ratio"] > 1:
                raise AssertionError(f"K1 {v} {cname}: {d}")
        res = turns(torch, fns, lambda f: cs._graph_pairs_ms(torch, f, flush,
                                                             50))
        for v, ms in res.items():
            print(f"[variants] {card} K1 {cname}, {v}: "
                  f"{[round(x, 5) for x in ms]} ms", flush=True)


def k1g_section(np, torch, cs, card, ref, pa) -> None:
    """K1 at G = 12 (8 slots, mistral-large-123b's 96 heads over 8 kv heads
    of 128) with 6, 4 (shipped), 3, 2 and 1 query heads a block, and at
    G = 11 (88 heads over 8) with 4 (shipped), 6 and 1; L2 flushed (CUDA
    graphs of flush + call pairs less the flushes), in turns."""
    for G, chunks in ((12, (6, 4, 3, 2, 1)), (11, (4, 6, 1))):
        k1g_case(np, torch, cs, card, ref, pa, G, chunks)


def k1g_case(np, torch, cs, card, ref, pa, G, chunks) -> None:
    lib = pa._lib()
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda").zero_
    rng = np.random.default_rng(0)
    case = cs._paged_case(torch, rng, [300, 5, 0, 17, 129, 64, 512, 200], 16,
                          32, 8, G, 128)
    q, kp, vp, table, kv_len = case
    slots, H, dh = q.shape
    _, ps, K, _ = kp.shape
    mp = table.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def call_with(gc):
        pairs = slots * K * -(-G // gc)
        ns = pa.num_splits(pairs, mp, sms)
        heads = pairs * gc
        f32 = dict(dtype=torch.float32, device="cuda")
        bufs = (torch.empty(heads * mp * ps, **f32),
                torch.empty(heads * ns, **f32),
                torch.empty(heads * ns * dh, **f32),
                torch.zeros(pairs, dtype=torch.int32, device="cuda"))
        out = torch.empty_like(q)

        def call():
            rc = lib.paged_attention_launch(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
                kv_len.data_ptr(), out.data_ptr(),
                *(b.data_ptr() for b in bufs), slots, K, G, gc, dh, ps, mp,
                ns, 1.0 / math.sqrt(dh),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return out
        return call
    fns = {f"{gc} heads a block ({-(-G // gc)} chunks)": call_with(gc)
           for gc in chunks}
    for v, fn in fns.items():
        d = cs._rounding_diff(torch, ref, case, fn().clone())
        if d["ratio"] > 1:
            raise AssertionError(f"K1 G={G} {v}: {d}")
    res = turns(torch, fns, lambda f: cs._graph_pairs_ms(torch, f, flush, 50))
    for v, ms in res.items():
        print(f"[variants] {card} K1 G={G}, {v}: {[round(x, 5) for x in ms]} "
              f"ms", flush=True)


def k4_section(torch, cs, card, _build, ref, lulesh) -> None:
    """K4's variants, timed in turns (see the module docstring)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory(prefix="kernel_variants_") as tmp:
        k4 = build(_build, "sedov_stencil", K4_VARIANTS, Path(tmp))
    for lib in k4.values():
        lib.sedov_stencil_launch.argtypes = [P] * 9 + [I, ctypes.c_float, P]
    cfg = lulesh.LuleshConfig(grid=256)
    st = lulesh.run(lulesh.init_state(cfg, "cuda"), cfg, 200)
    dt = ref.cfl_dt(st)
    want = ref.sedov_step_ref(st, dt)

    def k4_call(lib):
        out = {k: torch.empty_like(st[k]) for k in ("rho", "e", "v", "t")}

        def call():
            rc = lib.sedov_stencil_launch(
                *(st[k].data_ptr() for k in ("rho", "e", "v")), dt.data_ptr(),
                st["t"].data_ptr(),
                *(out[k].data_ptr() for k in ("rho", "e", "v", "t")), 256,
                1.0, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return out
        return call

    fns = {v: k4_call(lib) for v, lib in k4.items()}
    for v, f in fns.items():
        got = f()
        if not all(torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"K4 {v}: not bitwise equal to plain")
    res = turns(torch, fns, lambda f: cs._events_ms(torch, f, 50))
    for v, ms in res.items():
        print(f"[variants] {card} K4 256^3, {v} (bitwise equal to plain): "
              f"{[round(x, 5) for x in ms]} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
