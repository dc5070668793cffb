#!/usr/bin/env python3
"""Variants of the paged-decode (K1) and Sedov stencil (K4) kernels, timed
in turns in one process on one card.

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 tools/kernel_variants.py

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
plain step.  Prints one line per variant and case; gates nothing.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import tempfile
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


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import lulesh

    card = f"[{cs._smi()}]"
    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory(prefix="kernel_variants_") as tmp:
        k1 = build(_build, "paged_attention", K1_VARIANTS, Path(tmp))
        k4 = build(_build, "sedov_stencil", K4_VARIANTS, Path(tmp))
    for lib in k1.values():
        lib.paged_attention_launch.argtypes = [P] * 10 + [I] * 7 + \
            [ctypes.c_float, P]
    for lib in k4.values():
        lib.sedov_stencil_launch.argtypes = [P] * 9 + [I, ctypes.c_float, P]

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
                *(b.data_ptr() for b in bufs), slots, K, H // K, dh, ps, mp,
                ns, 1.0 / math.sqrt(dh), torch.cuda.current_stream().cuda_stream)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
