#!/usr/bin/env python3
"""Mutants of the paged-decode (K1), RMSNorm (K2) and Sedov stencil (K4)
kernels, each held by the gates of ``chip_smoke.py``, which must reject
it.

Run from the repository root on a machine with one NVIDIA Hopper GPU:

    python3 tools/kernel_mutants.py [name ...]

Each mutant is a copy of ``src/`` in a temporary directory with one edit
to a kernel source; a child process imports the port from that copy (so
``kernels/_build.py`` compiles the copy's source) and runs the gate:
K1's ``_k1_hold`` over the main-path case and ``_k1_cases`` (every
element within the two-rounding bound, two calls bitwise equal, freed
slots zero), with the old 2e-2 tolerance at the main path beside it;
K2's ``_k2_hold`` at each shape of phase 2 (rows 1, 8, 40, 128 and 1000
by d 64, 4096, 12288 and 18432, both forms of the fused add + norm: the
residual bitwise, the norm within one bf16 step, two calls equal);
K4's ``_stencil_checks`` at each grid of phase 6 (every zone of every
field within rtol 1e-6 of the plain step, developed and rough states).
The unedited sources run first as the control, which must pass.  Prints
one line per case and a RESULT line per mutant; exits non-zero when a
mutant passes or the control fails.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
K1 = "src/repro_torch/kernels/csrc/paged_attention.cu"
K2 = "src/repro_torch/kernels/csrc/rmsnorm.cu"
K4 = "src/repro_torch/kernels/csrc/sedov_stencil.cu"
GRIDS = (1, 2, 3, 5, 8, 13, 16, 24, 32, 33, 64, 70, 100, 256)
# name: (gate, source, text, replacement); None: the control
MUTANTS = {
    "control K1": ("k1", K1, None, None),
    "control K2": ("k2", K2, None, None),
    "control K4": ("k4", K4, None, None),
    # the combine leaves split 0's partial out
    "K1 split 0 dropped": (
        "k1", K1,
        "for (int sp = 0; sp < geo.nsplit; ++sp) s += __ldcg(",
        "for (int sp = geo.nsplit > 1; sp < geo.nsplit; ++sp) s += __ldcg("),
    # P.V skips the last token of each split (one token off its boundary)
    "K1 split end one token early": (
        "k1", K1,
        "        if (!cur.live[u]) continue;",
        "        if (!cur.live[u] || cur.pos[u] == pc1 * geo.page_size - 1)"
        " continue;"),
    # the pv kernel skips the last chunk of each kv head's query heads
    # (G = 12: heads 6-11 of every kv head are never written)
    "K1 last head chunk skipped": (
        "k1", K1,
        "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;",
        "  if (geo.hc > 1 && (int)blockIdx.y % geo.hc == geo.hc - 1) return;\n"
        "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;"),
    # the row's sum of squares leaves the last warp's partial out
    "K2 last warp's partial dropped": (
        "k2", K2,
        "for (int i = 0; i < nthreads / 32; ++i) s += red[i];",
        "for (int i = 0; i < nthreads / 32 - 1; ++i) s += red[i];"),
    # 2 warm-up planes in place of 3 at an inner chunk seam
    "K4 two warm-up planes": (
        "k4", K4,
        "const int lo = max(c0 - 3, 0), hi = min(c1 + 3, n);",
        "const int lo = c0 > 0 ? c0 - 2 : 0, hi = min(c1 + 3, n);"),
    # the axis-2 neighbour clamped at the tile edge, not the domain edge
    "K4 axis-2 clamp at the tile edge": (
        "k4", K4,
        "auto up2 = [&](int k) { return k < n - 1 ? 1 : 0; };\n"
        "  auto dn2 = [&](int k) { return k > 0 ? 1 : 0; };",
        "auto up2 = [&](int k) { return k < min(o2 + kT2, n) - 1 ? 1 : 0; };\n"
        "  auto dn2 = [&](int k) { return k > o2 ? 1 : 0; };"),
}


def gate(src: str, which: str) -> int:
    """Run ``which`` gate on the port imported from ``src``; the number of
    cases it rejected."""
    sys.path.insert(0, src)
    sys.path.insert(1, str(REPO))
    import numpy as np
    import torch

    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels import ref
    if not repro_torch.__file__.startswith(src):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {src}")
    rejected = 0
    if which == "k1":
        from repro_torch.kernels.paged_attention import (num_splits,
                                                          paged_attention_cuda)
        rng = np.random.default_rng(0)
        lens = [int(n) + 16 for n in np.random.RandomState(0).randint(
            64, 385, size=8)]
        main = cs._paged_case(torch, rng, lens, 16, 32, 32, 1, 128,
                              num_pages=257)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        want = ref.paged_attention_ref(*main).float()
        err = (paged_attention_cuda(*main).float() - want).abs()
        old = bool((err <= cs.KERNEL_ATOL + cs.KERNEL_RTOL * want.abs()).all())
        print(f"  main path, old 2e-2 gate: {'holds' if old else 'rejects'} "
              f"(max abs {float(err.max()):.4g})")
        for name, case in [("main path", main)] + cs._k1_cases(
                torch, rng, 32, 128, 16, sms, num_splits):
            try:
                d = cs._k1_hold(torch, ref, paged_attention_cuda, name, case)
                print(f"  {name}: holds ({d['ratio']:.4f} of the bound)")
            except AssertionError as e:
                rejected += 1
                print(f"  {name}: rejects: {str(e)[:240]}")
    elif which == "k2":
        from repro_torch.kernels.rmsnorm import add_rmsnorm_cuda, plan
        torch.manual_seed(0)
        for dk in cs.K2_WIDTHS:
            w = (1 + 0.1 * torch.randn(dk, device="cuda")).to(torch.bfloat16)
            for rows in cs.K2_ROWS:
                x = (3 * torch.randn((rows, dk), device="cuda")).to(
                    torch.bfloat16)
                a = torch.randn((rows, dk), device="cuda").to(torch.bfloat16)
                for rounded in (False, True):
                    name = (f"rows={rows} d={dk} norm_of_rounded={rounded} "
                            f"(threads, nv) = {plan(dk)}")
                    try:
                        h = cs._k2_hold(torch, ref, add_rmsnorm_cuda, name,
                                        x, a, w, rounded)
                        print(f"  {name}: holds ({h['share']:.4f} of a step)")
                    except AssertionError as e:
                        rejected += 1
                        print(f"  {name}: rejects: {str(e)[:160]}")
    else:
        from repro_torch.kernels.sedov_stencil import sedov_step_cuda
        from repro_torch.models import lulesh
        for n in GRIDS:
            try:
                cs._stencil_checks(np, lulesh, ref, sedov_step_cuda, (n,), ())
                print(f"  n={n}: holds")
            except AssertionError as e:
                rejected += 1
                print(f"  n={n}: rejects: {str(e)[:200]}")
    return rejected


def main(names) -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_mutants: no CUDA device", file=sys.stderr)
        return 1
    bad = 0
    for name in names or list(MUTANTS):
        which, path, old, new = MUTANTS[name]
        with tempfile.TemporaryDirectory(prefix="kernel_mutant_") as tmp:
            shutil.copytree(REPO / "src", Path(tmp) / "src",
                            ignore=shutil.ignore_patterns(".cuda_build",
                                                          "__pycache__"))
            if old is not None:
                f = Path(tmp) / path
                text = f.read_text()
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: edit does not apply")
                f.write_text(text.replace(old, new))
            print(f"=== {name}", flush=True)
            out = subprocess.run(
                [sys.executable, __file__, "--gate", str(Path(tmp) / "src"),
                 which], capture_output=True, text=True, timeout=900)
        print(out.stdout + out.stderr[-2000:], end="", flush=True)
        control = old is None
        ok = out.returncode == (0 if control else 1)
        print(f"RESULT {name}: "
              f"{'passed' if out.returncode == 0 else 'rejected' if out.returncode == 1 else 'error'}"
              f" ({'as it must' if ok else 'WRONG'})", flush=True)
        bad += not ok
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gate"]:
        try:
            sys.exit(1 if gate(sys.argv[2], sys.argv[3]) else 0)
        except Exception:
            traceback.print_exc()
            sys.exit(2)
    sys.exit(main(sys.argv[1:]))
