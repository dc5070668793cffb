"""Kernel microbenchmarks of the port (the counterpart of the reference's
``benchmarks/kernel_bench.py``): each hand-written kernel against its
plain version at the reference's four shapes, with the reference's
bytes-moved estimates.

    from repro_torch.kernels import bench
    bench.run(lambda name, us, extra: print(name, us, extra))

Rows keep the reference's names with ``_cuda`` in place of
``_pallas_interp``.  On the card (the default) every time is device
time from CUDA events around back-to-back calls after a warm-up; with
``device="cpu"`` the kernels' plain versions run in their place and the
times are host seconds, marked ``device=cpu`` in each row's note.
"""

from __future__ import annotations

import time

import torch

from repro_torch.core.target import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.models import lulesh
from repro_torch.models.layers import dot_attention

REPEATS = 3


def _timed(fn, device: torch.device, n: int = REPEATS) -> float:
    """Mean seconds per call of ``fn`` over ``n`` calls after one warm-up:
    CUDA events on the card, the host clock (the plain versions) on the
    CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def run(report, device=None) -> None:
    """Time the four kernels; ``report(name, microseconds, note)`` per
    row.  ``device=None`` is the card (raises where there is none)."""
    device = resolve_device(device)
    where = "" if device.type == "cuda" else ",device=cpu"
    gen = torch.Generator(device=device).manual_seed(0)

    def normal(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    # --- flash attention: the unfused oracle vs the kernel ---------------
    b, s, H, K, dh = 1, 512, 4, 2, 64
    q, k, v = normal((b, s, H, dh)), normal((b, s, K, dh)), normal((b, s, K, dh))
    t_ref = _timed(lambda: ref.attention_ref(q, k, v), device)
    t_ker = _timed(lambda: ops.flash_attention(q, k, v, causal=True), device)
    # HBM traffic: unfused materializes s^2 scores fp32 (x2 passes) + probs
    unfused_bytes = b * H * s * s * 4 * 3
    # fused touches q + out at H heads but K/V at only K kv heads (GQA)
    fused_bytes = (2 * H + 2 * K) * b * s * dh * 4
    report("kernel_flash_ref", t_ref * 1e6, f"bytes={unfused_bytes}{where}")
    report("kernel_flash_cuda", t_ker * 1e6,
           f"bytes={fused_bytes},traffic_reduction="
           f"{unfused_bytes / fused_bytes:.1f}x{where}")

    # --- paged decode: gather-then-attend vs the page-walking kernel -----
    slots, psize, max_pages = 4, 16, 8
    Kp, dhp, Hp = 2, 64, 4
    lens = [128, 48, 16, 96]                   # heavy-tailed slot lengths
    held = [-(-n // psize) for n in lens]
    num_pages = sum(held) + 1                  # + reserved junk page 0
    table = torch.zeros((slots, max_pages), dtype=torch.int32)
    nxt = 1
    for i, h in enumerate(held):
        table[i, :h] = torch.arange(nxt, nxt + h, dtype=torch.int32)
        nxt += h
    table = table.to(device)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device=device)
    qd = normal((slots, Hp, dhp), torch.bfloat16)
    kp = normal((num_pages, psize, Kp, dhp), torch.bfloat16)
    vp = normal((num_pages, psize, Kp, dhp), torch.bfloat16)

    def gather_decode():
        kg = kp[table.long()].reshape(slots, max_pages * psize, Kp, dhp)
        vg = vp[table.long()].reshape(slots, max_pages * psize, Kp, dhp)
        return dot_attention(qd[:, None], kg, vg, causal=True,
                             q_offset=kv_lens - 1, kv_len=kv_lens)

    t_gather = _timed(gather_decode, device)
    t_fused = _timed(lambda: ops.paged_attention(qd, kp, vp, table, kv_lens),
                     device)
    item = 2                                   # bf16 K/V pool
    gather_bytes = 2 * 2 * slots * max_pages * psize * Kp * dhp * item
    fused_paged_bytes = 3 * 2 * sum(held) * psize * Kp * dhp * item
    report("kernel_paged_decode_gather", t_gather * 1e6,
           f"bytes={gather_bytes}{where}")
    report("kernel_paged_decode_fused", t_fused * 1e6,
           f"bytes={fused_paged_bytes},traffic_reduction="
           f"{gather_bytes / fused_paged_bytes:.1f}x{where}")

    # --- RMSNorm ----------------------------------------------------------
    x = normal((4096, 2048), torch.bfloat16)
    w = torch.ones((2048,), dtype=torch.bfloat16, device=device)
    t_ref = _timed(lambda: ref.rmsnorm_ref(x, w), device)
    t_ker = _timed(lambda: ops.rmsnorm(x, w), device)
    report("kernel_rmsnorm_ref", t_ref * 1e6, f"bytes=5x{where}")
    report("kernel_rmsnorm_cuda", t_ker * 1e6, f"bytes=2x{where}")

    # --- the Sedov step ---------------------------------------------------
    cfg = lulesh.LuleshConfig(grid=16)
    st = lulesh.init_state(cfg, device)
    t_ref = _timed(lambda: lulesh.step(st, cfg), device)
    t_ker = _timed(lambda: ops.sedov_step_kernel(st, cfg), device)
    report("kernel_sedov_ref", t_ref * 1e6, f"passes=8{where}")
    report("kernel_sedov_cuda", t_ker * 1e6, f"passes=1{where}")
