"""Wrapper of the CUDA paged-decode attention kernel
(``csrc/paged_attention.cu``), the port of the Pallas kernel
``repro/kernels/paged_attention.py:paged_attention_pallas``.

The kernel walks each slot's page-table row on the card, split over the
KV run: each (slot, kv head) pair is cut into ``num_splits`` splits of
whole live pages, sized on the device from ``kv_len``, so that the grid
fills the card at one slot as well as at eight.  One call is two
launches: (a) each split's scores and local maxima into a scratch, (b)
each split's P.V partial under the global max and denominator, summed
in split order by the pair's last block.  The result is deterministic.
The query heads of a kv head are taken at most ``MAX_G`` per block
(``head_chunk``): past 8 in chunks of about 4, the last one short where
4 does not divide G (G = 12: three chunks of 4; G = 11: 4, 4 and 3),
each chunk reading the pair's K/V rows.
The scratch (scores, maxima, partials and the pairs' arrival counters)
is allocated once per (device, shape) and kept: the decode tick is
bound by the host, and an allocation per call would cost it.  One
shape's scratch serves one stream at a time.

A call may read a sub-range of the pool's kv heads (``kv0``,
``kv_heads``): a rank of a mesh whose model axis the kv heads do not
divide holds every kv head in its pool and reads those its query heads
use, in place.

Its plain version is ``ref.paged_attention_ref``; ``ops.paged_attention``
picks between the two by the tensors' device.  This wrapper takes CUDA
tensors only and raises on anything the kernel does not take.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

MAX_G = 8                      # query heads a block holds in registers
BLOCKS_PER_SM = 4              # the grid (nsplit, K, slots) aims at this many

_P, _I = ctypes.c_void_p, ctypes.c_int
_SCRATCH: dict[tuple, tuple[torch.Tensor, ...]] = {}


@functools.cache
def _lib():
    """The built library, its C signature declared once."""
    lib = _build.load("paged_attention")
    lib.paged_attention_launch.argtypes = [_P] * 10 + [_I] * 10 + \
        [ctypes.c_float, _P]
    lib.paged_attention_launch.restype = _I
    return lib


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def kernel_takes(H: int, K: int, dh: int) -> bool:
    """Whether the kernel takes H query heads over K kv heads of dh: any
    GQA grouping (H % K == 0, as the reference's kernel), dh % 8 == 0 up
    to 256 (16-byte row loads, at most 32 lanes per row)."""
    return K > 0 and H > 0 and H % K == 0 and dh % 8 == 0 and 0 < dh <= 256


def head_chunk(G: int) -> int:
    """Query heads per block for G per kv head: all G up to MAX_G; past
    it ceil(G / 4) chunks as even as they can be (measured on an H100 at
    G = 12: 3 or 4 heads a block beat 6, and 1 re-reads the rows G
    times; ``tools/kernel_variants.py``).  The last chunk may be short."""
    if G <= MAX_G:
        return G
    return -(-G // -(-G // 4))


def head_chunks(G: int) -> int:
    """Chunks of ``head_chunk(G)`` heads that cover G."""
    return -(-G // head_chunk(G))


def num_splits(pairs: int, max_pages: int, sms: int) -> int:
    """Splits per (slot, kv head) pair: enough blocks for BLOCKS_PER_SM on
    each of ``sms`` SMs, at most one per page of the table row."""
    want = -(-BLOCKS_PER_SM * sms // max(pairs, 1))
    return max(1, min(max_pages, want))


def _scratch(device: torch.device, slots: int, K: int, G: int, dh: int,
             T: int, nsplit: int) -> tuple[torch.Tensor, ...]:
    key = (device.index, slots, K, G, dh, T, nsplit)
    buf = _SCRATCH.get(key)
    if buf is None:
        f32 = dict(dtype=torch.float32, device=device)
        pairs = slots * K * head_chunks(G)
        heads = pairs * head_chunk(G)         # a short last chunk padded
        buf = (torch.empty(heads * T, **f32),
               torch.empty(heads * nsplit, **f32),
               torch.empty(heads * nsplit * dh, **f32),
               torch.zeros(pairs, dtype=torch.int32, device=device))
        _SCRATCH[key] = buf
    return buf


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         kv_len: torch.Tensor, kv0: int = 0,
                         kv_heads: int | None = None) -> torch.Tensor:
    """Single-token GQA decode attention through a page table, on the card.

    q: (slots, H, dh) bf16; k/v_pages: (num_pages, page_size, Kp, dh) bf16,
    of whose Kp kv heads the ``kv_heads`` (default all) from ``kv0`` on
    are read, H % kv_heads == 0; page_table: (slots, max_pages) int32
    (entry 0 = the junk page); kv_len: (slots,) int32.  Returns (slots, H,
    dh) bf16.
    """
    tensors = (q, k_pages, v_pages, page_table, kv_len)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_cuda takes CUDA tensors on one "
                         "device; CPU tensors go to ref.paged_attention_ref")
    if not (q.dtype == k_pages.dtype == v_pages.dtype == torch.bfloat16):
        raise ValueError(f"q/k/v must be bfloat16, got {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}")
    if page_table.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise ValueError("page_table and kv_len must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_cuda takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("q/k/v must start on 16-byte boundaries (the "
                         "kernel reads rows with 16-byte loads)")
    slots, H, dh = q.shape
    num_pages, page_size, Kp, dh_kv = k_pages.shape
    K = Kp if kv_heads is None else kv_heads
    if not 0 <= kv0 <= kv0 + K <= Kp:
        raise ValueError(f"kv heads [{kv0}, {kv0 + K}) of a pool of {Kp}")
    if v_pages.shape != k_pages.shape or dh_kv != dh or \
            not kernel_takes(H, K, dh):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_pages.shape)}"
                         f", v {tuple(v_pages.shape)}: kernel takes GQA (H % "
                         f"K == 0) with dh % 8 == 0, dh <= 256")
    G = H // K
    max_pages = page_table.shape[1]
    if page_table.shape[0] != slots or kv_len.shape != (slots,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / kv_len "
                         f"{tuple(kv_len.shape)} do not match {slots} slots")
    gc = head_chunk(G)
    out = torch.empty_like(q)
    if slots == 0:
        return out
    nsplit = num_splits(slots * K * head_chunks(G), max_pages,
                        _sm_count(q.device.index))
    scores, maxes, partials, counters = _scratch(
        q.device, slots, K, G, dh, max_pages * page_size, nsplit)
    rc = _lib().paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        scores.data_ptr(), maxes.data_ptr(), partials.data_ptr(),
        counters.data_ptr(), slots, K, G, gc, dh, page_size, max_pages, nsplit,
        Kp, kv0, 1.0 / math.sqrt(dh), _build.stream_of(q))
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
