"""Wrapper of the CUDA paged-decode attention kernel
(``csrc/paged_attention.cu``), the port of the Pallas kernel
``repro/kernels/paged_attention.py:paged_attention_pallas``.

The kernel walks each slot's page-table row on the card: one block per
(kv head, slot) holding that head's G query heads.  Its plain version is
``ref.paged_attention_ref``; ``ops.paged_attention`` picks between the
two by the tensors' device.  This wrapper takes CUDA tensors only and
raises on anything the kernel does not take.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

MAX_G = 8                      # query heads per kv head the kernel holds

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    """The built library, its C signatures declared once."""
    lib = _build.load("paged_attention")
    lib.paged_attention_launch.argtypes = [_P] * 6 + [_I] * 6 + \
        [ctypes.c_float, _P]
    lib.paged_attention_launch.restype = _I
    lib.paged_attention_smem_bytes.argtypes = [_I] * 4
    lib.paged_attention_smem_bytes.restype = _I
    lib.paged_attention_smem_limit.argtypes = []
    lib.paged_attention_smem_limit.restype = _I
    return lib


@functools.cache
def _smem_limit(device_index: int) -> int:
    """Dynamic shared memory one block may take on the (current) device
    ``device_index``, as the card reports it."""
    limit = _lib().paged_attention_smem_limit()
    if limit < 0:
        raise RuntimeError(f"reading the shared-memory limit of cuda:"
                           f"{device_index} failed: CUDA error {-limit}")
    return limit


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """Single-token GQA decode attention through a page table, on the card.

    q: (slots, H, dh) bf16; k/v_pages: (num_pages, page_size, K, dh) bf16;
    page_table: (slots, max_pages) int32 (entry 0 = the junk page);
    kv_len: (slots,) int32.  Returns (slots, H, dh) bf16.
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
    slots, H, dh = q.shape
    num_pages, page_size, K, dh_kv = k_pages.shape
    if v_pages.shape != k_pages.shape or dh_kv != dh or H % K:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k_pages.shape)}"
                         f", v {tuple(v_pages.shape)} do not form GQA")
    G = H // K
    max_pages = page_table.shape[1]
    if page_table.shape[0] != slots or kv_len.shape != (slots,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / kv_len "
                         f"{tuple(kv_len.shape)} do not match {slots} slots")
    if G > MAX_G or dh % 8 or dh > 256:
        raise ValueError(f"kernel takes G <= {MAX_G} and dh % 8 == 0, "
                         f"dh <= 256; got G={G}, dh={dh}")
    out = torch.empty_like(q)
    if slots == 0:
        return out
    lib = _lib()
    stream = _build.stream_of(q)
    smem = lib.paged_attention_smem_bytes(G, dh, page_size, max_pages)
    if smem > _smem_limit(q.device.index):
        raise ValueError(f"{max_pages} pages x {page_size} tokens x G={G} "
                         f"need {smem} B of shared memory > "
                         f"{_smem_limit(q.device.index)}")
    rc = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        slots, K, G, dh, page_size, max_pages, 1.0 / math.sqrt(dh), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0

