"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``),
the port of the Pallas kernel
``repro/kernels/flash_attention.py:flash_attention_pallas``.

Blockwise causal or non-causal GQA attention with an online softmax in
f32, the TPU kernel's ``-1e30`` masking, zeroed masked probabilities and
1e-20 denominator clamp.  The work is bound by operations on the card.
bf16 inputs run on the tensor cores: ``wgmma`` for q.k and for p.v,
one block per (128 query rows, query head, batch) with a producer
warpgroup issuing TMA loads of 128-key K/V tiles into a two-stage ring
and two consumer warpgroups of 64 rows; p is split into two bf16 terms,
p_hi = bf16(p) and p_lo = bf16(p - p_hi), each multiplied with V into
one f32 accumulator, so P.V keeps p at f32 grade (~16 significant bits)
for 1.5x the bf16 work.  f32 inputs stay on CUDA cores (one block per
64 query rows, 64-key tiles), because the tensor cores would round
them to TF32.  Any head dim with ``dh % 8 == 0`` up to 256 runs, each
body compiled for a padded width (16, 32, 64, 128, 192, 256) whose extra
columns are zeros; above 128 the tensor-core body takes 64-key tiles.
Its plain version is ``ref.flash_attention_ref``;
``ops.flash_attention`` picks between the two by the tensors' device.
This wrapper takes CUDA tensors only and raises on anything the kernel
does not take, or when the kernel reports an error; it counts its
launches, and the bf16 ones apart.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 256
MAX_GRID_YZ = 65_535           # CUDA's limit on grid dimensions y and z

_P, _I = ctypes.c_void_p, ctypes.c_int


def kernel_takes(H: int, K: int, dh: int) -> bool:
    """Whether the kernel takes H query heads over K kv heads of dh: GQA
    (H % K == 0) and dh % 8 == 0 up to ``MAX_HEAD_DIM`` (16-byte rows for
    TMA, 8-column steps of the tensor cores' output)."""
    return K > 0 and H % K == 0 and dh % 8 == 0 and 0 < dh <= MAX_HEAD_DIM


@functools.cache
def _lib():
    """The built library, its C signature declared once."""
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [_P] * 4 + [_I] * 9 + \
        [ctypes.c_float, _P]
    lib.flash_attention_launch.restype = _I
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         kv_len: int | None = None) -> torch.Tensor:
    """q: (b, s, H, dh); k/v: (b, t, K, dh) with H % K == 0; one dtype,
    f32 or bf16; ``kernel_takes(H, K, dh)``.  Keys at or past ``kv_len`` (default
    t) are masked; ``causal`` masks key j > query i (top-left aligned).
    Returns (b, s, H, dh) in q's dtype."""
    tensors = (q, k, v)
    if not all(x.is_cuda and x.device == q.device for x in tensors):
        raise ValueError("flash_attention_cuda takes CUDA tensors on one "
                         "device; CPU tensors go to ref.flash_attention_ref")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q/k/v must share one dtype, float32 or bfloat16;"
                         f" got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (b, s, H, dh) and "
                         f"(b, t, K, dh) twice")
    b, s, H, dh = q.shape
    _, t, K, dh_kv = k.shape
    if k.shape[0] != b or dh_kv != dh or not kernel_takes(H, K, dh):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}: "
                         f"kernel takes GQA (H % K == 0) with dh % 8 == 0, "
                         f"dh <= {MAX_HEAD_DIM}")
    if H > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"{H} heads x batch {b}: each must be <= "
                         f"{MAX_GRID_YZ}")
    seq_k = t if kv_len is None else int(kv_len)
    if not 0 <= seq_k <= t:
        raise ValueError(f"kv_len {kv_len} not in [0, {t}]")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("flash_attention_cuda takes contiguous tensors")
    out = torch.empty_like(q)
    rc = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, s, t, H, K, dh, seq_k,
        int(causal), 1.0 / math.sqrt(dh), _build.stream_of(q))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention_cuda.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention_cuda.tensor_core_launches += 1
    return out


flash_attention_cuda.launches = 0
# the bf16 launches among them: those that ran the tensor-core body
flash_attention_cuda.tensor_core_launches = 0
