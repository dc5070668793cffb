// Paged single-token decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention_pallas` / its body
// `_paged_decode_kernel` (src/repro/kernels/paged_attention.py).
//
// What it computes: for every (slot, kv head), the G = H / K query heads
// of that kv head attend the slot's KV run through its page-table row:
//   s_t  = (q . k_t) * scale                       f32, scale after the dot
//   m    = max_t s_t,  l = sum_t exp(s_t - m)      f32
//   out  = sum_t bf16(exp(s_t - m) / l) * v_t      f32 accumulate -> bf16
// Positions on the junk page 0 or at/after kv_len are masked with p = 0
// (explicitly, never exp(-inf - -inf)); a slot with no live page writes
// exact zeros.  Normalizing THEN rounding each probability to bf16 before
// PV is the reference gather path's recipe (layers.dot_attention rounds
// probs to the value dtype), which keeps kernel-on token streams equal to
// the gather path's.
//
// Bound on this card: device-memory bytes.  A decode tick reads each held
// K/V token once (2 * K * dh * 2 bytes per token) and does 4 * G flops per
// byte-pair of K/V, far below the ~295 flop/byte ridge of an H100.  The
// design reads each K and V row once: the TPU kernel walks the pages three
// times (max, denominator, PV) and recomputes the scores each time; here
// the scores of the slot are computed once into shared memory (G * T
// floats, T = max_pages * page_size) and the max / denominator passes run
// over shared memory, so only the PV pass touches V.
//
// Layout: one block of kThreads threads per (kv head, slot).  Scores: one
// warp per token, each lane loading 4 bf16 of the K row (8-byte vector
// loads, a warp covers a 128-wide row in one 256-byte transaction).  PV:
// each thread owns a pair of output columns (bf16x2 loads of V) for a
// strided subset of the tokens; the column groups are summed through
// shared memory at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reduction; every thread gets the result.  `red` is 32 floats
// of shared scratch; the leading barrier makes back-to-back calls safe.
template <bool kIsMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kIsMax ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = lane < nwarps ? red[lane] : (kIsMax ? -INFINITY : 0.f);
  return kIsMax ? warp_max(v) : warp_sum(v);
}

__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ kv_len,
                    __nv_bfloat16* __restrict__ out,
                    int K, int G, int dh, int page_size, int max_pages,
                    float scale) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  const int T = max_pages * page_size;
  const int kh = blockIdx.x, slot = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int len = kv_len[slot];
  const int32_t* row = page_table + (size_t)slot * max_pages;
  const size_t tok_stride = (size_t)K * dh;      // elements per token
  float* qs = smem;                               // G * dh
  float* sc = smem + G * dh;                      // max(G * T, groups * G * dh)

  const __nv_bfloat16* qh = q + ((size_t)slot * K * G + (size_t)kh * G) * dh;
  for (int i = tid; i < G * dh; i += blockDim.x) qs[i] = __bfloat162float(qh[i]);
  __syncthreads();

  // ---- scores: one warp per token position ----
  for (int pos = warp; pos < T; pos += nwarps) {
    const int page = row[pos / page_size];
    if (page == 0 || pos >= len) {
      if (lane < G) sc[lane * T + pos] = -INFINITY;
      continue;
    }
    const __nv_bfloat16* krow = k_pages +
        ((size_t)page * page_size + pos % page_size) * tok_stride + (size_t)kh * dh;
    float part[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
    for (int d = lane * 4; d < dh; d += 128) {
      const uint2 raw = *reinterpret_cast<const uint2*>(krow + d);
      const float2 k01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 k23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float* qg = qs + g * dh + d;
          part[g] += qg[0] * k01.x + qg[1] * k01.y + qg[2] * k23.x + qg[3] * k23.y;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float s = warp_sum(part[g]);
        if (lane == 0) sc[g * T + pos] = s * scale;
      }
    }
  }
  __syncthreads();

  // ---- max, denominator, then normalized bf16-rounded probabilities ----
  for (int g = 0; g < G; ++g) {
    float* sg = sc + g * T;
    float m = -INFINITY;
    for (int i = tid; i < T; i += blockDim.x) m = fmaxf(m, sg[i]);
    m = block_reduce<true>(m, red);
    float l = 0.f;
    for (int i = tid; i < T; i += blockDim.x)
      if (sg[i] != -INFINITY) l += expf(sg[i] - m);
    l = block_reduce<false>(l, red);
    // each thread rewrites only the entries it read above: no race
    for (int i = tid; i < T; i += blockDim.x) {
      const float s = sg[i];
      sg[i] = s == -INFINITY ? 0.f
                             : __bfloat162float(__float2bfloat16(expf(s - m) / l));
    }
  }
  __syncthreads();

  // ---- PV: thread = (token group, column pair) ----
  const int pairs = dh / 2;
  const int groups = blockDim.x / pairs;
  const int grp = tid / pairs, c = (tid % pairs) * 2;
  float acc[kMaxG][2];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g][0] = acc[g][1] = 0.f;
  if (grp < groups) {
    for (int pos = grp; pos < T; pos += groups) {
      const int page = row[pos / page_size];
      if (page == 0 || pos >= len) continue;
      const __nv_bfloat16* vrow = v_pages +
          ((size_t)page * page_size + pos % page_size) * tok_stride + (size_t)kh * dh;
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vrow + c));
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float p = sc[g * T + pos];
          acc[g][0] += p * v.x;
          acc[g][1] += p * v.y;
        }
      }
    }
  }
  __syncthreads();                                // done reading sc
  float* part = sc;                               // groups * G * dh floats
  if (grp < groups) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        part[(grp * G + g) * dh + c] = acc[g][0];
        part[(grp * G + g) * dh + c + 1] = acc[g][1];
      }
    }
  }
  __syncthreads();
  __nv_bfloat16* oh = out + ((size_t)slot * K * G + (size_t)kh * G) * dh;
  for (int i = tid; i < G * dh; i += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < groups; ++r) s += part[r * G * dh + i];
    oh[i] = __float2bfloat16(s);
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes the launch needs (the wrapper checks them against
// the card's per-block limit before launching).
int paged_attention_smem_bytes(int G, int dh, int page_size, int max_pages) {
  const int T = max_pages * page_size;
  const int groups = kThreads / (dh / 2);
  const int scratch = G * T > groups * G * dh ? G * T : groups * G * dh;
  return (G * dh + scratch) * (int)sizeof(float);
}

// Dynamic shared memory one block may take on the current device: the
// card's opt-in per-block limit less the kernel's static shared memory.
// A negative CUDA error code on failure.
int paged_attention_smem_limit(void) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, paged_decode_kernel);
  if (e != cudaSuccess) return -(int)e;
  return optin - (int)attr.sharedSizeBytes;
}

// q (slots, K*G, dh) bf16; k/v_pages (num_pages, page_size, K, dh) bf16;
// page_table (slots, max_pages) int32; kv_len (slots,) int32;
// out (slots, K*G, dh) bf16.  All contiguous.  Requires G <= 8,
// dh % 8 == 0 and dh <= 256.  Launches on `stream`; returns the CUDA error
// code of the launch (0 on success).
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* kv_len, void* out, int slots, int K,
                           int G, int dh, int page_size, int max_pages,
                           float scale, void* stream) {
  const int smem = paged_attention_smem_bytes(G, dh, page_size, max_pages);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(K, slots);
  paged_decode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int32_t*)page_table,
      (const int32_t*)kv_len, (__nv_bfloat16*)out, K, G, dh, page_size,
      max_pages, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
