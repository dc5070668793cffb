// Blockwise (flash) GQA attention with an online softmax for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` / its body
// `_flash_kernel` (src/repro/kernels/flash_attention.py).
//
// What it computes, for q (b, s, H, dh) and k/v (b, t, K, dh), H % K == 0,
// query head ih reading kv head ih / (H / K):
//   s_ij = (q_i . k_j) * scale                        f32, scale after the dot
//   mask_ij = j < seq_k  and, if causal, j <= i         (top-left aligned)
//   s_ij = mask ? s_ij : -1e30
//   online over key tiles:  m' = max(m, max_j s_ij)
//                           p_ij = mask ? exp(s_ij - m') : 0
//                           l' = l * exp(m - m') + sum_j p_ij
//                           acc' = acc * exp(m - m') + sum_j p_ij v_j
//   out_i = acc / max(l, 1e-20)                       cast to q's dtype
// with m starting at -1e30 and l, acc at 0: the TPU kernel's constants and
// masking, so a row with no valid key returns exact zeros.  p stays f32
// for the P.V product, as in the TPU kernel.
//
// Bound on this card: operations.  At the deepseek-7b shape (s = t = 4096,
// 32 heads of 128, causal) the products are 1.4e11 flops on 134 MB of
// q/k/v/out, ~1000 flops per byte, far above the ~295 flop/byte ridge.
// The least time is the tensor cores' (989 TFLOP/s bf16).  This first
// design runs the products on CUDA cores in f32 (67 TFLOP/s at best), so
// it cannot come within 15x of that bound; a wgmma/TMA design is later
// work.  What the design does: one block per (q tile of 64 rows, q head,
// batch); the q tile, one 64-key K tile and one V tile are staged in
// shared memory as f32 (rows padded by one float, so that the column
// reads below hit 32 different banks); each of the 256 threads holds a
// 4 x 4 block of scores (rows ty + 16 i, keys tx + 16 j) and a 4 x dh/16
// block of the output in registers, so each shared-memory read feeds 4
// multiply-adds.  Key tiles wholly past seq_k or wholly above the causal
// diagonal are skipped: with m still -1e30 such a tile changes nothing
// (correction exp(0) = 1, p = 0), so skipping it is exact.  Blocks are
// launched longest causal rows first.  Partial tiles (any s, t) are
// masked here; the op checks the reference's block divisibility.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per staged tile
constexpr int kThreads = 256;       // 16 x 16 threads
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF
constexpr float kMinDenom = 1e-20f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Stage `rows` rows of DH elements (row r at src + r * stride) into dst as
// f32 with row stride DH + 1; rows at or past `valid` are zero-filled.
// Consecutive threads read consecutive elements of a row.
template <int DH, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      size_t stride, int rows, int valid) {
  for (int i = threadIdx.x; i < rows * DH; i += blockDim.x) {
    const int r = i / DH, d = i % DH;
    dst[r * (DH + 1) + d] = r < valid ? to_f32(src[(size_t)r * stride + d]) : 0.f;
  }
}

// Max / sum over the 16 lanes that hold one row (lanes tx = 0..15 of a
// half warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DH>
constexpr int smem_floats() {
  return kBQ * (DH + 1) + 2 * kBK * (DH + 1) + kBQ * (kBK + 1);
}

template <int DH, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int s, int t,
                 int H, int K, int seq_k, int causal, float scale) {
  constexpr int LD = DH + 1;         // padded row stride of q/k/v tiles
  constexpr int LP = kBK + 1;        // padded row stride of the p tile
  constexpr int CPT = DH / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* ps = vs + kBK * LD;

  const int n_qt = (s + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;   // longest causal rows first
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int kh = ih / (H / K);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kBQ;
  const size_t q_stride = (size_t)H * DH, kv_stride = (size_t)K * DH;
  const T* qb = q + ((size_t)ib * s + q0) * q_stride + (size_t)ih * DH;
  const T* kb = k + (size_t)ib * t * kv_stride + (size_t)kh * DH;
  const T* vb = v + (size_t)ib * t * kv_stride + (size_t)kh * DH;

  stage<DH>(qs, qb, q_stride, kBQ, min(kBQ, s - q0));

  float acc[4][CPT], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  // keys at or past `limit` are masked; causal rows of this tile see keys
  // below min(q0 + kBQ, s) at most, so later tiles are wholly masked
  const int limit = min(seq_k, t);
  const int kv_end = causal ? min(limit, min(q0 + kBQ, s)) : limit;
  const int n_kt = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                 // the previous tile's reads are done
    stage<DH>(ks, kb + (size_t)k0 * kv_stride, kv_stride, kBK, min(kBK, t - k0));
    stage<DH>(vs, vb + (size_t)k0 * kv_stride, kv_stride, kBK, min(kBK, t - k0));
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        valid[j] = k_pos < limit && (!causal || k_pos <= q_pos);
        sc[i][j] = valid[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        rs += p;
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + row_sum(rs);
      m[i] = m_new;
    }
    __syncthreads();                 // the p tile is complete

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float pv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) pv[c] = 0.f;
      const float* prow = ps + (ty + 16 * i) * LP;
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        const float p = prow[j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) pv[c] += p * vs[j * LD + tx + 16 * c];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = acc[i][c] * corr[i] + pv[c];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + ty + 16 * i;
    if (q_pos >= s) continue;
    const float denom = fmaxf(l[i], kMinDenom);
    T* orow = out + ((size_t)ib * s + q_pos) * q_stride + (size_t)ih * DH;
#pragma unroll
    for (int c = 0; c < CPT; ++c) store(orow + tx + 16 * c, acc[i][c] / denom);
  }
}

template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int t, int H, int K, int seq_k, int causal, float scale,
           cudaStream_t stream) {
  const int smem = smem_floats<DH>() * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((s + kBQ - 1) / kBQ, H, b);
  flash_fwd_kernel<DH, T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, s, t, H, K, seq_k,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out, int b,
              int s, int t, int H, int K, int dh, int seq_k, int causal,
              float scale, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<32, T>(q, k, v, out, b, s, t, H, K, seq_k, causal, scale, stream);
    case 64: return launch<64, T>(q, k, v, out, b, s, t, H, K, seq_k, causal, scale, stream);
    case 128: return launch<128, T>(q, k, v, out, b, s, t, H, K, seq_k, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (b, s, H, dh), k/v (b, t, K, dh), out (b, s, H, dh); all contiguous, of
// one dtype (bf16 when `bf16` is nonzero, else f32); H % K == 0, dh in
// {32, 64, 128}; keys at or past `seq_k` are masked.  Launches on `stream`
// (nothing when s, H or b is 0); returns the CUDA error code of the launch
// (0 on success, cudaErrorInvalidValue for a dh without an instance).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int bf16, int b, int s, int t, int H,
                           int K, int dh, int seq_k, int causal, float scale,
                           void* stream) {
  if (K <= 0 || H % K) return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0 || H == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_dh<__nv_bfloat16>(q, k, v, out, b, s, t, H, K, dh, seq_k, causal, scale, st)
              : launch_dh<float>(q, k, v, out, b, s, t, H, K, dh, seq_k, causal, scale, st);
}

}  // extern "C"
