// RMSNorm, and the residual add fused into it, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rmsnorm_pallas` / its body
// `_rmsnorm_kernel` (src/repro/kernels/rmsnorm.py), which exists to give
// one device-memory read and one write per element in place of the
// unfused chain.
//
// Two entries, one kernel:
//   rmsnorm_launch      y = bf16(t * rsqrt(mean(t^2) + eps) * f32(w)),
//                       t = f32(x), x bf16 or f32 (rows, d);
//   add_rmsnorm_launch  s = f32(x) + f32(a), x and a bf16 (rows, d), and
//                       r = bf16(s), the new residual stream, and y as above
//                       with t = s (norm_of_rounded == 0) or t = f32(r)
//                       (norm_of_rounded == 1).
// The mean is an f32 sum of t^2 over the row divided by d, and y rounds
// once: (t * rsqrt) * w in f32, then bf16; the math of models/layers.
// rmsnorm.  The fused entry is the model's residual add and the next
// norm in one pass: the reference's XLA program fuses `x + attn_out` into
// the block's second norm, which reads the unrounded f32 sum (t = s),
// and the MLP's add into the next block's first norm or the final norm,
// which read the rounded stream the layer scan carries (t = f32(r)).
//
// Bound on this card: device-memory bytes (x and a read once, r and y
// written once, w read once; a few operations per element), and at the
// decode shapes (8 rows of 4,096) the launch itself: 270 KB take 0.08 us,
// far below what any launch costs.  So the design keeps every element in
// registers between the two passes and asks little of the launch:
//   - one CTA a row.  Each thread holds `NV` vectors of 8 elements
//     (16-byte loads, the vectors of a block adjacent, so that a warp
//     reads 512 contiguous bytes), loads x, a and w once and keeps t in
//     registers from the sum of squares to the scaling (no second read of
//     x).  The sum of squares runs in one fixed order (thread order, then
//     a xor butterfly in each warp, then the warps in order), so two calls
//     give the same bits.  The wrapper picks the block size and NV from d
//     alone: 512 threads hold a row of 4,096 at one vector each, and up to
//     32,768 at eight;
//   - a plain launch.  Splitting a row over a thread-block cluster (sums
//     exchanged through distributed shared memory) was slower at the
//     decode path's d = 4,096, and programmatic dependent launch gained
//     nothing behind the cuBLAS GEMM that feeds the norm on that path
//     (tools/kernel_variants.py times the latter as a variant).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;    // 128 registers a thread for t and w

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void bf16x8(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = __bfloat1622float2(h[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

// 8 elements of x as floats: one 16-byte load of bf16, two of f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  bf16x8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One row per CTA; `a` null: the plain norm of x; `r_out` null: no
// residual output.
template <typename T, int NV>
__global__ void __launch_bounds__(kMaxThreads)
norm_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ a,
            const __nv_bfloat16* __restrict__ w,
            __nv_bfloat16* __restrict__ r_out,
            __nv_bfloat16* __restrict__ y_out, int d, float eps,
            int norm_of_rounded) {
  __shared__ float red[kMaxThreads / 32];
  __shared__ float total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const size_t base = (size_t)blockIdx.x * d;
  const int col0 = tid * 8;           // vector v at col0 + v * nthreads * 8

  uint4 wr[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int col = col0 + v * nthreads * 8;
    wr[v] = col < d ? *reinterpret_cast<const uint4*>(w + col)
                    : make_uint4(0, 0, 0, 0);
  }

  float t[NV][8];
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int col = col0 + v * nthreads * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) t[v][j] = 0.f;
    if (col >= d) continue;
    load8(x + base + col, t[v]);
    if (a != nullptr) {
      float av[8];
      load8(a + base + col, av);
      uint4 rr;
      uint32_t* rp = reinterpret_cast<uint32_t*>(&rr);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        t[v][j] += av[j];
        t[v][j + 1] += av[j + 1];
        rp[j / 2] = pack2(t[v][j], t[v][j + 1]);
      }
      *reinterpret_cast<uint4*>(r_out + base + col) = rr;
      if (norm_of_rounded) bf16x8(rr, t[v]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += t[v][j] * t[v][j];
  }
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < nthreads / 32; ++i) s += red[i];
    total = s;
  }
  __syncthreads();
  const float rs = rsqrtf(total / (float)d + eps);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int col = col0 + v * nthreads * 8;
    if (col >= d) continue;
    float wf[8];
    bf16x8(wr[v], wf);
    uint4 yy;
    uint32_t* yp = reinterpret_cast<uint32_t*>(&yy);
#pragma unroll
    for (int j = 0; j < 8; j += 2)
      yp[j / 2] = pack2((t[v][j] * rs) * wf[j], (t[v][j + 1] * rs) * wf[j + 1]);
    *reinterpret_cast<uint4*>(y_out + base + col) = yy;
  }
}

template <typename T, int NV>
cudaError_t launch_nv(const T* x, const __nv_bfloat16* a,
                      const __nv_bfloat16* w, __nv_bfloat16* r_out,
                      __nv_bfloat16* y_out, int rows, int d, float eps,
                      int norm_of_rounded, int threads, cudaStream_t stream) {
  norm_kernel<T, NV><<<rows, threads, 0, stream>>>(x, a, w, r_out, y_out, d,
                                                   eps, norm_of_rounded);
  return cudaGetLastError();
}

template <typename T>
int launch(const T* x, const __nv_bfloat16* a, const __nv_bfloat16* w,
           __nv_bfloat16* r_out, __nv_bfloat16* y_out, int rows, int d,
           float eps, int norm_of_rounded, int threads, int nv,
           cudaStream_t stream) {
  if (d <= 0 || d % 8 || threads < 32 || threads > kMaxThreads ||
      threads % 32 || (long long)threads * nv * 8 < d)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
#define NORM_NV(n)                                                         \
  case n:                                                                  \
    return (int)launch_nv<T, n>(x, a, w, r_out, y_out, rows, d, eps,       \
                                norm_of_rounded, threads, stream);
  switch (nv) {
    NORM_NV(1) NORM_NV(2) NORM_NV(4) NORM_NV(8)
  }
#undef NORM_NV
  return (int)cudaErrorInvalidValue;
}

// The shared memory of norm_kernel<T, NV>: the static bytes as compiled;
// launch_nv asks for no dynamic bytes.
template <typename T, int NV>
int smem_nv(int* static_bytes, int* dynamic_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, norm_kernel<T, NV>);
  if (e != cudaSuccess) return (int)e;
  *static_bytes = (int)a.sharedSizeBytes;
  *dynamic_bytes = 0;
  return 0;
}

template <typename T>
int smem(int nv, int* static_bytes, int* dynamic_bytes) {
  switch (nv) {
    case 1: return smem_nv<T, 1>(static_bytes, dynamic_bytes);
    case 2: return smem_nv<T, 2>(static_bytes, dynamic_bytes);
    case 4: return smem_nv<T, 4>(static_bytes, dynamic_bytes);
    case 8: return smem_nv<T, 8>(static_bytes, dynamic_bytes);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (rows, d) bf16 (x_is_f32 == 0) or f32 (x_is_f32 == 1), w (d,) bf16,
// out (rows, d) bf16; all contiguous and 16-byte aligned, d % 8 == 0.  A
// row is one CTA of `threads` threads (a multiple of 32, at most 512),
// each thread holding `nv` vectors of 8 elements (1, 2, 4 or 8), threads *
// nv * 8 >= d.  Launches on `stream`; returns the CUDA error code of the
// launch (cudaErrorInvalidValue for a shape or plan it does not take).
int rmsnorm_launch(const void* x, int x_is_f32, const void* w, void* out,
                   int rows, int d, float eps, int threads, int nv,
                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* wp = (const __nv_bfloat16*)w;
  __nv_bfloat16* op = (__nv_bfloat16*)out;
  if (x_is_f32)
    return launch((const float*)x, nullptr, wp, nullptr, op, rows, d, eps, 0,
                  threads, nv, st);
  return launch((const __nv_bfloat16*)x, nullptr, wp, nullptr, op, rows, d,
                eps, 0, threads, nv, st);
}

// x, a (rows, d) bf16, w (d,) bf16; writes the residual r = bf16(x + a)
// to r_out and its norm to y_out, both (rows, d) bf16, the norm of the
// f32 sum (norm_of_rounded == 0) or of r (norm_of_rounded == 1).  The
// rest as rmsnorm_launch.
int add_rmsnorm_launch(const void* x, const void* a, const void* w,
                       void* r_out, void* y_out, int rows, int d, float eps,
                       int norm_of_rounded, int threads, int nv,
                       void* stream) {
  return launch((const __nv_bfloat16*)x, (const __nv_bfloat16*)a,
                (const __nv_bfloat16*)w, (__nv_bfloat16*)r_out,
                (__nv_bfloat16*)y_out, rows, d, eps, norm_of_rounded, threads,
                nv, (cudaStream_t)stream);
}

// Shared memory of the kernel the launches run for x of f32 (x_is_f32 ==
// 1) or bf16 and nv vectors a thread: its static bytes as compiled
// (cudaFuncGetAttributes) and the dynamic bytes its launch asks for.
// Launches nothing; returns the CUDA error of the query.
int rmsnorm_smem(int x_is_f32, int nv, int* static_bytes,
                 int* dynamic_bytes) {
  return x_is_f32 ? smem<float>(nv, static_bytes, dynamic_bytes)
                  : smem<__nv_bfloat16>(nv, static_bytes, dynamic_bytes);
}

}  // extern "C"
