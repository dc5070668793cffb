// Fused RMSNorm for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rmsnorm_pallas` / its body
// `_rmsnorm_kernel` (src/repro/kernels/rmsnorm.py).
//
// What it computes, per row of x (rows, d) with weight w (d,) bf16:
//   ms  = sum(x^2) / d                 f32
//   y   = x * rsqrt(ms + eps)          f32
//   out = bf16(y * w)                  f32 multiply, one rounding
// the math of models/layers.rmsnorm, so results do not change when the
// port routes every norm of the model through this kernel.  x is bf16, or
// f32 where the model hands the norm an unrounded residual sum (the
// reference's XLA evaluation keeps that sum in f32; see
// models/transformer.DenseLM.block_apply).
//
// Bound on this card: device-memory bytes (one read of x, one write of
// out, a few flops per element).  One block per row: each thread loads 16
// bytes at a time (8 bf16 or 4 f32, neighbouring threads on neighbouring
// addresses), the f32 sum of squares is reduced across the block, and the
// second pass re-reads its own vectors (L1/L2-resident) to scale them, so
// x and out cross device memory once each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of x as floats: 8 bf16 or 4 f32.
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  static __device__ void load(const __nv_bfloat16* p, float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __bfloat1622float2(h[j]);
      f[2 * j] = v.x;
      f[2 * j + 1] = v.y;
    }
  }
};
template <> struct Vec<float> {
  static constexpr int n = 4;
  static __device__ void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int d, float eps) {
  constexpr int kVec = Vec<T>::n;
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float f[kVec];
  float ss = 0.f;
  for (int i = tid * kVec; i < d; i += kThreads * kVec) {
    Vec<T>::load(x + base + i, f);
#pragma unroll
    for (int j = 0; j < kVec; ++j) ss += f[j] * f[j];
  }
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  ss = lane < kThreads / 32 ? red[lane] : 0.f;
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)d + eps);
  for (int i = tid * kVec; i < d; i += kThreads * kVec) {
    Vec<T>::load(x + base + i, f);
#pragma unroll
    for (int j = 0; j < kVec; j += 2) {
      const float2 g = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(w + i + j));
      *reinterpret_cast<__nv_bfloat162*>(out + base + i + j) =
          __floats2bfloat162_rn((f[j] * r) * g.x, (f[j + 1] * r) * g.y);
    }
  }
}

}  // namespace

extern "C" {

// x (rows, d) bf16 (x_is_f32 == 0) or f32 (x_is_f32 == 1), w (d,) bf16,
// out (rows, d) bf16; all contiguous and 16-byte aligned, d % 8 == 0.
// Launches on `stream`; returns the CUDA error code of the launch.
int rmsnorm_launch(const void* x, int x_is_f32, const void* w, void* out,
                   int rows, int d, float eps, void* stream) {
  if (rows == 0) return 0;
  if (x_is_f32) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)out, d, eps);
  } else {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (__nv_bfloat16*)out,
        d, eps);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
