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
// masking, so a row with no valid key returns exact zeros.  p stays at f32
// grade for the P.V product, as in the TPU kernel.  Key tiles wholly past
// seq_k or wholly above the causal diagonal are skipped: with m still
// -1e30 such a tile changes nothing (correction 1, p = 0), so skipping it
// is exact.  Blocks are launched longest causal rows first.
//
// Bound on this card: operations.  At the deepseek-7b shape (s = t = 4096,
// 32 heads of 128, causal) the two products are 1.4e11 operations on 134
// MB of q/k/v/out, ~1000 per byte, far above the ~295 per byte at which
// the bf16 tensor cores (989 TFLOP/s) become the limit; the least time is
// 0.139 ms.  This kernel does P.V twice (below), 1.5x that work: 0.209 ms.
//
// Head dims.  Both bodies take any dh % 8 == 0 up to 256.  Each is
// compiled for a padded width DP in {16, 32, 64, 128, 192, 256}, the
// least one >= dh; the columns in [dh, DP) of q, k and v are zeros in
// shared memory (loaded as zeros, never read from the tensors), which add
// exact zeros to q . k and give output columns that are not stored.
//
// bf16 (the tensor-core body, `tc`).  One block of 384 threads per (128
// query rows, query head, batch): a producer warpgroup whose one thread
// issues every TMA load, and two consumer warpgroups of 64 query rows
// each, with registers moved from the first to the others by setmaxnreg
// (24 and 240 per thread; 168 at launch).  Key tiles hold 128 keys up to
// DP 128 and 64 keys above it: at dh 32 a 256-key tile would need 128
// score and 128 p registers per thread, past the 240 a consumer has, and
// at DP 192 and 256 the output's 96 and 128 registers leave room for 64
// keys only (and a two-stage ring of 128-key tiles would pass the 232,448
// bytes of shared memory a block may take).  Shared memory holds the Q
// tile once and a ring of 2 stages of K and V tiles, in bf16, laid out
// by TMA with the swizzle that wgmma's descriptors read (128-byte rows
// of 64 columns from DP 64 up, 64-byte at DP 32, 32-byte at DP 16), plus
// 5 mbarriers and 1 KB to align the ring: 164,904 bytes at DP 128 (32 KB
// of Q, 64 KB per stage), 148,520 at DP 192, 197,672 at DP 256, 82,984 at
// DP 64, 42,024 at DP 32, 21,544 at DP 16.  The tensor maps cover q (b,
// s, H, dh) and k/v (b, t, K, dh) in their own layouts (the head a tensor
// dimension, no transpose); they are built per call on the host and
// passed by value.  TMA fills rows past s or t, and columns past dh (at
// dh 112 the second 64-column box of a row holds 48 columns of the
// tensor), with zeros; keys in [seq_k, t) are loaded and masked in
// registers; q rows past s are not stored.  Per key tile, each consumer
// warpgroup:
//   S = Q K^T      wgmma m64n(keys)k16, f32 accumulate, both operands
//                  K-major in shared memory, DP / 16 steps;
//   softmax        in the accumulator's register layout: a row's 4 lanes
//                  reduce the max with shuffles; m, l and the correction
//                  stay in registers; scores are multiplied by
//                  scale * log2(e) (still after the dot) and exponentiated
//                  with exp2f, which rounds otherwise than expf by about an
//                  ulp; only tiles crossing seq_k or the diagonal are
//                  masked, to -inf, so masked p = exp2(-inf) = 0 exactly;
//   O += P V       O rescaled by the correction first; p split in registers
//                  into p_hi = bf16(p) and p_lo = bf16(p - p_hi), both in
//                  the A-from-registers fragment layout (the accumulator's
//                  own), and two wgmma m64n(DP)k16 per 16 keys, B = V read
//                  MN-major (V's rows are keys), into one f32 accumulator;
// then frees the stage on its mbarrier.  out = O / max(l, 1e-20), rounded
// once to bf16.
//
// Why the split: the op promises P.V with p in f32.  bf16 q and k, and p_hi
// or p_lo times bf16 v, are exact products in f32, so only the order of
// the f32 sums differs from the plain version, plus p_lo's own rounding:
// p - p_hi is exact, so p_hi + p_lo carries p to ~16 significant bits
// (relative error ~2^-17).  One bf16 wgmma on p would round p to 8 bits;
// TF32 would run at half the bf16 rate and keep 10 mantissa bits.
//
// f32 (the CUDA-core body, `simt`).  f32 inputs on the tensor cores would
// run in TF32, about three decimal digits, which fails the reference's
// 2e-5 tolerance; so f32 keeps a CUDA-core design: one block per (64
// query rows, query head, batch), q, one 64-key K tile and one V tile
// staged in shared memory as f32 (rows padded by one float, so that column
// reads hit 32 different banks), each of 256 threads holding a 4 x 4 block
// of scores and a 4 x DP/16 block of the output in registers, so that each
// shared-memory read feeds 4 multiply-adds (214,016 bytes of shared memory
// at DP 256).
//
// Both bodies mask partial tiles (any s, t) themselves; the op checks the
// reference's block divisibility.
//
// The C entry point picks the body by dtype.  Neither falls back to the
// other: a failed tensor-map encode or launch returns its error.  wgmma,
// TMA and mbarriers are raw PTX with hand-built descriptors (no CUTLASS or
// CuTe), so the file builds with nvcc alone in a few seconds.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF
constexpr float kMinDenom = 1e-20f;

// ---------------------------------------------------------------------------
// f32: the CUDA-core body

namespace simt {

constexpr int kBQ = 64;             // query rows per block
constexpr int kBK = 64;             // keys per staged tile
constexpr int kThreads = 256;       // 16 x 16 threads

// Stage `rows` rows of dh floats (row r at src + r * stride) into dst with
// row stride DP + 1; rows at or past `valid`, and columns dh..DP-1, are
// zero-filled.  Consecutive threads read consecutive elements of a row.
template <int DP>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      size_t stride, int rows, int valid,
                                      int dh) {
  for (int i = threadIdx.x; i < rows * DP; i += blockDim.x) {
    const int r = i / DP, d = i % DP;
    dst[r * (DP + 1) + d] =
        r < valid && d < dh ? src[(size_t)r * stride + d] : 0.f;
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

template <int DP>
constexpr int smem_floats() {
  return kBQ * (DP + 1) + 2 * kBK * (DP + 1) + kBQ * (kBK + 1);
}

// the dynamic shared memory a block asks for
template <int DP>
constexpr int smem_bytes() {
  return smem_floats<DP>() * (int)sizeof(float);
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int s,
                 int t, int H, int K, int dh, int seq_k, int causal,
                 float scale) {
  constexpr int LD = DP + 1;         // padded row stride of q/k/v tiles
  constexpr int LP = kBK + 1;        // padded row stride of the p tile
  constexpr int CPT = DP / 16;       // output columns per thread
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
  const size_t q_stride = (size_t)H * dh, kv_stride = (size_t)K * dh;
  const float* qb = q + ((size_t)ib * s + q0) * q_stride + (size_t)ih * dh;
  const float* kb = k + (size_t)ib * t * kv_stride + (size_t)kh * dh;
  const float* vb = v + (size_t)ib * t * kv_stride + (size_t)kh * dh;

  stage<DP>(qs, qb, q_stride, kBQ, min(kBQ, s - q0), dh);

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
    stage<DP>(ks, kb + (size_t)k0 * kv_stride, kv_stride, kBK, min(kBK, t - k0),
              dh);
    stage<DP>(vs, vb + (size_t)k0 * kv_stride, kv_stride, kBK, min(kBK, t - k0),
              dh);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
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
    float* orow = out + ((size_t)ib * s + q_pos) * q_stride + (size_t)ih * dh;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (tx + 16 * c < dh) orow[tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int t, int H, int K, int dh, int seq_k, int causal,
           float scale, cudaStream_t stream) {
  const int smem = smem_bytes<DP>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((s + kBQ - 1) / kBQ, H, b);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, s, t, H,
      K, dh, seq_k, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: the tensor-core body

namespace tc {

constexpr int kBQ = 128;            // query rows per block
constexpr int kStages = 2;          // K/V tiles in the ring
constexpr int kConsumers = 2;       // warpgroups, 64 query rows each
constexpr int kThreads = 128 * (1 + kConsumers);   // + the producer's
// registers per thread after rebalancing (setmaxnreg): the producer
// warpgroup gives up what the consumers take, 24 * 128 + 240 * 256 =
// 168 * 384, the launch's share at one block of 384 threads per SM
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry of one padded head dim DP.  Q, K and V tiles are
// stored as TMA writes them with a 128-byte swizzle (64-byte at DP 32,
// 32-byte at DP 16): rows of kRowBytes, the head dim cut into kChunks
// column chunks of kChunk elements, chunk c of a tile of R rows at byte
// c * R * kRowBytes.  An 8-row atom (kAtom bytes) is the swizzle's
// period.  Key tiles hold kBK keys.
template <int DP>
struct Geo {
  static constexpr int kRowBytes = DP >= 64 ? 128 : 2 * DP;
  static constexpr int kChunk = kRowBytes / 2;
  static constexpr int kChunks = DP / kChunk;
  static constexpr int kAtom = 8 * kRowBytes;
  // wgmma's swizzle codes: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kLayout = DP >= 64 ? 1 : DP == 32 ? 2 : 3;
  static constexpr int kBK = DP > 128 ? 64 : 128;
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kTileBytes = kBK * DP * 2;          // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  // + 1024: the dynamic buffer is rounded up to the swizzle's alignment
  static constexpr int kSmemBytes = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at coordinates (c0, c1, c2, c3) of `map` into shared memory
// at `dst`; its bytes count against the expect_tx of barrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle layout (1 = 128 B, 2 = 64 B)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pin accumulator registers at this point of the program: the compiler
// sees them rewritten here, so it moves no read of them above the wait
// that precedes this call.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, f32) = or += A (64 x 16, bf16, shared) * B (16 x 64, bf16,
// shared), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// D (64 x 128, f32) = or += A (64 x 16, bf16, shared) * B (16 x 128, bf16,
// shared), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// D (64 x N, f32) += A (64 x 16, bf16, registers) * B (16 x N, bf16,
// shared, MN-major), N = 16, 32, 64, 128, 192, 256: the head dims
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x kBK keys, f32) = Q (this warpgroup's 64 rows) K^T, over DP in
// steps of 16: both operands K-major, the step's bytes within a swizzled
// row added to the start address, the next column chunk a whole tile on
template <int DP>
__device__ __forceinline__ void qk(float (&sc)[Geo<DP>::kBK / 2], uint32_t q_wg,
                                   uint32_t k_tile) {
  using G = Geo<DP>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = kk * 16 / G::kChunk;
    const uint32_t off = (kk * 16 % G::kChunk) * 2;
    const uint64_t da = make_desc(q_wg + c * kBQ * G::kRowBytes + off, 16,
                                  G::kAtom, G::kLayout);
    const uint64_t db = make_desc(k_tile + c * G::kBK * G::kRowBytes + off, 16,
                                  G::kAtom, G::kLayout);
    wgmma_ss(sc, da, db, kk > 0);
  }
}

// O (64 x DP, f32) += p_hi V + p_lo V over the tile's keys in steps of 16:
// V (keys x DP) read MN-major, 16 keys = 16 swizzled rows further, its
// column chunks a tile apart (the leading byte offset)
template <int DP>
__device__ __forceinline__ void pv(float (&o)[DP / 2],
                                   const uint32_t (&p_hi)[Geo<DP>::kBK / 16][4],
                                   const uint32_t (&p_lo)[Geo<DP>::kBK / 16][4],
                                   uint32_t v_tile) {
  using G = Geo<DP>;
#pragma unroll
  for (int kk = 0; kk < G::kBK / 16; ++kk) {
    const uint64_t db = make_desc(v_tile + kk * 16 * G::kRowBytes,
                                  G::kBK * G::kRowBytes, G::kAtom, G::kLayout);
    wgmma_rs(o, p_hi[kk], db);
    wgmma_rs(o, p_lo[kk], db);
  }
}

// The online softmax of one tile, in the accumulator's layout: element i
// of sc is row row0 + 8 * ((i / 2) % 2), key k0 + 8 * (i / 4) + col + i % 2,
// and the 4 lanes of a row share lane / 4.  Scores go to the log2 domain
// (log2(e) is folded into the scale); masked ones become -inf, so their
// p = exp2(-inf - m) is exactly 0 while m keeps the -1e30 start.  Leaves
// p (f32) in sc, the new row max in m, the correction exp(m_old - m_new)
// in corr, and l = l * corr + the thread's own part of the row sum (the
// 4 lanes are summed once, at the end).
template <int kBK>
__device__ __forceinline__ void softmax(float (&sc)[kBK / 2], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        float scale_log2, bool masked, int k0,
                                        int limit, int causal, int row0,
                                        int col) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int r = (i / 2) % 2;
    float x = sc[i] * scale_log2;
    if (masked) {
      const int kp = k0 + 8 * (i / 4) + col + i % 2;
      if (kp >= limit || (causal && kp > row0 + 8 * r)) x = -INFINITY;
    }
    sc[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = exp2f(sc[i] - m[r]);
    l[r] += sc[i];
  }
}

// p = p_hi + p_lo, both bf16, as wgmma A fragments: key step kk's register
// j holds the pair p[8 kk + 2 j], p[8 kk + 2 j + 1] (rows and keys of the
// accumulator layout are those of the A layout).  p - p_hi is exact in
// f32, so p_hi + p_lo carries p to ~16 significant bits.
template <int kBK>
__device__ __forceinline__ void split(const float (&p)[kBK / 2],
                                      uint32_t (&p_hi)[kBK / 16][4],
                                      uint32_t (&p_lo)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = p[8 * kk + 2 * j], b = p[8 * kk + 2 * j + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
      p_hi[kk][j] = bits(hi);
      p_lo[kk][j] = bits(__floats2bfloat162_rn(a - __low2float(hi),
                                               b - __high2float(hi)));
    }
}

// Key tile kt of kv head kh into its ring stage: K and V, each in
// kChunks TMA boxes, completing on the stage's `full` barrier
template <int DP>
__device__ __forceinline__ void load_kv(const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, uint32_t k_sm,
                                        uint32_t v_sm, uint32_t full, int kt,
                                        int kh, int ib) {
  using G = Geo<DP>;
  const int st = kt % kStages;
  mbar_expect_tx(full + 8 * st, 2 * G::kTileBytes);
#pragma unroll
  for (int c = 0; c < G::kChunks; ++c) {
    const uint32_t off = st * G::kTileBytes + c * G::kBK * G::kRowBytes;
    tma_load(k_sm + off, tm_k, full + 8 * st, c * G::kChunk, kh, kt * G::kBK,
             ib);
    tma_load(v_sm + off, tm_v, full + 8 * st, c * G::kChunk, kh, kt * G::kBK,
             ib);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc(__grid_constant__ const CUtensorMap tm_q,
             __grid_constant__ const CUtensorMap tm_k,
             __grid_constant__ const CUtensorMap tm_v,
             __nv_bfloat16* __restrict__ out, int s, int t, int H, int K,
             int dh, int seq_k, int causal, float scale_log2) {
  using G = Geo<DP>;
  constexpr int kBK = G::kBK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_sm = base;
  const uint32_t k_sm = base + G::kQBytes;                        // + st * kTileBytes
  const uint32_t v_sm = base + G::kQBytes + kStages * G::kTileBytes;
  const uint32_t q_full = base + G::kBarOffset;
  const uint32_t full = q_full + 8;                               // + 8 * st
  const uint32_t empty = q_full + 8 * (1 + kStages);              // + 8 * st

  const int n_qt = (s + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;   // longest causal rows first
  const int ih = blockIdx.y, ib = blockIdx.z;
  const int kh = ih / (H / K);
  const int q0 = qt * kBQ;
  const int limit = min(seq_k, t);
  const int kv_end = causal ? min(limit, min(q0 + kBQ, s)) : limit;
  const int n_kt = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load; a stage is
    // refilled once both consumer warpgroups have released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, G::kQBytes);
#pragma unroll
      for (int c = 0; c < G::kChunks; ++c)
        tma_load(q_sm + c * kBQ * G::kRowBytes, &tm_q, q_full, c * G::kChunk,
                 ih, q0, ib);
      for (int kt = 0; kt < n_kt; ++kt) {
        // round kt / kStages of a stage waits for the consumers' release
        // of round kt / kStages - 1 (the first round passes at once)
        mbar_wait(empty + 8 * (kt % kStages), ((kt / kStages) & 1) ^ 1);
        load_kv<DP>(&tm_k, &tm_v, k_sm, v_sm, full, kt, kh, ib);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));

  const int tid = threadIdx.x - 128;
  const int w = tid / 128;                   // consumer warpgroup
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = q0 + 64 * w + 16 * warp + lane / 4;   // and row0 + 8
  const int col = 2 * (lane % 4);
  const uint32_t q_wg = q_sm + 64 * w * G::kRowBytes;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    mbar_wait(full + 8 * st, (kt / kStages) & 1);
    float sc[kBK / 2];
    wg_fence();
    qk<DP>(sc, q_wg, k_sm + st * G::kTileBytes);
    wg_commit();
    wg_wait_all();
    pin(sc);
    // only tiles that cross kv_len or this warpgroup's causal diagonal
    // are masked
    float corr[2];
    const int k0 = kt * kBK;
    softmax<kBK>(sc, m, l, corr, scale_log2,
            k0 + kBK > limit || (causal && k0 + kBK - 1 > q0 + 64 * w), k0,
            limit, causal, row0, col);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i / 2) % 2];
    uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
    split<kBK>(sc, p_hi, p_lo);
    wg_fence();
    pv<DP>(o, p_hi, p_lo, v_sm + st * G::kTileBytes);
    wg_commit();
    wg_wait_all();
    pin(o);
    mbar_arrive(empty + 8 * st);   // both warpgroups free the stage
  }

  // out = O / max(l, 1e-20), rounded once to bf16; rows past s and
  // columns past dh not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], kMinDenom);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= s) continue;
    __nv_bfloat16* orow = out + (((size_t)ib * s + row) * H + ih) * dh + col;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < dh)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
            o[4 * j + 2 * r] / l[r], o[4 * j + 2 * r + 1] / l[r]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// Tensor map over a contiguous (b, n, heads, dh) bf16 tensor in its own
// layout: dims (dh, heads, n, b), innermost first; the box is one chunk
// of the padded head dim, one head, `rows` rows of n and one batch.
// Coordinates past n or past dh are filled with zeros.
template <int DP>
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int b,
                int n, int heads, int dh, int rows) {
  using G = Geo<DP>;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)n,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)n * heads * dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::kChunk, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            G::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
            : G::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int t, int H, int K, int dh, int seq_k, int causal,
           float scale, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 ||
      (uintptr_t)out % 4)
    return (int)cudaErrorMisalignedAddress;
  // t == 0: no key is ever loaded; the K/V maps only need a valid address
  const void* kp = t > 0 ? k : q;
  const void* vp = t > 0 ? v : q;
  CUtensorMap mq, mk, mv;
  constexpr int kBK = Geo<DP>::kBK;
  CUresult r = encode<DP>(fn, &mq, q, b, s, H, dh, kBQ);
  if (r == CUDA_SUCCESS)
    r = encode<DP>(fn, &mk, kp, b, t > 0 ? t : 1, K, dh, kBK);
  if (r == CUDA_SUCCESS)
    r = encode<DP>(fn, &mv, vp, b, t > 0 ? t : 1, K, dh, kBK);
  if (r != CUDA_SUCCESS) return (int)r;
  const int smem = Geo<DP>::kSmemBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s + kBQ - 1) / kBQ, H, b);
  flash_fwd_tc<DP><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, s, t, H, K, dh, seq_k, causal,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <int DP>
int launch_dp(const void* q, const void* k, const void* v, void* out, int bf16,
              int b, int s, int t, int H, int K, int dh, int seq_k, int causal,
              float scale, cudaStream_t stream) {
  return bf16 ? tc::launch<DP>(q, k, v, out, b, s, t, H, K, dh, seq_k, causal,
                               scale, stream)
              : simt::launch<DP>(q, k, v, out, b, s, t, H, K, dh, seq_k, causal,
                                 scale, stream);
}

// The shared memory of the body launch_dp<DP> runs: the static bytes of
// the compiled kernel and the dynamic bytes its launcher asks for.
template <int DP>
int smem_dp(int bf16, int* static_bytes, int* dynamic_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = bf16 ? cudaFuncGetAttributes(&a, tc::flash_fwd_tc<DP>)
                             : cudaFuncGetAttributes(&a, simt::flash_fwd_kernel<DP>);
  if (e != cudaSuccess) return (int)e;
  *static_bytes = (int)a.sharedSizeBytes;
  *dynamic_bytes = bf16 ? tc::Geo<DP>::kSmemBytes : simt::smem_bytes<DP>();
  return 0;
}

}  // namespace

extern "C" {

// q (b, s, H, dh), k/v (b, t, K, dh), out (b, s, H, dh); all contiguous, of
// one dtype (bf16 when `bf16` is nonzero, else f32); H % K == 0, dh % 8 ==
// 0 and 8 <= dh <= 256; keys at or past `seq_k` are masked.  bf16 runs the
// tensor-core body, f32 the CUDA-core body; neither falls back to the
// other.  Launches on `stream` (nothing when s, H or b is 0); returns 0 on
// success, else the error: the CUDA runtime's of the launch, the driver's
// of a tensor-map encode, cudaErrorInvalidValue for a dh it does not take,
// cudaErrorMisalignedAddress for bf16 q/k/v not 16-byte aligned.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int bf16, int b, int s, int t, int H,
                           int K, int dh, int seq_k, int causal, float scale,
                           void* stream) {
  if (K <= 0 || H % K || dh % 8 || dh < 8 || dh > 256)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || s == 0 || H == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define FLASH_DP(n)                                                          \
  if (dh <= n)                                                               \
    return launch_dp<n>(q, k, v, out, bf16, b, s, t, H, K, dh, seq_k, causal, \
                        scale, st);
  FLASH_DP(16) FLASH_DP(32) FLASH_DP(64) FLASH_DP(128) FLASH_DP(192)
  FLASH_DP(256)
#undef FLASH_DP
  return (int)cudaErrorInvalidValue;
}

// Shared memory of the kernel flash_attention_launch runs for (bf16, dh):
// its static bytes as compiled (cudaFuncGetAttributes) and the dynamic
// bytes its launch asks for.  Launches nothing; returns the CUDA error of
// the query, cudaErrorInvalidValue for a dh the launch refuses.
int flash_attention_smem(int bf16, int dh, int* static_bytes,
                         int* dynamic_bytes) {
  if (dh % 8 || dh < 8 || dh > 256) return (int)cudaErrorInvalidValue;
#define FLASH_SMEM(n) \
  if (dh <= n) return smem_dp<n>(bf16, static_bytes, dynamic_bytes);
  FLASH_SMEM(16) FLASH_SMEM(32) FLASH_SMEM(64) FLASH_SMEM(128) FLASH_SMEM(192)
  FLASH_SMEM(256)
#undef FLASH_SMEM
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
