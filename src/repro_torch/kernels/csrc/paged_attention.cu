// Paged single-token decode attention for NVIDIA Hopper (sm_90a), split
// over the KV run so that the grid fills the card at any slot count.
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
// (explicitly, never exp(-inf - -inf)) and never read; a slot with no
// live page writes exact zeros.  Normalizing with the GLOBAL m and l and
// THEN rounding each probability to bf16 before PV is the reference
// gather path's recipe (layers.dot_attention rounds probs to the value
// dtype), which keeps kernel-on token streams equal to the gather path's.
// That recipe rules out FlashDecoding's rescaling of unnormalized partial
// outputs by exp(m_i - m): a probability may be rounded only once the
// whole run's m and l are known.
//
// Bound on this card: device-memory bytes.  A call reads each live K and V
// row once (2 * K * dh * 2 bytes per token) and does 4 * G operations per
// byte-pair of K/V, far below the ~295 operations per byte of an H100's
// ridge.  So the design is about bytes in flight and full SMs.
//
// Work split.  Each (slot, kv head) pair is cut into `nsplit` splits of
// whole pages: of the P = ceil(min(kv_len, T) / page_size) live pages,
// split i takes pages [i P / nsplit, (i + 1) P / nsplit), so the splits
// follow kv_len on the device and pages past it are never walked.  The
// wrapper picks nsplit from the pair count and the SM count (about four
// blocks per SM), so 1 slot fills the card as well as 8 do.  Two kernels,
// grid (nsplit, K, slots), 128 threads a block:
//   (a) paged_scores_kernel: each split computes its scores into a device
//       scratch (slots, K, G, T) and its local max per query head.
//   (b) paged_pv_kernel: each split takes m as the max of the local maxima,
//       computes l over ALL the pair's scores (read back from L2) in one
//       fixed order, so every split gets the same l bit for bit, rounds
//       bf16(exp(s - m) / l) for its own tokens and writes its f32 P.V
//       partial.  The last block of the pair to finish (a ticket: an
//       atomicAdd on the pair's int counter after __threadfence) sums the
//       partials in split order into the bf16 output and resets the
//       counter to 0, so the next call (or a CUDA-graph replay) finds it
//       so.  No float atomics: the same inputs give the same bits.
// Head chunks.  A block holds the q vectors and P.V accumulators of its
// query heads in registers (qf[G][8], acc[G][8]), which spill past 8
// heads.  So past 8 the G query heads of a kv head are cut into hc =
// ceil(G / gc) chunks of gc heads (the wrapper's head_chunk: about 4, the
// fastest measured at G = 12), the last one holding the G - (hc - 1) gc
// heads left (G = 11: 4, 4 and 3).  Each chunk is a pair of its own: the
// grid's y runs over the K * hc (kv head, chunk) pairs, which read the kv
// head's rows.  q and out keep their (slots, H, dh) layout: a chunk reads
// and writes only its own heads, and a short chunk's missing heads are
// zero q vectors whose results are never written.  The scratch is laid out
// per pair, gc heads each.  Each chunk's blocks read the kv head's K and
// V rows again: hc times the rows' bytes per call (3 times at G = 12, 4
// at G = 16), mostly from L2 where the chunks run together.  Each head's
// m, l, p and partials are computed exactly as with one chunk: the same
// bits.
// Rows: a K or V row of dh bf16 is read with 16-byte loads, 8 bf16 per
// lane, by a group of lpr = pow2ceil(dh / 8) lanes (16 at dh 128, so a
// warp covers two rows per load).  Each lane keeps two batches of kUnroll
// row loads in flight (the next batch loads while the current one is
// used), and the split's page ids are staged in shared memory kPageChunk
// at a time, so no row load waits on a page-table load.  (b) starts
// before (a) ends (programmatic dependent launch: (a) lets it launch at
// once, (b) loads its first V rows, which are inputs, and only then waits
// for (a)'s scores at griddepcontrol.wait), so its loads overlap (a)'s
// tail and the gap between the launches.  Shared memory does not depend
// on T: kPageChunk ints, and in (b) kWarps * G * dh floats to sum its
// warps' partials.
// A sub-range of the pool's kv heads.  The pool may hold more kv heads
// (Kp) than the call reads: a rank of a mesh whose model axis the kv
// heads do not divide keeps every kv head and reads the K heads
// [kv0, kv0 + K) its query heads use.  Only a row's address changes (its
// head stride is Kp, its head kv0 + kh); q, out and the scratch hold the
// K heads read, as they do at Kp = K, kv0 = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                        // row loads in flight per lane
constexpr int kMaxG = 8;
constexpr int kPageChunk = 64;                    // page ids staged at a time

struct Geo {
  int K, heads, hc, dh, page_size, max_pages, nsplit, lpr, Kp, kv0;
};  // heads: query heads per kv head, hc: their chunks; Kp: the pool's kv
    // heads, kv0: the first of the K read

// First query head of the block's chunk, and how many of its gc heads are
// real (fewer in the last chunk where gc does not divide the heads).
__device__ __forceinline__ int chunk_heads(int slot, int gc, const Geo& g,
                                           int& nh) {
  const int kh = blockIdx.y / g.hc, ci = blockIdx.y % g.hc;
  nh = min(gc, g.heads - ci * gc);
  return (slot * g.K + kh) * g.heads + ci * gc;
}

// Pages [p0, p1) of `split` in a run of len_eff tokens (p1 <= p0: none).
__device__ __forceinline__ void split_pages(int len_eff, const Geo& g,
                                            int split, int& p0, int& p1) {
  const int P = (len_eff + g.page_size - 1) / g.page_size;
  p0 = (int)((long long)split * P / g.nsplit);
  p1 = (int)((long long)(split + 1) * P / g.nsplit);
}

__device__ __forceinline__ int live_len(const int32_t* kv_len, int slot,
                                        const Geo& g) {
  return max(0, min(kv_len[slot], g.max_pages * g.page_size));
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

// Address of the bf16 row of token `pos` of kv head kh on `page`.
__device__ __forceinline__ const __nv_bfloat16* row_at(
    const __nv_bfloat16* pages, int page, int pos, int kh, const Geo& g) {
  return pages + (((size_t)page * g.page_size + pos % g.page_size) * g.Kp +
                  g.kv0 + kh) * g.dh;
}

// The rows a warp loads at once: kUnroll loads per lane, each lane group
// of lpr lanes covering one row.  Rows at or past `tb`, or on page 0, are
// dead: not loaded, p = 0.
struct Batch {
  uint4 raw[kUnroll];
  int pos[kUnroll];
  bool live[kUnroll];
};

// Load the batch of rows starting at token `base` of the chunk whose page
// ids (from page pc0 on) are in `spg`.
__device__ __forceinline__ void fetch(Batch& b, const __nv_bfloat16* pages,
                                      const int* spg, int pc0, int base,
                                      int tb, int kh, int warp, int grp,
                                      int rpl, int c, bool on, const Geo& g) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    b.pos[u] = base + (u * kWarps + warp) * rpl + grp;
    const int page = b.pos[u] < tb ? spg[b.pos[u] / g.page_size - pc0] : 0;
    b.live[u] = page != 0;
    b.raw[u] = make_uint4(0, 0, 0, 0);
    if (b.live[u] && on)
      b.raw[u] = *reinterpret_cast<const uint4*>(
          row_at(pages, page, b.pos[u], kh, g) + c);
  }
}

// Page ids of pages [pc0, pc1) of the slot's row into shared memory.
__device__ __forceinline__ void load_table(int* spg, const int32_t* row,
                                           int pc0, int pc1) {
  __syncthreads();                                // the last chunk is done
  for (int i = threadIdx.x; i < pc1 - pc0; i += kThreads) spg[i] = row[pc0 + i];
  __syncthreads();
}

// ---- (a) scores and local maxima ------------------------------------------
template <int G>
__global__ void __launch_bounds__(kThreads)
paged_scores_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ kv_len,
                    float* __restrict__ scores, float* __restrict__ maxes,
                    Geo geo, float scale) {
  // (b) may start now: it loads its V rows, then waits for this grid
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ float wmax[kWarps][G];
  __shared__ int spg[kPageChunk];
  const int split = blockIdx.x, slot = blockIdx.z;
  const int pair = slot * gridDim.y + blockIdx.y;   // (slot, kv head, chunk)
  const int kh = blockIdx.y / geo.hc;
  const int T = geo.max_pages * geo.page_size;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpr = geo.lpr, rpl = 32 / lpr;        // lanes per row, rows per load
  const int sub = lane & (lpr - 1), grp = lane / lpr;
  const int c = sub * 8;
  const bool on = c < geo.dh;
  const int32_t* row = page_table + (size_t)slot * geo.max_pages;
  const int len = live_len(kv_len, slot, geo);
  int p0, p1;
  split_pages(len, geo, split, p0, p1);

  float qf[G][8];
  int nh;
  const __nv_bfloat16* qh =
      q + (size_t)chunk_heads(slot, G, geo, nh) * geo.dh;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (on && g < nh)
      raw = *reinterpret_cast<const uint4*>(qh + g * geo.dh + c);
    bf16x8(raw, qf[g]);
  }
  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = -INFINITY;

  float* sc = scores + (size_t)pair * G * T;
  const int step = kWarps * rpl * kUnroll;
  for (int pc0 = p0; pc0 < p1; pc0 += kPageChunk) {   // uniform over the block
    const int pc1 = min(pc0 + kPageChunk, p1);
    load_table(spg, row, pc0, pc1);
    const int ta = pc0 * geo.page_size, tb = min(pc1 * geo.page_size, len);
    Batch cur;
    fetch(cur, k_pages, spg, pc0, ta, tb, kh, warp, grp, rpl, c, on, geo);
    for (int base = ta; base < tb; base += step) {
      Batch nxt;                                  // in flight while cur is used
      fetch(nxt, k_pages, spg, pc0, base + step, tb, kh, warp, grp, rpl, c, on,
            geo);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kf[8];
        bf16x8(cur.raw[u], kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) part += qf[g][j] * kf[j];
          // xor butterfly inside the row's lane group: every lane of the
          // group ends with the same bits (a + b == b + a)
          for (int o = lpr >> 1; o > 0; o >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          const float s = part * scale;
          if (cur.pos[u] < tb && sub == 0)
            sc[g * T + cur.pos[u]] = cur.live[u] ? s : -INFINITY;
          if (cur.live[u]) mx[g] = fmaxf(mx[g], s);
        }
      }
      cur = nxt;
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float v = mx[g];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) wmax[warp][g] = v;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float v = -INFINITY;
    for (int w = 0; w < kWarps; ++w) v = fmaxf(v, wmax[w][threadIdx.x]);
    maxes[((size_t)pair * geo.nsplit + split) * G + threadIdx.x] = v;
  }
}

// ---- (b) P.V partials, and the combine by the pair's last block ------------
template <int G>
__global__ void __launch_bounds__(kThreads)
paged_pv_kernel(const __nv_bfloat16* __restrict__ v_pages,
                const int32_t* __restrict__ page_table,
                const int32_t* __restrict__ kv_len,
                const float* __restrict__ scores,
                const float* __restrict__ maxes, float* partials,
                int* counters, __nv_bfloat16* __restrict__ out, Geo geo) {
  extern __shared__ float wacc[];                 // kWarps * G * dh
  __shared__ float wsum[kWarps][G];
  __shared__ int spg[kPageChunk];
  __shared__ int is_last;
  const int split = blockIdx.x, slot = blockIdx.z;
  const int pair = slot * gridDim.y + blockIdx.y;   // (slot, kv head, chunk)
  const int kh = blockIdx.y / geo.hc;
  const int T = geo.max_pages * geo.page_size;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpr = geo.lpr, rpl = 32 / lpr;
  const int sub = lane & (lpr - 1), grp = lane / lpr;
  const int c = sub * 8;
  const bool on = c < geo.dh;
  const int GD = G * geo.dh;
  const int32_t* row = page_table + (size_t)slot * geo.max_pages;
  const int len = live_len(kv_len, slot, geo);
  int p0, p1;
  split_pages(len, geo, split, p0, p1);
  const float* sc = scores + (size_t)pair * G * T;
  const int step = kWarps * rpl * kUnroll;

  // the first rows of V are inputs, not (a)'s results: load them before
  // waiting for (a) to finish
  int pc0 = p0, pc1 = min(p0 + kPageChunk, p1);
  load_table(spg, row, pc0, pc1);
  Batch cur;
  fetch(cur, v_pages, spg, pc0, pc0 * geo.page_size,
        min(pc1 * geo.page_size, len), kh, warp, grp, rpl, c, on, geo);
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // m: the max of the splits' maxima (exact in any order)
  float m[G];
#pragma unroll
  for (int g = 0; g < G; ++g) m[g] = -INFINITY;
  for (int i = 0; i < geo.nsplit; ++i) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      m[g] = fmaxf(m[g], maxes[((size_t)pair * geo.nsplit + i) * G + g]);
  }
  // l: every split sums all the pair's scores in the same fixed order
  float l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) l[g] = 0.f;
  for (int i = tid; i < len; i += kThreads) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float s = sc[g * T + i];
      if (s != -INFINITY) l[g] += expf(s - m[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float v = l[g];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) wsum[warp][g] = v;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += wsum[w][g];
    l[g] = v;
  }

  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  while (pc0 < p1) {                              // uniform over the block
    const int ta = pc0 * geo.page_size, tb = min(pc1 * geo.page_size, len);
    for (int base = ta; base < tb; base += step) {
      Batch nxt;                                  // in flight while cur is used
      fetch(nxt, v_pages, spg, pc0, base + step, tb, kh, warp, grp, rpl, c, on,
            geo);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!cur.live[u]) continue;
        float vf[8];
        bf16x8(cur.raw[u], vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = __bfloat162float(__float2bfloat16(
              expf(sc[g * T + cur.pos[u]] - m[g]) / l[g]));
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[g][j] += p * vf[j];
        }
      }
      cur = nxt;
    }
    pc0 = pc1;
    pc1 = min(pc0 + kPageChunk, p1);
    if (pc0 < p1) {
      load_table(spg, row, pc0, pc1);
      fetch(cur, v_pages, spg, pc0, pc0 * geo.page_size,
            min(pc1 * geo.page_size, len), kh, warp, grp, rpl, c, on, geo);
    }
  }
  // the warp's row groups, then the warps, each summed in a fixed order
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      for (int o = lpr; o < 32; o <<= 1)
        acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
  if (grp == 0 && on) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j) wacc[(warp * G + g) * geo.dh + c + j] = acc[g][j];
  }
  __syncthreads();
  float* part = partials + ((size_t)pair * geo.nsplit + split) * GD;
  for (int i = tid; i < GD; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wacc[w * GD + i];
    part[i] = s;
  }

  // ticket: the pair's last block sums the partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + pair, 1) == geo.nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* parts = partials + (size_t)pair * geo.nsplit * GD;
  int nh;
  __nv_bfloat16* oh = out + (size_t)chunk_heads(slot, G, geo, nh) * geo.dh;
  for (int i = tid; i < nh * geo.dh; i += kThreads) {
    float s = 0.f;
    for (int sp = 0; sp < geo.nsplit; ++sp) s += __ldcg(parts + (size_t)sp * GD + i);
    oh[i] = __float2bfloat16(s);
  }
  if (tid == 0) counters[pair] = 0;
}

// the dynamic shared memory a block of (b) asks for: its warps' partials
template <int G>
constexpr size_t pv_smem_bytes(int dh) {
  return (size_t)kWarps * G * dh * sizeof(float);
}

template <int G>
cudaError_t launch_g(const void* q, const void* k_pages, const void* v_pages,
                     const void* page_table, const void* kv_len, void* out,
                     float* scores, float* maxes, float* partials,
                     int* counters, int slots, const Geo& geo, float scale,
                     cudaStream_t stream) {
  const dim3 grid(geo.nsplit, geo.K * geo.hc, slots);
  paged_scores_kernel<G><<<grid, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const int32_t*)page_table, (const int32_t*)kv_len, scores, maxes, geo,
      scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // (b) may start once every block of (a) has begun (programmatic
  // dependent launch); it waits for (a)'s results at griddepcontrol.wait
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pv_smem_bytes<G>(geo.dh);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, paged_pv_kernel<G>,
                         (const __nv_bfloat16*)v_pages,
                         (const int32_t*)page_table, (const int32_t*)kv_len,
                         (const float*)scores, (const float*)maxes, partials,
                         counters, (__nv_bfloat16*)out, geo);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The shared memory of kernel (a) (pv == 0) or (b) (pv == 1) at G: the
// static bytes as compiled and the dynamic bytes launch_g<G> asks for.
template <int G>
int smem_g(int pv, int dh, int* static_bytes, int* dynamic_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = pv ? cudaFuncGetAttributes(&a, paged_pv_kernel<G>)
                           : cudaFuncGetAttributes(&a, paged_scores_kernel<G>);
  if (e != cudaSuccess) return (int)e;
  *static_bytes = (int)a.sharedSizeBytes;
  *dynamic_bytes = pv ? (int)pv_smem_bytes<G>(dh) : 0;
  return 0;
}

}  // namespace

extern "C" {

// q (slots, K*G, dh) bf16; k/v_pages (num_pages, page_size, Kp, dh) bf16,
// of whose Kp kv heads the K heads [kv0, kv0 + K) are read (Kp = K, kv0 =
// 0: every head); page_table (slots, max_pages) int32; kv_len (slots,)
// int32; out (slots, K*G, dh) bf16; all contiguous, q/k/v/out 16-byte
// aligned.
// Query heads are taken gc at a time (1 <= gc <= 8), in hc = ceil(G / gc)
// chunks.  Scratch from the caller, with C = slots*K*hc*gc: scores
// C*max_pages*page_size f32, maxes C*nsplit f32, partials C*nsplit*dh f32
// and counters slots*K*hc int32, all ZERO before the first call (the last
// block of each pair leaves its counter at 0 again).  Requires dh % 8 ==
// 0, dh <= 256, 1 <= nsplit.  Launches the two kernels on `stream`;
// returns the CUDA error code of the launches (0 on success).
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* kv_len, void* out, void* scores,
                           void* maxes, void* partials, void* counters,
                           int slots, int K, int G, int gc, int dh,
                           int page_size, int max_pages, int nsplit,
                           int Kp, int kv0, float scale, void* stream) {
  if (gc < 1 || gc > kMaxG || G < 1 || dh % 8 || dh > 256 || nsplit < 1 ||
      kv0 < 0 || kv0 + K > Kp)
    return (int)cudaErrorInvalidValue;
  int lpr = 1;
  while (lpr * 8 < dh) lpr <<= 1;
  const Geo geo{K, G, (G + gc - 1) / gc, dh, page_size, max_pages, nsplit,
                lpr, Kp, kv0};
  float *s = (float*)scores, *mx = (float*)maxes, *pt = (float*)partials;
  int* ct = (int*)counters;
  const cudaStream_t st = (cudaStream_t)stream;
#define PAGED_G(n)                                                           \
  case n:                                                                    \
    return (int)launch_g<n>(q, k_pages, v_pages, page_table, kv_len, out, s, \
                            mx, pt, ct, slots, geo, scale, st);
  switch (gc) {
    PAGED_G(1) PAGED_G(2) PAGED_G(3) PAGED_G(4)
    PAGED_G(5) PAGED_G(6) PAGED_G(7) PAGED_G(8)
  }
#undef PAGED_G
  return (int)cudaErrorInvalidValue;
}

// Shared memory of kernel (a) (pv == 0) or (b) (pv == 1) as
// paged_attention_launch runs it for a head chunk gc and head dim dh: its
// static bytes as compiled (cudaFuncGetAttributes) and the dynamic bytes
// its launch asks for.  Launches nothing; returns the CUDA error of the
// query, cudaErrorInvalidValue for a gc or dh the launch refuses.
int paged_attention_smem(int pv, int gc, int dh, int* static_bytes,
                         int* dynamic_bytes) {
  if (gc < 1 || gc > kMaxG || dh % 8 || dh > 256)
    return (int)cudaErrorInvalidValue;
#define PAGED_SMEM(n) \
  case n:             \
    return smem_g<n>(pv, dh, static_bytes, dynamic_bytes);
  switch (gc) {
    PAGED_SMEM(1) PAGED_SMEM(2) PAGED_SMEM(3) PAGED_SMEM(4)
    PAGED_SMEM(5) PAGED_SMEM(6) PAGED_SMEM(7) PAGED_SMEM(8)
  }
#undef PAGED_SMEM
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
