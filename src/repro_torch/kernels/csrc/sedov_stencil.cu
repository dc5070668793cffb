// Fused Sedov hydro step (the LULESH hot loop) for NVIDIA Hopper (sm_90a),
// as a 2.5-D plane-marching stencil.
//
// Replaces the Pallas TPU kernel `sedov_step_pallas` / its body
// `_sedov_kernel` (src/repro/kernels/sedov_stencil.py).
//
// What it computes, for a given dt (a device scalar: the global CFL
// reduction runs before it, on the device), on an (n, n, n) f32 grid with
// rho, e and v = (vx, vy, vz), every neighbour taken at the edge-clamped
// coordinate (min(i + 1, n - 1), max(i - 1, 0)) and grad_a(f) =
// (f[i+1] - f[i-1]) / (2 dx) along axis a:
//   rho_inv = 1 / max(rho, 1e-12)
//   p       = (0.4 rho) e                          EOS, gamma = 1.4
//   dv      = (grad_0 vx + grad_1 vy) + grad_2 vz
//   q       = dv < 0 ? ((2 rho) dv) dv : 0          artificial viscosity
//   pq      = p + q
//   v_n     = v - (dt grad(pq)) rho_inv             momentum
//   dv_n    = div(v_n)
//   e_n     = max(e - ((dt pq) dv_n) rho_inv, 0)
//   rho_n   = max(rho (1 - dt dv_n), 1e-12)
//   t_n     = t + dt
// in that operation order (ref.sedov_step_ref is its plain version).
// Every derived field is edge-clamped too: pq and v_n at a neighbour past
// the domain edge are their values at the edge zone, never values
// computed from clamped inputs.  The kernel computes derived fields only
// at in-domain coordinates and reads each neighbour at its clamped
// coordinate (in-plane through a zero offset at the edge, across planes
// through the ring slot of the clamped plane), which gives exactly that.
//
// Floating point: built with -fmad=false (kernels/_build.py), IEEE
// division, no fast math, so each operation rounds once as the plain
// version's separate PyTorch ops do.  Where 2 dx is a power of two (dx =
// 1), x / (2 dx) is taken as x * (1 / (2 dx)): both are the correctly
// rounded value of the same real number, so the bits do not change.
//
// Bound on this card: device-memory bytes.  Five f32 fields are read and
// five written per step (40 bytes per zone) against ~50 f32 operations
// per zone.
//
// Design: each block owns a 16 x 32 output tile over axes (1, 2) (axis 2
// contiguous) and a chunk of kChunk = 64 planes along axis 0, and marches
// along axis 0.  Input planes of the five fields (the tile plus a halo of
// 3 rows along axis 1 and of 4 columns along axis 2, so that rows start
// on 16-byte boundaries) stream into a shared-memory ring of 4 planes
// with cp.async, one plane ahead of use.  Once plane q has landed, the
// block computes pq at plane q - 1 (over the tile + 2), v_n at q - 2 (over
// the tile + 1) and the outputs at q - 3 (over the tile), each into its
// own small ring, so each input zone is loaded once per block (22 x 40 /
// (16 x 32) = 1.72x the tile, the halo's re-reads mostly from L2) and
// each derived value is computed once per block.  A chunk starts 3 planes
// early and ends 3 planes late (warm-up planes, recomputing exactly what
// the neighbouring chunk computes; at the domain's first and last planes
// they clamp instead).  At 256^3 the grid has 512 blocks, ~2 waves of
// two blocks per SM; chunks of 64 planes ran 5% faster there than chunks
// of 32 (1.19x the planes loaded, 4 waves) or 16.  Shared
// memory is 105,600 bytes a block, so two blocks share an SM and one's
// loads overlap the other's arithmetic.  Stages walk their region with
// one warp per row of 32 columns (the few columns past 32 in 8 x 4
// patches on the warps with the fewest rows): no per-element div/mod.
// rho and e at the output zones are kept in registers from plane q - 2 to
// plane q - 3, so their ring needs no fifth plane.  Rows load with 16-byte
// copies where n % 4 == 0, else 4-byte ones.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT1 = 16, kT2 = 32;                   // output tile (axes 1, 2)
constexpr int kH1 = 3, kH2 = 4;                     // loaded halo (axes 1, 2)
constexpr int kW1 = kT1 + 2 * kH1, kW2 = kT2 + 2 * kH2;   // 22 x 40
constexpr int kPlane = kW1 * kW2;                   // floats per plane
constexpr int kChunk = 64;                          // output planes per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// ring depths (planes): inputs, pq, vx_n, vy_n and vz_n
constexpr int kRin = 4, kRpq = 3, kRvx = 3, kRvyz = 2;
constexpr int kPlanes = 5 * kRin + kRpq + kRvx + 2 * kRvyz;
constexpr int kSmemBytes = kPlanes * kPlane * (int)sizeof(float);  // 105,600

constexpr float kGammaM1 = 0.4f;                    // GAMMA - 1
constexpr float kCQ = 2.0f;
constexpr float kRhoFloor = 1e-12f;

// max(a, b) that keeps a NaN in a (jnp.maximum / torch.clamp_min do; a
// blow-up must show, not be clamped away)
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : fmaxf(a, b);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Calls f(j, k) for every (j, k) of [a1, b1) x [a2, b2) (b2 - a2 <= 36):
// one warp per row of the first 32 columns; the rest in passes of 8 rows
// x 4 columns, from the last warp down (the warps with the fewest rows).
template <typename F>
__device__ __forceinline__ void for_region(int a1, int b1, int a2, int b2,
                                           F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nr = b1 - a1, wa = min(b2 - a2, 32), wb = b2 - a2 - wa;
  if (lane < wa)
    for (int r = warp; r < nr; r += kWarps) f(a1 + r, a2 + lane);
  if (wb > 0)
    for (int r0 = (kWarps - 1 - warp) * 8; r0 < nr; r0 += kWarps * 8) {
      const int r = r0 + (lane >> 2), c = lane & 3;
      if (r < nr && c < wb) f(a1 + r, a2 + 32 + c);
    }
}

template <bool kVec, bool kPow2>
__global__ void __launch_bounds__(kThreads, 2)
sedov_step_kernel(const float* __restrict__ rho, const float* __restrict__ e,
                  const float* __restrict__ v, const float* __restrict__ dt_p,
                  const float* __restrict__ t_p, float* __restrict__ rho_o,
                  float* __restrict__ e_o, float* __restrict__ v_o,
                  float* __restrict__ t_o, int n, float two_dx) {
  extern __shared__ __align__(16) float smem[];
  float* in = smem;                                 // [5][kRin][kPlane]
  float* s_pq = smem + 5 * kRin * kPlane;           // [kRpq][kPlane]
  float* s_vx = s_pq + kRpq * kPlane;               // [kRvx][kPlane]
  float* s_vy = s_vx + kRvx * kPlane;               // [kRvyz][kPlane]
  float* s_vz = s_vy + kRvyz * kPlane;              // [kRvyz][kPlane]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t nn = (size_t)n * n;
  const size_t vol = nn * n;
  const float dt = *dt_p;
  const float inv_two_dx = 1.f / two_dx;
  auto grad = [&](float up, float dn) {
    return kPow2 ? (up - dn) * inv_two_dx : (up - dn) / two_dx;
  };
  const int o1 = blockIdx.y * kT1, o2 = blockIdx.x * kT2;
  const int c0 = blockIdx.z * kChunk, c1 = min(c0 + kChunk, n);
  const int r1 = o1 - kH1, r2 = o2 - kH2;           // smem origin (domain coords)
  // the loaded region, clamped to the domain
  const int j0 = max(r1, 0), j1 = min(o1 + kT1 + kH1, n);
  const int k0 = max(r2, 0), k1 = min(o2 + kT2 + kH2, n);
  const int lo = max(c0 - 3, 0), hi = min(c1 + 3, n);   // input planes
  const float* src[5] = {rho, e, v, v + vol, v + 2 * vol};

  auto load_plane = [&](int i) {
    const size_t base = (size_t)i * nn;
    const int nr = j1 - j0;
#pragma unroll
    for (int f = 0; f < 5; ++f) {
      float* dst = in + (f * kRin + (i & (kRin - 1))) * kPlane;
      const float* s = src[f] + base;
      if (kVec) {                                   // 16-byte copies, <= 10 a row
        const int nc = (k1 - k0) >> 2;
        for (int it = tid; it < nr * 16; it += kThreads) {
          const int c = it & 15;
          if (c >= nc) continue;
          const int j = j0 + (it >> 4), k = k0 + 4 * c;
          cp_async16(dst + (j - r1) * kW2 + (k - r2), s + (size_t)j * n + k);
        }
      } else {                                      // 4-byte copies, <= 40 a row
        const int nc = k1 - k0;
        for (int it = tid; it < nr * 64; it += kThreads) {
          const int c = it & 63;
          if (c >= nc) continue;
          const int j = j0 + (it >> 6), k = k0 + c;
          cp_async4(dst + (j - r1) * kW2 + (k - r2), s + (size_t)j * n + k);
        }
      }
    }
  };
  auto ring = [&](int f, int i) {                   // input field f at plane i
    return in + (f * kRin + (i & (kRin - 1))) * kPlane;
  };
  // smem offsets of the clamped +1 / -1 neighbours along axes 1 and 2
  auto up1 = [&](int j) { return j < n - 1 ? kW2 : 0; };
  auto dn1 = [&](int j) { return j > 0 ? kW2 : 0; };
  auto up2 = [&](int k) { return k < n - 1 ? 1 : 0; };
  auto dn2 = [&](int k) { return k > 0 ? 1 : 0; };

  // rho, e of this thread's output zones (rows warp, warp + 8 of the tile,
  // column lane): `cur` at the plane being output, `nxt` one plane later
  float cur_r[2], cur_e[2], nxt_r[2], nxt_e[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) cur_r[h] = cur_e[h] = nxt_r[h] = nxt_e[h] = 0.f;
  const int kz = o2 + lane;

  load_plane(lo);
  cp_async_commit();
  for (int q = lo; q <= c1 + 2; ++q) {
    if (q + 1 < hi) load_plane(q + 1);
    cp_async_commit();                              // an empty group at the end
    cp_async_wait1();                               // plane q has landed
    __syncthreads();

    // pq = p + q at plane q - 1, over the tile + 2
    const int ip = q - 1;
    if (ip >= max(c0 - 2, 0) && ip < min(c1 + 2, n)) {
      const float* vxu = ring(2, min(ip + 1, n - 1));
      const float* vxd = ring(2, max(ip - 1, 0));
      const float *r_ = ring(0, ip), *e_ = ring(1, ip), *vy = ring(3, ip),
                  *vz = ring(4, ip);
      float* pq = s_pq + (ip % kRpq) * kPlane;
      for_region(max(o1 - 2, 0), min(o1 + kT1 + 2, n), max(o2 - 2, 0),
                 min(o2 + kT2 + 2, n), [&](int j, int k) {
        const int s = (j - r1) * kW2 + (k - r2);
        const float dv = (grad(vxu[s], vxd[s]) +
                          grad(vy[s + up1(j)], vy[s - dn1(j)])) +
                         grad(vz[s + up2(k)], vz[s - dn2(k)]);
        const float r = r_[s];
        const float p = (kGammaM1 * r) * e_[s];
        const float qv = dv < 0.f ? ((kCQ * r) * dv) * dv : 0.f;
        pq[s] = p + qv;
      });
    }
    __syncthreads();

    // v_n at plane q - 2, over the tile + 1; keep rho, e of plane q - 2
    const int iv = q - 2;
    if (iv >= max(c0 - 1, 0) && iv < min(c1 + 1, n)) {
      const float* pu = s_pq + (min(iv + 1, n - 1) % kRpq) * kPlane;
      const float* pd = s_pq + (max(iv - 1, 0) % kRpq) * kPlane;
      const float* pc = s_pq + (iv % kRpq) * kPlane;
      const float *r_ = ring(0, iv), *vx = ring(2, iv), *vy = ring(3, iv),
                  *vz = ring(4, iv);
      float* wx = s_vx + (iv % kRvx) * kPlane;
      float* wy = s_vy + (iv & 1) * kPlane;
      float* wz = s_vz + (iv & 1) * kPlane;
      for_region(max(o1 - 1, 0), min(o1 + kT1 + 1, n), max(o2 - 1, 0),
                 min(o2 + kT2 + 1, n), [&](int j, int k) {
        const int s = (j - r1) * kW2 + (k - r2);
        const float r_inv = 1.f / max_nan(r_[s], kRhoFloor);
        const float gx = grad(pu[s], pd[s]);
        const float gy = grad(pc[s + up1(j)], pc[s - dn1(j)]);
        const float gz = grad(pc[s + up2(k)], pc[s - dn2(k)]);
        wx[s] = vx[s] - (dt * gx) * r_inv;
        wy[s] = vy[s] - (dt * gy) * r_inv;
        wz[s] = vz[s] - (dt * gz) * r_inv;
      });
    }
    if (iv >= lo && iv < hi && kz < n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = o1 + warp + kWarps * h;
        if (j < n) {
          const int s = (j - r1) * kW2 + (kz - r2);
          nxt_r[h] = ring(0, iv)[s];
          nxt_e[h] = ring(1, iv)[s];
        }
      }
    }
    __syncthreads();

    // dv_n, e_n, rho_n at plane q - 3, over the tile; write the five fields
    const int io = q - 3;
    if (io >= c0 && io < c1 && kz < n) {
      const float* xu = s_vx + (min(io + 1, n - 1) % kRvx) * kPlane;
      const float* xd = s_vx + (max(io - 1, 0) % kRvx) * kPlane;
      const float* xc = s_vx + (io % kRvx) * kPlane;
      const float* yc = s_vy + (io & 1) * kPlane;
      const float* zc = s_vz + (io & 1) * kPlane;
      const float* pc = s_pq + (io % kRpq) * kPlane;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = o1 + warp + kWarps * h;
        if (j >= n) continue;
        const int s = (j - r1) * kW2 + (kz - r2);
        const float dv_n = (grad(xu[s], xd[s]) +
                            grad(yc[s + up1(j)], yc[s - dn1(j)])) +
                           grad(zc[s + up2(kz)], zc[s - dn2(kz)]);
        const float r = cur_r[h];
        const float r_inv = 1.f / max_nan(r, kRhoFloor);
        const size_t g = io * nn + (size_t)j * n + kz;
        e_o[g] = max_nan(cur_e[h] - ((dt * pc[s]) * dv_n) * r_inv, 0.f);
        rho_o[g] = max_nan(r * (1.f - dt * dv_n), kRhoFloor);
        v_o[g] = xc[s];
        v_o[vol + g] = yc[s];
        v_o[2 * vol + g] = zc[s];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cur_r[h] = nxt_r[h];
      cur_e[h] = nxt_e[h];
    }
  }

  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && tid == 0)
    t_o[0] = t_p[0] + dt;
}

template <bool kVec, bool kPow2>
cudaError_t launch_t(const dim3& grid, cudaStream_t stream, const float* rho,
                     const float* e, const float* v, const float* dt,
                     const float* t, float* rho_o, float* e_o, float* v_o,
                     float* t_o, int n, float two_dx) {
  auto kern = sedov_step_kernel<kVec, kPow2>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, kSmemBytes, stream>>>(rho, e, v, dt, t, rho_o, e_o,
                                               v_o, t_o, n, two_dx);
  return cudaGetLastError();
}

// The shared memory of sedov_step_kernel<kVec, kPow2>: the static bytes as
// compiled and the dynamic bytes launch_t asks for.
template <bool kVec, bool kPow2>
int smem_t(int* static_bytes, int* dynamic_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, sedov_step_kernel<kVec, kPow2>);
  if (e != cudaSuccess) return (int)e;
  *static_bytes = (int)a.sharedSizeBytes;
  *dynamic_bytes = kSmemBytes;
  return 0;
}

}  // namespace

extern "C" {

// rho, e (n, n, n) f32; v (3, n, n, n) f32; dt, t 0-d f32 on the device;
// outputs of the same shapes; all contiguous, outputs not aliasing inputs.
// Rows load with 16-byte copies where n % 4 == 0 and the inputs start on
// 16-byte boundaries, else with 4-byte ones.  Launches on `stream`; returns the CUDA error code of
// setting the kernel's shared-memory attributes or of the launch.
int sedov_stencil_launch(const void* rho, const void* e, const void* v,
                         const void* dt, const void* t, void* rho_o,
                         void* e_o, void* v_o, void* t_o, int n, float dx,
                         void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kT2 - 1) / kT2, (n + kT1 - 1) / kT1,
                  (n + kChunk - 1) / kChunk);
  const float two_dx = 2.0f * dx;
  int exp2 = 0;
  const bool pow2 = two_dx > 0.f && frexpf(two_dx, &exp2) == 0.5f;
  const bool vec = n % 4 == 0 &&
      (((uintptr_t)rho | (uintptr_t)e | (uintptr_t)v) & 15) == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const float *r = (const float*)rho, *ee = (const float*)e,
              *vv = (const float*)v, *d = (const float*)dt,
              *tt = (const float*)t;
  float *ro = (float*)rho_o, *eo = (float*)e_o, *vo = (float*)v_o,
        *to = (float*)t_o;
  cudaError_t err;
  if (vec && pow2)
    err = launch_t<true, true>(grid, st, r, ee, vv, d, tt, ro, eo, vo, to, n, two_dx);
  else if (vec)
    err = launch_t<true, false>(grid, st, r, ee, vv, d, tt, ro, eo, vo, to, n, two_dx);
  else if (pow2)
    err = launch_t<false, true>(grid, st, r, ee, vv, d, tt, ro, eo, vo, to, n, two_dx);
  else
    err = launch_t<false, false>(grid, st, r, ee, vv, d, tt, ro, eo, vo, to, n, two_dx);
  return (int)err;
}

// Shared memory of the kernel sedov_stencil_launch runs with 16-byte row
// loads (vec) and a power-of-two 2 dx (pow2): its static bytes as compiled
// (cudaFuncGetAttributes) and the dynamic bytes its launch asks for.
// Launches nothing; returns the CUDA error of the query.
int sedov_stencil_smem(int vec, int pow2, int* static_bytes,
                       int* dynamic_bytes) {
  if (vec && pow2) return smem_t<true, true>(static_bytes, dynamic_bytes);
  if (vec) return smem_t<true, false>(static_bytes, dynamic_bytes);
  if (pow2) return smem_t<false, true>(static_bytes, dynamic_bytes);
  return smem_t<false, false>(static_bytes, dynamic_bytes);
}

}  // extern "C"
