// Fused Sedov hydro step (the LULESH hot loop) for NVIDIA Hopper (sm_90a).
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
// coordinate, which gives exactly that.
//
// Floating point: built with -fmad=false (kernels/_build.py), IEEE
// division, no fast math, so each operation rounds once as the plain
// version's separate PyTorch ops do.
//
// Bound on this card: device-memory bytes.  Five f32 fields are read and
// five written per step (40 bytes per zone) against ~50 f32 operations
// per zone.
// Design: one block per 8 x 8 x 32 output tile (axis 2 is the contiguous
// one), 512 threads.  The block stages its tile plus a halo of 3 zones
// (14 x 14 x 38 zones, clamped at the domain edge) of all five fields in
// shared memory, then computes pq over the tile + 2, v_n over the tile + 1
// (in place over v) and the outputs over the tile, so every intermediate
// stays on chip; the staged box is 3.6x the tile, and its re-reads of
// neighbouring tiles' zones go through L2.  Partial tiles at the
// domain edge take any n >= 1.  The TPU kernel's three shifted views of
// each field (left / centre / right x-blocks) are not needed: a block
// loads its own halo.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalo = 3;
constexpr int kT0 = 8, kT1 = 8, kT2 = 32;          // output tile per block
constexpr int kE0 = kT0 + 2 * kHalo, kE1 = kT1 + 2 * kHalo,
              kE2 = kT2 + 2 * kHalo;                // staged box (14, 14, 38)
constexpr int kS1 = kE2, kS0 = kE1 * kE2;           // shared-memory strides
constexpr int kBox = kE0 * kE1 * kE2;
constexpr int kFields = 6;                          // rho, e, vx, vy, vz, pq
constexpr int kSmemBytes = kFields * kBox * (int)sizeof(float);  // 178,752
constexpr int kThreads = 512;

constexpr float kGammaM1 = 0.4f;                    // GAMMA - 1
constexpr float kCQ = 2.0f;
constexpr float kRhoFloor = 1e-12f;

// max(a, b) that keeps a NaN in a (jnp.maximum / torch.clamp_min do; a
// blow-up must show, not be clamped away)
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : fmaxf(a, b);
}

// The block's staged region along one axis: domain coordinates [lo, hi).
struct Span {
  int lo, hi;
};

// Calls f(c0, c1, c2, s) for every domain coordinate of
// [o0 - w, o0 + kT0 + w) x [o1 - w, ...) x [o2 - w, ...) clamped to the
// domain, s being its shared-memory index; axis 2 fastest, so
// neighbouring threads touch neighbouring addresses.
template <typename F>
__device__ __forceinline__ void for_region(int n, int o0, int o1, int o2,
                                           int w, const Span* box, F f) {
  const int a0 = max(o0 - w, 0), b0 = min(o0 + kT0 + w, n);
  const int a1 = max(o1 - w, 0), b1 = min(o1 + kT1 + w, n);
  const int a2 = max(o2 - w, 0), b2 = min(o2 + kT2 + w, n);
  const int n1 = b1 - a1, n2 = b2 - a2;
  const int total = (b0 - a0) * n1 * n2;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int c2 = a2 + i % n2;
    const int r = i / n2;
    const int c1 = a1 + r % n1;
    const int c0 = a0 + r / n1;
    const int s = (c0 - box[0].lo) * kS0 + (c1 - box[1].lo) * kS1 +
                  (c2 - box[2].lo);
    f(c0, c1, c2, s);
  }
}

// Shared-memory offsets of the clamped +1 / -1 neighbours along one axis.
struct Nb {
  int up, dn;
};
__device__ __forceinline__ Nb nb(int c, int n, int stride) {
  return {c < n - 1 ? stride : 0, c > 0 ? stride : 0};
}

__global__ void __launch_bounds__(kThreads)
sedov_step_kernel(const float* __restrict__ rho, const float* __restrict__ e,
                  const float* __restrict__ v, const float* __restrict__ dt_p,
                  const float* __restrict__ t_p, float* __restrict__ rho_o,
                  float* __restrict__ e_o, float* __restrict__ v_o,
                  float* __restrict__ t_o, int n, float two_dx) {
  extern __shared__ float smem[];
  float* s_rho = smem;
  float* s_e = smem + kBox;
  float* s_vx = smem + 2 * kBox;
  float* s_vy = smem + 3 * kBox;
  float* s_vz = smem + 4 * kBox;
  float* s_pq = smem + 5 * kBox;

  const size_t plane = (size_t)n * n;
  const size_t vol = plane * n;
  const float dt = *dt_p;
  const int o0 = blockIdx.z * kT0, o1 = blockIdx.y * kT1,
            o2 = blockIdx.x * kT2;
  const Span box[3] = {{max(o0 - kHalo, 0), min(o0 + kT0 + kHalo, n)},
                       {max(o1 - kHalo, 0), min(o1 + kT1 + kHalo, n)},
                       {max(o2 - kHalo, 0), min(o2 + kT2 + kHalo, n)}};

  // 1. stage the tile + 3 of every field
  for_region(n, o0, o1, o2, kHalo, box, [&](int c0, int c1, int c2, int s) {
    const size_t g = c0 * plane + (size_t)c1 * n + c2;
    s_rho[s] = rho[g];
    s_e[s] = e[g];
    s_vx[s] = v[g];
    s_vy[s] = v[vol + g];
    s_vz[s] = v[2 * vol + g];
  });
  __syncthreads();

  // 2. pq = p + q over the tile + 2
  for_region(n, o0, o1, o2, 2, box, [&](int c0, int c1, int c2, int s) {
    const Nb x = nb(c0, n, kS0), y = nb(c1, n, kS1), z = nb(c2, n, 1);
    const float dv = ((s_vx[s + x.up] - s_vx[s - x.dn]) / two_dx +
                      (s_vy[s + y.up] - s_vy[s - y.dn]) / two_dx) +
                     (s_vz[s + z.up] - s_vz[s - z.dn]) / two_dx;
    const float r = s_rho[s];
    const float p = (kGammaM1 * r) * s_e[s];
    const float q = dv < 0.f ? ((kCQ * r) * dv) * dv : 0.f;
    s_pq[s] = p + q;
  });
  __syncthreads();

  // 3. v_n over the tile + 1, in place over v: each position's v is read
  // and written by one thread only, and this phase reads no other v
  for_region(n, o0, o1, o2, 1, box, [&](int c0, int c1, int c2, int s) {
    const Nb x = nb(c0, n, kS0), y = nb(c1, n, kS1), z = nb(c2, n, 1);
    const float r_inv = 1.f / max_nan(s_rho[s], kRhoFloor);
    const float gx = (s_pq[s + x.up] - s_pq[s - x.dn]) / two_dx;
    const float gy = (s_pq[s + y.up] - s_pq[s - y.dn]) / two_dx;
    const float gz = (s_pq[s + z.up] - s_pq[s - z.dn]) / two_dx;
    s_vx[s] = s_vx[s] - (dt * gx) * r_inv;
    s_vy[s] = s_vy[s] - (dt * gy) * r_inv;
    s_vz[s] = s_vz[s] - (dt * gz) * r_inv;
  });
  __syncthreads();

  // 4. dv_n, e_n, rho_n over the tile; write the five fields
  for_region(n, o0, o1, o2, 0, box, [&](int c0, int c1, int c2, int s) {
    const Nb x = nb(c0, n, kS0), y = nb(c1, n, kS1), z = nb(c2, n, 1);
    const float dv_n = ((s_vx[s + x.up] - s_vx[s - x.dn]) / two_dx +
                        (s_vy[s + y.up] - s_vy[s - y.dn]) / two_dx) +
                       (s_vz[s + z.up] - s_vz[s - z.dn]) / two_dx;
    const float r = s_rho[s];
    const float r_inv = 1.f / max_nan(r, kRhoFloor);
    const size_t g = c0 * plane + (size_t)c1 * n + c2;
    e_o[g] = max_nan(s_e[s] - ((dt * s_pq[s]) * dv_n) * r_inv, 0.f);
    rho_o[g] = max_nan(r * (1.f - dt * dv_n), kRhoFloor);
    v_o[g] = s_vx[s];
    v_o[vol + g] = s_vy[s];
    v_o[2 * vol + g] = s_vz[s];
  });

  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0)
    t_o[0] = t_p[0] + dt;
}

}  // namespace

extern "C" {

// rho, e (n, n, n) f32; v (3, n, n, n) f32; dt, t 0-d f32 on the device;
// outputs of the same shapes; all contiguous, outputs not aliasing inputs.
// Launches on `stream`; returns the CUDA error code of raising the
// kernel's dynamic shared-memory limit or of the launch.
int sedov_stencil_launch(const void* rho, const void* e, const void* v,
                         const void* dt, const void* t, void* rho_o,
                         void* e_o, void* v_o, void* t_o, int n, float dx,
                         void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      sedov_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kT2 - 1) / kT2, (n + kT1 - 1) / kT1,
                  (n + kT0 - 1) / kT0);
  sedov_step_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)rho, (const float*)e, (const float*)v, (const float*)dt,
      (const float*)t, (float*)rho_o, (float*)e_o, (float*)v_o, (float*)t_o,
      n, 2.0f * dx);
  return (int)cudaGetLastError();
}

}  // extern "C"
