// K3 (closest hit), K3 `_init` (closest hit from a carried best hit) and
// K4 (shadow any hit) against the fat-row BVH4, for Hopper (sm_90a).
//
// Replaces craytracer_tpu/accel/pallas_bvh4.py:146 `_traversal_kernel`
// (K3, launched by `pallas_bvh4_closest_hit` :583; K3 `_init`, through
// `_make_traversal_kernel_init` :126, launched by
// `pallas_bvh4_closest_hit_init` :399 for each part of a partitioned
// table, accel/bvh4_parts.py) and :451 `_anyhit_kernel` (K4, launched by
// `pallas_bvh4_any_hit` :547). K3 `_init` is K3 with INIT set: each ray
// starts from its carried (t0, tri0) instead of TMAX / -1, so a box is
// entered and a triangle kept only when closer than the best hit of the
// parts walked before. The Pallas `_init` kernel also skips a whole ray
// block whose lanes all miss the part's root boxes; with one ray per
// thread that skip is the root pop itself (four box tests, no push). The
// Pallas kernels walk a block of rays as one packet with a scalar stack in
// SMEM and a packet vote per child, because Mosaic cannot gather a row per
// lane. Here each thread walks its own ray with its own stack and follows
// the per-lane visit order of the plain version (accel/bvh4.py, after
// craytracer_tpu/accel/bvh4.py `_traverse4` :262-410) exactly:
//   pop the top node (clamped to the table), slab-test its four child
//   boxes against min(best_t, max_dist) as it stood before this pop, test
//   the row's inlined triangles in slot order (a slot replaces the best hit
//   only when strictly closer; any hit also needs t < max_dist), sort the
//   entered internal children far to near with the network
//   (0,1),(2,3),(0,2),(1,3),(1,2), push them clamped to min(npush, S - sp)
//   so the nearest pops next; any hit retires the ray once best_t <
//   max_dist.
// With the same order, the same expression trees and --fmad=false, t and
// the triangle id are the plain version's bit for bit, tie breaks
// included; K4's t (not only its verdict) matches too, which the caller's
// lit test needs (it compares t with dist_adj - max(K_EPS, 1e-3 dist_adj),
// not with max_dist).
//
// Divide guard: Moller-Trumbore guards det with 1e-12, as the plain
// version and the JAX XLA traversal do (core/math.py `_safe`); the Pallas
// kernels used 1e-20 (pallas_bvh4.py:219, :518).
//
// A ray with a NaN in its origin or direction (or a NaN max_dist) misses
// everything in the plain version, whose min/max propagate NaN; fminf and
// fmaxf here would not, so such a ray returns its starting hit (TMAX / -1
// or the carried one) at once. Retired lanes arrive as escape rays (origin
// 3e18, direction +x): every box lies behind them, so they pop the root and
// return their starting hit.
//
// What bounds it on an H100: dependent global loads per pop and
// divergence. Each pop reads one 512-byte row whose address depends on the
// previous pop, and the lanes of a warp walk different nodes. The design:
//   * one ray per thread, the stack (<= 128 ints, per-tree bound
//     `stack_size`) in local memory, everything else in registers;
//   * a partitioned table (K3 `_init`, one launch per part) is the same
//     walk over a smaller table, the carried best hit read once and
//     written once per ray and part;
//   * the walk itself is bvh4_walk.cuh's, shared with K5;
//   * each popped row is read through the read-only path as aligned
//     float4 loads (boxes and child ids: 7 loads; two leaf slots: 5 loads);
//     the parity_mesh_mid table (5,733 rows, 2.9 MB) and the 327,680-tri
//     city's stay in the 50 MB L2;
//   * the wrapper sorts the rays by ray_key (ops/raysort.py) so that a
//     warp's rays start alike and walk alike.
// Shared-memory treelets, wide-node compression and ray reordering inside
// the kernel are not done here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh4_walk.cuh"

namespace {

using bvh4::TMAXF;

template <bool INIT>
__global__ void __launch_bounds__(128)
k3_closest_kernel(const float4* __restrict__ fat, int m, int stack_size,
                  const float* __restrict__ o, const float* __restrict__ d,
                  const float* __restrict__ t0, const int* __restrict__ tri0,
                  int n, float* __restrict__ t_out, int* __restrict__ tri_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float t = INIT ? t0[lane] : TMAXF;
  int tri = INIT ? tri0[lane] : -1;
  bvh4::walk<false>(bvh4::FatRows{fat}, m, stack_size, o[3 * lane],
                    o[3 * lane + 1], o[3 * lane + 2], d[3 * lane],
                    d[3 * lane + 1], d[3 * lane + 2], TMAXF, t, tri);
  t_out[lane] = t;
  tri_out[lane] = tri;
}

__global__ void __launch_bounds__(128)
k4_any_kernel(const float4* __restrict__ fat, int m, int stack_size,
              const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ md, int n, float* __restrict__ t_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float t = TMAXF;
  int tri = -1;
  bvh4::walk<true>(bvh4::FatRows{fat}, m, stack_size, o[3 * lane],
                   o[3 * lane + 1], o[3 * lane + 2], d[3 * lane],
                   d[3 * lane + 1], d[3 * lane + 2], md[lane], t, tri);
  t_out[lane] = t;
}

}  // namespace

extern "C" int k3_closest_launch(const float* fat, int m, int stack_size,
                                 const float* o, const float* d, int n,
                                 float* t_out, int* tri_out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  k3_closest_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)fat, m, stack_size, o, d, nullptr, nullptr, n, t_out,
      tri_out);
  return (int)cudaGetLastError();
}

extern "C" int k3_closest_init_launch(const float* fat, int m,
                                      int stack_size, const float* o,
                                      const float* d, const float* t0,
                                      const int* tri0, int n, float* t_out,
                                      int* tri_out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  k3_closest_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)fat, m, stack_size, o, d, t0, tri0, n, t_out, tri_out);
  return (int)cudaGetLastError();
}

extern "C" int k4_any_launch(const float* fat, int m, int stack_size,
                             const float* o, const float* d, const float* md,
                             int n, float* t_out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  k4_any_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)fat, m, stack_size, o, d, md, n, t_out);
  return (int)cudaGetLastError();
}

extern "C" const char* cray_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
