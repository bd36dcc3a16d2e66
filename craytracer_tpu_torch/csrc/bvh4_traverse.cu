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
//   the row's inlined triangles in slot order (a slot replaces the best
//   hit only when strictly closer; any hit also needs t < max_dist), sort
//   the entered internal children far to near with the network
//   (0,1),(2,3),(0,2),(1,3),(1,2), push them clamped to min(npush, S - sp)
//   so the nearest pops next; any hit retires the ray once best_t <
//   max_dist, after the whole row.
// The sort reads nothing the triangle tests write, so it runs before
// them and changes no result. With the same order, the same expression
// trees and --fmad=false, t and the triangle id are the plain version's
// bit for bit, tie breaks included; K4's t (not only its verdict) matches
// too, which the caller's lit test needs (it compares t with dist_adj -
// max(K_EPS, 1e-3 dist_adj), not with max_dist).
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
// What bounds it on an H100: the latency of dependent loads, not bytes or
// operations (PERF.md holds it at 10-25x its bound). Each pop reads a row
// whose address depends on the previous pop, and a leaf child's slots
// only after the row's child ids have arrived; the lanes of a warp walk
// different nodes. The design:
//   * one ray per thread in blocks of 128, the stack (<= 128 ints,
//     per-tree bound `stack_size`) in local memory, everything else in
//     registers; a partitioned table (K3 `_init`, one launch per part) is
//     the same walk over a smaller table, the carried best hit read once
//     and written once per ray and part;
//   * exact slot skips (bvh4_walk.cuh): a pop reads its row's boxes and
//     child ids (7 float4 loads, through the read-only path) and skips the
//     slots of internal children (5 loads and two tests each), which are
//     empty: a row without a leaf child, as every row of a tree's top
//     levels is, reads 7 of its 27 float4 and tests nothing. On a table
//     past the L2 a pop reads its leaf children's slots only, not those of
//     empty children (the builder's sentinel box); on one the L2 holds, a
//     row with a leaf child has all its slots read and tested, since
//     there a branch per child cost more than the empty slots;
//   * on a table past the L2 (a city part, 120 MiB, or the 1.05 GB city;
//     the device's L2 size, read once, decides per launch), each pop asks
//     L1 for the whole rows of the children it will push before it tests
//     its own triangles, which hides part of their later pops' trips to
//     device memory; on a table the L2 holds, prefetching cost more than
//     it saved (PERF.md), so that form has none;
//   * the wrapper sorts the rays by ray_key (ops/raysort.py) so that a
//     warp's rays start alike and walk alike.
// Measured slower and left out (same-call A/Bs, PERF.md): persistent
// warps (the warp's next 32 rays from one atomicAdd, or an idle lane's
// next ray from its warp's chunk of 64); the top 85 rows' boxes in shared
// memory (cp.async, once per block); a branch around each empty slot's
// test; the stack stores before the triangle tests on a table the L2
// holds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh4_walk.cuh"

namespace {

using bvh4::TMAXF;

constexpr int THREADS = 128;

// INIT: start from the carried (t0, tri0) (`aux` = t0); ANY: the any hit
// under max_dist (`aux` = max_dist); neither: K3 from TMAX / -1.
// PREFETCH: the table is past the L2 (bvh4_walk.cuh FatRows).
template <bool INIT, bool ANY, bool PREFETCH>
__global__ void __launch_bounds__(THREADS)
walk_kernel(const float4* __restrict__ fat, int m, int stack_size,
            const float* __restrict__ o, const float* __restrict__ d,
            const float* __restrict__ aux, const int* __restrict__ tri0,
            int n, float* __restrict__ t_out, int* __restrict__ tri_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float t = INIT ? aux[lane] : TMAXF;
  int tri = INIT ? tri0[lane] : -1;
  bvh4::Ray r;
  if (bvh4::load_ray(o, d, ANY ? aux[lane] : TMAXF, lane, r))
    bvh4::walk<ANY>(bvh4::FatRows<PREFETCH>{fat}, m, stack_size, r, t, tri);
  t_out[lane] = t;
  if (!ANY) tri_out[lane] = tri;
}

// The L2 size of the current device, read once per device.
int l2_bytes(int* l2) {
  static int known[64];  // 0: not read yet
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= 64)
    return (int)cudaDeviceGetAttribute(l2, cudaDevAttrL2CacheSize, dev);
  if (!known[dev]) {
    err = (int)cudaDeviceGetAttribute(&known[dev], cudaDevAttrL2CacheSize,
                                      dev);
    if (err) return err;
  }
  *l2 = known[dev];
  return 0;
}

template <bool INIT, bool ANY>
int launch(const float* fat, int m, int stack_size, const float* o,
           const float* d, const float* aux, const int* tri0, int n,
           float* t_out, int* tri_out, void* stream) {
  if (n <= 0) return 0;
  int l2 = 0;
  const int err = l2_bytes(&l2);
  if (err) return err;
  const bool past_l2 =
      (size_t)m * bvh4::ROW_F4 * sizeof(float4) > (size_t)l2;
  const int blocks = (n + THREADS - 1) / THREADS;
  if (past_l2)
    walk_kernel<INIT, ANY, true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)fat, m, stack_size, o, d, aux, tri0, n, t_out,
        tri_out);
  else
    walk_kernel<INIT, ANY, false><<<blocks, THREADS, 0,
                                    (cudaStream_t)stream>>>(
        (const float4*)fat, m, stack_size, o, d, aux, tri0, n, t_out,
        tri_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k3_closest_launch(const float* fat, int m, int stack_size,
                                 const float* o, const float* d, int n,
                                 float* t_out, int* tri_out, void* stream) {
  return launch<false, false>(fat, m, stack_size, o, d, nullptr, nullptr, n,
                              t_out, tri_out, stream);
}

extern "C" int k3_closest_init_launch(const float* fat, int m,
                                      int stack_size, const float* o,
                                      const float* d, const float* t0,
                                      const int* tri0, int n, float* t_out,
                                      int* tri_out, void* stream) {
  return launch<true, false>(fat, m, stack_size, o, d, t0, tri0, n, t_out,
                             tri_out, stream);
}

extern "C" int k4_any_launch(const float* fat, int m, int stack_size,
                             const float* o, const float* d, const float* md,
                             int n, float* t_out, void* stream) {
  return launch<false, true>(fat, m, stack_size, o, d, md, nullptr, n, t_out,
                             nullptr, stream);
}

extern "C" const char* cray_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
