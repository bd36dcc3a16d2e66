// K5: the split-table BVH4 closest hit, optionally from a carried best hit,
// for Hopper (sm_90a).
//
// Replaces craytracer_tpu/accel/pallas_bvh4.py:683 `_traversal_kernel_split`
// (launched by `pallas_bvh4_closest_hit_hbm` :837, call :876). The table is
// split in two: the topology, each node's four child boxes and child ids
// (the fat row's first 32 floats, 128 bytes a row, a quarter of the fat
// table), and the leaf triangle columns, read from the fat table itself.
// The TPU kernel keeps the topology resident in VMEM and DMAs an aligned
// 8-row tile of the fat table per pop behind the box tests; it was measured
// slower than the resident walk there and nothing routes to it. Nothing
// routes to this kernel either: chip_smoke.py holds and times it on the
// partitioned city's tables.
//
// It computes what K3 and K3 `_init` compute (accel/bvh4.py
// `bvh4_closest_hit_init` is its plain version): one ray per thread, the
// plain walk's visit order (bvh4_walk.cuh, with SplitRows), t0 / tri0
// carried in when INIT is set, else TMAX / -1 (the JAX `with_init=False`
// path, :848-853). With --fmad=false, t and the triangle id equal the plain
// version's bit for bit.
//
// What bounds it on an H100: as K3, dependent loads per pop and divergence.
// The Hopper form of the split:
//   * the block first copies the top TOPO_CACHE_ROWS topology rows (rows are
//     breadth-first, so the top levels of the tree: 32 KB) into shared
//     memory; every ray's first pops, which all rays share, read them from
//     there instead of from L2;
//   * deeper pops read 112 bytes of a 128-byte topology row (boxes and
//     children), so the topology, a quarter of the fat table, stays in the
//     50 MB L2 four times as far as K3's rows do (a 120 MiB part's topology
//     is 30 MiB);
//   * the leaf slots (80 bytes a child) are read from the fat table only for
//     the children the row marks as leaves (child id -1), not for all
//     eight slots of every pop as K3 reads them; an upper-tree pop reads no
//     leaf column at all.
// Not done here: a cluster-shared topology cache, asynchronous prefetch of
// the leaf columns behind the box tests.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bvh4_walk.cuh"

namespace {

using bvh4::TMAXF;
using bvh4::TOPO_F4;

constexpr int THREADS = 128;
constexpr int TOPO_CACHE_ROWS = 256;  // 32 KB of topology rows per block

template <bool INIT>
__global__ void __launch_bounds__(THREADS)
k5_split_kernel(const float4* __restrict__ topo,
                const float4* __restrict__ fat, int m, int stack_size,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t0,
                const int* __restrict__ tri0, int n,
                float* __restrict__ t_out, int* __restrict__ tri_out) {
  __shared__ float4 topo_s[TOPO_CACHE_ROWS * TOPO_F4];
  const int cached = min(m, TOPO_CACHE_ROWS);
  for (int i = threadIdx.x; i < cached * TOPO_F4; i += blockDim.x)
    topo_s[i] = __ldg(topo + i);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float t = INIT ? t0[lane] : TMAXF;
  int tri = INIT ? tri0[lane] : -1;
  bvh4::Ray r;
  if (bvh4::load_ray(o, d, TMAXF, lane, r))
    bvh4::walk<false>(bvh4::SplitRows{topo_s, cached, topo, fat}, m,
                      stack_size, r, t, tri);
  t_out[lane] = t;
  tri_out[lane] = tri;
}

}  // namespace

// t0 and tri0 both null: the walk starts from TMAX / -1.
extern "C" int k5_split_launch(const float* topo, const float* fat, int m,
                               int stack_size, const float* o, const float* d,
                               const float* t0, const int* tri0, int n,
                               float* t_out, int* tri_out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + THREADS - 1) / THREADS;
  if (t0 != nullptr) {
    k5_split_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)topo, (const float4*)fat, m, stack_size, o, d, t0,
        tri0, n, t_out, tri_out);
  } else {
    k5_split_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)topo, (const float4*)fat, m, stack_size, o, d,
        nullptr, nullptr, n, t_out, tri_out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cray_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
