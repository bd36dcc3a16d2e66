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
// plain walk's visit order (bvh4_walk.cuh, with SplitRows below), t0 /
// tri0 carried in when INIT is set, else TMAX / -1 (the JAX
// `with_init=False` path, :848-853). With --fmad=false, t and the triangle
// id equal the plain version's bit for bit.
//
// What bounds it on an H100: as K3, dependent loads per pop and divergence.
// The Hopper form, chosen by same-call timings on the 7M city (PERF.md):
//   * a pop reads its row's boxes and child ids (112 bytes of the 128-byte
//     topology row: the topology is a quarter of the fat table, so a 120
//     MiB part's, 30 MiB, stays in the 50 MB L2) and its leaf children's
//     slots (80 bytes a child, from the fat table); the slots are read only
//     for children the row marks as leaves (child id -1), and not for
//     empty ones (the builder's sentinel box);
//   * on a table whose topology the L2 holds (a part), one ray per thread
//     in blocks of 128, the grid covering the rays, as K3; a pop asks L1
//     for the lines its leaf children's slots span as soon as the row's
//     child ids arrive, before its box tests, and for the topology row of
//     every child it will push;
//   * on a topology past the L2 (the 1.05 GB city's is 263 MB; the
//     device's L2 size, read once, decides per launch, as in K3),
//     persistent blocks of 1,024 threads, as many as are resident, whose
//     warps take 32 rays at a time from the launch's counter (atomicAdd,
//     zeroed on the launch's stream first, as K1 does) when all their
//     lanes are done, so the long walks of such a table keep every SM
//     busy to the end; a pop asks for nothing ahead.
// Measured and not kept (PERF.md): the top topology rows in shared memory
// (the first form's 256 rows per 128-ray block, and a persistent block's
// 1,365 rows in dynamic shared memory), L2 cache policies (evict_last on
// the topology, evict_first on the slots), prefetch past the L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bvh4_walk.cuh"

namespace {

using bvh4::PAIR_F4;
using bvh4::ROW_F4;
using bvh4::TMAXF;
using bvh4::TOPO_F4;
using bvh4::TRI0_F4;

constexpr int THREADS = 128;           // a table the L2 holds
constexpr int PERSIST_THREADS = 1024;  // past the L2: persistent blocks
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ void prefetch_l1(const float4* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#else
  (void)p;
#endif
}

// SplitRows: K5 reads boxes and child ids from the 128-byte topology row
// (the fat row's first 32 floats) and the leaf slots from the fat row.
// PREFETCH (a topology the L2 holds): a pop asks L1 for its leaf
// children's slots and its pushed children's topology rows.
template <bool PREFETCH>
struct SplitRows {
  static constexpr bool kLeafPairsOnly = true;
  static constexpr bool kSkipEmpty = true;
  const float4* __restrict__ topo;
  const float4* __restrict__ fat;
  __device__ __forceinline__ float4 box4(int node, int q) const {
    return __ldg(topo + (size_t)node * TOPO_F4 + q);
  }
  __device__ __forceinline__ const float4* pair(int node, int c) const {
    return fat + (size_t)node * ROW_F4 + TRI0_F4 + c * PAIR_F4;
  }
  __device__ __forceinline__ void prefetch_slots(int node,
                                                 const float* b) const {
    if constexpr (PREFETCH) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if ((int)b[24 + c] >= 0) continue;
        if (b[c * 3] > b[12 + c * 3]) continue;  // empty
        const float4* p = pair(node, c);
        prefetch_l1(p);                // the line of the slots' start
        prefetch_l1(p + PAIR_F4 - 1);  // and of their end
      }
    }
  }
  __device__ __forceinline__ void prefetch(int node) const {
    if constexpr (PREFETCH) prefetch_l1(topo + (size_t)node * TOPO_F4);
  }
};

template <bool INIT, bool PAST_L2>
__device__ __forceinline__ void walk_ray(const SplitRows<!PAST_L2>& rows,
                                         int m, int stack_size,
                                         const float* __restrict__ o,
                                         const float* __restrict__ d,
                                         const float* __restrict__ t0,
                                         const int* __restrict__ tri0, int i,
                                         float* __restrict__ t_out,
                                         int* __restrict__ tri_out) {
  float t = INIT ? t0[i] : TMAXF;
  int tri = INIT ? tri0[i] : -1;
  bvh4::Ray r;
  if (bvh4::load_ray(o, d, TMAXF, i, r))
    bvh4::walk<false>(rows, m, stack_size, r, t, tri);
  t_out[i] = t;
  tri_out[i] = tri;
}

template <bool INIT, bool PAST_L2>
__global__ void __launch_bounds__(PAST_L2 ? PERSIST_THREADS : THREADS)
k5_split_kernel(const float4* __restrict__ topo,
                const float4* __restrict__ fat, int m, int stack_size,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ t0,
                const int* __restrict__ tri0, int n,
                float* __restrict__ t_out, int* __restrict__ tri_out,
                int* __restrict__ next_ray) {
  const SplitRows<!PAST_L2> rows{topo, fat};
  if constexpr (!PAST_L2) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i < n)
      walk_ray<INIT, PAST_L2>(rows, m, stack_size, o, d, t0, tri0, i, t_out,
                              tri_out);
  } else {
    const int lane = threadIdx.x & 31;
    for (;;) {
      int base = 0;
      if (lane == 0) base = atomicAdd(next_ray, 32);
      base = __shfl_sync(FULL_MASK, base, 0);
      if (base >= n) break;
      if (base + lane < n)
        walk_ray<INIT, PAST_L2>(rows, m, stack_size, o, d, t0, tri0,
                                base + lane, t_out, tri_out);
    }
  }
}

// What a launch needs of the current device, read once per device: the L2
// size, and the persistent form's resident grid.
struct Device {
  int ready, l2, blocks;
};

template <bool INIT>
int resident_blocks(int sms, int* blocks) {
  int per_sm = 0;
  const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k5_split_kernel<INIT, true>, PERSIST_THREADS, 0);
  *blocks = std::min(*blocks, per_sm * sms);
  return err;
}

int device(Device** out) {
  static Device devs[64];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= 64) return 101;  // cudaErrorInvalidDevice
  Device& x = devs[dev];
  if (!x.ready) {
    int sms = 0;
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
    if (!err)
      err = (int)cudaDeviceGetAttribute(&x.l2, cudaDevAttrL2CacheSize, dev);
    x.blocks = 1 << 30;
    if (!err) err = resident_blocks<false>(sms, &x.blocks);
    if (!err) err = resident_blocks<true>(sms, &x.blocks);
    if (err) return err;
    if (x.blocks <= 0) return 9;  // cudaErrorInvalidConfiguration
    x.ready = 1;
  }
  *out = &x;
  return 0;
}

template <bool INIT, bool PAST_L2>
int launch(const Device& dv, const float* topo, const float* fat, int m,
           int stack_size, const float* o, const float* d, const float* t0,
           const int* tri0, int n, float* t_out, int* tri_out, int* next_ray,
           cudaStream_t stream) {
  constexpr int threads = PAST_L2 ? PERSIST_THREADS : THREADS;
  int blocks = (n + threads - 1) / threads;
  if (PAST_L2) {
    blocks = std::min(dv.blocks, blocks);
    const int err = (int)cudaMemsetAsync(next_ray, 0, sizeof(int), stream);
    if (err) return err;
  }
  k5_split_kernel<INIT, PAST_L2><<<blocks, threads, 0, stream>>>(
      (const float4*)topo, (const float4*)fat, m, stack_size, o, d, t0, tri0,
      n, t_out, tri_out, next_ray);
  return (int)cudaGetLastError();
}

}  // namespace

// t0 and tri0 both null: the walk starts from TMAX / -1. `next_ray`: one
// int of device memory, the persistent form's ray counter, zeroed here on
// `stream` before the launch.
extern "C" int k5_split_launch(const float* topo, const float* fat, int m,
                               int stack_size, const float* o, const float* d,
                               const float* t0, const int* tri0, int n,
                               float* t_out, int* tri_out, int* next_ray,
                               void* stream) {
  if (n <= 0) return 0;
  Device* dv = nullptr;
  const int err = device(&dv);
  if (err) return err;
  const bool past_l2 = (size_t)m * TOPO_F4 * sizeof(float4) > (size_t)dv->l2;
  const auto go = t0 != nullptr
                       ? (past_l2 ? launch<true, true> : launch<true, false>)
                       : (past_l2 ? launch<false, true> : launch<false, false>);
  return go(*dv, topo, fat, m, stack_size, o, d, t0, tri0, n, t_out, tri_out,
            next_ray, (cudaStream_t)stream);
}

extern "C" const char* cray_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
