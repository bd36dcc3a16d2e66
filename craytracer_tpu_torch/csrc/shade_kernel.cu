// K2: one bounce's shading for an external hit record, for Hopper
// (sm_90a).
//
// Replaces craytracer_tpu/integrator/pallas_shade.py:240 `_shade_kernel`
// (through `_shade_core` :874, launched by `fused_shade` :1846) for the
// materials and lights the port's gate admits: all seven material types
// with isotropic Beckmann lobes, rect and sphere area lights (<= 16 rows),
// a constant or black env light. The shading itself is shade_core.cuh's
// `shade_lane`, the code K1 runs per bounce.
//
// One build per feature mask: K2_MASK (integrator/gate.py
// `shade_features`, the seven has_* flags the JAX kernel is specialized
// on, pallas_shade.py:1872-1887) is set on the nvcc command line, and a
// lobe or light whose bit is clear is not compiled. Mask 0 is the
// matte-only core.
//
// What bounds it on an H100: bytes. A lane reads 78 bytes (its ray
// direction, hit point, normal, dpdu and throughput, hit t, material id,
// pixel, spp, two flags) and writes 99 (seven 3-vectors, two floats, an
// int32 count and three bool flags): 177 bytes, 0.0139 ms for 262,144
// lanes at 3.35 TB/s. The arithmetic in between is ~330 flops for a matte
// lane and up to ~1,000 for a glass or plastic one. The design:
//   * one thread per lane, in the route's lane order; a warp's loads of an
//     [N, 3] input and its stores of an output row each cover one
//     contiguous span, so every line is fetched and written whole;
//   * one build per mask (above): a scene pays the registers, and so the
//     occupancy, of its own lobes only;
//   * a lane whose path ends at this hit (dead, missed, on an emitter, at
//     max_depth) skips the BSDF sample (shade_lane's SKIP_ENDED), so from
//     bounce 1 on whole warps of ended paths skip it;
//   * the flags are written as bool and the count as int32, the dtypes the
//     wrapper returns, and the material and light rows (<= ~6 KB) are
//     copied once per block into shared memory.
// Tried and dropped, slower on every scene (PERF.md, PR 12, from
// profiling/ab_k2): staging a block's 128 lanes through shared memory with
// 16-byte cp.async copies and 16-byte stores (a block waits for its whole
// window before it shades and for its slowest warp before it stores, so
// loads, math and stores overlap less than warp by warp), and binning a
// block's lanes by material type with a counting sort (the gathered
// lanes' loads and stores scatter over the block's span, and the sort's
// barriers cost more than the lobe divergence they remove).
// Numerics: --fmad=false, -prec-div=true, -prec-sqrt=true (see
// shade_core.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "shade_core.cuh"

#ifndef K2_MASK
#error "build shade_kernel.cu with -DK2_MASK=<feature mask>"
#endif

namespace {

using namespace cray;

constexpr uint32_t MASK = K2_MASK;
constexpr int W = 128;  // lanes per block, one per thread

// table layout (floats), written by shade_kernel.shade_tables: env
// radiance (3) and a pad, then n_mats x 19 material rows, n_lights x 19
// light rows
constexpr int MATS = 4;

// the vector outputs ([7, N, 3]), scalar float outputs ([2, N]) and flags
// ([3, N] bool)
enum { F3_LADD, F3_SHO, F3_SHD, F3_CONTRIB, F3_NEWO, F3_NEWD, F3_NEWB };
enum { F1_DADJ, F1_DADJT };
enum { FL_WSH, FL_ALIVE, FL_PSG };

struct K2In {
  const float *d, *point, *normal, *dpdu, *beta, *hit_t;
  const int *mat_id, *pix, *spp;  // spp null: spp_const for every lane
  const bool *alive, *prev_sg;
  int spp_const;
};

struct K2Out {
  float *f3, *f1;
  int* good;
  bool* flags;
};

__device__ __forceinline__ void store3(float* dst, const float (&v)[3]) {
  dst[0] = v[0];
  dst[1] = v[1];
  dst[2] = v[2];
}

__global__ void __launch_bounds__(W)
k2_shade_kernel(const float* __restrict__ tables, int n_floats, int n_mats,
                int n_lights, K2In in, int n, uint32_t seed, int bounce,
                int max_depth, int rr_start, K2Out out) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < n_floats; i += W) tab[i] = tables[i];
  __syncthreads();
  const size_t i = (size_t)blockIdx.x * W + threadIdx.x;
  if (i >= (size_t)n) return;
  const float* mt = tab + MATS;
  const float* lt = mt + n_mats * MT_COLS;
  const size_t i3 = 3 * i;
  const uint32_t s = in.spp != nullptr ? (uint32_t)in.spp[i]
                                       : (uint32_t)in.spp_const;
  ShadeOut o;
  shade_lane<MASK, true>(
      seed, bounce, max_depth, rr_start, tab, mt, n_mats, lt, n_lights,
      lane_hash((uint32_t)in.pix[i], s), in.d[i3], in.d[i3 + 1],
      in.d[i3 + 2], in.point[i3], in.point[i3 + 1], in.point[i3 + 2],
      in.normal[i3], in.normal[i3 + 1], in.normal[i3 + 2], in.dpdu[i3],
      in.dpdu[i3 + 1], in.dpdu[i3 + 2], in.beta[i3], in.beta[i3 + 1],
      in.beta[i3 + 2], in.mat_id[i], in.hit_t[i] < TMAXF, in.alive[i],
      in.prev_sg[i], o);

  const size_t blk = 3 * (size_t)n;
  store3(out.f3 + F3_LADD * blk + i3, o.l_add);
  store3(out.f3 + F3_SHO * blk + i3, o.sho);
  store3(out.f3 + F3_SHD * blk + i3, o.wi);
  store3(out.f3 + F3_CONTRIB * blk + i3, o.contrib);
  store3(out.f3 + F3_NEWO * blk + i3, o.new_o);
  store3(out.f3 + F3_NEWD * blk + i3, o.new_d);
  store3(out.f3 + F3_NEWB * blk + i3, o.new_beta);
  out.f1[F1_DADJ * (size_t)n + i] = o.dist_adj;
  out.f1[F1_DADJT * (size_t)n + i] = o.dadj_t;
  out.good[i] = o.good_inc;
  out.flags[FL_WSH * (size_t)n + i] = o.want_shadow;
  out.flags[FL_ALIVE * (size_t)n + i] = o.new_alive;
  out.flags[FL_PSG * (size_t)n + i] = o.new_prev_sg;
}

}  // namespace

// this build's feature mask
extern "C" int k2_shade_mask() { return (int)MASK; }

extern "C" int k2_shade_launch(const float* tables, int n_floats, int n_mats,
                               int n_lights, const float* d,
                               const float* point, const float* normal,
                               const float* dpdu, const float* beta,
                               const float* hit_t, const int* mat_id,
                               const bool* alive, const bool* prev_sg,
                               const int* pix, const int* spp, int spp_const,
                               int n, unsigned int seed, int bounce,
                               int max_depth, int rr_start, float* f3,
                               float* f1, int* good, bool* flags,
                               void* stream) {
  if (n <= 0) return 0;
  const K2In in{d, point, normal, dpdu, beta, hit_t, mat_id, pix, spp,
                alive, prev_sg, spp_const};
  const K2Out out{f3, f1, good, flags};
  const int blocks = (n + W - 1) / W;
  const size_t smem = (size_t)n_floats * sizeof(float);
  k2_shade_kernel<<<blocks, W, smem, (cudaStream_t)stream>>>(
      tables, n_floats, n_mats, n_lights, in, n, seed, bounce, max_depth,
      rr_start, out);
  return (int)cudaGetLastError();
}

extern "C" const char* cray_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
