// K2: one bounce's shading for an external hit record, for Hopper
// (sm_90a).
//
// Replaces craytracer_tpu/integrator/pallas_shade.py:240 `_shade_kernel`
// (through `_shade_core` :874, launched by `fused_shade` :1846) for the
// materials and lights the port's gate admits: all seven material types
// with isotropic Beckmann lobes, rect and sphere area lights (<= 16 rows),
// a constant or black env light. The shading itself is shade_core.cuh, the
// same code K1 runs per bounce, instantiated as the matte-only core and
// as the full core; the launcher picks one.
//
// What bounds it on an H100: bytes. A lane reads its ray direction, hit
// point, normal, dpdu and throughput (15 floats), hit t, material id, two
// flags, pixel and spp, and writes 23 floats and 4 ints; the arithmetic in
// between is ~300 flops for a matte lane and up to ~1,000 for a glass or
// plastic one, at most about 5 flops per byte moved, below the card's
// ~20 flops per byte of f32 balance. The design:
//   * one thread per lane, no shared state between lanes;
//   * the material and light rows (<= ~6 KB) are copied once per block
//     into shared memory; the threads of a warp read the same few rows;
//   * inputs are [N, 3] rows and the vector outputs [7, N, 3] blocks, so
//     each thread's three floats are adjacent and a warp's loads and
//     stores cover contiguous 384-byte spans; scalar outputs are [2, N]
//     and [4, N] rows;
//   * `bounce` is a launch argument; spp comes per lane (or as one value).
// Numerics: --fmad=false, -prec-div=true, -prec-sqrt=true (see
// shade_core.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "shade_core.cuh"

namespace {

using namespace cray;

// table layout (floats), written by shade_kernel.shade_tables: env
// radiance (3) and a pad, then n_mats x 19 material rows, n_lights x 19
// light rows
constexpr int MATS = 4;

// output blocks of `f3` ([7, N, 3]) and rows of `f1` ([2, N]), `io` ([4, N])
enum { F3_LADD, F3_SHO, F3_SHD, F3_CONTRIB, F3_NEWO, F3_NEWD, F3_NEWB };
enum { F1_DADJ, F1_DADJT };
enum { IO_GOOD, IO_WSH, IO_ALIVE, IO_PSG };

__device__ __forceinline__ void store3(float* dst, const float (&v)[3]) {
  dst[0] = v[0];
  dst[1] = v[1];
  dst[2] = v[2];
}

template <bool FULL>
__global__ void __launch_bounds__(128)
k2_shade_kernel(const float* __restrict__ tables, int n_floats, int n_mats,
                int n_lights, const float* __restrict__ d,
                const float* __restrict__ point,
                const float* __restrict__ normal,
                const float* __restrict__ dpdu,
                const float* __restrict__ beta,
                const float* __restrict__ hit_t,
                const int* __restrict__ mat_id,
                const bool* __restrict__ alive,
                const bool* __restrict__ prev_sg,
                const int* __restrict__ pix, const int* __restrict__ spp,
                int spp_const, int n, uint32_t seed, int bounce,
                int max_depth, int rr_start, float* __restrict__ f3,
                float* __restrict__ f1, int* __restrict__ io) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < n_floats; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const float* mt = tab + MATS;
  const float* lt = mt + n_mats * MT_COLS;

  const int i3 = 3 * lane;
  const uint32_t s = (uint32_t)(spp != nullptr ? spp[lane] : spp_const);
  ShadeOut o;
  shade_core<FULL>(seed, bounce, max_depth, rr_start, tab, mt, n_mats, lt,
                   n_lights, lane_hash((uint32_t)pix[lane], s),
                   d[i3], d[i3 + 1], d[i3 + 2],
                   point[i3], point[i3 + 1], point[i3 + 2],
                   normal[i3], normal[i3 + 1], normal[i3 + 2],
                   dpdu[i3], dpdu[i3 + 1], dpdu[i3 + 2],
                   beta[i3], beta[i3 + 1], beta[i3 + 2],
                   mat_id[lane], hit_t[lane] < TMAXF, alive[lane],
                   prev_sg[lane], o);

  const size_t blk = 3 * (size_t)n;
  store3(f3 + F3_LADD * blk + i3, o.l_add);
  store3(f3 + F3_SHO * blk + i3, o.sho);
  store3(f3 + F3_SHD * blk + i3, o.wi);
  store3(f3 + F3_CONTRIB * blk + i3, o.contrib);
  store3(f3 + F3_NEWO * blk + i3, o.new_o);
  store3(f3 + F3_NEWD * blk + i3, o.new_d);
  store3(f3 + F3_NEWB * blk + i3, o.new_beta);
  f1[F1_DADJ * n + lane] = o.dist_adj;
  f1[F1_DADJT * n + lane] = o.dadj_t;
  io[IO_GOOD * n + lane] = o.good_inc;
  io[IO_WSH * n + lane] = o.want_shadow ? 1 : 0;
  io[IO_ALIVE * n + lane] = o.new_alive ? 1 : 0;
  io[IO_PSG * n + lane] = o.new_prev_sg ? 1 : 0;
}

template <bool FULL>
int launch(const float* tables, int n_floats, int n_mats, int n_lights,
           const float* d, const float* point, const float* normal,
           const float* dpdu, const float* beta, const float* hit_t,
           const int* mat_id, const bool* alive, const bool* prev_sg,
           const int* pix, const int* spp, int spp_const, int n,
           unsigned int seed, int bounce, int max_depth, int rr_start,
           float* f3, float* f1, int* io, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const size_t smem = (size_t)n_floats * sizeof(float);
  k2_shade_kernel<FULL><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      tables, n_floats, n_mats, n_lights, d, point, normal, dpdu, beta, hit_t,
      mat_id, alive, prev_sg, pix, spp, spp_const, n, seed, bounce, max_depth,
      rr_start, f3, f1, io);
  return (int)cudaGetLastError();
}

}  // namespace

// `full` is 0 for the matte-only core (a scene whose feature mask,
// integrator/gate.py shade_features, is 0), else 1 for every lobe
extern "C" int k2_shade_launch(const float* tables, int n_floats, int n_mats,
                               int n_lights, const float* d,
                               const float* point, const float* normal,
                               const float* dpdu, const float* beta,
                               const float* hit_t, const int* mat_id,
                               const bool* alive, const bool* prev_sg,
                               const int* pix, const int* spp, int spp_const,
                               int n, unsigned int seed, int bounce,
                               int max_depth, int rr_start, int full,
                               float* f3, float* f1, int* io, void* stream) {
  if (n <= 0) return 0;
  return (full ? launch<true> : launch<false>)(
      tables, n_floats, n_mats, n_lights, d, point, normal, dpdu, beta, hit_t,
      mat_id, alive, prev_sg, pix, spp, spp_const, n, seed, bounce, max_depth,
      rr_start, f3, f1, io, stream);
}

extern "C" const char* cray_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
