// K6: brute-force closest triangle per ray (min t, argmin), for Hopper
// (sm_90a).
//
// Replaces craytracer_tpu/ops/pallas_tri.py:35 `_kernel` (launched by
// `pallas_triangle_closest` :90, call :101). The TPU kernel tiles rays over
// the grid, keeps the whole [9, T'] SoA triangle table in VMEM and folds a
// [1024, 128] block of Moller-Trumbore tests per step into a running (min t,
// argmin). Here one thread owns one ray; a block of THREADS rays walks the
// table in tiles of TRI_TILE triangles, each tile staged once through
// shared memory by the whole block, so a triangle's nine floats are read
// from device memory once per block instead of once per ray.
//
// The test is pallas_tri.py:53-74 in its expression order: the |det| <
// 1e-20 guard (replaced by +1e-20), tt > K_EPS, tri_id < num_tris (the
// table's padded width, so every column; the pads are degenerate and never
// pass tt > K_EPS). A triangle replaces the best only when strictly
// closer, so ties go to the lowest index, as the per-tile argmin and the
// strict < across tiles do. t = TMAX and idx = -1 on a miss. With
// --fmad=false every product and sum rounds on its own, as in the plain
// version (ops/tri_kernel.py `triangle_closest`): t and idx are bit-equal.
//
// What bounds it on an H100: operations, about 53 f32 operations per
// (ray, triangle) pair, ~N * T' of them, against a few bytes per ray and
// 36 bytes per triangle and block. Not done here: register tiling of
// several rays per thread, a warp-level early-out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float TMAXF = 3.4028235e38f;
constexpr float K_EPS = 7.0e-6f;
constexpr int THREADS = 128;
constexpr int TRI_TILE = 128;  // the table's width is a multiple of it

__global__ void __launch_bounds__(THREADS)
k6_tri_kernel(const float* __restrict__ o, const float* __restrict__ d,
              int n, const float* __restrict__ tris, int num_tris,
              float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ float tile[9 * TRI_TILE];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = lane < n;
  const float ox = live ? o[3 * lane] : 0.0f;
  const float oy = live ? o[3 * lane + 1] : 0.0f;
  const float oz = live ? o[3 * lane + 2] : 0.0f;
  const float dx = live ? d[3 * lane] : 0.0f;
  const float dy = live ? d[3 * lane + 1] : 0.0f;
  const float dz = live ? d[3 * lane + 2] : 0.0f;
  float best_t = TMAXF;
  int best_i = -1;
  for (int base = 0; base < num_tris; base += TRI_TILE) {
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < 9 * TRI_TILE; i += blockDim.x) {
      const int row = i / TRI_TILE, col = i % TRI_TILE;
      tile[i] = tris[(size_t)row * num_tris + base + col];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < TRI_TILE; ++j) {
      const float v0x = tile[j], v0y = tile[TRI_TILE + j];
      const float v0z = tile[2 * TRI_TILE + j];
      const float e1x = tile[3 * TRI_TILE + j], e1y = tile[4 * TRI_TILE + j];
      const float e1z = tile[5 * TRI_TILE + j];
      const float e2x = tile[6 * TRI_TILE + j], e2y = tile[7 * TRI_TILE + j];
      const float e2z = tile[8 * TRI_TILE + j];
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const float inv_det = 1.0f / (fabsf(det) < 1e-20f ? 1e-20f : det);
      const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
      const float beta = (tx * px + ty * py + tz * pz) * inv_det;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float gamma = (dx * qx + dy * qy + dz * qz) * inv_det;
      const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      const bool ok = beta >= 0.0f && gamma >= 0.0f && beta + gamma <= 1.0f
                      && tt > K_EPS && base + j < num_tris;
      if (ok && tt < best_t) {
        best_t = tt;
        best_i = base + j;
      }
    }
  }
  if (!live) return;
  t_out[lane] = best_t;
  idx_out[lane] = best_t < TMAXF ? best_i : -1;
}

}  // namespace

extern "C" int k6_tri_launch(const float* o, const float* d, int n,
                             const float* tris, int num_tris, float* t_out,
                             int* idx_out, void* stream) {
  if (n <= 0) return 0;
  if (num_tris <= 0 || num_tris % TRI_TILE != 0)
    return 1;  // cudaErrorInvalidValue: the wrapper pads the table
  const int blocks = (n + THREADS - 1) / THREADS;
  k6_tri_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      o, d, n, tris, num_tris, t_out, idx_out);
  return (int)cudaGetLastError();
}

extern "C" const char* cray_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
