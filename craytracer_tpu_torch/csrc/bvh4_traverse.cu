// K3 (closest hit) and K4 (shadow any hit) against the fat-row BVH4, for
// Hopper (sm_90a).
//
// Replaces craytracer_tpu/accel/pallas_bvh4.py:146 `_traversal_kernel`
// (K3, launched by `pallas_bvh4_closest_hit` :583) and :451
// `_anyhit_kernel` (K4, launched by `pallas_bvh4_any_hit` :547). The
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
// fmaxf here would not, so such a ray returns TMAX / -1 at once. Retired
// lanes arrive as escape rays (origin 3e18, direction +x): every box lies
// behind them, so they pop the root and return TMAX / -1.
//
// What bounds it on an H100: dependent global loads per pop and
// divergence. Each pop reads one 512-byte row whose address depends on the
// previous pop, and the lanes of a warp walk different nodes. The design:
//   * one ray per thread, the stack (<= 128 ints, per-tree bound
//     `stack_size`) in local memory, everything else in registers;
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

namespace {

constexpr float TMAXF = 3.4028235e38f;
constexpr float K_EPS = 7.0e-6f;
constexpr int MAX_STACK = 128;
constexpr int ROW_F4 = 32;  // a 128-float row = 32 float4
constexpr int LEAF = 2;     // leaf size: 4 x 2 inlined triangle slots
constexpr int TRI0_F4 = 7;  // the slots start at float 28 = float4 7

__device__ __forceinline__ float safe_div(float v) {
  return fabsf(v) < 1e-12f ? (v < 0.0f ? -1e-12f : 1e-12f) : v;
}

template <bool ANY>
__device__ __forceinline__ void traverse(
    const float4* __restrict__ fat, int m, int stack_size, float ox,
    float oy, float oz, float dx, float dy, float dz, float md,
    float& best_t, int& best_tri) {
  best_t = TMAXF;
  best_tri = -1;
  if (ox != ox || oy != oy || oz != oz || dx != dx || dy != dy || dz != dz
      || md != md)
    return;
  const float ivx = 1.0f / safe_div(dx);
  const float ivy = 1.0f / safe_div(dy);
  const float ivz = 1.0f / safe_div(dz);
  int stack[MAX_STACK];
  stack[0] = 0;  // root
  int sp = 1;
  while (sp > 0) {
    sp -= 1;
    const int node = min(max(stack[sp], 0), m - 1);
    const float4* row = fat + (size_t)node * ROW_F4;

    // ---- 4-box slab test against the limit before this pop's triangles
    const float tlimit = fminf(best_t, md);
    float r[28];
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      const float4 v = __ldg(row + q);
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
    float key[4];
    int cv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float t0x = (r[c * 3] - ox) * ivx;
      const float t1x = (r[12 + c * 3] - ox) * ivx;
      const float t0y = (r[c * 3 + 1] - oy) * ivy;
      const float t1y = (r[12 + c * 3 + 1] - oy) * ivy;
      const float t0z = (r[c * 3 + 2] - oz) * ivz;
      const float t1z = (r[12 + c * 3 + 2] - oz) * ivz;
      const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fminf(t0z, t1z));
      const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fmaxf(t0z, t1z));
      const int child = (int)r[24 + c];
      const bool is_int = child >= 0 && tn <= tf && tf > 0.0f && tn < tlimit;
      key[c] = is_int ? tn : -INFINITY;
      cv[c] = is_int ? child : -1;
    }

    // ---- the row's inlined triangles, two slots (20 floats) per 5 loads
#pragma unroll
    for (int pair = 0; pair < 4 * LEAF / 2; ++pair) {
      float s[20];
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        const float4 v = __ldg(row + TRI0_F4 + pair * 5 + q);
        s[4 * q] = v.x;
        s[4 * q + 1] = v.y;
        s[4 * q + 2] = v.z;
        s[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* tr = s + 10 * h;
        const int tid = (int)tr[9];
        const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
        const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const float inv_det = 1.0f / safe_div(det);
        const float tx = ox - tr[0], ty = oy - tr[1], tz = oz - tr[2];
        const float beta = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float gamma = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool ok = tid >= 0 && beta >= 0.0f && gamma >= 0.0f
                        && beta + gamma <= 1.0f && tt > K_EPS
                        && tt < best_t && (!ANY || tt < md);
        if (ok) {
          best_t = tt;
          best_tri = tid;
        }
      }
    }

    // ---- push the entered internal children far to near
#define CRAY_SWAP(i, j)                                         \
  if (key[i] < key[j]) {                                        \
    const float tk = key[i]; key[i] = key[j]; key[j] = tk;      \
    const int tc = cv[i]; cv[i] = cv[j]; cv[j] = tc;            \
  }
    CRAY_SWAP(0, 1)
    CRAY_SWAP(2, 3)
    CRAY_SWAP(0, 2)
    CRAY_SWAP(1, 3)
    CRAY_SWAP(1, 2)
#undef CRAY_SWAP
    int npush = (cv[0] >= 0) + (cv[1] >= 0) + (cv[2] >= 0) + (cv[3] >= 0);
    npush = min(npush, stack_size - sp);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < npush) stack[sp + k] = cv[k];
    sp += npush;
    if (ANY && best_t < md) sp = 0;
  }
}

__global__ void __launch_bounds__(128)
k3_closest_kernel(const float4* __restrict__ fat, int m, int stack_size,
                  const float* __restrict__ o, const float* __restrict__ d,
                  int n, float* __restrict__ t_out, int* __restrict__ tri_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float t;
  int tri;
  traverse<false>(fat, m, stack_size, o[3 * lane], o[3 * lane + 1],
                  o[3 * lane + 2], d[3 * lane], d[3 * lane + 1],
                  d[3 * lane + 2], TMAXF, t, tri);
  t_out[lane] = t;
  tri_out[lane] = tri;
}

__global__ void __launch_bounds__(128)
k4_any_kernel(const float4* __restrict__ fat, int m, int stack_size,
              const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ md, int n, float* __restrict__ t_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  float t;
  int tri;
  traverse<true>(fat, m, stack_size, o[3 * lane], o[3 * lane + 1],
                 o[3 * lane + 2], d[3 * lane], d[3 * lane + 1],
                 d[3 * lane + 2], md[lane], t, tri);
  t_out[lane] = t;
}

}  // namespace

extern "C" int k3_closest_launch(const float* fat, int m, int stack_size,
                                 const float* o, const float* d, int n,
                                 float* t_out, int* tri_out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  k3_closest_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)fat, m, stack_size, o, d, n, t_out, tri_out);
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
