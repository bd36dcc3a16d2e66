// One ray's walk of a fat-row BVH4, shared by K3, K3 `_init` and K4
// (bvh4_traverse.cu) and K5 (bvh4_split.cu). See bvh4_traverse.cu for the
// visit order, which is the plain version's (accel/bvh4.py `_traverse4`)
// exactly, and for why t and the triangle id come out bit for bit.
//
// A row source says where a pop reads its node:
//   * FatRows: boxes, child ids and the eight leaf slots from the 512-byte
//     fat row (K3, K4);
//   * SplitRows: boxes and child ids from the 128-byte topology row (the
//     fat row's first 32 floats), the first `cached` rows of which the
//     block holds in shared memory; a leaf child's two slots from the fat
//     row, and only for leaf children (K5). An internal child's slots hold
//     no triangle (id -1) in every table the builder or the partition
//     makes, so skipping them changes nothing.
#pragma once

#include <cuda_runtime.h>

namespace bvh4 {

constexpr float TMAXF = 3.4028235e38f;
constexpr float K_EPS = 7.0e-6f;
constexpr int MAX_STACK = 128;
constexpr int ROW_F4 = 32;   // a 128-float fat row = 32 float4
constexpr int TOPO_F4 = 8;   // a 32-float topology row = 8 float4
constexpr int LEAF = 2;      // leaf size: 4 x 2 inlined triangle slots
constexpr int TRI0_F4 = 7;   // the slots start at float 28 = float4 7
constexpr int PAIR_F4 = 5;   // one child's two slots: 20 floats

__device__ __forceinline__ float safe_div(float v) {
  return fabsf(v) < 1e-12f ? (v < 0.0f ? -1e-12f : 1e-12f) : v;
}

struct FatRows {
  const float4* __restrict__ fat;
  static constexpr bool kLeafSlotsOnly = false;
  __device__ __forceinline__ float4 box4(int node, int q) const {
    return __ldg(fat + (size_t)node * ROW_F4 + q);
  }
  __device__ __forceinline__ float4 slot4(int node, int q) const {
    return __ldg(fat + (size_t)node * ROW_F4 + TRI0_F4 + q);
  }
};

struct SplitRows {
  const float4* topo_s;  // the first `cached` topology rows, shared memory
  int cached;
  const float4* __restrict__ topo;
  const float4* __restrict__ fat;
  static constexpr bool kLeafSlotsOnly = true;
  __device__ __forceinline__ float4 box4(int node, int q) const {
    return node < cached ? topo_s[node * TOPO_F4 + q]
                         : __ldg(topo + (size_t)node * TOPO_F4 + q);
  }
  __device__ __forceinline__ float4 slot4(int node, int q) const {
    return __ldg(fat + (size_t)node * ROW_F4 + TRI0_F4 + q);
  }
};

// best_t / best_tri come in as the walk's starting hit (TMAX / -1, or a
// carried one) and leave as its result.
template <bool ANY, class Rows>
__device__ __forceinline__ void walk(
    const Rows& rows, int m, int stack_size, float ox, float oy, float oz,
    float dx, float dy, float dz, float md, float& best_t, int& best_tri) {
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

    // ---- 4-box slab test against the limit before this pop's triangles
    const float tlimit = fminf(best_t, md);
    float r[28];
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      const float4 v = rows.box4(node, q);
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
    float key[4];
    int cv[4];
    int child[4];
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
      child[c] = (int)r[24 + c];
      const bool is_int = child[c] >= 0 && tn <= tf && tf > 0.0f
                          && tn < tlimit;
      key[c] = is_int ? tn : -INFINITY;
      cv[c] = is_int ? child[c] : -1;
    }

    // ---- the row's inlined triangles: child c's two slots (20 floats,
    // 5 loads) in slot order
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (Rows::kLeafSlotsOnly && child[c] >= 0) continue;
      float s[20];
#pragma unroll
      for (int q = 0; q < PAIR_F4; ++q) {
        const float4 v = rows.slot4(node, c * PAIR_F4 + q);
        s[4 * q] = v.x;
        s[4 * q + 1] = v.y;
        s[4 * q + 2] = v.z;
        s[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < LEAF; ++h) {
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

}  // namespace bvh4
