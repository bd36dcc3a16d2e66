// A ray's walk of a fat-row BVH4, shared by K3, K3 `_init` and K4
// (bvh4_traverse.cu, FatRows below) and K5 (bvh4_split.cu, SplitRows).
// See bvh4_traverse.cu for the visit order, which is the plain version's
// (accel/bvh4.py `_traverse4`) exactly, and for why t and the triangle id
// come out bit for bit.
//
// A row source says where a pop reads its node: `box4(node, q)` is float4
// q of the node's four child boxes and child ids (7 float4), `pair(node,
// c)` points at child c's two leaf slots (5 float4) in the fat row,
// `prefetch(node)` may ask for the row of a child the pop will push, and
// `prefetch_slots(node, b)` may ask for the slots of the popped row's leaf
// children once its boxes and child ids (`b`, 28 floats) have arrived,
// before its box tests.
// A pop skips the slots of internal children (child id >= 0): all of
// them in a row without a leaf child, and with `kLeafPairsOnly` in every
// row; with `kSkipEmpty` also those of empty children (the builder's
// sentinel box, min x 1 > max x -1). That is exact: neither kind of child
// holds a triangle (id -1) in its slots in any table the port hands to a
// kernel (build_bvh4, partition_bvh4 and interop.scene_from_numpy hold
// each one to accel/bvh4.py `check_leaf_slots`), and a slot with id < 0
// never passes the test (`ok` needs tid >= 0).
#pragma once

#include <cuda_runtime.h>

namespace bvh4 {

constexpr float TMAXF = 3.4028235e38f;
constexpr float K_EPS = 7.0e-6f;
constexpr int MAX_STACK = 128;
constexpr int ROW_F4 = 32;   // a 128-float fat row = 32 float4
constexpr int BOX_F4 = 7;    // boxes and child ids: the row's first 28 floats
constexpr int TOPO_F4 = 8;   // a 32-float topology row = 8 float4
constexpr int LEAF = 2;      // leaf size: 4 x 2 inlined triangle slots
constexpr int TRI0_F4 = 7;   // the slots start at float 28 = float4 7
constexpr int PAIR_F4 = 5;   // one child's two slots: 20 floats

__device__ __forceinline__ float safe_div(float v) {
  return fabsf(v) < 1e-12f ? (v < 0.0f ? -1e-12f : 1e-12f) : v;
}

// FatRows: K3, K3 `_init` and K4 read the fat table itself. With
// PREFETCH (a table past the L2), a pop reads the slots of its leaf
// children only, not of internal or empty ones, and asks L1 for the whole
// row (four 128-byte lines) of every child it will push before it tests
// its own triangles, so the later pops of those rows find their box and
// slot lines on their way from device memory. Without (a table the L2
// holds), a row with a leaf child has all its eight slots read and
// tested: there the empty slots cost less than a branch per child.
template <bool PREFETCH>
struct FatRows {
  static constexpr bool kLeafPairsOnly = PREFETCH;
  static constexpr bool kSkipEmpty = PREFETCH;
  const float4* __restrict__ fat;
  __device__ __forceinline__ float4 box4(int node, int q) const {
    return __ldg(fat + (size_t)node * ROW_F4 + q);
  }
  __device__ __forceinline__ const float4* pair(int node, int c) const {
    return fat + (size_t)node * ROW_F4 + TRI0_F4 + c * PAIR_F4;
  }
  __device__ __forceinline__ void prefetch_slots(int, const float*) const {}
  __device__ __forceinline__ void prefetch(int node) const {
#ifdef __CUDA_ARCH__
    if constexpr (PREFETCH) {
      const float4* p = fat + (size_t)node * ROW_F4;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(p + 8 * k));
    }
#endif
  }
};

// A ray with its reciprocal direction and its max_dist (TMAX for a
// closest hit).
struct Ray {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz, md;
};

// The ray of lane i; false when its origin, direction or max_dist holds a
// NaN. The plain version's min/max propagate NaN, so such a ray misses
// everything; fminf/fmaxf would not, so its walk must not start.
__device__ __forceinline__ bool load_ray(const float* __restrict__ o,
                                         const float* __restrict__ d,
                                         float md, int i, Ray& r) {
  r.ox = o[3 * i];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.md = md;
  r.ivx = 1.0f / safe_div(r.dx);
  r.ivy = 1.0f / safe_div(r.dy);
  r.ivz = 1.0f / safe_div(r.dz);
  return !(r.ox != r.ox || r.oy != r.oy || r.oz != r.oz || r.dx != r.dx
           || r.dy != r.dy || r.dz != r.dz || md != md);
}

// One ray's whole walk, one pop per iteration. best_t / best_tri come in
// as the walk's starting hit (TMAX / -1, or a carried one) and leave as
// its result.
template <bool ANY, class Rows>
__device__ __forceinline__ void walk(const Rows& rows, int m, int stack_size,
                                     const Ray& r, float& best_t,
                                     int& best_tri) {
  int stack[MAX_STACK];
  stack[0] = 0;  // root
  int sp = 1;
  while (sp > 0) {
    sp -= 1;
    const int node = min(max(stack[sp], 0), m - 1);

    // ---- 4-box slab test against the limit before this pop's triangles
    const float tlimit = fminf(best_t, r.md);
    float b[28];
#pragma unroll
    for (int q = 0; q < BOX_F4; ++q) {
      const float4 v = rows.box4(node, q);
      b[4 * q] = v.x;
      b[4 * q + 1] = v.y;
      b[4 * q + 2] = v.z;
      b[4 * q + 3] = v.w;
    }
    rows.prefetch_slots(node, b);
    float key[4];
    int cv[4];
    int child[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float t0x = (b[c * 3] - r.ox) * r.ivx;
      const float t1x = (b[12 + c * 3] - r.ox) * r.ivx;
      const float t0y = (b[c * 3 + 1] - r.oy) * r.ivy;
      const float t1y = (b[12 + c * 3 + 1] - r.oy) * r.ivy;
      const float t0z = (b[c * 3 + 2] - r.oz) * r.ivz;
      const float t1z = (b[12 + c * 3 + 2] - r.oz) * r.ivz;
      const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fminf(t0z, t1z));
      const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fmaxf(t0z, t1z));
      child[c] = (int)b[24 + c];
      const bool is_int = child[c] >= 0 && tn <= tf && tf > 0.0f
                          && tn < tlimit;
      key[c] = is_int ? tn : -INFINITY;
      cv[c] = is_int ? child[c] : -1;
    }

    // ---- sort the entered internal children far to near (nothing here
    // depends on the triangle tests below); with PREFETCH ask for their rows
#define CRAY_SWAP(i, j)                                     \
    if (key[i] < key[j]) {                                  \
      const float tk = key[i]; key[i] = key[j]; key[j] = tk; \
      const int tc = cv[i]; cv[i] = cv[j]; cv[j] = tc;       \
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
      if (k < npush) rows.prefetch(min(cv[k], m - 1));

    // ---- the slots (20 floats, 5 loads a child) in slot order: of the
    // children that are not internal (and with kSkipEmpty not empty), or
    // of every child in a row with a leaf child (Rows::kLeafPairsOnly
    // false); internal and empty children's slots hold no triangle
    if (Rows::kLeafPairsOnly || child[0] < 0 || child[1] < 0 || child[2] < 0
        || child[3] < 0)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (Rows::kLeafPairsOnly && child[c] >= 0) continue;
      if (Rows::kSkipEmpty && b[c * 3] > b[12 + c * 3]) continue;
      const float4* pp = rows.pair(node, c);
      float s[20];
#pragma unroll
      for (int q = 0; q < PAIR_F4; ++q) {
        const float4 v = __ldg(pp + q);
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
        const float px = r.dy * e2z - r.dz * e2y;
        const float py = r.dz * e2x - r.dx * e2z;
        const float pz = r.dx * e2y - r.dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const float inv_det = 1.0f / safe_div(det);
        const float tx = r.ox - tr[0], ty = r.oy - tr[1], tz = r.oz - tr[2];
        const float beta = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float gamma = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool ok = tid >= 0 && beta >= 0.0f && gamma >= 0.0f
                        && beta + gamma <= 1.0f && tt > K_EPS
                        && tt < best_t && (!ANY || tt < r.md);
        if (ok) {
          best_t = tt;
          best_tri = tid;
        }
      }
    }
    // ---- push them, the nearest on top
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < npush) stack[sp + k] = cv[k];
    sp += npush;

    if (ANY && best_t < r.md) sp = 0;
  }
}

}  // namespace bvh4
