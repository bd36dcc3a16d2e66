// K1: the whole-pass path-tracing kernel for Hopper (sm_90a).
//
// Replaces craytracer_tpu/integrator/pallas_shade.py:781 `_pass_kernel`
// (with `_camera_raygen` :696, `_brute_hit` :533, `_brute_closest` :471,
// `_brute_any` :509, `_sphere_t` :363, `_plane_t` :314, `_rect_t` :293,
// `_disk_t` :325, `_tri_t` :341, `_box_object_ray` / `_box_t` :413-453 and
// `_shade_core` :874) for the scenes the port's gate admits: spheres
// (with the phi/theta clip window), planes, rects, disks and flat
// triangles in intersect_scene's group order, then a table of instanced
// boxes, <= 64 rows in all; all seven material types with isotropic
// Beckmann lobes; rect and sphere area lights (<= 16 rows); a constant or
// black env light; a pinhole or thin-lens camera with the stratified or
// the plain CAMERA_BOUNCE film jitter, or external rays (`_pass_kernel`
// with raygen=None, pallas_shade.py:806-808: the camera rays of a table
// sampler, made outside); depth < 31; the reference and the physical
// estimators (the wrapper normalizes).
//
// What bounds it on an H100: arithmetic and divergence, not memory. A path
// reads two ints and writes seven words; everything else is ~20-80 flops
// per prim test over <= 64 rows, twice per bounce (closest hit, then the
// shadow any hit), plus the shading. Paths end at different bounces and,
// in a scene of several materials, take different lobes. The design:
//   * persistent warps: the launch has only as many blocks as fit on the
//     card at once; each thread holds one path's state and steps it one
//     bounce per iteration. A thread whose path has ended writes that
//     path's outputs and takes the next path index, with the raygen
//     inline (or, with external rays, the path's o and d read from the
//     launch's [N, 3] inputs: 24 more bytes a path), so no lane idles in a live warp while paths remain, and the
//     grid has no partial last wave. A warp takes its indices with one
//     atomicAdd on a counter of the launch (zeroed on the launch's
//     stream), aggregated with __ballot_sync / __popc; a lane with no path
//     left idles inside the loop until its whole warp is done, so every
//     warp-wide intrinsic sees all 32 lanes;
//   * the camera, env, material, light, prim and box tables (<= ~17 KB)
//     are copied once per block into shared memory, and per-row constants
//     (a rect's squared edge lengths, a sphere's or disk's squared radius)
//     are computed there once, with the expression each lane computed;
//     every thread of a warp reads the same row, so each read is a
//     broadcast;
//   * each prim test takes a t_max (the best t so far in the closest hit,
//     the shadow threshold in the any hit) and stops once t <= K_EPS or t
//     >= t_max: a rect's edge divisions, a triangle's gamma and t after a
//     failed beta, a sphere root's window test. The shadow any hit
//     returns at the first occluder below the threshold. Outputs are
//     unchanged: a skipped test could only return a value the caller
//     discards, and the closest hit keeps its row order and its strict <;
//   * the full core regroups the block's paths by the material type of
//     their hit before each shading step (a counting sort of the path
//     states through shared memory), so the lanes of a warp mostly take
//     one lobe; its loop ends for the whole block at once;
//   * the kernel is a template on the shading core and on the prim groups
//     present: `FULL` (every lobe and the sphere light; else the
//     matte-only core of Cornell), `PD` (any plane or disk row) and `BOX`
//     (any box row). The launcher picks the instantiation from the row
//     counts, so a table without such rows carries no code for them;
//   * the fill reads only the winner's row (the TPU kernel selected it
//     with a masked loop over every row);
//   * row/column come from an exact integer pix / width (the f32 residual
//     trick at pallas_shade.py:708-721 only worked around Mosaic);
//   * each path writes its own good / rays / shadow_rays / alive-bitmask
//     words, once (a path alive at bounces 0..b traced b + 1 rays); the
//     wrapper sums them, so counts are deterministic.
//     Every random number of a path is keyed by (pix, spp) and the bounce,
//     never by the thread, so which thread runs a path changes nothing;
//   * the sphere clip window is tested in cosine space, as the TPU kernel
//     does (no atan2/acos): equal to the atan2/acos window on the gate's
//     domain (phi <= pi, thetas in [0, pi]) up to boundary lanes.
// Numerics: built with --fmad=false, -prec-div=true, -prec-sqrt=true and
// without --use_fast_math, so each multiply and add rounds on its own, as
// in the op-by-op plain PyTorch version and the JAX reference (on the TPU,
// FMA contraction cost 1 lane in 4096 of `good` drift). The formulas keep
// the JAX kernel's expression trees and epsilons; the raygen and the box
// affines keep the plain version's (camera.py generate_rays,
// ops/intersect.py `_affine`). The shading of a bounce is shade_core.cuh,
// the same code K2 runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shade_core.cuh"

namespace {

using namespace cray;

constexpr uint32_t CAMERA_BOUNCE = 0x7FFFu;
constexpr int THREADS = 128;
constexpr unsigned FULL_MASK = 0xffffffffu;

// table layout (floats), written by pass_kernel.kernel_tables
constexpr int CAM = 0;   // 0-2 position, 3-5 x, 6-8 y, 9-11 z, 12 focal_dist,
                         // 13 frame_length, 14 frame_height, 15 pixel_length
constexpr int ENV = 18;  // constant env radiance (color * intensity)
constexpr int MATS = 24; // then n_mats x 19, n_lights x 19, n_prims x 16,
                         // n_box x 25
constexpr int PT_COLS = 16;
// box row: 0-11 inv_transform [3, 4] row-major, 12-20 normal_mat [3, 3]
// row-major, 21-23 half extents, 24 mat_id
constexpr int BT_COLS = 25;
// unread columns of the prim rows that the block fills in shared memory:
// a sphere's or disk's squared radius, a rect's squared edge lengths
constexpr int R2_COL = 7;
constexpr int W2_COL = 13, H2_COL = 14;

// one root of sphere_ts (ops/intersect.py:61-99) in the TPU kernel's
// cosine-space window (_sphere_t :363-410): |atan2(x, z)| <= phi  <=>
// z / |xz| >= cos(phi), and theta in [mn, mx]  <=>  cos in [cos mx,
// cos mn], with the unclamped-acos rejection |cos| > 1. Row: center (0-2),
// radius (3), cos(phi) (4), cos(min_theta) (5), cos(max_theta) (6).
__device__ __forceinline__ bool sphere_window(const float* r, float t,
                                              float ox, float oy, float oz,
                                              float wx, float wy, float wz) {
  const float hx = ox + t * wx - r[0];
  const float hy = oy + t * wy - r[1];
  const float hz = oz + t * wz - r[2];
  const float xz = sqrtf(fmaxf(hx * hx + hz * hz, 1e-30f));
  const float cos_raw = hy / r[3];
  return (hz / xz >= r[4]) && (cos_raw <= r[5]) && (cos_raw >= r[6])
         && (fabsf(cos_raw) <= 1.0f);
}

// the nearer accepted root in (K_EPS, t_max), else TMAXF: the stable
// quadratic (core/solvers.py), then the window of the nearer root and, if
// it fails, of the farther. A root at or past t_max is not tested: the
// caller discards it either way.
__device__ __forceinline__ float sphere_t(const float* r, float ox, float oy,
                                          float oz, float wx, float wy,
                                          float wz, float t_max) {
  const float ocx = ox - r[0], ocy = oy - r[1], ocz = oz - r[2];
  const float a = wx * wx + wy * wy + wz * wz;
  const float b = 2.0f * (ocx * wx + ocy * wy + ocz * wz);
  const float c = (ocx * ocx + ocy * ocy + ocz * ocz) - r[R2_COL];
  const float disc = b * b - 4.0f * a * c;
  if (!(disc >= 0.0f)) return TMAXF;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float q = -0.5f * (b + (b >= 0.0f ? sq : -sq));
  float r0, r1;
  if (a == 0.0f) {
    r0 = r1 = -c / (b == 0.0f ? 1.0f : b);
  } else {
    r0 = q / a;
    r1 = c / (q == 0.0f ? 1.0f : q);
  }
  const float lo = fminf(r0, r1), hi = fmaxf(r0, r1);
  if (lo > K_EPS && lo < t_max
      && sphere_window(r, lo, ox, oy, oz, wx, wy, wz))
    return lo;
  if (hi > K_EPS && hi < t_max
      && sphere_window(r, hi, ox, oy, oz, wx, wy, wz))
    return hi;
  return TMAXF;
}

// the plane distance of a row holding a point (0-2) and a normal (9-11)
__device__ __forceinline__ float plane_dist(const float* r, float ox,
                                            float oy, float oz, float wx,
                                            float wy, float wz) {
  const float denom = wx * r[9] + wy * r[10] + wz * r[11];
  return ((r[0] - ox) * r[9] + (r[1] - oy) * r[10] + (r[2] - oz) * r[11])
         / safe_div(denom);
}

// rect_ts (ops/intersect.py:117-141) for one table row; the edge
// divisions only for t in (K_EPS, t_max), vv only for uu in [0, 1]
__device__ __forceinline__ float rect_t(const float* r, float ox, float oy,
                                        float oz, float wx, float wy,
                                        float wz, float t_max) {
  const float t = plane_dist(r, ox, oy, oz, wx, wy, wz);
  if (!(t > K_EPS && t < t_max)) return TMAXF;
  const float qx = ox + t * wx - r[0];
  const float qy = oy + t * wy - r[1];
  const float qz = oz + t * wz - r[2];
  const float uu = (qx * r[3] + qy * r[4] + qz * r[5]) / r[W2_COL];
  if (!(uu >= 0.0f && uu <= 1.0f)) return TMAXF;
  const float vv = (qx * r[6] + qy * r[7] + qz * r[8]) / r[H2_COL];
  return (vv >= 0.0f && vv <= 1.0f) ? t : TMAXF;
}

// plane_ts (ops/intersect.py:102-114): unbounded
__device__ __forceinline__ float plane_t(const float* r, float ox, float oy,
                                         float oz, float wx, float wy,
                                         float wz, float t_max) {
  const float t = plane_dist(r, ox, oy, oz, wx, wy, wz);
  return (t > K_EPS && t < t_max) ? t : TMAXF;
}

// disk_ts (ops/intersect.py:143-160); row holds the center (0-2), the
// radius (6) and the normal (9-11)
__device__ __forceinline__ float disk_t(const float* r, float ox, float oy,
                                        float oz, float wx, float wy,
                                        float wz, float t_max) {
  const float t = plane_dist(r, ox, oy, oz, wx, wy, wz);
  if (!(t > K_EPS && t < t_max)) return TMAXF;
  const float qx = ox + t * wx - r[0];
  const float qy = oy + t * wy - r[1];
  const float qz = oz + t * wz - r[2];
  return ((qx * qx + qy * qy + qz * qz) <= r[R2_COL]) ? t : TMAXF;
}

// triangle_ts Moller-Trumbore (ops/intersect.py:163-197); row holds
// v0 (0-2), e1 (3-5), e2 (6-8); gamma only after beta passes, t only
// after gamma does
__device__ __forceinline__ float tri_t(const float* r, float ox, float oy,
                                       float oz, float wx, float wy,
                                       float wz, float t_max) {
  const float e1x = r[3], e1y = r[4], e1z = r[5];
  const float e2x = r[6], e2y = r[7], e2z = r[8];
  const float cpx = wy * e2z - wz * e2y;
  const float cpy = wz * e2x - wx * e2z;
  const float cpz = wx * e2y - wy * e2x;
  const float det = e1x * cpx + e1y * cpy + e1z * cpz;
  const float inv_det = 1.0f / safe_div(det);
  const float tx = ox - r[0], ty = oy - r[1], tz = oz - r[2];
  const float beta = (tx * cpx + ty * cpy + tz * cpz) * inv_det;
  if (!(beta >= 0.0f)) return TMAXF;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float gamma = (wx * qx + wy * qy + wz * qz) * inv_det;
  if (!(gamma >= 0.0f && beta + gamma <= 1.0f)) return TMAXF;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return (t > K_EPS && t < t_max) ? t : TMAXF;
}

// the world ray in a box row's object space (_instanced_object_rays,
// ops/intersect.py:198-206); the direction is not renormalized
__device__ __forceinline__ void box_object_ray(const float* b, float ox,
                                               float oy, float oz, float wx,
                                               float wy, float wz, float& oox,
                                               float& ooy, float& ooz,
                                               float& odx, float& ody,
                                               float& odz) {
  oox = b[0] * ox + b[1] * oy + b[2] * oz + b[3];
  ooy = b[4] * ox + b[5] * oy + b[6] * oz + b[7];
  ooz = b[8] * ox + b[9] * oy + b[10] * oz + b[11];
  odx = b[0] * wx + b[1] * wy + b[2] * wz;
  ody = b[4] * wx + b[5] * wy + b[6] * wz;
  odz = b[8] * wx + b[9] * wy + b[10] * wz;
}

// _aabox_ts (ops/intersect.py:209-220): the slab test on the canonical
// box [-half, half]; the entry distance from outside, the exit from inside
__device__ __forceinline__ float box_t(const float* b, float ox, float oy,
                                       float oz, float wx, float wy,
                                       float wz, float t_max) {
  float oox, ooy, ooz, odx, ody, odz;
  box_object_ray(b, ox, oy, oz, wx, wy, wz, oox, ooy, ooz, odx, ody, odz);
  const float hx = b[21], hy = b[22], hz = b[23];
  const float ivx = 1.0f / safe_div(odx);
  const float ivy = 1.0f / safe_div(ody);
  const float ivz = 1.0f / safe_div(odz);
  const float t0x = (-hx - oox) * ivx, t1x = (hx - oox) * ivx;
  const float t0y = (-hy - ooy) * ivy, t1y = (hy - ooy) * ivy;
  const float t0z = (-hz - ooz) * ivz, t1z = (hz - ooz) * ivz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  const float t = (tn > K_EPS ? tn : tf);
  return ((tn < tf) && (tf > K_EPS) && t < t_max) ? t : TMAXF;
}

// orthonormal_basis's tangent of a unit normal (Duff et al.; core/math.py),
// the dpdu the plain plane, disk and instanced fills give. Taken here, not
// through the shading core's zero-dpdu fallback: the shading renormalizes
// a nonzero dpdu against n, which moves some normals' tangent by an ulp
__device__ __forceinline__ void duff_tangent(float nx, float ny, float nz,
                                             float& tx, float& ty,
                                             float& tz) {
  const float s = nz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (s + nz);
  tx = 1.0f + s * nx * nx * a;
  ty = s * (nx * ny * a);
  tz = -s * nx;
}

// jnp.sign: 0 at 0 (copysignf would give +-1)
__device__ __forceinline__ float sign0(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// the face a box point lies on: sign(r_k) e_k for k = argmax |r_k|, the
// first of a tie (argmax's order)
__device__ __forceinline__ void dominant(float rx, float ry, float rz,
                                         float& nx, float& ny, float& nz) {
  const float ax = fabsf(rx), ay = fabsf(ry), az = fabsf(rz);
  const bool use_x = (ax >= ay) && (ax >= az);
  const bool use_y = !use_x && (ay >= az);
  nx = use_x ? sign0(rx) : 0.0f;
  ny = use_y ? sign0(ry) : 0.0f;
  nz = (!use_x && !use_y) ? sign0(rz) : 0.0f;
}

// the row spans of the prim table in intersect_scene's order: spheres
// [0, sph), planes [sph, sp), rects [sp, spr), disks [spr, sprd), triangles
// [sprd, tot); box k is candidate tot + k
struct Spans {
  int sph, sp, spr, sprd, tot, box;
};

// the shadow any hit (_brute_any): true at the first row that occludes
// below `thr`. The plain shadow_distance takes the minimum t over every
// row and compares it with thr; a row can only decide that compare by a
// t below thr, and every test returns TMAXF for a t at or past it. The
// plane, disk and box loops, here and in the closest hit, stay rolled.
template <bool PD, bool BOX>
__device__ __forceinline__ bool occluded(const float* pt, const float* bt,
                                         const Spans& n, float ox, float oy,
                                         float oz, float wx, float wy,
                                         float wz, float thr) {
  for (int k = 0; k < n.sph; ++k)
    if (sphere_t(pt + k * PT_COLS, ox, oy, oz, wx, wy, wz, thr) < thr)
      return true;
  if (PD) {
#pragma unroll 1
    for (int k = n.sph; k < n.sp; ++k)
      if (plane_t(pt + k * PT_COLS, ox, oy, oz, wx, wy, wz, thr) < thr)
        return true;
  }
  for (int k = n.sp; k < n.spr; ++k)
    if (rect_t(pt + k * PT_COLS, ox, oy, oz, wx, wy, wz, thr) < thr)
      return true;
  if (PD) {
#pragma unroll 1
    for (int k = n.spr; k < n.sprd; ++k)
      if (disk_t(pt + k * PT_COLS, ox, oy, oz, wx, wy, wz, thr) < thr)
        return true;
  }
  for (int k = n.sprd; k < n.tot; ++k)
    if (tri_t(pt + k * PT_COLS, ox, oy, oz, wx, wy, wz, thr) < thr)
      return true;
  if (BOX) {
#pragma unroll 1
    for (int k = 0; k < n.box; ++k)
      if (box_t(bt + k * BT_COLS, ox, oy, oz, wx, wy, wz, thr) < thr)
        return true;
  }
  return false;
}

// the closest hit (_brute_closest): strict < keeps the first minimum
template <bool PD, bool BOX>
__device__ __forceinline__ void closest(const float* pt, const float* bt,
                                        const Spans& n, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, float& best_t,
                                        int& best_k) {
  best_t = TMAXF;
  best_k = 0;
  for (int k = 0; k < n.sph; ++k) {
    const float t = sphere_t(pt + k * PT_COLS, ox, oy, oz, dx, dy, dz,
                             best_t);
    if (t < best_t) { best_t = t; best_k = k; }
  }
  if (PD) {
#pragma unroll 1
    for (int k = n.sph; k < n.sp; ++k) {
      const float t = plane_t(pt + k * PT_COLS, ox, oy, oz, dx, dy, dz,
                              best_t);
      if (t < best_t) { best_t = t; best_k = k; }
    }
  }
  for (int k = n.sp; k < n.spr; ++k) {
    const float t = rect_t(pt + k * PT_COLS, ox, oy, oz, dx, dy, dz, best_t);
    if (t < best_t) { best_t = t; best_k = k; }
  }
  if (PD) {
#pragma unroll 1
    for (int k = n.spr; k < n.sprd; ++k) {
      const float t = disk_t(pt + k * PT_COLS, ox, oy, oz, dx, dy, dz,
                             best_t);
      if (t < best_t) { best_t = t; best_k = k; }
    }
  }
  for (int k = n.sprd; k < n.tot; ++k) {
    const float t = tri_t(pt + k * PT_COLS, ox, oy, oz, dx, dy, dz, best_t);
    if (t < best_t) { best_t = t; best_k = k; }
  }
  if (BOX) {
#pragma unroll 1
    for (int k = 0; k < n.box; ++k) {
      const float t = box_t(bt + k * BT_COLS, ox, oy, oz, dx, dy, dz,
                            best_t);
      if (t < best_t) { best_t = t; best_k = n.tot + k; }
    }
  }
}

// the camera ray of one path (_camera_raygen; generate_rays' pinhole and
// thin-lens)
__device__ __forceinline__ void raygen(const float* cam, int ipix,
                                       uint32_t spp, uint32_t h_lane,
                                       uint32_t seed, int strat,
                                       int thinlens, int width, float& ox,
                                       float& oy, float& oz, float& dx,
                                       float& dy, float& dz) {
  const uint32_t pix = (uint32_t)ipix;
  const int row = ipix / width;
  const int col = ipix - row * width;
  const uint32_t hc = fmix(h_lane ^ (seed + GOLDEN * CAMERA_BOUNCE));
  const float u0 = uni(hc, 0), u1 = uni(hc, 1);
  float j0 = u0, j1 = u1;
  if (strat) {  // stratified_jitter: rotated 4x4 stratum + in-stratum u
    const uint32_t rot = fmix(pix ^ (seed * 977u)) % 16u;
    const uint32_t stratum = (spp + rot) % 16u;
    j0 = ((float)(stratum % 4u) + u0) * 0.25f;
    j1 = ((float)(stratum / 4u) + u1) * 0.25f;
  }
  const float ix = -cam[13] * 0.5f + cam[15] * ((float)col + j0);
  const float iy = cam[14] * 0.5f - cam[15] * ((float)row + j1);
  const float fd = cam[12];
  if (thinlens) {
    // the lens sample: map_to_disk_polar of CAMERA_BOUNCE dims 2-3 times
    // lens_radius (17), aimed at the focal-plane point at focal_length
    // (16); normalized in camera space, then turned to world space
    // without renormalizing
    const float phi = TWO_PI_F * uni(hc, 2);
    const float rl = sqrtf(uni(hc, 3));
    const float lx = rl * cosf(phi) * cam[17];
    const float ly = rl * sinf(phi) * cam[17];
    const float fl = cam[16];
    const float scale = fl / fd;
    float cx = ix * scale - lx, cy = iy * scale - ly, cz = -fl - fd;
    normalize3(cx, cy, cz);
    dx = cx * cam[3] + cy * cam[6] + cz * cam[9];
    dy = cx * cam[4] + cy * cam[7] + cz * cam[10];
    dz = cx * cam[5] + cy * cam[8] + cz * cam[11];
    ox = lx * cam[3] + ly * cam[6] + fd * cam[9] + cam[0];
    oy = lx * cam[4] + ly * cam[7] + fd * cam[10] + cam[1];
    oz = lx * cam[5] + ly * cam[8] + fd * cam[11] + cam[2];
  } else {
    dx = ix * cam[3] + iy * cam[6] - fd * cam[9];
    dy = ix * cam[4] + iy * cam[7] - fd * cam[10];
    dz = ix * cam[5] + iy * cam[8] - fd * cam[11];
    normalize3(dx, dy, dz);
    ox = ix * cam[3] + iy * cam[6] + cam[0];
    oy = ix * cam[4] + iy * cam[7] + cam[1];
    oz = ix * cam[5] + iy * cam[8] + cam[2];
  }
}

// the hit record of the winner (_brute_hit): its row, the facing rules and
// dpdu. Spheres refine t by one Newton step on |o + t d - c|^2 - r^2 and
// never flip; boxes refine t by one Newton step on the face plane; rects
// always face the ray and flip dpdu with the normal; disks face the ray;
// planes never flip; flat triangles flip only when double-sided. Planes,
// disks and boxes take the Duff tangent of the faced normal as dpdu, as
// their plain fills do. A miss carries the intersect_scene defaults.
template <bool PD, bool BOX>
__device__ __forceinline__ void fill(const float* pt, const float* bt,
                                     const Spans& n, int n_mats, float ox,
                                     float oy, float oz, float dx, float dy,
                                     float dz, bool hitm, float best_t,
                                     int best_k, float& px, float& py,
                                     float& pz, float& fnx, float& fny,
                                     float& fnz, float& ndx, float& ndy,
                                     float& ndz, int& mat_id) {
  fnx = 0.0f; fny = 0.0f; fnz = 1.0f;
  ndx = 1.0f; ndy = 0.0f; ndz = 0.0f;
  px = 0.0f; py = 0.0f; pz = 0.0f;
  mat_id = 0;
  if (hitm && best_k < n.sph) {
    const float* r = pt + best_k * PT_COLS;
    mat_id = min(max((int)r[12], 0), n_mats - 1);
    const float socx = ox + best_t * dx - r[0];
    const float socy = oy + best_t * dy - r[1];
    const float socz = oz + best_t * dz - r[2];
    const float Fv = socx * socx + socy * socy + socz * socz - r[R2_COL];
    const float Fp = 2.0f * (socx * dx + socy * dy + socz * dz);
    const float t_n = best_t - Fv / safe_div(Fp);
    fnx = ox + t_n * dx - r[0];
    fny = oy + t_n * dy - r[1];
    fnz = oz + t_n * dz - r[2];
    ndx = -fnz; ndy = 0.0f; ndz = fnx;
    normalize3(fnx, fny, fnz);
    normalize3(ndx, ndy, ndz);
    px = ox + t_n * dx;
    py = oy + t_n * dy;
    pz = oz + t_n * dz;
  } else if (BOX && hitm && best_k >= n.tot) {
    // _fill_instanced's box legs: the object-space ray, one Newton step
    // on the face plane, the dominant-axis normal of the refined point,
    // pushed to world space through normal_mat, faced toward the ray
    const float* br = bt + (best_k - n.tot) * BT_COLS;
    mat_id = min(max((int)br[24], 0), n_mats - 1);
    float oox, ooy, ooz, odx, ody, odz;
    box_object_ray(br, ox, oy, oz, dx, dy, dz, oox, ooy, ooz, odx, ody,
                   odz);
    const float hx = br[21], hy = br[22], hz = br[23];
    const float hpx = oox + best_t * odx;
    const float hpy = ooy + best_t * ody;
    const float hpz = ooz + best_t * odz;
    float nfx, nfy, nfz;
    dominant(hpx / safe_div(hx), hpy / safe_div(hy), hpz / safe_div(hz),
             nfx, nfy, nfz);
    const float F = (hpx * nfx + hpy * nfy + hpz * nfz)
                    - (hx * fabsf(nfx) + hy * fabsf(nfy) + hz * fabsf(nfz));
    const float Fp = odx * nfx + ody * nfy + odz * nfz;
    const float t_n = best_t - F / safe_div(Fp);
    dominant((oox + t_n * odx) / safe_div(hx),
             (ooy + t_n * ody) / safe_div(hy),
             (ooz + t_n * odz) / safe_div(hz), nfx, nfy, nfz);
    fnx = br[12] * nfx + br[13] * nfy + br[14] * nfz;
    fny = br[15] * nfx + br[16] * nfy + br[17] * nfz;
    fnz = br[18] * nfx + br[19] * nfy + br[20] * nfz;
    normalize3(fnx, fny, fnz);
    if (fnx * dx + fny * dy + fnz * dz > 0.0f) {
      fnx = -fnx; fny = -fny; fnz = -fnz;
    }
    duff_tangent(fnx, fny, fnz, ndx, ndy, ndz);
    px = ox + t_n * dx;
    py = oy + t_n * dy;
    pz = oz + t_n * dz;
  } else if (hitm) {
    const float* r = pt + best_k * PT_COLS;
    fnx = r[9]; fny = r[10]; fnz = r[11];
    mat_id = min(max((int)r[12], 0), n_mats - 1);
    const bool is_pl = PD && best_k >= n.sph && best_k < n.sp;
    const bool is_rect = best_k >= n.sp && best_k < n.spr;
    const bool is_dsk = PD && best_k >= n.spr && best_k < n.sprd;
    const bool is_tri = best_k >= n.sprd && best_k < n.tot;
    const bool flip = (-dx * fnx - dy * fny - dz * fnz) < 0.0f;
    const bool do_flip = flip && (is_rect || is_dsk
                                  || (is_tri && r[13] != 0.0f));
    const float sgn = do_flip ? -1.0f : 1.0f;
    fnx = fnx * sgn; fny = fny * sgn; fnz = fnz * sgn;
    if (is_pl || is_dsk) {
      duff_tangent(fnx, fny, fnz, ndx, ndy, ndz);
    } else {
      const float du_sgn = (do_flip && is_rect) ? -1.0f : 1.0f;
      ndx = r[3] * du_sgn; ndy = r[4] * du_sgn; ndz = r[5] * du_sgn;
      normalize3(ndx, ndy, ndz);
    }
    px = ox + best_t * dx;
    py = oy + best_t * dy;
    pz = oz + best_t * dz;
  }
}

template <bool FULL, bool PD, bool BOX>
__global__ void __launch_bounds__(THREADS)
k1_pass_kernel(const float* __restrict__ tables, int n_floats,
               const int* __restrict__ pix_in, const int* __restrict__ spp_in,
               const float* __restrict__ o_in,
               const float* __restrict__ d_in, int n, int n_mats, int n_lights, int n_sph, int n_pl,
               int n_rects, int n_dsk, int n_tris, int n_box, uint32_t seed,
               int max_depth, int rr_start, int strat, int thinlens,
               int width, int* __restrict__ next_path,
               float* __restrict__ L_out, int* __restrict__ g_out) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < n_floats; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();

  const float* cam = tab + CAM;
  const float* env = tab + ENV;
  const float* mt = tab + MATS;
  const float* lt = mt + n_mats * MT_COLS;
  float* const pt = tab + MATS + (n_mats + n_lights) * MT_COLS;
  Spans ns;
  ns.sph = n_sph;
  ns.sp = n_sph + n_pl;
  ns.spr = ns.sp + n_rects;
  ns.sprd = ns.spr + n_dsk;
  ns.tot = ns.sprd + n_tris;
  ns.box = n_box;
  const float* bt = pt + ns.tot * PT_COLS;
  // per-row constants, once per block: the expressions (and so the
  // roundings) of the plain tests
  for (int k = threadIdx.x; k < ns.sprd; k += blockDim.x) {
    float* r = pt + k * PT_COLS;
    if (k < ns.sph) {
      r[R2_COL] = r[3] * r[3];
    } else if (k >= ns.sp && k < ns.spr) {
      r[W2_COL] = r[3] * r[3] + r[4] * r[4] + r[5] * r[5];
      r[H2_COL] = r[6] * r[6] + r[7] * r[7] + r[8] * r[8];
    } else if (k >= ns.spr) {
      r[R2_COL] = r[6] * r[6];
    }
  }
  __syncthreads();

  const int wl = threadIdx.x & 31;
  const unsigned below = (1u << wl) - 1u;
  // one path's state; path < 0: none. The path has entered bounces 0..b,
  // so its ray count is b + 1 and its alive mask the low b + 1 bits
  int path = -1, b = 0;
  uint32_t h_lane = 0u;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float bx = 1.0f, by = 1.0f, bz = 1.0f;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
  bool prev_sg = false;
  int good = 0, shadows = 0;
  bool drained = false;  // warp-uniform: the counter has passed n

  for (;;) {
    // ---- refill: the lanes without a path take the next indices, one
    // atomicAdd per warp
    if (!drained) {
      const unsigned ask = __ballot_sync(FULL_MASK, path < 0);
      if (ask != 0u) {
        const int leader = __ffs((int)ask) - 1;
        int base = 0;
        if (wl == leader) base = atomicAdd(next_path, __popc(ask));
        base = __shfl_sync(FULL_MASK, base, leader);
        drained = base + __popc(ask) >= n;
        const int idx = base + __popc(ask & below);
        if (path < 0 && idx < n) {
          path = idx;
          const int ipix = pix_in[path];
          const uint32_t spp = (uint32_t)spp_in[path];
          h_lane = lane_hash((uint32_t)ipix, spp);
          if (o_in != nullptr) {  // external rays: no padding lanes
            ox = o_in[3 * path]; oy = o_in[3 * path + 1];
            oz = o_in[3 * path + 2];
            dx = d_in[3 * path]; dy = d_in[3 * path + 1];
            dz = d_in[3 * path + 2];
          } else {
            raygen(cam, ipix, spp, h_lane, seed, strat, thinlens, width, ox,
                   oy, oz, dx, dy, dz);
          }
          b = 0;
          bx = 1.0f; by = 1.0f; bz = 1.0f;
          lr = 0.0f; lg = 0.0f; lb = 0.0f;
          prev_sg = false;
          good = 0; shadows = 0;
        }
      }
    }
    // the full core regroups the block's paths, so its loop ends for the
    // whole block at once; the matte-only core's for each warp
    if (!(FULL ? __syncthreads_or(path >= 0)
               : __any_sync(FULL_MASK, path >= 0)))
      break;

    // ---- one bounce's hit: a path enters every bounce alive
    float px = 0.0f, py = 0.0f, pz = 0.0f, fnx = 0.0f, fny = 0.0f;
    float fnz = 0.0f, ndx = 0.0f, ndy = 0.0f, ndz = 0.0f;
    int mat_id = 0;
    bool hitm = false;
    if (path >= 0) {
      float best_t;
      int best_k;
      closest<PD, BOX>(pt, bt, ns, ox, oy, oz, dx, dy, dz, best_t, best_k);
      hitm = best_t < TMAXF;
      fill<PD, BOX>(pt, bt, ns, n_mats, ox, oy, oz, dx, dy, dz, hitm,
                    best_t, best_k, px, py, pz, fnx, fny, fnz, ndx, ndy, ndz,
                    mat_id);
    }
    if constexpr (FULL) {
      // ---- regroup the block's paths by the material type of their hit
      // (0 a miss, 15 no path), so a warp's lanes mostly take one lobe in
      // the shading: a counting sort of the block's path states through
      // shared memory. The ray origin is not carried: the shading makes
      // the next one
      __shared__ int key_count[16];
      __shared__ float sf[18][THREADS];
      __shared__ int si[7][THREADS];
      const int key = path < 0 ? 15
          : (hitm ? (int)mt[min(max(mat_id, 0), n_mats - 1) * MT_COLS] : 0);
      if (threadIdx.x < 16) key_count[threadIdx.x] = 0;
      __syncthreads();
      int slot = atomicAdd(&key_count[key], 1);
      __syncthreads();
      for (int k = 0; k < key; ++k) slot += key_count[k];
      const float f[18] = {dx, dy, dz, px, py, pz, fnx, fny, fnz, ndx, ndy,
                           ndz, bx, by, bz, lr, lg, lb};
      const int g[7] = {path, b, (int)h_lane, mat_id,
                        (hitm ? 1 : 0) | (prev_sg ? 2 : 0), good, shadows};
      for (int j = 0; j < 18; ++j) sf[j][slot] = f[j];
      for (int j = 0; j < 7; ++j) si[j][slot] = g[j];
      __syncthreads();
      const int t = threadIdx.x;
      dx = sf[0][t]; dy = sf[1][t]; dz = sf[2][t];
      px = sf[3][t]; py = sf[4][t]; pz = sf[5][t];
      fnx = sf[6][t]; fny = sf[7][t]; fnz = sf[8][t];
      ndx = sf[9][t]; ndy = sf[10][t]; ndz = sf[11][t];
      bx = sf[12][t]; by = sf[13][t]; bz = sf[14][t];
      lr = sf[15][t]; lg = sf[16][t]; lb = sf[17][t];
      path = si[0][t]; b = si[1][t]; h_lane = (uint32_t)si[2][t];
      mat_id = si[3][t]; hitm = (si[4][t] & 1) != 0;
      prev_sg = (si[4][t] & 2) != 0; good = si[5][t]; shadows = si[6][t];
    }
    if (path < 0) continue;

    // ---- the bounce's shading and shadow ray
    ShadeOut s;
    shade_lane<FULL ? F_ALL : 0u>(seed, b, max_depth, rr_start, env, mt,
                                  n_mats, lt, n_lights, h_lane, dx, dy, dz,
                                  px, py, pz, fnx, fny, fnz, ndx, ndy, ndz,
                                  bx, by, bz, mat_id, hitm, true, prev_sg, s);
    lr = lr + s.l_add[0];
    lg = lg + s.l_add[1];
    lb = lb + s.l_add[2];
    good += s.good_inc;

    if (s.want_shadow) {
      shadows += 1;
      // lit <=> min t over the rows >= thr (a NaN thr is never lit)
      const float dadj = s.dist_adj;
      const float thr = dadj - fmaxf(K_EPS, 1e-3f * dadj);
      if (TMAXF >= thr
          && !occluded<PD, BOX>(pt, bt, ns, s.sho[0], s.sho[1], s.sho[2],
                                s.wi[0], s.wi[1], s.wi[2], thr)) {
        lr = lr + s.contrib[0];
        lg = lg + s.contrib[1];
        lb = lb + s.contrib[2];
        good += (s.contrib[0] != 0.0f || s.contrib[1] != 0.0f
                 || s.contrib[2] != 0.0f) ? 1 : 0;
      }
    }
    if (s.new_alive && b < max_depth) {
      ox = s.new_o[0]; oy = s.new_o[1]; oz = s.new_o[2];
      dx = s.new_d[0]; dy = s.new_d[1]; dz = s.new_d[2];
      bx = s.new_beta[0]; by = s.new_beta[1]; bz = s.new_beta[2];
      prev_sg = s.new_prev_sg;
      ++b;
      continue;
    }
    // the path has ended: every later bounce would add exactly nothing
    L_out[3 * path + 0] = lr;
    L_out[3 * path + 1] = lg;
    L_out[3 * path + 2] = lb;
    g_out[path] = good;
    g_out[n + path] = b + 1;
    g_out[2 * n + path] = shadows;
    g_out[3 * n + path] = (int)((2u << b) - 1u);
    path = -1;
  }
}

template <bool FULL, bool PD, bool BOX>
int launch(const float* tables, int n_floats, const int* pix, const int* spp,
           const float* o_in, const float* d_in, int n, const int* counts, unsigned int seed, int max_depth,
           int rr_start, int strat, int thinlens, int width, int* next_path,
           float* L_out, int* g_out, cudaStream_t stream) {
  const size_t smem = (size_t)n_floats * sizeof(float);
  int per_sm = 0, sms = 0, dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k1_pass_kernel<FULL, PD, BOX>, THREADS, smem);
  if (!err) err = (int)cudaMemsetAsync(next_path, 0, sizeof(int), stream);
  if (err) return err;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  const int needed = (n + THREADS - 1) / THREADS;
  const int blocks = resident < needed ? resident : needed;
  k1_pass_kernel<FULL, PD, BOX><<<blocks, THREADS, smem, stream>>>(
      tables, n_floats, pix, spp, o_in, d_in, n, counts[0], counts[1],
      counts[2],
      counts[3], counts[4], counts[5], counts[6], counts[7], seed, max_depth,
      rr_start, strat, thinlens, width, next_path, L_out, g_out);
  return (int)cudaGetLastError();
}

typedef int (*Launch)(const float*, int, const int*, const int*,
                      const float*, const float*, int, const int*, unsigned int, int, int, int, int, int, int*,
                      float*, int*, cudaStream_t);

// the eight instantiations, indexed by full * 4 + pd * 2 + box
const Launch LAUNCHES[8] = {
    launch<false, false, false>, launch<false, false, true>,
    launch<false, true, false>,  launch<false, true, true>,
    launch<true, false, false>,  launch<true, false, true>,
    launch<true, true, false>,   launch<true, true, true>};

}  // namespace

// `counts` (host memory): n_mats, n_lights, n_sph, n_pl, n_rects, n_dsk,
// n_tris, n_box, the row counts of the tables (pass_kernel.table_counts);
// `full` is 0 for the matte-only core (a scene whose feature mask,
// integrator/gate.py shade_features, is 0), else 1 for every lobe;
// `thinlens` 1 for a thin-lens camera, 0 for a pinhole; `next_path` one
// int of device scratch, the launch's path counter (zeroed here on
// `stream` before the launch). The instantiation is picked from `full`
// and whether the table holds planes or disks, and boxes.
extern "C" int k1_pass_launch(const float* tables, int n_floats,
                              const int* pix, const int* spp, int n,
                              const int* counts, unsigned int seed,
                              int max_depth, int rr_start, int strat,
                              int thinlens, int width, int full,
                              int* next_path, float* L_out, int* g_out,
                              void* stream) {
  if (n <= 0) return 0;
  const int pd = (counts[3] + counts[5]) > 0;
  const int box = counts[7] > 0;
  return LAUNCHES[(full ? 4 : 0) + pd * 2 + box](
      tables, n_floats, pix, spp, nullptr, nullptr, n, counts, seed,
      max_depth, rr_start, strat, thinlens, width, next_path, L_out, g_out,
      (cudaStream_t)stream);
}

// K1 on external rays (raygen=None): `o` and `d` are [n, 3] f32 device
// arrays, row-major, the camera rays of path i at row i; `pix` and `spp`
// still key each path's random numbers. The rest as k1_pass_launch.
extern "C" int k1_pass_rays_launch(const float* tables, int n_floats,
                                   const int* pix, const int* spp,
                                   const float* o, const float* d, int n,
                                   const int* counts, unsigned int seed,
                                   int max_depth, int rr_start, int full,
                                   int* next_path, float* L_out, int* g_out,
                                   void* stream) {
  if (n <= 0) return 0;
  if (o == nullptr || d == nullptr) return 1;  // cudaErrorInvalidValue
  const int pd = (counts[3] + counts[5]) > 0;
  const int box = counts[7] > 0;
  return LAUNCHES[(full ? 4 : 0) + pd * 2 + box](
      tables, n_floats, pix, spp, o, d, n, counts, seed, max_depth, rr_start,
      0, 0, 1, next_path, L_out, g_out, (cudaStream_t)stream);
}

extern "C" const char* cray_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
