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
// the plain CAMERA_BOUNCE film jitter; depth < 31; the reference and the
// physical estimators (the wrapper normalizes).
//
// What bounds it on an H100: arithmetic and divergence, not memory. A lane
// reads two ints and writes seven words; everything else is ~20-80 flops
// per prim test over <= 64 rows, twice per bounce (closest hit, then the
// shadow any-hit), plus the shading, with lanes of a warp retiring at
// different bounces and, in a scene of several materials, taking
// different lobes. The design:
//   * one thread per path, the whole bounce loop in registers (the TPU
//     kernel carried the same state in VMEM across a fori_loop);
//   * the camera, env, material, light, prim and box tables (<= ~17 KB)
//     are copied once per block into shared memory; every thread of a
//     warp reads the same row, so each read is a broadcast;
//   * a lane that is no longer alive leaves the bounce loop: every later
//     bounce adds exactly nothing to its L, good or counters (the TPU
//     kernel had to keep SIMD lanes in lockstep), and the shadow any-hit
//     runs only for lanes that shoot a shadow ray;
//   * the fill reads only the winner's row (the TPU kernel selected it
//     with a masked loop over every row);
//   * row/column come from an exact integer pix / width (the f32 residual
//     trick at pallas_shade.py:708-721 only worked around Mosaic);
//   * each lane writes its own good / rays / shadow_rays / alive-bitmask
//     words; the wrapper sums them, so counts are deterministic (no
//     atomics);
//   * the kernel is a template on the shading core: `k1<false>` (the
//     matte-only core: Cornell) keeps the registers it had, `k1<true>`
//     carries every lobe and the sphere light; the launcher picks one;
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

// sphere_ts (ops/intersect.py:61-99) in the TPU kernel's cosine-space
// form (_sphere_t :363-410): the stable quadratic (core/solvers.py), then
// each root inside |atan2(x, z)| <= phi  <=>  z / |xz| >= cos(phi), and
// theta in [mn, mx]  <=>  cos in [cos mx, cos mn], with the unclamped-acos
// rejection |cos| > 1. Row: center (0-2), radius (3), cos(phi) (4),
// cos(min_theta) (5), cos(max_theta) (6).
__device__ __forceinline__ float sphere_accept(const float* r, float t,
                                               float ox, float oy, float oz,
                                               float wx, float wy, float wz) {
  const float hx = ox + t * wx - r[0];
  const float hy = oy + t * wy - r[1];
  const float hz = oz + t * wz - r[2];
  const float xz = sqrtf(fmaxf(hx * hx + hz * hz, 1e-30f));
  const float cos_raw = hy / r[3];
  const bool ok = (t > K_EPS) && (t < TMAXF) && (hz / xz >= r[4])
                  && (cos_raw <= r[5]) && (cos_raw >= r[6])
                  && (fabsf(cos_raw) <= 1.0f);
  return ok ? t : TMAXF;
}

__device__ __forceinline__ float sphere_t(const float* r, float ox, float oy,
                                          float oz, float wx, float wy,
                                          float wz) {
  const float ocx = ox - r[0], ocy = oy - r[1], ocz = oz - r[2];
  const float a = wx * wx + wy * wy + wz * wz;
  const float b = 2.0f * (ocx * wx + ocy * wy + ocz * wz);
  const float c = (ocx * ocx + ocy * ocy + ocz * ocz) - r[3] * r[3];
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
  return fminf(sphere_accept(r, fminf(r0, r1), ox, oy, oz, wx, wy, wz),
               sphere_accept(r, fmaxf(r0, r1), ox, oy, oz, wx, wy, wz));
}

// rect_ts (ops/intersect.py:117-141) for one table row
__device__ __forceinline__ float rect_t(const float* r, float ox, float oy,
                                        float oz, float wx, float wy,
                                        float wz) {
  const float denom = wx * r[9] + wy * r[10] + wz * r[11];
  const float t = ((r[0] - ox) * r[9] + (r[1] - oy) * r[10]
                   + (r[2] - oz) * r[11]) / safe_div(denom);
  const float qx = ox + t * wx - r[0];
  const float qy = oy + t * wy - r[1];
  const float qz = oz + t * wz - r[2];
  const float uu = (qx * r[3] + qy * r[4] + qz * r[5])
                   / (r[3] * r[3] + r[4] * r[4] + r[5] * r[5]);
  const float vv = (qx * r[6] + qy * r[7] + qz * r[8])
                   / (r[6] * r[6] + r[7] * r[7] + r[8] * r[8]);
  const bool ok = (t > K_EPS) && (uu >= 0.0f) && (uu <= 1.0f)
                  && (vv >= 0.0f) && (vv <= 1.0f);
  return ok ? t : TMAXF;
}

// plane_ts (ops/intersect.py:102-114): unbounded; row holds the point
// (0-2) and the normal (9-11)
__device__ __forceinline__ float plane_t(const float* r, float ox, float oy,
                                         float oz, float wx, float wy,
                                         float wz) {
  const float denom = wx * r[9] + wy * r[10] + wz * r[11];
  const float t = ((r[0] - ox) * r[9] + (r[1] - oy) * r[10]
                   + (r[2] - oz) * r[11]) / safe_div(denom);
  return t > K_EPS ? t : TMAXF;
}

// disk_ts (ops/intersect.py:143-160); row holds the center (0-2), the
// radius (6) and the normal (9-11)
__device__ __forceinline__ float disk_t(const float* r, float ox, float oy,
                                        float oz, float wx, float wy,
                                        float wz) {
  const float denom = wx * r[9] + wy * r[10] + wz * r[11];
  const float t = ((r[0] - ox) * r[9] + (r[1] - oy) * r[10]
                   + (r[2] - oz) * r[11]) / safe_div(denom);
  const float qx = ox + t * wx - r[0];
  const float qy = oy + t * wy - r[1];
  const float qz = oz + t * wz - r[2];
  const bool ok = (t > K_EPS) && ((qx * qx + qy * qy + qz * qz)
                                  <= r[6] * r[6]);
  return ok ? t : TMAXF;
}

// triangle_ts Moller-Trumbore (ops/intersect.py:163-197); row holds
// v0 (0-2), e1 (3-5), e2 (6-8)
__device__ __forceinline__ float tri_t(const float* r, float ox, float oy,
                                       float oz, float wx, float wy,
                                       float wz) {
  const float e1x = r[3], e1y = r[4], e1z = r[5];
  const float e2x = r[6], e2y = r[7], e2z = r[8];
  const float cpx = wy * e2z - wz * e2y;
  const float cpy = wz * e2x - wx * e2z;
  const float cpz = wx * e2y - wy * e2x;
  const float det = e1x * cpx + e1y * cpy + e1z * cpz;
  const float inv_det = 1.0f / safe_div(det);
  const float tx = ox - r[0], ty = oy - r[1], tz = oz - r[2];
  const float beta = (tx * cpx + ty * cpy + tz * cpz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float gamma = (wx * qx + wy * qy + wz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  const bool ok = (beta >= 0.0f) && (gamma >= 0.0f)
                  && (beta + gamma <= 1.0f) && (t > K_EPS);
  return ok ? t : TMAXF;
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
                                       float wz) {
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
  const bool ok = (tn < tf) && (tf > K_EPS);
  return ok ? (tn > K_EPS ? tn : tf) : TMAXF;
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

// min t over every row and box: the shadow any-hit (_brute_any), no
// early out, as the plain shadow_distance takes the minimum. The plane,
// disk and box loops, here and in the closest hit, stay rolled: unrolled,
// their code slowed scenes without such rows (parity_mix's full core)
__device__ __forceinline__ float any_t(const float* pt, const float* bt,
                                       int n_sph, int n_sp, int n_spr,
                                       int n_sprd, int n_tot, int n_box,
                                       float ox, float oy, float oz,
                                       float wx, float wy, float wz) {
  float t = TMAXF;
  for (int k = 0; k < n_sph; ++k)
    t = fminf(t, sphere_t(pt + k * PT_COLS, ox, oy, oz, wx, wy, wz));
#pragma unroll 1
  for (int k = n_sph; k < n_sp; ++k)
    t = fminf(t, plane_t(pt + k * PT_COLS, ox, oy, oz, wx, wy, wz));
  for (int k = n_sp; k < n_spr; ++k)
    t = fminf(t, rect_t(pt + k * PT_COLS, ox, oy, oz, wx, wy, wz));
#pragma unroll 1
  for (int k = n_spr; k < n_sprd; ++k)
    t = fminf(t, disk_t(pt + k * PT_COLS, ox, oy, oz, wx, wy, wz));
  for (int k = n_sprd; k < n_tot; ++k)
    t = fminf(t, tri_t(pt + k * PT_COLS, ox, oy, oz, wx, wy, wz));
#pragma unroll 1
  for (int k = 0; k < n_box; ++k)
    t = fminf(t, box_t(bt + k * BT_COLS, ox, oy, oz, wx, wy, wz));
  return t;
}

template <bool FULL>
__global__ void __launch_bounds__(128)
k1_pass_kernel(const float* __restrict__ tables, int n_floats,
               const int* __restrict__ pix_in, const int* __restrict__ spp_in,
               int n, int n_mats, int n_lights, int n_sph, int n_pl,
               int n_rects, int n_dsk, int n_tris, int n_box, uint32_t seed,
               int max_depth, int rr_start, int strat, int thinlens,
               int width, float* __restrict__ L_out,
               int* __restrict__ g_out) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < n_floats; i += blockDim.x) tab[i] = tables[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;

  const float* cam = tab + CAM;
  const float* env = tab + ENV;
  const float* mt = tab + MATS;
  const float* lt = mt + n_mats * MT_COLS;
  const float* pt = lt + n_lights * LT_COLS;
  // group spans in intersect_scene's order: spheres [0, n_sph), planes,
  // rects, disks, triangles [n_sprd, n_tot); box k is candidate n_tot + k
  const int n_sp = n_sph + n_pl;
  const int n_spr = n_sp + n_rects;
  const int n_sprd = n_spr + n_dsk;
  const int n_tot = n_sprd + n_tris;
  const float* bt = pt + n_tot * PT_COLS;

  const int ipix = pix_in[lane];
  const uint32_t pix = (uint32_t)ipix;
  const uint32_t spp = (uint32_t)spp_in[lane];
  const uint32_t h_lane = lane_hash(pix, spp);

  // ---- raygen (_camera_raygen; generate_rays' pinhole and thin-lens)
  const int row = ipix / width;
  const int col = ipix - row * width;
  float ox, oy, oz, dx, dy, dz;
  {
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
      // the lens sample: map_to_disk_polar of CAMERA_BOUNCE dims 2-3
      // times lens_radius (17), aimed at the focal-plane point at
      // focal_length (16); normalized in camera space, then turned to
      // world space without renormalizing
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

  float bx = 1.0f, by = 1.0f, bz = 1.0f;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
  bool prev_sg = false;
  int good = 0, rays = 0, shadows = 0;
  uint32_t hist = 0u;

  for (int b = 0; b <= max_depth; ++b) {
    // a lane enters every bounce alive: a lane that dies adds nothing at
    // any later bounce, so it leaves the loop instead
    rays += 1;
    hist |= 1u << b;

    // ---- closest hit (_brute_closest): strict < keeps the first minimum
    float best_t = TMAXF;
    int best_k = 0;
    for (int k = 0; k < n_sph; ++k) {
      const float t = sphere_t(pt + k * PT_COLS, ox, oy, oz, dx, dy, dz);
      if (t < best_t) { best_t = t; best_k = k; }
    }
#pragma unroll 1
    for (int k = n_sph; k < n_sp; ++k) {
      const float t = plane_t(pt + k * PT_COLS, ox, oy, oz, dx, dy, dz);
      if (t < best_t) { best_t = t; best_k = k; }
    }
    for (int k = n_sp; k < n_spr; ++k) {
      const float t = rect_t(pt + k * PT_COLS, ox, oy, oz, dx, dy, dz);
      if (t < best_t) { best_t = t; best_k = k; }
    }
#pragma unroll 1
    for (int k = n_spr; k < n_sprd; ++k) {
      const float t = disk_t(pt + k * PT_COLS, ox, oy, oz, dx, dy, dz);
      if (t < best_t) { best_t = t; best_k = k; }
    }
    for (int k = n_sprd; k < n_tot; ++k) {
      const float t = tri_t(pt + k * PT_COLS, ox, oy, oz, dx, dy, dz);
      if (t < best_t) { best_t = t; best_k = k; }
    }
#pragma unroll 1
    for (int k = 0; k < n_box; ++k) {
      const float t = box_t(bt + k * BT_COLS, ox, oy, oz, dx, dy, dz);
      if (t < best_t) { best_t = t; best_k = n_tot + k; }
    }
    const bool hitm = best_t < TMAXF;

    // ---- fill (_brute_hit): winner's row, facing rules, dpdu. Spheres
    // refine t by one Newton step on |o + t d - c|^2 - r^2 and never flip;
    // boxes refine t by one Newton step on the face plane; rects always
    // face the ray and flip dpdu with the normal; disks face the ray;
    // planes never flip; flat triangles flip only when double-sided.
    // Planes, disks and boxes take the Duff tangent of the faced normal as
    // dpdu, as their plain fills do. A miss carries the intersect_scene
    // defaults.
    float fnx = 0.0f, fny = 0.0f, fnz = 1.0f;
    float ndx = 1.0f, ndy = 0.0f, ndz = 0.0f;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    int mat_id = 0;
    if (hitm && best_k < n_sph) {
      const float* r = pt + best_k * PT_COLS;
      mat_id = min(max((int)r[12], 0), n_mats - 1);
      const float socx = ox + best_t * dx - r[0];
      const float socy = oy + best_t * dy - r[1];
      const float socz = oz + best_t * dz - r[2];
      const float Fv = socx * socx + socy * socy + socz * socz - r[3] * r[3];
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
    } else if (hitm && best_k >= n_tot) {
      // _fill_instanced's box legs: the object-space ray, one Newton step
      // on the face plane, the dominant-axis normal of the refined point,
      // pushed to world space through normal_mat, faced toward the ray
      const float* br = bt + (best_k - n_tot) * BT_COLS;
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
      const bool is_pl = best_k >= n_sph && best_k < n_sp;
      const bool is_rect = best_k >= n_sp && best_k < n_spr;
      const bool is_dsk = best_k >= n_spr && best_k < n_sprd;
      const bool is_tri = best_k >= n_sprd && best_k < n_tot;
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

    ShadeOut s;
    shade_core<FULL>(seed, b, max_depth, rr_start, env, mt, n_mats, lt,
                     n_lights, h_lane, dx, dy, dz, px, py, pz, fnx, fny, fnz,
                     ndx, ndy, ndz, bx, by, bz, mat_id, hitm, true, prev_sg,
                     s);
    lr = lr + s.l_add[0];
    lg = lg + s.l_add[1];
    lb = lb + s.l_add[2];
    good += s.good_inc;

    if (s.want_shadow) {
      shadows += 1;
      const float t_sh = any_t(pt, bt, n_sph, n_sp, n_spr, n_sprd, n_tot,
                               n_box, s.sho[0], s.sho[1], s.sho[2],
                               s.wi[0], s.wi[1], s.wi[2]);
      const float dadj = s.dist_adj;
      if (t_sh >= dadj - fmaxf(K_EPS, 1e-3f * dadj)) {
        lr = lr + s.contrib[0];
        lg = lg + s.contrib[1];
        lb = lb + s.contrib[2];
        good += (s.contrib[0] != 0.0f || s.contrib[1] != 0.0f
                 || s.contrib[2] != 0.0f) ? 1 : 0;
      }
    }
    if (!s.new_alive) break;
    ox = s.new_o[0]; oy = s.new_o[1]; oz = s.new_o[2];
    dx = s.new_d[0]; dy = s.new_d[1]; dz = s.new_d[2];
    bx = s.new_beta[0]; by = s.new_beta[1]; bz = s.new_beta[2];
    prev_sg = s.new_prev_sg;
  }

  L_out[3 * lane + 0] = lr;
  L_out[3 * lane + 1] = lg;
  L_out[3 * lane + 2] = lb;
  g_out[lane] = good;
  g_out[n + lane] = rays;
  g_out[2 * n + lane] = shadows;
  g_out[3 * n + lane] = (int)hist;
}

template <bool FULL>
int launch(const float* tables, int n_floats, const int* pix, const int* spp,
           int n, const int* counts, unsigned int seed, int max_depth,
           int rr_start, int strat, int thinlens, int width, float* L_out,
           int* g_out, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const size_t smem = (size_t)n_floats * sizeof(float);
  k1_pass_kernel<FULL><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      tables, n_floats, pix, spp, n, counts[0], counts[1], counts[2],
      counts[3], counts[4], counts[5], counts[6], counts[7], seed, max_depth,
      rr_start, strat, thinlens, width, L_out, g_out);
  return (int)cudaGetLastError();
}

}  // namespace

// `counts` (host memory): n_mats, n_lights, n_sph, n_pl, n_rects, n_dsk,
// n_tris, n_box, the row counts of the tables (pass_kernel.table_counts);
// `full` is 0 for the matte-only core (a scene whose feature mask,
// integrator/gate.py shade_features, is 0), else 1 for every lobe;
// `thinlens` 1 for a thin-lens camera, 0 for a pinhole
extern "C" int k1_pass_launch(const float* tables, int n_floats,
                              const int* pix, const int* spp, int n,
                              const int* counts, unsigned int seed,
                              int max_depth, int rr_start, int strat,
                              int thinlens, int width, int full,
                              float* L_out, int* g_out, void* stream) {
  if (n <= 0) return 0;
  return (full ? launch<true> : launch<false>)(
      tables, n_floats, pix, spp, n, counts, seed, max_depth, rr_start, strat,
      thinlens, width, L_out, g_out, stream);
}

extern "C" const char* cray_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
