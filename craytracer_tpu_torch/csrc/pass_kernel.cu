// K1: the whole-pass path-tracing kernel for Hopper (sm_90a).
//
// Replaces craytracer_tpu/integrator/pallas_shade.py:781 `_pass_kernel`
// (with `_camera_raygen` :696, `_brute_hit` :533, `_brute_closest` :471,
// `_brute_any` :509 and `_shade_core` :874) for the scenes the port's gate
// admits: rects and flat triangles in intersect_scene's group order,
// Lambertian MATTE and EMISSIVE materials, rect area lights (<= 16 rows),
// a constant or black env light, a pinhole camera with the stratified or
// the plain CAMERA_BOUNCE film jitter, depth < 31, the reference and the
// physical estimators (the wrapper normalizes).
//
// What bounds it on an H100: arithmetic and divergence, not memory. A lane
// reads two ints and writes seven words; everything else is ~60 flops per
// prim test over <= 64 prims, twice per bounce (closest hit, then the
// shadow any-hit), with lanes of a warp retiring at different bounces.
// The design:
//   * one thread per path, the whole bounce loop in registers (the TPU
//     kernel carried the same state in VMEM across a fori_loop);
//   * the camera, env, material, light and prim tables (<= ~10 KB) are
//     copied once per block into shared memory; every thread of a warp
//     reads the same row, so each read is a broadcast;
//   * a lane that is no longer alive leaves the bounce loop: every later
//     bounce adds exactly nothing to its L, good or counters (the TPU
//     kernel had to keep SIMD lanes in lockstep), and the shadow any-hit
//     runs only for lanes that shoot a shadow ray;
//   * row/column come from an exact integer pix / width (the f32 residual
//     trick at pallas_shade.py:708-721 only worked around Mosaic);
//   * each lane writes its own good / rays / shadow_rays / alive-bitmask
//     words; the wrapper sums them, so counts are deterministic (no
//     atomics).
// Numerics: built with --fmad=false, -prec-div=true, -prec-sqrt=true and
// without --use_fast_math, so each multiply and add rounds on its own, as
// in the op-by-op plain PyTorch version and the JAX reference (on the TPU,
// FMA contraction cost 1 lane in 4096 of `good` drift). The formulas keep
// the JAX kernel's expression trees and epsilons.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float TMAXF = 3.4028235e38f;
constexpr float K_EPS = 7.0e-6f;
constexpr float INV_PI_F = 0.318309886183790671538f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t CAMERA_BOUNCE = 0x7FFFu;
constexpr int MAT_MATTE = 1;
constexpr int MAT_EMISSIVE = 4;

// table layout (floats), written by pass_kernel.kernel_tables
constexpr int CAM = 0;   // 0-2 position, 3-5 x, 6-8 y, 9-11 z, 12 focal_dist,
                         // 13 frame_length, 14 frame_height, 15 pixel_length
constexpr int ENV = 18;  // constant env radiance (color * intensity)
constexpr int MATS = 24; // then n_mats x 19, n_lights x 19, n_prims x 16
constexpr int MT_COLS = 19;
constexpr int LT_COLS = 19;
constexpr int PT_COLS = 16;

// murmur3 fmix32 (sampling/rng.py hash_u32)
__device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// uniforms(): top 24 bits of the dimension hash, exact in f32
__device__ __forceinline__ float uni(uint32_t h, uint32_t dim) {
  return (float)(fmix(h + GOLDEN * dim) >> 8) * (1.0f / 16777216.0f);
}

// vm._safe: replace ~0 with +-1e-12, keeping the sign
__device__ __forceinline__ float safe_div(float v) {
  return fabsf(v) < 1e-12f ? (v < 0.0f ? -1e-12f : 1e-12f) : v;
}

// vm.normalize: zero for (near-)zero vectors
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float n2 = x * x + y * y + z * z;
  const float inv = n2 > 1e-20f ? 1.0f / sqrtf(fmaxf(n2, 1e-20f)) : 0.0f;
  x = x * inv;
  y = y * inv;
  z = z * inv;
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

__global__ void __launch_bounds__(128)
k1_pass_kernel(const float* __restrict__ tables, int n_floats,
               const int* __restrict__ pix_in, const int* __restrict__ spp_in,
               int n, int n_mats, int n_lights, int n_rects, int n_tris,
               uint32_t seed, int max_depth, int rr_start, int strat,
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
  const int n_tot = n_rects + n_tris;

  const int ipix = pix_in[lane];
  const uint32_t pix = (uint32_t)ipix;
  const uint32_t spp = (uint32_t)spp_in[lane];
  // pixel and spp hashed in separate rounds (rng.py _combine)
  const uint32_t h_lane = fmix(fmix(pix) ^ fmix(spp));

  // ---- raygen (_camera_raygen, pinhole)
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
    dx = ix * cam[3] + iy * cam[6] - fd * cam[9];
    dy = ix * cam[4] + iy * cam[7] - fd * cam[10];
    dz = ix * cam[5] + iy * cam[8] - fd * cam[11];
    normalize3(dx, dy, dz);
    ox = ix * cam[3] + iy * cam[6] + cam[0];
    oy = ix * cam[4] + iy * cam[7] + cam[1];
    oz = ix * cam[5] + iy * cam[8] + cam[2];
  }

  float bx = 1.0f, by = 1.0f, bz = 1.0f;
  float lr = 0.0f, lg = 0.0f, lb = 0.0f;
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
    for (int k = 0; k < n_rects; ++k) {
      const float t = rect_t(pt + k * PT_COLS, ox, oy, oz, dx, dy, dz);
      if (t < best_t) { best_t = t; best_k = k; }
    }
    for (int k = n_rects; k < n_tot; ++k) {
      const float t = tri_t(pt + k * PT_COLS, ox, oy, oz, dx, dy, dz);
      if (t < best_t) { best_t = t; best_k = k; }
    }
    const bool hitm = best_t < TMAXF;

    // ---- emitted / env add (trace.h:419-455). Matte lobes are neither
    // specular nor glossy, so only camera rays add emission or env light.
    if (!hitm) {
      if (b == 0) {
        lr = lr + bx * env[0];
        lg = lg + by * env[1];
        lb = lb + bz * env[2];
        good += 1;
      }
      break;
    }
    // ---- fill (_brute_hit): winner's row, facing rules, dpdu
    const float* r = pt + best_k * PT_COLS;
    float fnx = r[9], fny = r[10], fnz = r[11];
    const int mat_id = min(max((int)r[12], 0), n_mats - 1);
    const bool is_rect = best_k < n_rects;
    const bool is_tri = best_k >= n_rects && best_k < n_tot;
    // rects always face the ray and flip dpdu with the normal; flat
    // triangles flip only when double-sided and keep dpdu
    const bool flip = (-dx * fnx - dy * fny - dz * fnz) < 0.0f;
    const bool do_flip = flip && (is_rect || (is_tri && r[13] != 0.0f));
    const float sgn = do_flip ? -1.0f : 1.0f;
    fnx = fnx * sgn; fny = fny * sgn; fnz = fnz * sgn;
    const float du_sgn = (do_flip && is_rect) ? -1.0f : 1.0f;
    float ndx = r[3] * du_sgn, ndy = r[4] * du_sgn, ndz = r[5] * du_sgn;
    normalize3(ndx, ndy, ndz);
    const float px = ox + best_t * dx;
    const float py = oy + best_t * dy;
    const float pz = oz + best_t * dz;

    const float* m = mt + mat_id * MT_COLS;
    const int mtype = (int)m[0];
    const float cr = m[1], cg = m[2], cb = m[3], on_a = m[4], inten = m[5];
    if (mtype == MAT_EMISSIVE) {  // emissive hits end the path
      if (b == 0) {
        lr = lr + bx * (cr * inten);
        lg = lg + by * (cg * inten);
        lb = lb + bz * (cb * inten);
        good += 1;
      }
      break;
    }
    if (b >= max_depth) break;

    // ---- shading frame (make_shading_frame; Duff basis fallback)
    const float ndu = fnx * ndx + fny * ndy + fnz * ndz;
    float ftx = ndx - ndu * fnx, fty = ndy - ndu * fny, ftz = ndz - ndu * fnz;
    const float t_len2 = ftx * ftx + fty * fty + ftz * ftz;
    if (t_len2 > 1e-12f) {
      normalize3(ftx, fty, ftz);
    } else {
      const float s = fnz >= 0.0f ? 1.0f : -1.0f;
      const float a = -1.0f / (s + fnz);
      ftx = 1.0f + s * fnx * fnx * a;
      fty = s * (fnx * fny * a);
      ftz = -s * fnx;
    }
    float fbx = fny * ftz - fnz * fty;
    float fby = fnz * ftx - fnx * ftz;
    float fbz = fnx * fty - fny * ftx;
    normalize3(fbx, fby, fbz);

    // ---- per-bounce uniforms (dims 0,1 light, 4 pick, 5,6 bsdf, 8 rr)
    const uint32_t h = fmix(h_lane ^ (seed + GOLDEN * (uint32_t)b));
    const float u_l0 = uni(h, 0), u_l1 = uni(h, 1), u_pick = uni(h, 4);
    const float u_b0 = uni(h, 5), u_b1 = uni(h, 6), u_rr = uni(h, 8);

    // ---- NEE: power-CDF pick (searchsorted side='right' + clip)
    int idx = 0;
    for (int k = 0; k < n_lights; ++k)
      idx += (u_pick >= lt[k * LT_COLS + 16]) ? 1 : 0;
    idx = min(idx, n_lights - 1);
    const float* l = lt + idx * LT_COLS;
    const float spx = l[0] + u_l0 * l[3] + u_l1 * l[6];
    const float spy = l[1] + u_l0 * l[4] + u_l1 * l[7];
    const float spz = l[2] + u_l0 * l[5] + u_l1 * l[8];
    const float len_v1 = sqrtf(fmaxf(l[3] * l[3] + l[4] * l[4] + l[5] * l[5],
                                     1e-20f));
    const float len_v2 = sqrtf(fmaxf(l[6] * l[6] + l[7] * l[7] + l[8] * l[8],
                                     1e-20f));
    const float pdf_area = 1.0f / fmaxf(len_v1 * len_v2, 1e-12f);
    const float lnx = l[9], lny = l[10], lnz = l[11];
    const float tox = spx - px, toy = spy - py, toz = spz - pz;
    const float dist2 = tox * tox + toy * toy + toz * toz;
    const float dist = sqrtf(fmaxf(dist2, 1e-20f));
    float wix = tox, wiy = toy, wiz = toz;
    normalize3(wix, wiy, wiz);
    const float conv = dist2 / fmaxf(fabsf(lnx * -wix + lny * -wiy
                                           + lnz * -wiz), 1e-12f);
    const float pdf_sa = pdf_area * conv;
    const bool reject = (tox * lnx + toy * lny + toz * lnz) > 0.0f
                        || (tox * fnx + toy * fny + toz * fnz) < 0.0f;
    const float pick_p = l[17];
    const bool valid = !reject && pdf_sa > 1e-12f && pick_p > 0.0f;
    const float pdf_nee = pdf_sa * fmaxf(pick_p, 1e-12f);

    // NEE eval: Lambertian matte, |cos| at the shading normal
    const bool is_matte = mtype == MAT_MATTE;
    const float abs_cos_nee = fabsf(fnx * wix + fny * wiy + fnz * wiz);
    const float f_fac = is_matte ? on_a * INV_PI_F : 0.0f;
    const float f_r = (cr * f_fac) * abs_cos_nee;
    const float f_g = (cg * f_fac) * abs_cos_nee;
    const float f_b = (cb * f_fac) * abs_cos_nee;
    const bool want_shadow = valid
                             && (f_r > 0.0f || f_g > 0.0f || f_b > 0.0f);

    // offset origin along the hit normal (_offset_ray)
    const float mag = fmaxf(fmaxf(fabsf(px), fabsf(py)), fabsf(pz));
    const float eps = (mag + 1.0f) * 1e-4f;
    if (want_shadow) {
      shadows += 1;
      const float side = (wix * fnx + wiy * fny + wiz * fnz) >= 0.0f
                         ? 1.0f : -1.0f;
      const float shox = px + fnx * eps * side;
      const float shoy = py + fny * eps * side;
      const float shoz = pz + fnz * eps * side;
      const float dist_adj = dist - ((shox - px) * wix + (shoy - py) * wiy
                                     + (shoz - pz) * wiz);
      // shadow any-hit (_brute_any): min t over every prim
      float t_sh = TMAXF;
      for (int k = 0; k < n_rects; ++k)
        t_sh = fminf(t_sh, rect_t(pt + k * PT_COLS, shox, shoy, shoz,
                                  wix, wiy, wiz));
      for (int k = n_rects; k < n_tot; ++k)
        t_sh = fminf(t_sh, tri_t(pt + k * PT_COLS, shox, shoy, shoz,
                                 wix, wiy, wiz));
      const bool lit = t_sh >= dist_adj - fmaxf(K_EPS, 1e-3f * dist_adj);
      if (lit) {
        const float inv_pdf = 1.0f / fmaxf(pdf_nee, 1e-12f);
        const float ctr = bx * (f_r * l[12] * inv_pdf);
        const float ctg = by * (f_g * l[13] * inv_pdf);
        const float ctb = bz * (f_b * l[14] * inv_pdf);
        lr = lr + ctr;
        lg = lg + ctg;
        lb = lb + ctb;
        good += (ctr != 0.0f || ctg != 0.0f || ctb != 0.0f) ? 1 : 0;
      }
    }

    // ---- BSDF sample: MATTE cosine hemisphere (dims 5,6)
    const float phi = TWO_PI_F * u_b0;
    const float rad = sqrtf(u_b1);
    float wlx = rad * cosf(phi);
    float wly = rad * sinf(phi);
    float wlz = sqrtf(fmaxf(1.0f - wlx * wlx - wly * wly, 1e-12f));
    const float pdf_s = is_matte ? wlz * INV_PI_F : 0.0f;
    const float fs_fac = on_a * INV_PI_F;
    const float fs_r = is_matte ? cr * fs_fac : 0.0f;
    const float fs_g = is_matte ? cg * fs_fac : 0.0f;
    const float fs_b = is_matte ? cb * fs_fac : 0.0f;
    if (!is_matte) { wlx = 0.0f; wly = 0.0f; wlz = 1.0f; }
    const bool dead = pdf_s <= 0.0f
                      || (fs_r == 0.0f && fs_g == 0.0f && fs_b == 0.0f);
    const float wwx = wlx * ftx + wly * fbx + wlz * fnx;
    const float wwy = wlx * fty + wly * fby + wlz * fny;
    const float wwz = wlx * ftz + wly * fbz + wlz * fnz;
    const float w_cos = fabsf(wwx * fnx + wwy * fny + wwz * fnz);
    const float w_scale = w_cos / fmaxf(pdf_s, 1e-12f);
    bx = bx * (fs_r * w_scale);
    by = by * (fs_g * w_scale);
    bz = bz * (fs_b * w_scale);

    // ---- Russian roulette (trace.h:512-525)
    const float max_c = fmaxf(fmaxf(bx, by), bz);
    const float q = fmaxf(0.05f, 1.0f - max_c);
    const bool rr_active = b > rr_start;
    const bool rr_kill = rr_active && u_rr < q;
    if (rr_active && !rr_kill) {
      const float inv_q = 1.0f / fmaxf(1.0f - q, 1e-6f);
      bx = bx * inv_q;
      by = by * inv_q;
      bz = bz * inv_q;
    }
    if (dead || rr_kill) break;
    const float side2 = (wwx * fnx + wwy * fny + wwz * fnz) >= 0.0f
                        ? 1.0f : -1.0f;
    ox = px + fnx * eps * side2;
    oy = py + fny * eps * side2;
    oz = pz + fnz * eps * side2;
    dx = wwx;
    dy = wwy;
    dz = wwz;
  }

  L_out[3 * lane + 0] = lr;
  L_out[3 * lane + 1] = lg;
  L_out[3 * lane + 2] = lb;
  g_out[lane] = good;
  g_out[n + lane] = rays;
  g_out[2 * n + lane] = shadows;
  g_out[3 * n + lane] = (int)hist;
}

}  // namespace

extern "C" int k1_pass_launch(const float* tables, int n_floats,
                              const int* pix, const int* spp, int n,
                              int n_mats, int n_lights, int n_rects,
                              int n_tris, unsigned int seed, int max_depth,
                              int rr_start, int strat, int width,
                              float* L_out, int* g_out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const size_t smem = (size_t)n_floats * sizeof(float);
  k1_pass_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      tables, n_floats, pix, spp, n, n_mats, n_lights, n_rects, n_tris, seed,
      max_depth, rr_start, strat, width, L_out, g_out);
  return (int)cudaGetLastError();
}

extern "C" const char* k1_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
