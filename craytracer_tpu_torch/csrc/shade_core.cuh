// The shading core shared by K1 (pass_kernel.cu) and K2 (shade_kernel.cu):
// one path's shading of one bounce given its hit record, for the materials
// and lights the port's gate admits (Lambertian MATTE, EMISSIVE, rect area
// lights, a constant or black env light).
//
// Counterpart of craytracer_tpu/integrator/pallas_shade.py `_shade_core`
// :874 (the part of it those materials reach): emitted/env add, shading
// frame, counter RNG, power-CDF light pick and rect-light sample, the NEE
// candidate and its shadow ray, the cosine-hemisphere BSDF sample,
// throughput and Russian roulette, the next ray. Visibility is the caller's:
// K1 tests the shadow ray in the same thread, K2 hands it to K4.
//
// Every formula keeps the JAX kernel's expression tree and epsilons; the
// kernels are built with --fmad=false, -prec-div=true, -prec-sqrt=true, so
// each multiply and add rounds on its own, as in the op-by-op plain PyTorch
// versions.
#pragma once

#include <stdint.h>

namespace cray {

constexpr float TMAXF = 3.4028235e38f;
constexpr float K_EPS = 7.0e-6f;
constexpr float INV_PI_F = 0.318309886183790671538f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr int MAT_MATTE = 1;
constexpr int MAT_EMISSIVE = 4;
constexpr int MT_COLS = 19;  // material row (pallas_shade.py _meta_operands)
constexpr int LT_COLS = 19;  // light row

// murmur3 fmix32 (sampling/rng.py hash_u32)
__device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// the per-lane word: pixel and spp hashed in separate rounds (rng.py
// _combine); a bounce's word is fmix(lane ^ (seed + GOLDEN * bounce))
__device__ __forceinline__ uint32_t lane_hash(uint32_t pix, uint32_t spp) {
  return fmix(fmix(pix) ^ fmix(spp));
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

struct ShadeOut {
  float l_add[3];    // emitted / env radiance add (pre-NEE)
  float sho[3];      // shadow ray origin (3e18 escape when no shadow ray)
  float wi[3];       // shadow ray direction
  float dist_adj;    // offset-adjusted light distance (the lit compare)
  float dadj_t;      // shadow max_dist (0 when no shadow ray)
  float contrib[3];  // NEE contribution candidate (pre-visibility)
  float new_o[3];    // next ray origin (3e18 escape when the path ends)
  float new_d[3];    // next ray direction ((1,0,0) when the path ends)
  float new_beta[3];
  int good_inc;
  bool want_shadow;
  bool new_alive;
  bool new_prev_sg;
};

// One lane's shading. d: ray direction; p, n, du: hit point, hit normal
// (faced as the fill faced it) and dpdu; hitm: the ray hit something.
// env: 3 floats of constant env radiance; mt / lt: n_mats / n_lights rows.
__device__ __forceinline__ void shade_core(
    uint32_t seed, int bounce, int max_depth, int rr_start,
    const float* env, const float* mt, int n_mats, const float* lt,
    int n_lights, uint32_t h_lane, float dx, float dy, float dz, float px,
    float py, float pz, float nx, float ny, float nz, float ux, float uy,
    float uz, float bx, float by, float bz, int mat_id, bool hitm,
    bool alive, bool prev_sg, ShadeOut& o) {
  // ---- material row
  const float* m = mt + min(max(mat_id, 0), n_mats - 1) * MT_COLS;
  const int mtype = (int)m[0];
  const float cr = m[1], cg = m[2], cb = m[3], on_a = m[4], inten = m[5];

  // ---- emitted / env add (trace.h:419-455)
  const bool emissive_hit = hitm && mtype == MAT_EMISSIVE;
  const bool add_cond = alive && (bounce == 0 || prev_sg);
  const bool add_emit = add_cond && emissive_hit;
  const bool add_env = add_cond && !hitm;
  o.l_add[0] = (add_emit ? bx * (cr * inten) : 0.0f) + (add_env ? bx * env[0] : 0.0f);
  o.l_add[1] = (add_emit ? by * (cg * inten) : 0.0f) + (add_env ? by * env[1] : 0.0f);
  o.l_add[2] = (add_emit ? bz * (cb * inten) : 0.0f) + (add_env ? bz * env[2] : 0.0f);
  o.good_inc = (add_emit || add_env) ? 1 : 0;
  const bool cont = alive && hitm && !emissive_hit && bounce < max_depth;

  // ---- shading frame (make_shading_frame on sanitized inputs; Duff basis
  // fallback for a degenerate tangent)
  const float fnx = hitm ? nx : 0.0f, fny = hitm ? ny : 0.0f;
  const float fnz = hitm ? nz : 1.0f;
  const float sux = hitm ? ux : 1.0f, suy = hitm ? uy : 0.0f;
  const float suz = hitm ? uz : 0.0f;
  const float ndu = fnx * sux + fny * suy + fnz * suz;
  float ftx = sux - ndu * fnx, fty = suy - ndu * fny, ftz = suz - ndu * fnz;
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
  const uint32_t h = fmix(h_lane ^ (seed + GOLDEN * (uint32_t)bounce));
  const float u_l0 = uni(h, 0), u_l1 = uni(h, 1), u_pick = uni(h, 4);
  const float u_b0 = uni(h, 5), u_b1 = uni(h, 6), u_rr = uni(h, 8);

  // ---- NEE: power-CDF pick (searchsorted side='right' + clip), rect
  // sample, area -> solid angle, facing rejections (trace.h:221-397)
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
  o.want_shadow = cont && valid && (f_r > 0.0f || f_g > 0.0f || f_b > 0.0f);

  // shadow origin offset along the raw hit normal (_offset_ray)
  const float mag = fmaxf(fmaxf(fabsf(px), fabsf(py)), fabsf(pz));
  const float eps = (mag + 1.0f) * 1e-4f;
  const float side = (wix * nx + wiy * ny + wiz * nz) >= 0.0f ? 1.0f : -1.0f;
  const float shox = px + nx * eps * side;
  const float shoy = py + ny * eps * side;
  const float shoz = pz + nz * eps * side;
  o.dist_adj = dist - ((shox - px) * wix + (shoy - py) * wiy
                       + (shoz - pz) * wiz);
  o.sho[0] = o.want_shadow ? shox : 3.0e18f;
  o.sho[1] = o.want_shadow ? shoy : 3.0e18f;
  o.sho[2] = o.want_shadow ? shoz : 3.0e18f;
  o.wi[0] = wix;
  o.wi[1] = wiy;
  o.wi[2] = wiz;
  o.dadj_t = o.want_shadow ? o.dist_adj : 0.0f;
  const float inv_pdf = 1.0f / fmaxf(pdf_nee, 1e-12f);
  o.contrib[0] = o.want_shadow ? bx * (f_r * l[12] * inv_pdf) : 0.0f;
  o.contrib[1] = o.want_shadow ? by * (f_g * l[13] * inv_pdf) : 0.0f;
  o.contrib[2] = o.want_shadow ? bz * (f_b * l[14] * inv_pdf) : 0.0f;

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
  float nbx = cont ? bx * (fs_r * w_scale) : bx;
  float nby = cont ? by * (fs_g * w_scale) : by;
  float nbz = cont ? bz * (fs_b * w_scale) : bz;

  // ---- Russian roulette (trace.h:512-525)
  const float max_c = fmaxf(fmaxf(nbx, nby), nbz);
  const float q = fmaxf(0.05f, 1.0f - max_c);
  const bool rr_active = cont && bounce > rr_start;
  const bool rr_kill = rr_active && u_rr < q;
  if (rr_active && !rr_kill) {
    const float inv_q = 1.0f / fmaxf(1.0f - q, 1e-6f);
    nbx = nbx * inv_q;
    nby = nby * inv_q;
    nbz = nbz * inv_q;
  }
  o.new_beta[0] = nbx;
  o.new_beta[1] = nby;
  o.new_beta[2] = nbz;
  o.new_alive = cont && !dead && !rr_kill;
  const float side2 = (wwx * nx + wwy * ny + wwz * nz) >= 0.0f ? 1.0f : -1.0f;
  o.new_o[0] = o.new_alive ? px + nx * eps * side2 : 3.0e18f;
  o.new_o[1] = o.new_alive ? py + ny * eps * side2 : 3.0e18f;
  o.new_o[2] = o.new_alive ? pz + nz * eps * side2 : 3.0e18f;
  o.new_d[0] = o.new_alive ? wwx : 1.0f;
  o.new_d[1] = o.new_alive ? wwy : 0.0f;
  o.new_d[2] = o.new_alive ? wwz : 0.0f;
  // matte lobes are neither specular nor glossy
  o.new_prev_sg = cont ? false : prev_sg;
}

}  // namespace cray
