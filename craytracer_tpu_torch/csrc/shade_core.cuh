// The shading core shared by K1 (pass_kernel.cu) and K2 (shade_kernel.cu):
// one path's shading of one bounce given its hit record, for everything
// the port's gate admits: all seven material types (Lambertian and
// Oren-Nayar MATTE, MIRROR, PLASTIC's two-lobe FresnelBlend, METAL's
// conductor microfacet, thin TRANSPARENT, rough GLASS, EMISSIVE) with
// isotropic Beckmann lobes, rect and sphere area lights, a constant or
// black env light.
//
// Counterpart of craytracer_tpu/integrator/pallas_shade.py `_shade_core`
// :874 with the local-frame helpers :113-237: emitted/env add, shading
// frame, counter RNG, power-CDF light pick, rect- or sphere-light sample,
// the NEE candidate (diffuse lobes only, on the world vectors, as the
// reference's BSDF_f does) and its shadow ray, the BSDF sample,
// throughput and Russian roulette, the next ray and whether it left a
// specular or glossy lobe. Visibility is the caller's: K1 tests the shadow
// ray in the same thread, K2 hands it to K4.
//
// `shade_lane<MASK>` is specialized on the scene's feature mask
// (integrator/gate.py `shade_features`, the seven has_* flags of
// pallas_shade.py:1793-1802, the F_* bits below), as the JAX kernel is
// traced once per flag set: a branch whose bit is clear is not compiled.
// Mask 0 is the matte-only core (Lambertian matte and emissive materials,
// rect lights: Cornell, the meshes), F_ALL every lobe and the sphere
// light. K2 builds one variant per mask it meets; K1 instantiates the two
// ends (0 and F_ALL).
//
// Every formula keeps the JAX kernel's expression tree and epsilons; the
// kernels are built with --fmad=false, -prec-div=true, -prec-sqrt=true, so
// each multiply and add rounds on its own, as in the op-by-op plain
// PyTorch versions (integrator/shade_kernel.py, bsdf/). Constants the JAX
// code folds in double (28 / (23 pi), 1 - 1e-7) are folded in double here
// too, and integer powers are the products XLA lowers them to (x^5 =
// x * (x^2 * x^2)).
#pragma once

#include <stdint.h>

namespace cray {

constexpr float TMAXF = 3.4028235e38f;
constexpr float K_EPS = 7.0e-6f;
constexpr double PI_D = 3.141592653589793;  // constants.PI
constexpr float PI_F = (float)PI_D;
constexpr float INV_PI_F = 0.318309886183790671538f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr int MAT_MATTE = 1;
constexpr int MAT_MIRROR = 2;
constexpr int MAT_TRANSPARENT = 3;
constexpr int MAT_EMISSIVE = 4;
constexpr int MAT_PLASTIC = 5;
constexpr int MAT_GLASS = 6;
constexpr int MAT_METAL = 7;
constexpr int LIGHT_AREA_SPHERE = 1;
constexpr int MT_COLS = 19;  // material row (pallas_shade.py _meta_operands)
constexpr int LT_COLS = 19;  // light row
// the feature mask's bits (integrator/gate.py F_*)
constexpr uint32_t F_MIRROR = 1u, F_SPHERE_LIGHT = 2u, F_OREN = 4u,
                   F_PLASTIC = 8u, F_METAL = 16u, F_GLASS = 32u,
                   F_TRANSPARENT = 64u, F_ALL = 127u;
// the bits whose lobe samples a direction other than MATTE's
constexpr uint32_t F_LOBES = F_MIRROR | F_PLASTIC | F_METAL | F_GLASS
                             | F_TRANSPARENT;

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

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// vm.normalize: zero for (near-)zero vectors
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float n2 = x * x + y * y + z * z;
  const float inv = n2 > 1e-20f ? 1.0f / sqrtf(fmaxf(n2, 1e-20f)) : 0.0f;
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// |a + b|^2, each sum squared as XLA lowers `(a + b) ** 2`
__device__ __forceinline__ float len2_sum(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  const float sx = ax + bx, sy = ay + by, sz = az + bz;
  return sx * sx + sy * sy + sz * sz;
}

// cosine hemisphere (sampling/mappings.py map_to_hemisphere_cosine)
__device__ __forceinline__ void cos_hemisphere(float u0, float u1, float& x,
                                               float& y, float& z) {
  const float phi = TWO_PI_F * u0;
  const float r = sqrtf(u1);
  x = r * cosf(phi);
  y = r * sinf(phi);
  z = sqrtf(fmaxf(1.0f - x * x - y * y, 1e-12f));
}

// ---- local-frame BSDF helpers (bsdf/microfacet.py, bsdf/fresnel.py;
// pallas_shade.py :113-237)

__device__ __forceinline__ float lf_sin_theta(float z) {
  return sqrtf(fmaxf(fmaxf(0.0f, 1.0f - z * z), 1e-16f));
}

__device__ __forceinline__ float lf_cos_phi(float x, float z) {
  const float s = lf_sin_theta(z);
  return s < 1e-6f ? 1.0f : clip(x / safe_div(s), -1.0f, 1.0f);
}

__device__ __forceinline__ float lf_sin_phi(float y, float z) {
  const float s = lf_sin_theta(z);
  return s < 1e-6f ? 0.0f : clip(y / safe_div(s), -1.0f, 1.0f);
}

// Oren-Nayar's (a + b max_cos sin_a tan_b) / pi
__device__ __forceinline__ float on_scale(float wix, float wiy, float wiz,
                                          float wox, float woy, float woz,
                                          float a, float b) {
  const float sin_ti = lf_sin_theta(wiz);
  const float sin_to = lf_sin_theta(woz);
  const float d_cos = lf_cos_phi(wix, wiz) * lf_cos_phi(wox, woz)
                      + lf_sin_phi(wiy, wiz) * lf_sin_phi(woy, woz);
  const float max_cos = (sin_ti > 1e-4f && sin_to > 1e-4f)
                        ? fmaxf(0.0f, d_cos) : 0.0f;
  const float aci = fabsf(wiz), aco = fabsf(woz);
  const bool wi_bigger = aci > aco;
  const float sin_alpha = wi_bigger ? sin_to : sin_ti;
  const float tan_beta = wi_bigger ? sin_ti / fmaxf(aci, 1e-7f)
                                   : sin_to / fmaxf(aco, 1e-7f);
  return (a + b * max_cos * sin_alpha * tan_beta) * INV_PI_F;
}

// FresnelBlend's diffuse scale; multiply by kd (1 - ks)
__device__ __forceinline__ float fb_diffuse_scale(float wiz, float woz) {
  constexpr float FB = (float)(28.0 / (23.0 * PI_D));
  const float vi = 1.0f - 0.5f * fabsf(wiz);
  const float vo = 1.0f - 0.5f * fabsf(woz);
  return FB * (1.0f - (vi * vi) * (vi * vi) * vi)
         * (1.0f - (vo * vo) * (vo * vo) * vo);
}

// D(wh), isotropic Beckmann
__device__ __forceinline__ float d_beckmann(float whx, float why, float whz,
                                            float ax) {
  const float a = fmaxf(ax, 1e-4f);
  const float c2 = whz * whz;
  const float c4 = c2 * c2;
  if (!(c4 > 1e-16f)) return 0.0f;
  const float t2 = fmaxf(0.0f, 1.0f - c2) / fmaxf(c2, 1e-6f);
  const float cp = lf_cos_phi(whx, whz), sp = lf_sin_phi(why, whz);
  const float c2p = cp * cp, s2p = sp * sp;
  return expf(-t2 * (c2p / (a * a) + s2p / (a * a))) / (PI_F * a * a * c4);
}

// Lambda(w), Beckmann's rational approximation with the a >= 1.6 cutoff
__device__ __forceinline__ float lambda_beckmann(float wx, float wy, float wz,
                                                 float ax) {
  const float a_cl = fmaxf(ax, 1e-4f);
  const float c = fabsf(wz) < 1e-3f ? (wz < 0.0f ? -1e-3f : 1e-3f) : wz;
  const float abs_tan = fabsf(lf_sin_theta(wz) / c);
  const float cp = lf_cos_phi(wx, wz), sp = lf_sin_phi(wy, wz);
  const float c2p = cp * cp, s2p = sp * sp;
  const float alpha = sqrtf(fmaxf(c2p * a_cl * a_cl + s2p * a_cl * a_cl,
                                  1e-12f));
  const float ar = 1.0f / fmaxf(alpha * abs_tan, 1e-16f);
  if (ar >= 1.6f) return 0.0f;
  const float a_c = fminf(ar, 1.6f);
  return (1.0f - 1.259f * a_c + 0.396f * a_c * a_c)
         / (3.535f * a_c + 2.181f * a_c * a_c);
}

// a Beckmann half-vector, flipped to wo's side
__device__ __forceinline__ void sample_wh_beckmann(float woz, float u0,
                                                   float u1, float ax,
                                                   float& whx, float& why,
                                                   float& whz) {
  const float a = fmaxf(ax, 1e-4f);
  const float log_u = logf(fmaxf(u0, 1e-30f));
  const float t2 = -a * a * log_u;
  const float phi = u1 * TWO_PI_F;
  const float cos_t = 1.0f / sqrtf(1.0f + t2);
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 1e-12f));
  const float sgn = woz * cos_t > 0.0f ? 1.0f : -1.0f;
  whx = sin_t * cosf(phi) * sgn;
  why = sin_t * sinf(phi) * sgn;
  whz = cos_t * sgn;
}

// unpolarized dielectric Fresnel; the IORs swap from inside; TIR -> 1
__device__ __forceinline__ float fr_dielectric(float cos_theta_i, float eta_t,
                                               float eta_i) {
  const bool flip = cos_theta_i < 0.0f;
  const float ei = flip ? eta_t : eta_i;
  const float et = flip ? eta_i : eta_t;
  const float ci = fabsf(cos_theta_i);
  const float sin_i = sqrtf(fmaxf(1.0f - ci * ci, 1e-12f));
  const float sin_t = ei / et * sin_i;
  if (sin_t >= 1.0f) return 1.0f;
  const float ct = sqrtf(fmaxf(1.0f - sin_t * sin_t, 1e-12f));
  const float r_parl = (et * ci - ei * ct) / fmaxf(et * ci + ei * ct, 1e-12f);
  const float r_perp = (ei * ci - et * ct) / fmaxf(ei * ci + et * ct, 1e-12f);
  return 0.5f * (r_parl * r_parl + r_perp * r_perp);
}

// conductor Fresnel of one channel, eta_i = 1
__device__ __forceinline__ float fr_conductor(float c, float eta, float k) {
  const float cc = clip(c, -1.0f, 1.0f);
  const float c2 = cc * cc;
  const float s2 = 1.0f - c2;
  const float eta2 = eta * eta;
  const float etak2 = k * k;
  const float t0 = eta2 - etak2 - s2;
  const float a2b2 = sqrtf(fmaxf(t0 * t0 + 4.0f * eta2 * etak2, 1e-12f));
  const float t1 = a2b2 + c2;
  const float a = sqrtf(fmaxf(0.5f * (a2b2 + t0), 1e-12f));
  const float t2 = 2.0f * cc * a;
  const float rs = (t1 - t2) / fmaxf(t1 + t2, 1e-12f);
  const float t3 = c2 * a2b2 + s2 * s2;
  const float t4 = t2 * s2;
  const float rp = rs * (t3 - t4) / fmaxf(t3 + t4, 1e-12f);
  return 0.5f * (rp + rs);
}

// ---- the material samples (pallas_shade.py:1201-1442); each writes the
// local direction wl, f per channel and the pdf

struct Sample {
  float wl[3];
  float f[3];
  float pdf;
};

// PLASTIC: uniform lobe pick with the sample remapped; the chosen lobe's
// pdf must be > 0, then f and pdf sum over both lobes (the reference
// quirk, reflection.cpp:760-811)
__device__ __forceinline__ void plastic_sample(const float* m, float cr,
                                               float cg, float cb, float wox,
                                               float woy, float woz, float ub0,
                                               float ub1, Sample& s,
                                               bool& pick_spec) {
  const float ax = m[7];
  pick_spec = ub0 >= 0.5f;
  const float u0r = clip(pick_spec ? 2.0f * (ub0 - 0.5f) : 2.0f * ub0, 0.0f,
                         (float)(1.0 - 1e-7));
  float pdx, pdy, pdz;
  cos_hemisphere(u0r, ub1, pdx, pdy, pdz);
  if (woz < 0.0f) pdz = -pdz;
  float whx, why, whz;
  sample_wh_beckmann(woz, u0r, ub1, ax, whx, why, whz);
  const float dwh = dot3(wox, woy, woz, whx, why, whz);
  const float psx = 2.0f * dwh * whx - wox;
  const float psy = 2.0f * dwh * why - woy;
  const float psz = 2.0f * dwh * whz - woz;
  const bool ps_ok = psz * woz > 0.0f;
  const float wpx = pick_spec ? psx : pdx;
  const float wpy = pick_spec ? psy : pdy;
  const float wpz = pick_spec ? psz : pdz;
  const bool same_p = wpz * woz > 0.0f;
  const float cos_pdf = same_p ? fabsf(wpz) * INV_PI_F : 0.0f;
  float sx = wpx + wox, sy = wpy + woy, sz = wpz + woz;
  normalize3(sx, sy, sz);
  const float d_s = d_beckmann(sx, sy, sz, ax);
  const float spec_pdf = same_p
      ? d_s / fmaxf(2.0f * dot3(wox, woy, woz, sx, sy, sz), 1e-7f) : 0.0f;
  const float pdf_chosen = pick_spec ? (ps_ok ? spec_pdf : 0.0f) : cos_pdf;
  const float pdf_other = pick_spec ? cos_pdf : spec_pdf;
  const bool alive_p = pdf_chosen > 0.0f;
  const float fbd_s = fb_diffuse_scale(wpz, woz);
  const float cos_wh = dot3(wpx, wpy, wpz, sx, sy, sz);
  const bool degen = len2_sum(wpx, wpy, wpz, wox, woy, woz) < 1e-16f;
  const float om = 1.0f - cos_wh;
  const float om2 = om * om;
  const float p5w = om * (om2 * om2);
  const float denom_s = 4.0f * fabsf(cos_wh)
                        * fmaxf(fmaxf(fabsf(wpz), fabsf(woz)), 1e-7f);
  const float d_spec = degen ? 0.0f : d_s / fmaxf(denom_s, 1e-12f);
  const float kd[3] = {cr, cg, cb};
  for (int k = 0; k < 3; ++k) {
    const float ks = m[8 + k];
    s.f[k] = alive_p ? kd[k] * (1.0f - ks) * fbd_s
                           + (ks + p5w * (1.0f - ks)) * d_spec
                     : 0.0f;
  }
  s.pdf = alive_p ? pdf_chosen + pdf_other : 0.0f;
  s.wl[0] = wpx;
  s.wl[1] = wpy;
  s.wl[2] = wpz;
}

// METAL: Beckmann wh from the unremapped sample, conductor Fresnel,
// f = D G Fr / (4 |ci| |co|), pdf = D |wh.z| / (4 wo.wh)
__device__ __forceinline__ void metal_sample(const float* m, float wox,
                                             float woy, float woz, float ub0,
                                             float ub1, Sample& s) {
  const float ax = m[7];
  float mhx, mhy, mhz;
  sample_wh_beckmann(woz, ub0, ub1, ax, mhx, mhy, mhz);
  const float mdwh = dot3(wox, woy, woz, mhx, mhy, mhz);
  const float mwx = 2.0f * mdwh * mhx - wox;
  const float mwy = 2.0f * mdwh * mhy - woy;
  const float mwz = 2.0f * mdwh * mhz - woz;
  const bool m_ok = mwz * woz > 0.0f;
  const float aci = fabsf(mwz), aco = fabsf(woz);
  float shx = mwx + wox, shy = mwy + woy, shz = mwz + woz;
  normalize3(shx, shy, shz);
  const bool m_degen = len2_sum(mwx, mwy, mwz, wox, woy, woz) < 1e-16f
                       || aci < 1e-7f || aco < 1e-7f;
  const float cwh = dot3(mwx, mwy, mwz, shx, shy, shz);
  const float d_m = d_beckmann(shx, shy, shz, ax);
  const float g_m = 1.0f / (1.0f + lambda_beckmann(wox, woy, woz, ax)
                            + lambda_beckmann(mwx, mwy, mwz, ax));
  const float scale_m = m_degen ? 0.0f
                                : d_m * g_m / fmaxf(4.0f * aci * aco, 1e-12f);
  for (int k = 0; k < 3; ++k)
    s.f[k] = m_ok ? fr_conductor(cwh, m[11 + k], m[14 + k]) * scale_m : 0.0f;
  s.pdf = m_ok ? d_beckmann(mhx, mhy, mhz, ax) * fabsf(mhz)
                     / fmaxf(4.0f * mdwh, 1e-7f)
               : 0.0f;
  s.wl[0] = mwx;
  s.wl[1] = mwy;
  s.wl[2] = mwz;
}

// thin TRANSPARENT: the Fresnel branch sample picks mirror reflection or
// straight-through transmission
__device__ __forceinline__ void transparent_sample(const float* m, float wox,
                                                   float woy, float woz,
                                                   float r_extra, Sample& s) {
  const float ior_i = m[17], ior_o = m[18];
  const float kr = fr_dielectric(fabsf(woz), ior_i, ior_o);
  const bool take_refl = r_extra <= kr;
  const float twz = take_refl ? woz : -woz;
  const float eta_thin = ior_o / ior_i;
  const float mag = (take_refl ? kr : (1.0f - kr) * eta_thin * eta_thin)
                    / fmaxf(fabsf(twz), 1e-7f);
  s.f[0] = s.f[1] = s.f[2] = mag;
  s.pdf = take_refl ? kr : 1.0f - kr;
  s.wl[0] = -wox;
  s.wl[1] = -woy;
  s.wl[2] = twz;
}

// rough GLASS: Beckmann wh, the Fresnel branch sample picks microfacet
// reflection (the reference's 1 - Fr(wh, wi) weight) or transmission
// through the faced wh, whose pdf uses the unflipped half-vector
__device__ __forceinline__ void glass_sample(const float* m, float wox,
                                             float woy, float woz, float ub0,
                                             float ub1, float r_extra,
                                             Sample& s) {
  const float ax = m[7], ior_i = m[17], ior_o = m[18];
  float ghx, ghy, ghz;
  sample_wh_beckmann(woz, ub0, ub1, ax, ghx, ghy, ghz);
  const float gdwh = dot3(wox, woy, woz, ghx, ghy, ghz);
  const float kr_g = fr_dielectric(gdwh, ior_i, ior_o);
  const float lam_o = lambda_beckmann(wox, woy, woz, ax);
  if (r_extra <= kr_g) {  // ---- reflection
    const float grx = 2.0f * gdwh * ghx - wox;
    const float gry = 2.0f * gdwh * ghy - woy;
    const float grz = 2.0f * gdwh * ghz - woz;
    const bool gr_ok = grz * woz > 0.0f;
    float rhx = grx + wox, rhy = gry + woy, rhz = grz + woz;
    normalize3(rhx, rhy, rhz);
    const bool r_degen = len2_sum(grx, gry, grz, wox, woy, woz) < 1e-16f
                         || fabsf(grz) < 1e-7f || fabsf(woz) < 1e-7f;
    const float kr_quirk = 1.0f - fr_dielectric(
        dot3(rhx, rhy, rhz, grx, gry, grz), ior_i, ior_o);
    const float scale_gr = d_beckmann(rhx, rhy, rhz, ax)
        * (1.0f / (1.0f + lam_o + lambda_beckmann(grx, gry, grz, ax)))
        / fmaxf(4.0f * fabsf(grz) * fabsf(woz), 1e-12f);
    const float f_gr = r_degen ? 0.0f : kr_quirk * scale_gr;
    const float pdf_gr = d_beckmann(ghx, ghy, ghz, ax) * fabsf(ghz)
                         / fmaxf(4.0f * gdwh, 1e-7f);
    s.f[0] = s.f[1] = s.f[2] = gr_ok ? f_gr : 0.0f;
    s.pdf = gr_ok ? pdf_gr : 0.0f;
    s.wl[0] = grx;
    s.wl[1] = gry;
    s.wl[2] = grz;
    return;
  }
  // ---- transmission (refract through the faced wh)
  const float eta_g = woz > 0.0f ? ior_o / ior_i : ior_i / ior_o;
  const float fsg = gdwh < 0.0f ? -1.0f : 1.0f;
  const float fhx = ghx * fsg, fhy = ghy * fsg, fhz = ghz * fsg;
  const float cti_r = dot3(fhx, fhy, fhz, wox, woy, woz);
  const float s2i = fmaxf(0.0f, 1.0f - cti_r * cti_r);
  const float s2t = eta_g * eta_g * s2i;
  const bool gt_ok = s2t < 1.0f;
  const float ctt = sqrtf(fmaxf(1.0f - s2t, 1e-12f));
  const float gtx = -eta_g * wox + (eta_g * cti_r - ctt) * fhx;
  const float gty = -eta_g * woy + (eta_g * cti_r - ctt) * fhy;
  const float gtz = -eta_g * woz + (eta_g * cti_r - ctt) * fhz;
  const bool not_trans = gtz * woz > 0.0f;
  const float eta_t2 = woz > 0.0f ? ior_i / ior_o : ior_o / ior_i;
  float thx = wox + gtx * eta_t2, thy = woy + gty * eta_t2;
  float thz = woz + gtz * eta_t2;
  normalize3(thx, thy, thz);
  const float tsg = thz < 0.0f ? -1.0f : 1.0f;
  const float thx2 = thx * tsg, thy2 = thy * tsg, thz2 = thz * tsg;
  const float dot_ot = dot3(thx2, thy2, thz2, wox, woy, woz);
  const float fr_t = fr_dielectric(dot_ot, ior_i, ior_o);
  const float dot_it = dot3(thx2, thy2, thz2, gtx, gty, gtz);
  const float sqrt_den = dot_ot + eta_t2 * dot_it;
  const float den_t = gtz * woz * sqrt_den * sqrt_den;
  const float num_t = d_beckmann(thx2, thy2, thz2, ax)
      * (1.0f / (1.0f + lam_o + lambda_beckmann(gtx, gty, gtz, ax)))
      * fabsf(dot_it) * fabsf(dot_ot);
  const bool bad_t = not_trans || fabsf(gtz) < 1e-7f || fabsf(woz) < 1e-7f;
  const float f_gt = bad_t ? 0.0f
                           : (1.0f - fr_t) * fabsf(num_t / safe_div(den_t));
  const float dot_ot3 = dot3(thx, thy, thz, wox, woy, woz);
  const float dot_it3 = dot3(thx, thy, thz, gtx, gty, gtz);
  const float sd3 = dot_ot3 + eta_t2 * dot_it3;
  const float dwh_dwi = fabsf(eta_t2 * eta_t2 * dot_it3)
                        / fmaxf(sd3 * sd3, 1e-12f);
  const float pdf_gt = not_trans ? 0.0f
                       : d_beckmann(thx, thy, thz, ax) * fabsf(thz) * dwh_dwi;
  s.f[0] = s.f[1] = s.f[2] = gt_ok ? f_gt : 0.0f;
  s.pdf = gt_ok ? pdf_gt : 0.0f;
  s.wl[0] = gtx;
  s.wl[1] = gty;
  s.wl[2] = gtz;
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

// One lane's shading, with the branches of the feature mask MASK. d: ray
// direction; p, n, du: hit point, hit normal (faced as the fill faced it)
// and dpdu; hitm: the ray hit something. env: 3 floats of constant env
// radiance; mt / lt: n_mats / n_lights rows. With SKIP_ENDED a lane whose
// path ends here (dead, missed, on an emitter or at max_depth) skips the
// BSDF sample: every output it would feed is then a constant or an input
// (the next ray escapes, beta passes through), so the outputs are the
// same bits; K2 takes it, K1 never shades an ended path.
template <uint32_t MASK, bool SKIP_ENDED = false>
__device__ __forceinline__ void shade_lane(
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

  // ---- per-bounce uniforms (dims 0,1 light, 4 pick, 5,6 bsdf, 7 the
  // Fresnel branch of glass and transparent, 8 rr)
  const uint32_t h = fmix(h_lane ^ (seed + GOLDEN * (uint32_t)bounce));
  const float u_l0 = uni(h, 0), u_l1 = uni(h, 1), u_pick = uni(h, 4);
  const float u_b0 = uni(h, 5), u_b1 = uni(h, 6), u_rr = uni(h, 8);

  // ---- NEE: power-CDF pick (searchsorted side='right' + clip), rect or
  // sphere sample, area -> solid angle, facing rejections
  // (trace.h:221-397)
  int idx = 0;
  for (int k = 0; k < n_lights; ++k)
    idx += (u_pick >= lt[k * LT_COLS + 16]) ? 1 : 0;
  idx = min(idx, n_lights - 1);
  const float* l = lt + idx * LT_COLS;
  float spx = l[0] + u_l0 * l[3] + u_l1 * l[6];
  float spy = l[1] + u_l0 * l[4] + u_l1 * l[7];
  float spz = l[2] + u_l0 * l[5] + u_l1 * l[8];
  const float len_v1 = sqrtf(fmaxf(l[3] * l[3] + l[4] * l[4] + l[5] * l[5],
                                   1e-20f));
  const float len_v2 = sqrtf(fmaxf(l[6] * l[6] + l[7] * l[7] + l[8] * l[8],
                                   1e-20f));
  float pdf_area = 1.0f / fmaxf(len_v1 * len_v2, 1e-12f);
  float lnx = l[9], lny = l[10], lnz = l[11];
  if constexpr ((MASK & F_SPHERE_LIGHT) != 0) {
    if ((int)l[18] == LIGHT_AREA_SPHERE) {
      // cosine hemisphere about the center -> hit axis (trace.h:230-243)
      const float rad = l[15];
      float zx = px - l[0], zy = py - l[1], zz = pz - l[2];
      normalize3(zx, zy, zz);
      const float zsg = zz >= 0.0f ? 1.0f : -1.0f;
      const float za = -1.0f / (zsg + zz);
      const float zb = zx * zy * za;
      const float ztx = 1.0f + zsg * zx * zx * za;
      const float zty = zsg * zb;
      const float ztz = -zsg * zx;
      const float zby = zsg + zy * zy * za;
      const float zbz = -zy;
      float hx, hy, hz;
      cos_hemisphere(u_l0, u_l1, hx, hy, hz);
      const float hwx = hx * ztx + hy * zb + hz * zx;
      const float hwy = hx * zty + hy * zby + hz * zy;
      const float hwz = hx * ztz + hy * zbz + hz * zz;
      spx = l[0] + hwx * rad;
      spy = l[1] + hwy * rad;
      spz = l[2] + hwz * rad;
      lnx = hwx;
      lny = hwy;
      lnz = hwz;
      pdf_area = 1.0f / (TWO_PI_F * fmaxf(rad * rad, 1e-12f)) * fabsf(hz)
                 * INV_PI_F;
    }
  }
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

  // NEE eval: the diffuse lobes only (MATTE's Oren-Nayar, PLASTIC's
  // FresnelBlend diffuse) on the WORLD vectors (the reference's BSDF_f
  // quirk, reflection.cpp:719-735); other types get f = 0
  const bool is_matte = mtype == MAT_MATTE;
  const float abs_cos_nee = fabsf(fnx * wix + fny * wiy + fnz * wiz);
  float f_fac = 0.0f;
  if (is_matte) {
    if constexpr ((MASK & F_OREN) != 0)
      f_fac = on_scale(wix, wiy, wiz, -dx, -dy, -dz, on_a, m[6]);
    else
      f_fac = on_a * INV_PI_F;
  }
  float f_r = cr * f_fac, f_g = cg * f_fac, f_b = cb * f_fac;
  if constexpr ((MASK & F_PLASTIC) != 0) {
    if (mtype == MAT_PLASTIC) {
      const float fbd = fb_diffuse_scale(wiz, -dz);
      f_r = cr * (1.0f - m[8]) * fbd;
      f_g = cg * (1.0f - m[9]) * fbd;
      f_b = cb * (1.0f - m[10]) * fbd;
    }
  }
  f_r = f_r * abs_cos_nee;
  f_g = f_g * abs_cos_nee;
  f_b = f_b * abs_cos_nee;
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
  if constexpr (SKIP_ENDED) {
    if (!cont) {
      o.new_beta[0] = bx;
      o.new_beta[1] = by;
      o.new_beta[2] = bz;
      o.new_alive = false;
      o.new_o[0] = o.new_o[1] = o.new_o[2] = 3.0e18f;
      o.new_d[0] = 1.0f;
      o.new_d[1] = 0.0f;
      o.new_d[2] = 0.0f;
      o.new_prev_sg = prev_sg;
      return;
    }
  }

  // ---- BSDF sample: MATTE's cosine hemisphere (dims 5,6), then the lobe
  // of the lane's material type
  Sample s;
  cos_hemisphere(u_b0, u_b1, s.wl[0], s.wl[1], s.wl[2]);
  s.pdf = is_matte ? s.wl[2] * INV_PI_F : 0.0f;
  float fs_fac = on_a * INV_PI_F;
  float wox = 0.0f, woy = 0.0f, woz = 0.0f;  // wo in the shading frame
  if constexpr ((MASK & (F_LOBES | F_OREN)) != 0) {
    wox = -(dx * ftx + dy * fty + dz * ftz);
    woy = -(dx * fbx + dy * fby + dz * fbz);
    woz = -(dx * fnx + dy * fny + dz * fnz);
    if constexpr ((MASK & F_OREN) != 0) {
      if (is_matte)
        fs_fac = on_scale(s.wl[0], s.wl[1], s.wl[2], wox, woy, woz, on_a,
                          m[6]);
    }
  }
  s.f[0] = is_matte ? cr * fs_fac : 0.0f;
  s.f[1] = is_matte ? cg * fs_fac : 0.0f;
  s.f[2] = is_matte ? cb * fs_fac : 0.0f;
  if (!is_matte) { s.wl[0] = 0.0f; s.wl[1] = 0.0f; s.wl[2] = 1.0f; }
  bool spec_or_glossy = false;
  if constexpr ((MASK & F_MIRROR) != 0) {
    if (mtype == MAT_MIRROR) {  // SpecularReflection_sample_f
      const float inv_cos = 1.0f / fmaxf(fabsf(woz), 1e-7f);
      s.wl[0] = -wox;
      s.wl[1] = -woy;
      s.wl[2] = woz;
      s.f[0] = cr * inv_cos;
      s.f[1] = cg * inv_cos;
      s.f[2] = cb * inv_cos;
      s.pdf = 1.0f;
      spec_or_glossy = true;
    }
  }
  if constexpr ((MASK & F_PLASTIC) != 0) {
    if (mtype == MAT_PLASTIC) {
      bool pick_spec;
      plastic_sample(m, cr, cg, cb, wox, woy, woz, u_b0, u_b1, s, pick_spec);
      spec_or_glossy = pick_spec;
    }
  }
  if constexpr ((MASK & F_METAL) != 0) {
    if (mtype == MAT_METAL) {
      metal_sample(m, wox, woy, woz, u_b0, u_b1, s);
      spec_or_glossy = true;
    }
  }
  if constexpr ((MASK & F_TRANSPARENT) != 0) {
    if (mtype == MAT_TRANSPARENT) {
      transparent_sample(m, wox, woy, woz, uni(h, 7), s);
      spec_or_glossy = true;
    }
  }
  if constexpr ((MASK & F_GLASS) != 0) {
    if (mtype == MAT_GLASS) {
      glass_sample(m, wox, woy, woz, u_b0, u_b1, uni(h, 7), s);
      spec_or_glossy = true;
    }
  }
  const bool dead = s.pdf <= 0.0f
                    || (s.f[0] == 0.0f && s.f[1] == 0.0f && s.f[2] == 0.0f);
  const float wwx = s.wl[0] * ftx + s.wl[1] * fbx + s.wl[2] * fnx;
  const float wwy = s.wl[0] * fty + s.wl[1] * fby + s.wl[2] * fny;
  const float wwz = s.wl[0] * ftz + s.wl[1] * fbz + s.wl[2] * fnz;
  const float w_cos = fabsf(wwx * fnx + wwy * fny + wwz * fnz);
  const float w_scale = w_cos / fmaxf(s.pdf, 1e-12f);
  float nbx = cont ? bx * (s.f[0] * w_scale) : bx;
  float nby = cont ? by * (s.f[1] * w_scale) : by;
  float nbz = cont ? bz * (s.f[2] * w_scale) : bz;

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
  // emission after a specular or glossy bounce is added at the next hit
  o.new_prev_sg = cont ? spec_or_glossy : prev_sg;
}

}  // namespace cray
