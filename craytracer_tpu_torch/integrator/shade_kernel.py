"""K2, one bounce's shading for an external hit record (counterpart of
craytracer_tpu/integrator/pallas_shade.py: `fused_shade` :1846 with
`_shade_kernel` :240, `_shade_core` :874, `_meta_operands` :1613 and
`_unpack_outputs` :1643).

`fused_shade` is the wrapper: for CPU tensors it takes the plain version
`fused_shade_reference`; for CUDA tensors it launches K2
(csrc/shade_kernel.cu, whose shading is csrc/shade_core.cuh, shared with
K1) or raises. It never falls back. `KERNEL.launches` counts K2
launches. On a scene it has seen, the wrapper launches K2 and nothing
else: the material and light table is cached per Scene
(`cached_shade_tables`, rebuilt when one of its tensors changes) and the
kernel writes every output in its final dtype. Both return the dict of
`_unpack_outputs`: L_add, shadow_o, shadow_d, dist_adj, dist_adj_t,
contrib_cand, new_o, new_d, new_beta ([N, 3] / [N] f32), good_inc ([N]
int32), want_shadow, new_alive, new_prev_sg ([N] bool). Forward-only,
as in the JAX package (pallas_shade.py:47).

Covers everything the port's gate admits (integrator/gate.py): all seven
material types (Lambertian and Oren-Nayar MATTE, MIRROR, PLASTIC's
two-lobe FresnelBlend, METAL's conductor microfacet, thin TRANSPARENT,
rough GLASS, EMISSIVE) with isotropic Beckmann lobes, rect and sphere
area lights, a constant or black env light. As in the JAX kernels, the
scene's feature mask (`gate.shade_features`: mirror, sphere lights,
Oren-Nayar, plastic, metal, glass, transparent) decides which branches
are computed: the plain version skips absent ones, and K2 is built once
per mask (`library`), as the JAX kernel is traced once per flag set.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from craytracer_tpu_torch.bsdf.fresnel import fr_conductor, fr_dielectric
from craytracer_tpu_torch.bsdf.microfacet import (d_beckmann, fb_diffuse_scale,
                                                  lambda_beckmann, on_scale,
                                                  sample_wh_beckmann)
from craytracer_tpu_torch.constants import INV_PI, PI, TMAX
from craytracer_tpu_torch.core.math import _safe
from craytracer_tpu_torch.cuda_build import CudaLibrary, LaunchCount
from craytracer_tpu_torch.integrator import gate as G
from craytracer_tpu_torch.integrator.gate import MAX_LIGHTS, MAX_MATS
from craytracer_tpu_torch.sampling.mappings import map_to_hemisphere_cosine
from craytracer_tpu_torch.sampling.rng import MASK32, uniforms
from craytracer_tpu_torch.scene import types as T

RR_START = 3  # Russian roulette after bounce 3 (trace.h:512-525)
_F3 = ("L_add", "shadow_o", "shadow_d", "contrib_cand", "new_o", "new_d",
       "new_beta")


def env_radiance(scene: T.Scene):
    """The constant env light's radiance [3] f32; black without one."""
    env = scene.env
    if env.kind == 1:
        return (env.color * env.intensity).to(torch.float32)
    return torch.zeros(3, dtype=torch.float32, device=scene.device)


def material_light_rows(scene: T.Scene):
    """(env radiance [3], material rows [M, 19], light rows [L, 19]) in
    the column layouts of _meta_operands (pallas_shade.py:1613): material
    0 type, 1-3 color, 4 on_a, 5 intensity, 6 on_b, 7 alphax, 8-10 ks,
    11-13 eta, 14-16 k, 17 ior_in, 18 ior_out; light 0-2 p0, 3-5 v1, 6-8
    v2, 9-11 normal, 12-14 color * intensity, 15 radius, 16 power CDF, 17
    power, 18 type."""
    f32 = torch.float32
    m = scene.materials
    mt = torch.stack([m.mat_type.to(f32), m.color[:, 0], m.color[:, 1],
                      m.color[:, 2], m.on_a, m.intensity, m.on_b, m.alphax,
                      m.ks[:, 0], m.ks[:, 1], m.ks[:, 2],
                      m.eta[:, 0], m.eta[:, 1], m.eta[:, 2],
                      m.k[:, 0], m.k[:, 1], m.k[:, 2], m.ior_in, m.ior_out],
                     dim=-1)
    li = scene.lights
    lt = torch.cat([li.p0, li.v1, li.v2, li.normal,
                    li.color * li.intensity[:, None], li.radius[:, None],
                    li.power_cdf[:, None], li.power[:, None],
                    li.light_type[:, None].to(f32)], dim=-1)
    return env_radiance(scene), mt, lt


def shade_tables(scene: T.Scene):
    """K2's table: env radiance and a pad, then the material and light
    rows (csrc/shade_kernel.cu)."""
    env_li, mt, lt = material_light_rows(scene)
    pad = torch.zeros(1, dtype=torch.float32, device=scene.device)
    return torch.cat([env_li, pad, mt.reshape(-1), lt.reshape(-1)])


def _normalize3(x, y, z):
    n2 = x * x + y * y + z * z
    inv = torch.where(n2 > 1e-20, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-20)),
                      0.0)
    return x * inv, y * inv, z * inv


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _len2_sum(ax, ay, az, bx, by, bz):
    """|a + b|^2 with each sum squared as XLA lowers `(a + b) ** 2`."""
    sx, sy, sz = ax + bx, ay + by, az + bz
    return sx * sx + sy * sy + sz * sz


# ---------------------------------------------------------------------------
# The plain version


def _sample_sphere_light(u, px, py, pz, p0, rad):
    """Sphere area-light sample (trace.h:230-243): a cosine hemisphere
    about the center -> hit axis in the Duff basis; returns the world
    direction h (also the light normal there) and pdf = |h.z| / (2 pi^2
    r^2) (pallas_shade.py:1056-1094)."""
    zx, zy, zz = _normalize3(px - p0[:, 0], py - p0[:, 1], pz - p0[:, 2])
    zsg = torch.where(zz >= 0.0, 1.0, -1.0)
    za = -1.0 / (zsg + zz)
    zb_ = zx * zy * za
    ztx = 1.0 + zsg * zx * zx * za
    zty = zsg * zb_
    ztz = -zsg * zx
    zby = zsg + zy * zy * za
    zbz = -zy
    hx_, hy_, hz_ = map_to_hemisphere_cosine(u[:, 0:2]).unbind(1)
    hwx = hx_ * ztx + hy_ * zb_ + hz_ * zx
    hwy = hx_ * zty + hy_ * zby + hz_ * zy
    hwz = hx_ * ztz + hy_ * zbz + hz_ * zz
    pdf = (1.0 / (2.0 * PI * torch.clamp(rad * rad, min=1e-12))
           * torch.abs(hz_) * INV_PI)
    return hwx, hwy, hwz, pdf


def _plastic_sample(wo, u_b0, u_b1, ax_m, c, ks):
    """PLASTIC's two-lobe sample (BSDF_sample_f, reflection.cpp:760-811;
    pallas_shade.py:1214-1283): a uniform lobe pick with the sample
    remapped, the chosen lobe's pdf must be > 0, and f and pdf are then
    summed over both lobes (the reference quirk). Returns (wi, f [3],
    pdf, picked the specular lobe)."""
    wo_lx, wo_ly, wo_lz = wo
    pick_spec = u_b0 >= 0.5
    u0r = torch.clamp(torch.where(pick_spec, 2.0 * (u_b0 - 0.5), 2.0 * u_b0),
                      0.0, 1.0 - 1e-7)
    # diffuse lobe: cosine hemisphere from the remapped u0, on wo's side
    pdx, pdy, pdz = map_to_hemisphere_cosine(
        torch.stack([u0r, u_b1], dim=1)).unbind(1)
    pdz = torch.where(wo_lz < 0.0, -pdz, pdz)
    # specular lobe: Beckmann wh, then reflect
    whx, why, whz = sample_wh_beckmann(wo_lx, wo_ly, wo_lz, u0r, u_b1, ax_m)
    dwh = _dot3(wo_lx, wo_ly, wo_lz, whx, why, whz)
    psx = 2.0 * dwh * whx - wo_lx
    psy = 2.0 * dwh * why - wo_ly
    psz = 2.0 * dwh * whz - wo_lz
    ps_ok = psz * wo_lz > 0.0
    wpx = torch.where(pick_spec, psx, pdx)
    wpy = torch.where(pick_spec, psy, pdy)
    wpz = torch.where(pick_spec, psz, pdz)
    # both lobes' pdfs at the chosen wi
    same_p = wpz * wo_lz > 0.0
    cos_pdf = torch.where(same_p, torch.abs(wpz) * INV_PI, 0.0)
    sx_, sy_, sz_ = _normalize3(wpx + wo_lx, wpy + wo_ly, wpz + wo_lz)
    spec_pdf = torch.where(
        same_p, d_beckmann(sx_, sy_, sz_, ax_m) / torch.clamp(
            2.0 * _dot3(wo_lx, wo_ly, wo_lz, sx_, sy_, sz_), min=1e-7), 0.0)
    pdf_chosen = torch.where(pick_spec, torch.where(ps_ok, spec_pdf, 0.0),
                             cos_pdf)
    pdf_other = torch.where(pick_spec, cos_pdf, spec_pdf)
    alive_p = pdf_chosen > 0.0
    # f = FresnelBlend diffuse + specular at the chosen wi
    fbd_s = fb_diffuse_scale(wpz, wo_lz)
    cos_wh = _dot3(wpx, wpy, wpz, sx_, sy_, sz_)
    degen = _len2_sum(wpx, wpy, wpz, wo_lx, wo_ly, wo_lz) < 1e-16
    om = 1.0 - cos_wh
    om2 = om * om
    p5w = om * (om2 * om2)
    denom_s = 4.0 * torch.abs(cos_wh) * torch.clamp(
        torch.maximum(torch.abs(wpz), torch.abs(wo_lz)), min=1e-7)
    d_spec = d_beckmann(sx_, sy_, sz_, ax_m) / torch.clamp(denom_s, min=1e-12)
    d_spec = torch.where(degen, 0.0, d_spec)
    f = [torch.where(alive_p, kd * (1.0 - k_s) * fbd_s
                     + (k_s + p5w * (1.0 - k_s)) * d_spec, 0.0)
         for kd, k_s in zip(c, ks)]
    pdf = torch.where(alive_p, pdf_chosen + pdf_other, 0.0)
    return (wpx, wpy, wpz), f, pdf, pick_spec


def _metal_sample(wo, u_b0, u_b1, ax_m, eta, kk):
    """METAL (MicrofacetReflection_sample_f, reflection.cpp:329-344;
    pallas_shade.py:1284-1325): a Beckmann wh from the unremapped sample,
    conductor Fresnel, f = D G Fr / (4 |ci| |co|), pdf = D |wh.z| / (4
    wo.wh). Returns (wi, f [3], pdf)."""
    wo_lx, wo_ly, wo_lz = wo
    mhx, mhy, mhz = sample_wh_beckmann(wo_lx, wo_ly, wo_lz, u_b0, u_b1, ax_m)
    mdwh = _dot3(wo_lx, wo_ly, wo_lz, mhx, mhy, mhz)
    mwx = 2.0 * mdwh * mhx - wo_lx
    mwy = 2.0 * mdwh * mhy - wo_ly
    mwz = 2.0 * mdwh * mhz - wo_lz
    m_ok = mwz * wo_lz > 0.0
    aci = torch.abs(mwz)
    aco = torch.abs(wo_lz)
    shx, shy, shz = _normalize3(mwx + wo_lx, mwy + wo_ly, mwz + wo_lz)
    m_degen = ((_len2_sum(mwx, mwy, mwz, wo_lx, wo_ly, wo_lz) < 1e-16)
               | (aci < 1e-7) | (aco < 1e-7))
    cwh = _dot3(mwx, mwy, mwz, shx, shy, shz)
    d_m = d_beckmann(shx, shy, shz, ax_m)
    g_m = 1.0 / (1.0 + lambda_beckmann(wo_lx, wo_ly, wo_lz, ax_m)
                 + lambda_beckmann(mwx, mwy, mwz, ax_m))
    scale_m = d_m * g_m / torch.clamp(4.0 * aci * aco, min=1e-12)
    scale_m = torch.where(m_degen, 0.0, scale_m)
    f = [torch.where(m_ok, fr_conductor(cwh, e, k) * scale_m, 0.0)
         for e, k in zip(eta, kk)]
    pdf = (d_beckmann(mhx, mhy, mhz, ax_m) * torch.abs(mhz)
           / torch.clamp(4.0 * mdwh, min=1e-7))
    return (mwx, mwy, mwz), f, torch.where(m_ok, pdf, 0.0)


def _transparent_sample(wo, r_extra, ior_i, ior_o):
    """Thin TRANSPARENT (SpecularTransmission_sample_f's thin branch,
    reflection.cpp:250-282; pallas_shade.py:1326-1349): the Fresnel
    branch sample picks mirror reflection or straight-through
    transmission. Returns (wi, f (one value for every channel), pdf)."""
    wo_lx, wo_ly, wo_lz = wo
    kr_thin = fr_dielectric(torch.abs(wo_lz), ior_i, ior_o)
    take_refl = r_extra <= kr_thin
    twz = torch.where(take_refl, wo_lz, -wo_lz)
    eta_thin = ior_o / ior_i
    mag = torch.where(take_refl, kr_thin,
                      (1.0 - kr_thin) * eta_thin * eta_thin) \
        / torch.clamp(torch.abs(twz), min=1e-7)
    pdf = torch.where(take_refl, kr_thin, 1.0 - kr_thin)
    return (-wo_lx, -wo_ly, twz), mag, pdf


def _glass_sample(wo, u_b0, u_b1, r_extra, ax_m, ior_i, ior_o):
    """Rough GLASS (MicrofacetFresnel_sample_f, reflection.cpp:390-446;
    pallas_shade.py:1350-1442): a Beckmann wh, then the Fresnel branch
    sample picks microfacet reflection (weighted by the reference's
    1 - Fr(wh, wi)) or rough transmission through the faced wh, whose pdf
    uses the unflipped half-vector. Returns (wi, f (one value for every
    channel), pdf)."""
    wo_lx, wo_ly, wo_lz = wo
    ghx, ghy, ghz = sample_wh_beckmann(wo_lx, wo_ly, wo_lz, u_b0, u_b1, ax_m)
    gdwh = _dot3(wo_lx, wo_ly, wo_lz, ghx, ghy, ghz)
    kr_g = fr_dielectric(gdwh, ior_i, ior_o)
    g_refl = r_extra <= kr_g
    lam_o = lambda_beckmann(wo_lx, wo_ly, wo_lz, ax_m)
    # ---- reflection branch
    grx = 2.0 * gdwh * ghx - wo_lx
    gry = 2.0 * gdwh * ghy - wo_ly
    grz = 2.0 * gdwh * ghz - wo_lz
    gr_ok = grz * wo_lz > 0.0
    rhx, rhy, rhz = _normalize3(grx + wo_lx, gry + wo_ly, grz + wo_lz)
    r_degen = ((_len2_sum(grx, gry, grz, wo_lx, wo_ly, wo_lz) < 1e-16)
               | (torch.abs(grz) < 1e-7) | (torch.abs(wo_lz) < 1e-7))
    kr_quirk = 1.0 - fr_dielectric(_dot3(rhx, rhy, rhz, grx, gry, grz),
                                   ior_i, ior_o)
    scale_gr = (d_beckmann(rhx, rhy, rhz, ax_m)
                * (1.0 / (1.0 + lam_o + lambda_beckmann(grx, gry, grz, ax_m)))
                / torch.clamp(4.0 * torch.abs(grz) * torch.abs(wo_lz),
                              min=1e-12))
    f_gr = torch.where(r_degen, 0.0, kr_quirk * scale_gr)
    pdf_gr = (d_beckmann(ghx, ghy, ghz, ax_m) * torch.abs(ghz)
              / torch.clamp(4.0 * gdwh, min=1e-7))
    f_gr = torch.where(gr_ok, f_gr, 0.0)
    pdf_gr = torch.where(gr_ok, pdf_gr, 0.0)
    # ---- transmission branch (refract through the faced wh)
    eta_g = torch.where(wo_lz > 0.0, ior_o / ior_i, ior_i / ior_o)
    fsg = torch.where(gdwh < 0.0, -1.0, 1.0)
    fhx, fhy, fhz = ghx * fsg, ghy * fsg, ghz * fsg
    cti_r = _dot3(fhx, fhy, fhz, wo_lx, wo_ly, wo_lz)
    s2i = torch.clamp(1.0 - cti_r * cti_r, min=0.0)
    s2t = eta_g * eta_g * s2i
    gt_ok = s2t < 1.0
    ctt = torch.sqrt(torch.clamp(1.0 - s2t, min=1e-12))
    gtx = -eta_g * wo_lx + (eta_g * cti_r - ctt) * fhx
    gty = -eta_g * wo_ly + (eta_g * cti_r - ctt) * fhy
    gtz = -eta_g * wo_lz + (eta_g * cti_r - ctt) * fhz
    not_trans = gtz * wo_lz > 0.0
    eta_t2 = torch.where(wo_lz > 0.0, ior_i / ior_o, ior_o / ior_i)
    thx, thy, thz = _normalize3(wo_lx + gtx * eta_t2, wo_ly + gty * eta_t2,
                                wo_lz + gtz * eta_t2)
    tsg = torch.where(thz < 0.0, -1.0, 1.0)
    thx2, thy2, thz2 = thx * tsg, thy * tsg, thz * tsg
    fr_t = fr_dielectric(_dot3(thx2, thy2, thz2, wo_lx, wo_ly, wo_lz),
                         ior_i, ior_o)
    dot_ot = _dot3(thx2, thy2, thz2, wo_lx, wo_ly, wo_lz)
    dot_it = _dot3(thx2, thy2, thz2, gtx, gty, gtz)
    sqrt_den = dot_ot + eta_t2 * dot_it
    den_t = gtz * wo_lz * sqrt_den * sqrt_den
    num_t = (d_beckmann(thx2, thy2, thz2, ax_m)
             * (1.0 / (1.0 + lam_o + lambda_beckmann(gtx, gty, gtz, ax_m)))
             * torch.abs(dot_it) * torch.abs(dot_ot))
    f_gt = (1.0 - fr_t) * torch.abs(num_t / _safe(den_t))
    bad_t = (not_trans | (torch.abs(gtz) < 1e-7)
             | (torch.abs(wo_lz) < 1e-7))
    f_gt = torch.where(bad_t, 0.0, f_gt)
    # the transmission pdf uses the UNFLIPPED wh (bxdf.py:252-261)
    dot_ot3 = _dot3(thx, thy, thz, wo_lx, wo_ly, wo_lz)
    dot_it3 = _dot3(thx, thy, thz, gtx, gty, gtz)
    sd3 = dot_ot3 + eta_t2 * dot_it3
    dwh_dwi = torch.abs(eta_t2 * eta_t2 * dot_it3) \
        / torch.clamp(sd3 * sd3, min=1e-12)
    pdf_gt = d_beckmann(thx, thy, thz, ax_m) * torch.abs(thz) * dwh_dwi
    pdf_gt = torch.where(not_trans, 0.0, pdf_gt)
    f_gt = torch.where(gt_ok, f_gt, 0.0)
    pdf_gt = torch.where(gt_ok, pdf_gt, 0.0)
    wi = (torch.where(g_refl, grx, gtx), torch.where(g_refl, gry, gty),
          torch.where(g_refl, grz, gtz))
    return (wi, torch.where(g_refl, f_gr, f_gt),
            torch.where(g_refl, pdf_gr, pdf_gt))


@torch.no_grad()
def fused_shade_reference(scene: T.Scene, d, hit, beta, alive, prev_sg, pix,
                          spp, seed: int, bounce: int, max_depth: int,
                          rr_start: int = RR_START):
    """Plain PyTorch version of K2: `_shade_core` in torch ops, formula for
    formula (same expression trees and epsilons), over [N] lanes, with the
    branches of the scene's feature mask."""
    feats = G.shade_features(scene)
    hitm = hit.t < TMAX
    mats = scene.materials
    mid = hit.mat_id.to(torch.int64).clamp(0, mats.mat_type.shape[0] - 1)
    mtype = mats.mat_type[mid]
    c = mats.color[mid].unbind(1)
    cr, cg, cb = c
    on_a, inten, on_b = mats.on_a[mid], mats.intensity[mid], mats.on_b[mid]
    ax_m = mats.alphax[mid]
    env_li = env_radiance(scene)
    dx, dy, dz = d.unbind(1)
    px, py, pz = hit.point.unbind(1)
    nx, ny, nz = hit.normal.unbind(1)
    ux, uy, uz = hit.dpdu.unbind(1)
    bx, by, bz = beta.unbind(1)

    # ---- emitted / env add (trace.h:419-455)
    emissive_hit = hitm & (mtype == T.MAT_EMISSIVE)
    add_cond = alive & (prev_sg | (bounce == 0))
    add_emit = add_cond & emissive_hit
    add_env = add_cond & ~hitm
    l_add = torch.stack([
        torch.where(add_emit, b * (cc * inten), 0.0)
        + torch.where(add_env, b * e, 0.0)
        for b, cc, e in ((bx, cr, env_li[0]), (by, cg, env_li[1]),
                         (bz, cb, env_li[2]))], dim=1)
    good_inc = (add_emit | add_env).to(torch.int32)
    cont = alive & hitm & ~emissive_hit & (bounce < max_depth)

    # ---- shading frame (make_shading_frame on sanitized inputs)
    snx = torch.where(hitm, nx, 0.0)
    sny = torch.where(hitm, ny, 0.0)
    snz = torch.where(hitm, nz, 1.0)
    sux = torch.where(hitm, ux, 1.0)
    suy = torch.where(hitm, uy, 0.0)
    suz = torch.where(hitm, uz, 0.0)
    ndu = snx * sux + sny * suy + snz * suz
    tx = sux - ndu * snx
    ty = suy - ndu * sny
    tz = suz - ndu * snz
    t_len2 = tx * tx + ty * ty + tz * tz
    s = torch.where(snz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + snz)
    ntx, nty, ntz = _normalize3(tx, ty, tz)
    use_t = t_len2 > 1e-12
    ftx = torch.where(use_t, ntx, 1.0 + s * snx * snx * a)
    fty = torch.where(use_t, nty, s * (snx * sny * a))
    ftz = torch.where(use_t, ntz, -s * snx)
    fbx, fby, fbz = _normalize3(sny * ftz - snz * fty, snz * ftx - snx * ftz,
                                snx * fty - sny * ftx)
    fnx, fny, fnz = snx, sny, snz

    # ---- counter RNG: dims 0,1 light, 4 pick, 5,6 bsdf, 7 fresnel
    # branch (glass, transparent), 8 rr
    u = uniforms(seed, pix, spp, bounce, 9, 0)
    u_l0, u_l1, u_pick = u[:, 0], u[:, 1], u[:, 4]
    u_b0, u_b1, r_extra, u_rr = u[:, 5], u[:, 6], u[:, 7], u[:, 8]

    # ---- NEE: power-CDF pick (searchsorted side='right' + clip), rect or
    # sphere sample, area -> solid angle, facing rejections
    # (trace.h:221-397)
    li = scene.lights
    n_lights = li.light_type.shape[0]
    idx = torch.clamp(torch.searchsorted(li.power_cdf, u_pick.contiguous(),
                                         right=True), 0, n_lights - 1)
    p0, v1, v2, ln = li.p0[idx], li.v1[idx], li.v2[idx], li.normal[idx]
    l_rgb = (li.color * li.intensity[:, None])[idx]
    pick_p = li.power[idx]
    sp = p0 + u_l0[:, None] * v1 + u_l1[:, None] * v2
    len_v1 = torch.sqrt(torch.clamp(v1[:, 0] * v1[:, 0] + v1[:, 1] * v1[:, 1]
                                    + v1[:, 2] * v1[:, 2], min=1e-20))
    len_v2 = torch.sqrt(torch.clamp(v2[:, 0] * v2[:, 0] + v2[:, 1] * v2[:, 1]
                                    + v2[:, 2] * v2[:, 2], min=1e-20))
    pdf_area = 1.0 / torch.clamp(len_v1 * len_v2, min=1e-12)
    if feats & G.F_SPHERE_LIGHT:
        rad = li.radius[idx]
        is_sphl = (li.light_type[idx] == T.LIGHT_AREA_SPHERE)[:, None]
        hwx, hwy, hwz, pdf_sphl = _sample_sphere_light(u, px, py, pz, p0, rad)
        hw = torch.stack([hwx, hwy, hwz], dim=1)
        sp = torch.where(is_sphl, p0 + hw * rad[:, None], sp)
        ln = torch.where(is_sphl, hw, ln)
        pdf_area = torch.where(is_sphl[:, 0], pdf_sphl, pdf_area)
    lnx, lny, lnz = ln.unbind(1)
    tox, toy, toz = sp[:, 0] - px, sp[:, 1] - py, sp[:, 2] - pz
    dist2 = tox * tox + toy * toy + toz * toz
    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
    wix, wiy, wiz = _normalize3(tox, toy, toz)
    conv = dist2 / torch.clamp(torch.abs(lnx * -wix + lny * -wiy
                                         + lnz * -wiz), min=1e-12)
    pdf_sa = pdf_area * conv
    reject = (((tox * lnx + toy * lny + toz * lnz) > 0.0)
              | ((tox * fnx + toy * fny + toz * fnz) < 0.0))
    valid = ~reject & (pdf_sa > 1e-12) & (pick_p > 0.0)
    pdf_nee = pdf_sa * torch.clamp(pick_p, min=1e-12)

    # NEE eval: the diffuse lobes only (MATTE's Oren-Nayar, PLASTIC's
    # FresnelBlend diffuse), on the WORLD vectors (the reference's
    # BSDF_f quirk, reflection.cpp:719-735); other types get f = 0
    is_matte = mtype == T.MAT_MATTE
    abs_cos = torch.abs(fnx * wix + fny * wiy + fnz * wiz)
    if feats & G.F_OREN:
        on_fac = on_scale(wix, wiy, wiz, -dx, -dy, -dz, on_a, on_b)
    else:
        on_fac = on_a * INV_PI
    f_fac = torch.where(is_matte, on_fac, 0.0)
    f_nee = [cc * f_fac for cc in c]
    if feats & G.F_PLASTIC:
        is_pl = mtype == T.MAT_PLASTIC
        ks = mats.ks[mid].unbind(1)
        fbd = fb_diffuse_scale(wiz, -dz)
        f_nee = [torch.where(is_pl, cc * (1.0 - k_s) * fbd, f)
                 for cc, k_s, f in zip(c, ks, f_nee)]
    f_r, f_g, f_b = (f * abs_cos for f in f_nee)
    want_shadow = cont & valid & ((f_r > 0.0) | (f_g > 0.0) | (f_b > 0.0))

    # shadow origin offset along the raw hit normal (_offset_ray)
    mag = torch.maximum(torch.maximum(torch.abs(px), torch.abs(py)),
                        torch.abs(pz))
    eps = (mag + 1.0) * 1e-4
    side = torch.where((wix * nx + wiy * ny + wiz * nz) >= 0.0, 1.0, -1.0)
    shox, shoy, shoz = px + nx * eps * side, py + ny * eps * side, \
        pz + nz * eps * side
    dist_adj = dist - ((shox - px) * wix + (shoy - py) * wiy
                       + (shoz - pz) * wiz)
    shadow_o = torch.where(want_shadow[:, None],
                           torch.stack([shox, shoy, shoz], dim=1), 3.0e18)
    inv_pdf = 1.0 / torch.clamp(pdf_nee, min=1e-12)
    contrib = torch.stack([
        torch.where(want_shadow, b * (f * l_rgb[:, k] * inv_pdf), 0.0)
        for k, (b, f) in enumerate(((bx, f_r), (by, f_g), (bz, f_b)))],
        dim=1)

    # ---- BSDF sample over dims 5,6 (7 for the Fresnel branch)
    wo = (-(dx * ftx + dy * fty + dz * ftz), -(dx * fbx + dy * fby + dz * fbz),
          -(dx * fnx + dy * fny + dz * fnz))
    wlx, wly, wlz = map_to_hemisphere_cosine(u[:, 5:7]).unbind(1)
    pdf_s = torch.where(is_matte, wlz * INV_PI, 0.0)
    if feats & G.F_OREN:
        on_sfac = on_scale(wlx, wly, wlz, *wo, on_a, on_b)
    else:
        on_sfac = on_a * INV_PI
    fs = [torch.where(is_matte, cc * on_sfac, 0.0) for cc in c]
    wl = [torch.where(is_matte, wlx, 0.0), torch.where(is_matte, wly, 0.0),
          torch.where(is_matte, wlz, 1.0)]
    is_spec = torch.zeros_like(is_matte)
    is_glossy = torch.zeros_like(is_matte)

    def take(sel, wi_, f_, pdf_):
        """Select a material's sample on its lanes."""
        nonlocal pdf_s
        for k in range(3):
            wl[k] = torch.where(sel, wi_[k], wl[k])
            fs[k] = torch.where(sel, f_[k] if isinstance(f_, list) else f_,
                                fs[k])
        pdf_s = torch.where(sel, pdf_, pdf_s)

    if feats & G.F_MIRROR:
        # MIRROR (SpecularReflection_sample_f, reflection.cpp:240-247)
        is_mir = mtype == T.MAT_MIRROR
        inv_cos = 1.0 / torch.clamp(torch.abs(wo[2]), min=1e-7)
        take(is_mir, (-wo[0], -wo[1], wo[2]), [cc * inv_cos for cc in c],
             1.0)
        is_spec = is_mir
    if feats & G.F_PLASTIC:
        is_pl = mtype == T.MAT_PLASTIC
        wi_, f_, pdf_, pick_spec = _plastic_sample(
            wo, u_b0, u_b1, ax_m, c, mats.ks[mid].unbind(1))
        take(is_pl, wi_, f_, pdf_)
        is_glossy = is_glossy | (is_pl & pick_spec)
    if feats & G.F_METAL:
        is_met = mtype == T.MAT_METAL
        wi_, f_, pdf_ = _metal_sample(wo, u_b0, u_b1, ax_m,
                                      mats.eta[mid].unbind(1),
                                      mats.k[mid].unbind(1))
        take(is_met, wi_, f_, pdf_)
        is_glossy = is_glossy | is_met
    if feats & G.F_TRANSPARENT:
        is_tr = mtype == T.MAT_TRANSPARENT
        wi_, f_, pdf_ = _transparent_sample(wo, r_extra, mats.ior_in[mid],
                                            mats.ior_out[mid])
        take(is_tr, wi_, f_, pdf_)
        is_spec = is_spec | is_tr
    if feats & G.F_GLASS:
        is_gl = mtype == T.MAT_GLASS
        wi_, f_, pdf_ = _glass_sample(wo, u_b0, u_b1, r_extra, ax_m,
                                      mats.ior_in[mid], mats.ior_out[mid])
        take(is_gl, wi_, f_, pdf_)
        is_glossy = is_glossy | is_gl
    wlx, wly, wlz = wl
    fs_r, fs_g, fs_b = fs
    dead = (pdf_s <= 0.0) | ((fs_r == 0.0) & (fs_g == 0.0) & (fs_b == 0.0))
    wwx = wlx * ftx + wly * fbx + wlz * fnx
    wwy = wlx * fty + wly * fby + wlz * fny
    wwz = wlx * ftz + wly * fbz + wlz * fnz
    w_cos = torch.abs(wwx * fnx + wwy * fny + wwz * fnz)
    w_scale = w_cos / torch.clamp(pdf_s, min=1e-12)
    nb = torch.stack([torch.where(cont, b * (f * w_scale), b)
                      for b, f in ((bx, fs_r), (by, fs_g), (bz, fs_b))], 1)

    # ---- Russian roulette (trace.h:512-525)
    max_c = torch.maximum(torch.maximum(nb[:, 0], nb[:, 1]), nb[:, 2])
    q = torch.clamp(1.0 - max_c, min=0.05)
    rr_active = cont & (bounce > rr_start)
    rr_kill = rr_active & (u_rr < q)
    inv_q = 1.0 / torch.clamp(1.0 - q, min=1e-6)
    nb = torch.where((rr_active & ~rr_kill)[:, None], nb * inv_q[:, None], nb)

    new_alive = cont & ~dead & ~rr_kill
    side2 = torch.where((wwx * nx + wwy * ny + wwz * nz) >= 0.0, 1.0, -1.0)
    new_o = torch.where(new_alive[:, None], torch.stack(
        [px + nx * eps * side2, py + ny * eps * side2,
         pz + nz * eps * side2], dim=1), 3.0e18)
    escape_d = torch.zeros_like(d)
    escape_d[:, 0] = 1.0
    new_d = torch.where(new_alive[:, None],
                        torch.stack([wwx, wwy, wwz], dim=1), escape_d)
    return {
        "L_add": l_add, "shadow_o": shadow_o,
        "shadow_d": torch.stack([wix, wiy, wiz], dim=1),
        "dist_adj": dist_adj,
        "dist_adj_t": torch.where(want_shadow, dist_adj, 0.0),
        "contrib_cand": contrib, "new_o": new_o, "new_d": new_d,
        "new_beta": nb, "good_inc": good_inc, "want_shadow": want_shadow,
        "new_alive": new_alive,
        # emission after a specular or glossy bounce is added next bounce
        "new_prev_sg": (cont & (is_spec | is_glossy)) | (~cont & prev_sg),
    }


# ---------------------------------------------------------------------------
# K2 on the card


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k2_shade_launch.argtypes = ([vp, ci, ci, ci] + [vp] * 11
                                    + [ci, ci, ctypes.c_uint, ci, ci, ci]
                                    + [vp] * 5)
    lib.k2_shade_launch.restype = ci
    lib.k2_shade_mask.argtypes = []
    lib.k2_shade_mask.restype = ci


_VARIANTS: dict = {}  # feature mask -> its CudaLibrary


def library(mask: int) -> CudaLibrary:
    """K2 built for one feature mask (`gate.shade_features`): the branches
    of csrc/shade_core.cuh the mask's bits name and no other. Built at
    first `load()` into craytracer_tpu_torch/_build/, keyed on the sources'
    hash and the mask."""
    if not 0 <= mask <= G.F_ALL:
        raise ValueError(f"feature mask {mask} out of range")
    if mask not in _VARIANTS:
        _VARIANTS[mask] = CudaLibrary(
            "shade_kernel", headers=("shade_core.cuh",), bind=_bind,
            defines=(("K2_MASK", mask),))
    return _VARIANTS[mask]


def variants() -> dict:
    """{mask: CudaLibrary} of every variant asked for in this process."""
    return dict(_VARIANTS)


KERNEL = LaunchCount()  # K2 launches through `fused_shade`

# id(scene) -> (weak reference to the scene, key, table): each Scene's
# table, built once per scene and rebuilt when a tensor it reads changes
_TABLES: dict = {}


def _table_key(scene: T.Scene):
    """What `shade_tables` reads, as (data_ptr, _version) pairs: an
    in-place change bumps a tensor's version, a new tensor has another
    pointer or version."""
    m, li, env = scene.materials, scene.lights, scene.env
    ts = (m.mat_type, m.color, m.on_a, m.intensity, m.on_b, m.alphax, m.ks,
          m.eta, m.k, m.ior_in, m.ior_out, li.p0, li.v1, li.v2, li.normal,
          li.color, li.intensity, li.radius, li.power_cdf, li.power,
          li.light_type, env.color, env.intensity)
    return (env.kind,) + tuple((t.data_ptr(), t._version) for t in ts)


def cached_shade_tables(scene: T.Scene):
    """`shade_tables(scene)`, built once per Scene and rebuilt when a
    material, light or env tensor has changed since (in place or
    replaced)."""
    key = _table_key(scene)
    entry = _TABLES.get(id(scene))
    if entry is not None and entry[0]() is scene and entry[1] == key:
        return entry[2]
    for k in [k for k, e in _TABLES.items() if e[0]() is None]:
        del _TABLES[k]
    tab = shade_tables(scene)
    _TABLES[id(scene)] = (weakref.ref(scene), key, tab)
    return tab


def _check_lanes(n, dev, floats3=(), lanes=()):
    for name, x in floats3:
        if (x.device != dev or x.dtype != torch.float32 or x.shape != (n, 3)
                or not x.is_contiguous()):
            raise ValueError(f"K2 takes {name} as a contiguous f32 [N, 3] "
                             f"tensor on {dev}")
    for name, x, dtype in lanes:
        if (x.device != dev or x.dtype != dtype or x.shape != (n,)
                or not x.is_contiguous()):
            raise ValueError(f"K2 takes {name} as a contiguous {dtype} [N] "
                             f"tensor on {dev}")


def prepare_launch(scene: T.Scene, d, hit, beta, alive, prev_sg, pix, spp,
                   seed: int, bounce: int, max_depth: int,
                   rr_start: int = RR_START):
    """Check K2's inputs (CUDA tensors) and allocate its outputs: (the
    variant's CudaLibrary, built and loaded, the arguments of its
    `k2_shade_launch`, the output dict). `fused_shade` launches with them;
    a timing loop may launch the same arguments again (such launches are
    not counted)."""
    dev = d.device
    n = d.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"K2 runs on CUDA tensors, not {dev}")
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device}, rays on {dev}")
    n_mats = scene.materials.mat_type.shape[0]
    n_lights = scene.lights.light_type.shape[0]
    if not (1 <= n_lights <= MAX_LIGHTS and 1 <= n_mats <= MAX_MATS):
        raise ValueError("K2 table sizes out of range")
    per_lane = isinstance(spp, torch.Tensor) and spp.dim() > 0
    _check_lanes(n, dev, (("d", d), ("hit.point", hit.point),
                          ("hit.normal", hit.normal), ("hit.dpdu", hit.dpdu),
                          ("beta", beta)),
                 (("hit.t", hit.t, torch.float32),
                  ("hit.mat_id", hit.mat_id, torch.int32),
                  ("alive", alive, torch.bool),
                  ("prev_sg", prev_sg, torch.bool),
                  ("pix", pix, torch.int32))
                 + ((("spp", spp, torch.int32),) if per_lane else ()))
    tab = cached_shade_tables(scene)
    variant = library(G.shade_features(scene))
    variant.load()
    f3 = torch.empty((7, n, 3), dtype=torch.float32, device=dev)
    f1 = torch.empty((2, n), dtype=torch.float32, device=dev)
    good = torch.empty(n, dtype=torch.int32, device=dev)
    flags = torch.empty((3, n), dtype=torch.bool, device=dev)
    args = (tab.data_ptr(), tab.numel(), n_mats, n_lights, d.data_ptr(),
            hit.point.data_ptr(), hit.normal.data_ptr(), hit.dpdu.data_ptr(),
            beta.data_ptr(), hit.t.data_ptr(), hit.mat_id.data_ptr(),
            alive.data_ptr(), prev_sg.data_ptr(), pix.data_ptr(),
            spp.data_ptr() if per_lane else None,
            0 if per_lane else int(spp), n, int(seed) & MASK32, int(bounce),
            int(max_depth), int(rr_start), f3.data_ptr(), f1.data_ptr(),
            good.data_ptr(), flags.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    out = dict(zip(_F3, f3.unbind(0)))
    out.update(dist_adj=f1[0], dist_adj_t=f1[1], good_inc=good,
               want_shadow=flags[0], new_alive=flags[1], new_prev_sg=flags[2])
    return variant, args, out


@torch.no_grad()
def fused_shade(scene: T.Scene, d, hit, beta, alive, prev_sg, pix, spp,
                seed: int, bounce: int, max_depth: int,
                rr_start: int = RR_START):
    """One bounce's shading: the dict described in the module docstring.
    `d`'s device decides: a CPU tensor takes the plain version, a CUDA
    tensor launches K2 (the variant of the scene's feature mask), and
    nothing else: the table is the scene's cached one and every output is
    written in its final dtype. `spp` is an int or a per-lane [N]
    tensor."""
    for x in (d, hit.point, hit.normal, hit.dpdu, beta):
        if x.requires_grad:
            raise ValueError("K2 is forward-only: an input requires grad")
    if d.device.type == "cpu":
        return fused_shade_reference(scene, d, hit, beta, alive, prev_sg, pix,
                                     spp, seed, bounce, max_depth, rr_start)
    variant, args, out = prepare_launch(scene, d, hit, beta, alive, prev_sg,
                                        pix, spp, seed, bounce, max_depth,
                                        rr_start)
    variant.check(variant.load().k2_shade_launch(*args), "K2")
    KERNEL.launches += 1
    return out
