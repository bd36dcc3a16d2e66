"""Masked BSDF evaluation and sampling over hit queues, the general
route's lobes (counterpart of craytracer_tpu/bsdf/bxdf.py: `MatParams`
:45, `gather_params` :69, the lobes :122-265, `_use` :268,
`bsdf_f_direct` :276, `bsdf_f_nodelta` :291, `bsdf_pdf_balanced` :343,
`bsdf_pdf` :364, `bsdf_sample` :385).

Each material type is a static lobe configuration; hit lanes gather
their parameters from the material table and every lobe of a type the
scene holds runs masked for all lanes (MATTE: Oren-Nayar, Lambertian
when every matte sigma is 0; MIRROR; thin TRANSPARENT; PLASTIC's two
FresnelBlend lobes; GLASS's rough dielectric; METAL's conductor
microfacet; EMISSIVE: none). Lobes of absent types are skipped, not
evaluated and masked (`_use`), as the JAX code compiles them away, so
the two packages evaluate the same expressions. Directions are local
(z = shading normal). The reference quirks are the JAX package's:
FresnelBlend's specular pdf D / (2 wo.wh), glass reflection weighted
by 1 - Fr(wh, wi), the thin transmission wi = -wo scaled by eta^2, and
PLASTIC's summed lobe pdfs. Microfacet lobes take any (alphax, alphay,
distrib) through bsdf/microfacet.py's general forms. `gather_params`
resolves a diffuse texture (the nearest texel, bsdf/texture.py) where
the scene's pack holds real texels, as the JAX code does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from craytracer_tpu_torch.bsdf import microfacet as mf
from craytracer_tpu_torch.bsdf.fresnel import (fr_conductor_rgb,
                                               fr_dielectric, schlick_fresnel)
from craytracer_tpu_torch.bsdf.texture import tex_lookup_nearest
from craytracer_tpu_torch.constants import INV_PI, PI
from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.sampling.mappings import map_to_hemisphere_cosine
from craytracer_tpu_torch.scene import types as T


@dataclass(frozen=True)
class MatParams:
    """Per-hit material parameters gathered from the table ([N, ...])."""

    mat_type: torch.Tensor
    color: torch.Tensor  # diffuse / cr / kd / emissive color, textured
    ks: torch.Tensor
    on_a: torch.Tensor
    on_b: torch.Tensor
    ior_in: torch.Tensor
    ior_out: torch.Tensor
    eta3: torch.Tensor
    k3: torch.Tensor
    alphax: torch.Tensor
    alphay: torch.Tensor
    distrib: torch.Tensor
    intensity: torch.Tensor
    # static: every MATTE row has sigma 0 (Scene.matte_lambertian), so
    # Oren-Nayar is color * on_a / pi
    lambertian_only: bool = False
    # the table color before the texture (emitted radiance uses it,
    # trace.h:421-427) and the normal-map texture id (-1: none); the
    # lobes read neither
    color_raw: Optional[torch.Tensor] = None
    normal_tex: Optional[torch.Tensor] = None


def gather_params(materials: T.Materials, textures: T.TexturePack, mat_id,
                  uv, lambertian_only: bool = False) -> MatParams:
    """One row lookup per lane, the index clipped to the table as
    take_rows clips it (ops/gather.py:76): a miss lane's -1 reads row 0.
    Where the pack holds real texels (more than the empty pack's one), a
    row with a diffuse texture takes the nearest texel at `uv` as its
    color (computeScatteringFunc's texture branch, materials.cpp:117-127).
    The alphas are floored at 1e-4: non-microfacet rows carry 0, and
    every microfacet lobe divides by alpha^2 on the masked lanes too."""
    idx = torch.clamp(mat_id.to(torch.int64), 0,
                      materials.mat_type.shape[0] - 1)
    color_raw = materials.color[idx]
    color = color_raw
    if textures.texels.shape[0] > 1:
        tex_id = materials.diffuse_tex[idx]
        color = torch.where((tex_id >= 0)[:, None],
                            tex_lookup_nearest(textures, tex_id, uv), color)
    return MatParams(
        mat_type=materials.mat_type[idx], color=color,
        ks=materials.ks[idx], on_a=materials.on_a[idx],
        on_b=materials.on_b[idx], ior_in=materials.ior_in[idx],
        ior_out=materials.ior_out[idx], eta3=materials.eta[idx],
        k3=materials.k[idx],
        alphax=vm.maximum(materials.alphax[idx], 1e-4),
        alphay=vm.maximum(materials.alphay[idx], 1e-4),
        distrib=materials.distrib[idx], intensity=materials.intensity[idx],
        lambertian_only=lambertian_only, color_raw=color_raw,
        normal_tex=materials.normal_tex[idx])


# ---------------------------------------------------------------------------
# The lobes (local frame)


def _oren_nayar_f(wi, wo, color, a, b, lambertian_only: bool = False):
    """OrenNayar_f (reflection.cpp:511-543); a = 1, b = 0 is Lambertian."""
    if lambertian_only:
        return color * (a * INV_PI)[..., None]
    sin_ti = vm.sin_theta(wi)
    sin_to = vm.sin_theta(wo)
    d_cos = vm.cos_phi(wi) * vm.cos_phi(wo) + vm.sin_phi(wi) * vm.sin_phi(wo)
    max_cos = torch.where((sin_ti > 1e-4) & (sin_to > 1e-4),
                          vm.maximum(d_cos, 0.0), 0.0)
    aci = vm.abs_cos_theta(wi)
    aco = vm.abs_cos_theta(wo)
    wi_bigger = aci > aco
    sin_alpha = torch.where(wi_bigger, sin_to, sin_ti)
    tan_beta = torch.where(wi_bigger, sin_ti / vm.maximum(aci, 1e-7),
                           sin_to / vm.maximum(aco, 1e-7))
    return color * ((a + b * max_cos * sin_alpha * tan_beta)
                    * INV_PI)[..., None]


def _cos_hemisphere_pdf(wi, wo):
    """cosHemispherePdf (reflection.cpp:6-17)."""
    return torch.where(vm.same_hemisphere(wi, wo),
                       vm.abs_cos_theta(wi) * INV_PI, 0.0)


def _fb_diffuse_f(wi, wo, kd, ks):
    """FresnelBlendDiffuse_f (reflection.cpp:484-496)."""
    def p5(v):
        return (v * v) * (v * v) * v

    scale = ((28.0 / (23.0 * PI))
             * (1.0 - p5(1.0 - 0.5 * vm.abs_cos_theta(wi)))
             * (1.0 - p5(1.0 - 0.5 * vm.abs_cos_theta(wo))))
    return kd * (1.0 - ks) * scale[..., None]


def _fb_specular_f(wi, wo, ks, ax, ay, dist):
    """FresnelBlendSpecular_f (reflection.cpp:527-543)."""
    wh = wi + wo
    degenerate = vm.length_sq(wh) < 1e-16
    wh = vm.normalize(wh)
    cos_wh = vm.dot(wi, wh)
    fres = schlick_fresnel(cos_wh, ks)
    denom = 4.0 * torch.abs(cos_wh) * vm.maximum(
        torch.maximum(vm.abs_cos_theta(wi), vm.abs_cos_theta(wo)), 1e-7)
    f = fres * (mf.distribution_d(wh, ax, ay, dist)
                / vm.maximum(denom, 1e-12))[..., None]
    return torch.where(degenerate[..., None], 0.0, f)


def _fb_specular_pdf(wi, wo, ax, ay, dist):
    """FresnelBlendSpecular_pdf, the reference's D / (2 wo.wh)
    (reflection.cpp:545-555)."""
    wh = vm.normalize(wi + wo)
    pdf = mf.distribution_d(wh, ax, ay, dist) / vm.maximum(
        2.0 * vm.dot(wo, wh), 1e-7)
    return torch.where(vm.same_hemisphere(wi, wo), pdf, 0.0)


def _metal_f(wi, wo, color, eta3, k3, ax, ay, dist):
    """MicrofacetReflection_f, conductor branch (reflection.cpp:289-328)."""
    aci = vm.abs_cos_theta(wi)
    aco = vm.abs_cos_theta(wo)
    wh = wi + wo
    degenerate = (vm.length_sq(wh) < 1e-16) | (aci < 1e-7) | (aco < 1e-7)
    wh = vm.normalize(wh)
    fres = fr_conductor_rgb(vm.dot(wi, wh), eta3, torch.ones_like(eta3), k3)
    scale = (mf.distribution_d(wh, ax, ay, dist)
             * mf.distribution_g(wo, wi, ax, ay, dist)
             / vm.maximum(4.0 * aci * aco, 1e-12))
    return torch.where(degenerate[..., None], 0.0,
                       color * fres * scale[..., None])


def _metal_pdf(wi, wo, ax, ay, dist):
    """MicrofacetReflection_pdf (reflection.cpp:346-353)."""
    wh = vm.normalize(wi + wo)
    pdf = mf.distribution_pdf(wo, wh, ax, ay, dist) / vm.maximum(
        4.0 * vm.dot(wo, wh), 1e-7)
    return torch.where(vm.same_hemisphere(wi, wo), pdf, 0.0)


def _glass_refl_f(wi, wo, color, ior_in, ior_out, ax, ay, dist):
    """Glass reflection: MicrofacetReflection_f's dielectric branch with
    the reference's 1 - Fr(wh, wi) (reflection.cpp:303-316)."""
    aci = vm.abs_cos_theta(wi)
    aco = vm.abs_cos_theta(wo)
    wh = wi + wo
    degenerate = (vm.length_sq(wh) < 1e-16) | (aci < 1e-7) | (aco < 1e-7)
    wh = vm.normalize(wh)
    kr = 1.0 - fr_dielectric(vm.dot(wh, wi), ior_in, ior_out)
    scale = (mf.distribution_d(wh, ax, ay, dist)
             * mf.distribution_g(wo, wi, ax, ay, dist)
             / vm.maximum(4.0 * aci * aco, 1e-12))
    return torch.where(degenerate[..., None], 0.0,
                       color * (kr * scale)[..., None])


def _glass_trans_f(wi, wo, color, ior_in, ior_out, ax, ay, dist):
    """MicrofacetFresnel_f's transmission term (reflection.cpp:356-388)."""
    not_trans = vm.same_hemisphere(wi, wo)
    cto = vm.cos_theta(wo)
    cti = vm.cos_theta(wi)
    eta = torch.where(cto > 0.0, ior_in / ior_out, ior_out / ior_in)
    wh = vm.normalize(wo + wi * eta[..., None])
    wh = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    fr = fr_dielectric(vm.dot(wh, wo), ior_in, ior_out)
    sqrt_denom = vm.dot(wo, wh) + eta * vm.dot(wi, wh)
    denom = cti * cto * sqrt_denom * sqrt_denom
    num = (mf.distribution_d(wh, ax, ay, dist)
           * mf.distribution_g(wo, wi, ax, ay, dist)
           * torch.abs(vm.dot(wi, wh)) * torch.abs(vm.dot(wo, wh)))
    f = color * ((1.0 - fr) * torch.abs(num / vm._safe(denom)))[..., None]
    bad = not_trans | (torch.abs(cti) < 1e-7) | (torch.abs(cto) < 1e-7)
    return torch.where(bad[..., None], 0.0, f)


def _glass_trans_pdf(wi, wo, ior_in, ior_out, ax, ay, dist):
    """MicrofacetFresnel_pdf (reflection.cpp:449-462)."""
    not_trans = vm.same_hemisphere(wi, wo)
    eta = torch.where(vm.cos_theta(wo) > 0.0, ior_in / ior_out,
                      ior_out / ior_in)
    wh = vm.normalize(wo + wi * eta[..., None])
    sqrt_denom = vm.dot(wo, wh) + eta * vm.dot(wi, wh)
    dwh_dwi = torch.abs(eta * eta * vm.dot(wi, wh)) / vm.maximum(
        sqrt_denom * sqrt_denom, 1e-12)
    pdf = mf.distribution_pdf(wo, wh, ax, ay, dist) * dwh_dwi
    return torch.where(not_trans, 0.0, pdf)


# ---------------------------------------------------------------------------
# The BSDF, masked across material types


def _use(present, *codes) -> bool:
    """Static lobe gate: `present` is the scene's mat_types_present
    (empty or None: every lobe)."""
    return not present or any(c in present for c in codes)


def _sel(mask, val, acc):
    """`val` on the lanes of `mask`, `acc` elsewhere ([N] or [N, 3])."""
    if acc.dim() > mask.dim():
        mask = mask[..., None]
    return torch.where(mask, val, acc)


def bsdf_f_direct(wi, wo, mp: MatParams, present=None):
    """BSDF_f without the specular and glossy lobes, the NEE evaluation
    (estimateDirect, trace.h:328; exclusions trace.h:410): MATTE's
    Oren-Nayar and PLASTIC's FresnelBlend diffuse."""
    f = torch.zeros_like(wi)
    if _use(present, T.MAT_MATTE):
        f = _sel(mp.mat_type == T.MAT_MATTE,
                 _oren_nayar_f(wi, wo, mp.color, mp.on_a, mp.on_b,
                               mp.lambertian_only), f)
    if _use(present, T.MAT_PLASTIC):
        f = _sel(mp.mat_type == T.MAT_PLASTIC,
                 _fb_diffuse_f(wi, wo, mp.color, mp.ks), f)
    return f


def bsdf_f_nodelta(wi, wo, mp: MatParams, present=None):
    """Every finite lobe, glossy included (the MIS estimator's NEE
    evaluation); glass reflection weighted by Fr, not the 1 - Fr quirk."""
    f = torch.zeros_like(wi)
    mt = mp.mat_type
    if _use(present, T.MAT_MATTE):
        f = _sel(mt == T.MAT_MATTE,
                 _oren_nayar_f(wi, wo, mp.color, mp.on_a, mp.on_b,
                               mp.lambertian_only), f)
    if _use(present, T.MAT_PLASTIC):
        f = _sel(mt == T.MAT_PLASTIC,
                 _fb_diffuse_f(wi, wo, mp.color, mp.ks)
                 + _fb_specular_f(wi, wo, mp.ks, mp.alphax, mp.alphay,
                                  mp.distrib), f)
    if _use(present, T.MAT_METAL):
        f = _sel(mt == T.MAT_METAL,
                 _metal_f(wi, wo, torch.ones_like(mp.color), mp.eta3, mp.k3,
                          mp.alphax, mp.alphay, mp.distrib), f)
    if _use(present, T.MAT_GLASS):
        white = torch.ones_like(mp.color)
        wh_r = vm.normalize(wi + wo)
        fr_r = fr_dielectric(vm.dot(wh_r, wo), mp.ior_in, mp.ior_out)
        f_gr = _glass_refl_f(wi, wo, white, mp.ior_in, mp.ior_out,
                             mp.alphax, mp.alphay, mp.distrib)
        quirk = 1.0 - fr_dielectric(vm.dot(wh_r, wi), mp.ior_in, mp.ior_out)
        f_gr = f_gr * (fr_r / vm.maximum(quirk, 1e-6))[..., None]
        f_gt = _glass_trans_f(wi, wo, white, mp.ior_in, mp.ior_out,
                              mp.alphax, mp.alphay, mp.distrib)
        f = _sel(mt == T.MAT_GLASS,
                 _sel(vm.same_hemisphere(wi, wo), f_gr, f_gt), f)
    return f


def _glass_pdf_mixture(wi, wo, mp: MatParams):
    """Glass's density under the Fresnel branch choice: kr p_refl on
    wo's side, (1 - kr) p_trans across."""
    wh_r = vm.normalize(wi + wo)
    kr_r = fr_dielectric(vm.dot(wh_r, wo), mp.ior_in, mp.ior_out)
    pdf_r = mf.distribution_pdf(wo, wh_r, mp.alphax, mp.alphay,
                                mp.distrib) / vm.maximum(
        4.0 * vm.dot(wo, wh_r), 1e-7)
    eta = torch.where(vm.cos_theta(wo) > 0.0, mp.ior_in / mp.ior_out,
                      mp.ior_out / mp.ior_in)
    wh_t = vm.normalize(wo + wi * eta[..., None])
    kr_t = fr_dielectric(vm.dot(wh_t, wo), mp.ior_in, mp.ior_out)
    pdf_t = _glass_trans_pdf(wi, wo, mp.ior_in, mp.ior_out, mp.alphax,
                             mp.alphay, mp.distrib)
    return torch.where(vm.same_hemisphere(wi, wo), kr_r * pdf_r,
                       (1.0 - kr_t) * pdf_t)


def _pdf(wi, wo, mp: MatParams, present, balanced: bool):
    pdf = torch.zeros(wi.shape[:-1], dtype=wi.dtype, device=wi.device)
    mt = mp.mat_type
    if _use(present, T.MAT_MATTE):
        pdf = _sel(mt == T.MAT_MATTE, _cos_hemisphere_pdf(wi, wo), pdf)
    if _use(present, T.MAT_PLASTIC):
        p = _cos_hemisphere_pdf(wi, wo) + _fb_specular_pdf(
            wi, wo, mp.alphax, mp.alphay, mp.distrib)
        pdf = _sel(mt == T.MAT_PLASTIC, 0.5 * p if balanced else p, pdf)
    if _use(present, T.MAT_METAL):
        pdf = _sel(mt == T.MAT_METAL,
                   _metal_pdf(wi, wo, mp.alphax, mp.alphay, mp.distrib), pdf)
    if _use(present, T.MAT_GLASS):
        p = (_glass_pdf_mixture(wi, wo, mp) if balanced else
             _glass_trans_pdf(wi, wo, mp.ior_in, mp.ior_out, mp.alphax,
                              mp.alphay, mp.distrib))
        pdf = _sel(mt == T.MAT_GLASS, p, pdf)
    return pdf


def bsdf_pdf_balanced(wi, wo, mp: MatParams, present=None):
    """The one-sample mixture density of bsdf_sample(balanced=True):
    PLASTIC averages its two lobes (the reference sums them)."""
    return _pdf(wi, wo, mp, present, balanced=True)


def bsdf_pdf(wi, wo, mp: MatParams, present=None):
    """BSDF_pdf, the sum of the lobe pdfs (reflection.cpp:737-748)."""
    return _pdf(wi, wo, mp, present, balanced=False)


def bsdf_sample(u, wo, mp: MatParams, balanced: bool = False, present=None):
    """BSDF_sample_f (reflection.cpp:750-811) for the hit queue. `u` is
    [N, 3]: lobe select / sample x, sample y, and the Fresnel branch's
    extra uniform. `balanced` reports the MIS estimator's mixture
    densities (and glass reflection weighted by Fr); False reports the
    reference's values. Returns (f [N, 3], wi [N, 3], pdf [N],
    is_specular [N], is_glossy [N])."""
    mtype = mp.mat_type
    u2 = u[:, :2]
    r_extra = u[:, 2]
    f = torch.zeros_like(wo)
    wi = torch.zeros_like(wo)
    wi[:, 2] = 1.0
    pdf = torch.zeros(wo.shape[:-1], dtype=wo.dtype, device=wo.device)
    is_specular = torch.zeros(wo.shape[:-1], dtype=torch.bool,
                              device=wo.device)
    is_glossy = is_specular

    def take(code, val_f, val_wi, val_pdf):
        nonlocal f, wi, pdf
        m = mtype == code
        f, wi, pdf = _sel(m, val_f, f), _sel(m, val_wi, wi), \
            _sel(m, val_pdf, pdf)

    if _use(present, T.MAT_MATTE):
        # OrenNayar_sample_f (reflection.cpp:550-562): a cosine hemisphere
        # on the positive side, f with the original wo
        wi_m = map_to_hemisphere_cosine(u2)
        take(T.MAT_MATTE, _oren_nayar_f(wi_m, wo, mp.color, mp.on_a, mp.on_b,
                                        mp.lambertian_only),
             wi_m, vm.abs_cos_theta(wi_m) * INV_PI)

    if _use(present, T.MAT_MIRROR):
        # SpecularReflection_sample_f (reflection.cpp:240-247)
        wi_r = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], dim=-1)
        take(T.MAT_MIRROR, mp.color / vm.maximum(
            vm.abs_cos_theta(wi_r), 1e-7)[..., None], wi_r,
            torch.ones_like(pdf))
        is_specular = is_specular | (mtype == T.MAT_MIRROR)

    if _use(present, T.MAT_TRANSPARENT):
        # SpecularTransmission_sample_f, thin (reflection.cpp:250-282)
        kr = fr_dielectric(torch.abs(wo[:, 2]), mp.ior_in, mp.ior_out)
        refl = r_extra <= kr
        wi_t = torch.where(refl[:, None],
                           torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]],
                                       dim=-1), -wo)
        eta = mp.ior_out / mp.ior_in
        mag = torch.where(refl, kr, (1.0 - kr) * eta * eta) / vm.maximum(
            vm.abs_cos_theta(wi_t), 1e-7)
        take(T.MAT_TRANSPARENT, mag[:, None].expand_as(wo), wi_t,
             torch.where(refl, kr, 1.0 - kr))
        is_specular = is_specular | (mtype == T.MAT_TRANSPARENT)

    if _use(present, T.MAT_PLASTIC):
        # two lobes, a uniform pick with the sample remapped
        # (reflection.cpp:760-766), then both lobes' f and pdf summed
        # (:789-811)
        ax, ay, dist = mp.alphax, mp.alphay, mp.distrib
        pick_spec = u2[:, 0] >= 0.5
        u_remap = vm.clip(torch.stack(
            [torch.where(pick_spec, 2.0 * (u2[:, 0] - 0.5), 2.0 * u2[:, 0]),
             u2[:, 1]], dim=-1), 0.0, 1.0 - 1e-7)
        wi_pd = map_to_hemisphere_cosine(u_remap)
        flip = torch.tensor([1.0, 1.0, -1.0], dtype=wo.dtype,
                            device=wo.device)
        wi_pd = torch.where((wo[:, 2] < 0.0)[:, None], wi_pd * flip, wi_pd)
        wi_ps = vm.reflect(wo, mf.sample_wh(wo, u_remap, ax, ay, dist))
        ps_ok = vm.same_hemisphere(wo, wi_ps)
        wi_p = torch.where(pick_spec[:, None], wi_ps, wi_pd)
        spec_pdf = _fb_specular_pdf(wi_p, wo, ax, ay, dist)
        cos_pdf = _cos_hemisphere_pdf(wi_p, wo)
        pdf_chosen = torch.where(pick_spec,
                                 torch.where(ps_ok, spec_pdf, 0.0), cos_pdf)
        pdf_other = torch.where(pick_spec, cos_pdf, spec_pdf)
        alive_p = pdf_chosen > 0.0
        f_p = (_fb_diffuse_f(wi_p, wo, mp.color, mp.ks)
               + _fb_specular_f(wi_p, wo, mp.ks, ax, ay, dist))
        pdf_p = torch.where(alive_p, pdf_chosen + pdf_other, 0.0)
        if balanced:
            pdf_p = 0.5 * pdf_p
        take(T.MAT_PLASTIC, torch.where(alive_p[:, None], f_p, 0.0), wi_p,
             pdf_p)
        is_glossy = is_glossy | ((mtype == T.MAT_PLASTIC) & pick_spec)

    if _use(present, T.MAT_METAL):
        # MicrofacetReflection_sample_f (reflection.cpp:329-344)
        ax, ay, dist = mp.alphax, mp.alphay, mp.distrib
        wh = mf.sample_wh(wo, u2, ax, ay, dist)
        wi_mt = vm.reflect(wo, wh)
        ok = vm.same_hemisphere(wo, wi_mt)
        f_mt = _metal_f(wi_mt, wo, torch.ones_like(mp.color), mp.eta3,
                        mp.k3, ax, ay, dist)
        pdf_mt = mf.distribution_pdf(wo, wh, ax, ay, dist) / vm.maximum(
            4.0 * vm.dot(wo, wh), 1e-7)
        take(T.MAT_METAL, torch.where(ok[:, None], f_mt, 0.0), wi_mt,
             torch.where(ok, pdf_mt, 0.0))
        is_glossy = is_glossy | (mtype == T.MAT_METAL)

    if _use(present, T.MAT_GLASS):
        # MicrofacetFresnel_sample_f (reflection.cpp:390-446)
        ax, ay, dist = mp.alphax, mp.alphay, mp.distrib
        white = torch.ones_like(mp.color)
        wh = mf.sample_wh(wo, u2, ax, ay, dist)
        kr = fr_dielectric(vm.dot(wh, wo), mp.ior_in, mp.ior_out)
        g_refl = r_extra <= kr
        # reflection branch
        wi_gr = vm.reflect(wo, wh)
        gr_ok = vm.same_hemisphere(wo, wi_gr)
        f_gr = _glass_refl_f(wi_gr, wo, white, mp.ior_in, mp.ior_out,
                             ax, ay, dist)
        if balanced:
            wh_r = vm.normalize(wi_gr + wo)
            quirk = 1.0 - fr_dielectric(vm.dot(wh_r, wi_gr), mp.ior_in,
                                        mp.ior_out)
            fr_r = fr_dielectric(vm.dot(wh_r, wo), mp.ior_in, mp.ior_out)
            f_gr = f_gr * (fr_r / vm.maximum(quirk, 1e-6))[:, None]
        pdf_gr = mf.distribution_pdf(wo, wh, ax, ay, dist) / vm.maximum(
            4.0 * vm.dot(wo, wh), 1e-7)
        if balanced:
            pdf_gr = kr * pdf_gr
        f_gr = torch.where(gr_ok[:, None], f_gr, 0.0)
        pdf_gr = torch.where(gr_ok, pdf_gr, 0.0)
        # transmission branch
        eta = torch.where(vm.cos_theta(wo) > 0.0, mp.ior_out / mp.ior_in,
                          mp.ior_in / mp.ior_out)
        wh_face = torch.where(vm.dot(wh, wo)[..., None] < 0.0, -wh, wh)
        gt_ok, wi_gt = vm.refract(wo, wh_face, eta)
        f_gt = _glass_trans_f(wi_gt, wo, white, mp.ior_in, mp.ior_out,
                              ax, ay, dist)
        pdf_gt = _glass_trans_pdf(wi_gt, wo, mp.ior_in, mp.ior_out,
                                  ax, ay, dist)
        if balanced:
            pdf_gt = (1.0 - kr) * pdf_gt
        f_gt = torch.where(gt_ok[:, None], f_gt, 0.0)
        pdf_gt = torch.where(gt_ok, pdf_gt, 0.0)
        take(T.MAT_GLASS, torch.where(g_refl[:, None], f_gr, f_gt),
             torch.where(g_refl[:, None], wi_gr, wi_gt),
             torch.where(g_refl, pdf_gr, pdf_gt))
        is_glossy = is_glossy | (mtype == T.MAT_GLASS)

    return f, wi, pdf, is_specular, is_glossy
