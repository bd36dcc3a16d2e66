"""Microfacet distributions, in two forms.

The component helpers serve the "shade" route: the isotropic-Beckmann
distribution and the Oren-Nayar and FresnelBlend diffuse scales
(counterpart of craytracer_tpu/integrator/pallas_shade.py :113-201:
`_lf_sin_theta`, `_lf_cos_phi`, `_lf_sin_phi`, `_on_scale`,
`_fb_diffuse_scale`, `_d_beckmann`, `_lambda_beckmann`,
`_sample_wh_beckmann`), which csrc/shade_core.cuh repeats line for line.

The general forms serve the general route (bsdf/bxdf.py): Beckmann and
Trowbridge-Reitz, isotropic or anisotropic, per-lane (alphax, alphay,
distrib) on [N, 3] local directions (counterpart of
craytracer_tpu/bsdf/microfacet.py `distribution_d` :23,
`distribution_lambda` :47, `distribution_g1` :79, `distribution_g` :83,
`sample_wh` :89, `distribution_pdf` :122), each with the 1e-4 alpha clamp
and the double-`where` that sanitizes masked lanes' inputs.

Every function keeps the JAX helper's expression tree and epsilons.
Integer powers are written as products in the order XLA lowers `x ** n`
(x^2 = x*x, x^4 = x^2 * x^2, x^5 = x * x^4), since `torch.pow` rounds
differently.
"""

from __future__ import annotations

import torch

from craytracer_tpu_torch.constants import INV_PI, PI, TWO_PI
from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.core.math import _safe
from craytracer_tpu_torch.scene.types import DIST_BECKMANN


def lf_sin_theta(z):
    return torch.sqrt(torch.clamp(torch.clamp(1.0 - z * z, min=0.0),
                                  min=1e-16))


def lf_cos_phi(x, z):
    s = lf_sin_theta(z)
    return torch.where(s < 1e-6, 1.0, torch.clamp(x / _safe(s), -1.0, 1.0))


def lf_sin_phi(y, z):
    s = lf_sin_theta(z)
    return torch.where(s < 1e-6, 0.0, torch.clamp(y / _safe(s), -1.0, 1.0))


def on_scale(wix, wiy, wiz, wox, woy, woz, a, b):
    """Oren-Nayar's scalar factor (a + b max_cos sin_a tan_b) / pi
    (OrenNayar_f, reflection.cpp:511-543)."""
    sin_ti = lf_sin_theta(wiz)
    sin_to = lf_sin_theta(woz)
    d_cos = (lf_cos_phi(wix, wiz) * lf_cos_phi(wox, woz)
             + lf_sin_phi(wiy, wiz) * lf_sin_phi(woy, woz))
    max_cos = torch.where((sin_ti > 1e-4) & (sin_to > 1e-4),
                          torch.clamp(d_cos, min=0.0), 0.0)
    aci = torch.abs(wiz)
    aco = torch.abs(woz)
    wi_bigger = aci > aco
    sin_alpha = torch.where(wi_bigger, sin_to, sin_ti)
    tan_beta = torch.where(wi_bigger, sin_ti / torch.clamp(aci, min=1e-7),
                           sin_to / torch.clamp(aco, min=1e-7))
    return (a + b * max_cos * sin_alpha * tan_beta) * INV_PI


def fb_diffuse_scale(wiz, woz):
    """FresnelBlend's diffuse scale 28/(23 pi) (1 - (1 - |cos_i|/2)^5)
    (1 - (1 - |cos_o|/2)^5) (reflection.cpp:602-618); multiply by
    kd (1 - ks) per channel."""
    def p5(v):
        return (v * v) * (v * v) * v

    return ((28.0 / (23.0 * PI))
            * (1.0 - p5(1.0 - 0.5 * torch.abs(wiz)))
            * (1.0 - p5(1.0 - 0.5 * torch.abs(woz))))


def d_beckmann(whx, why, whz, ax):
    """D(wh), isotropic Beckmann (microfacet.cpp:4-31)."""
    a = torch.clamp(ax, min=1e-4)
    c2 = whz * whz
    t2 = torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-6)
    c4 = c2 * c2
    cp = lf_cos_phi(whx, whz)
    sp = lf_sin_phi(why, whz)
    c2p = cp * cp
    s2p = sp * sp
    finite = c4 > 1e-16
    t2 = torch.where(finite, t2, 0.0)
    c4 = torch.where(finite, c4, 1.0)
    d = torch.exp(-t2 * (c2p / (a * a) + s2p / (a * a))) / (PI * a * a * c4)
    return torch.where(finite, d, 0.0)


def lambda_beckmann(wx, wy, wz, ax):
    """Lambda(w), Beckmann's rational approximation with the a >= 1.6
    cutoff (microfacet.cpp:33-66)."""
    a_cl = torch.clamp(ax, min=1e-4)
    c = torch.where(torch.abs(wz) < 1e-3,
                    torch.where(wz < 0.0, -1e-3, 1e-3), wz)
    abs_tan = torch.abs(lf_sin_theta(wz) / c)
    cp = lf_cos_phi(wx, wz)
    sp = lf_sin_phi(wy, wz)
    c2p = cp * cp
    s2p = sp * sp
    alpha = torch.sqrt(torch.clamp(c2p * a_cl * a_cl + s2p * a_cl * a_cl,
                                   min=1e-12))
    ar = 1.0 / torch.clamp(alpha * abs_tan, min=1e-16)
    a_c = torch.clamp(ar, max=1.6)
    return torch.where(
        ar >= 1.6, 0.0,
        (1.0 - 1.259 * a_c + 0.396 * a_c * a_c)
        / (3.535 * a_c + 2.181 * a_c * a_c))


def sample_wh_beckmann(wox, woy, woz, u0, u1, ax):
    """A Beckmann half-vector, flipped to wo's side (sample_wh,
    microfacet.cpp:77-135, isotropic)."""
    a = torch.clamp(ax, min=1e-4)
    log_u = torch.log(torch.clamp(u0, min=1e-30))
    t2 = -a * a * log_u
    phi = u1 * TWO_PI
    cos_t = 1.0 / torch.sqrt(1.0 + t2)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12))
    whx = sin_t * torch.cos(phi)
    why = sin_t * torch.sin(phi)
    whz = cos_t
    sgn = torch.where(woz * whz > 0.0, 1.0, -1.0)
    return whx * sgn, why * sgn, whz * sgn


# ---------------------------------------------------------------------------
# The general forms


def _clamp_alpha(a):
    return vm.maximum(a, 1e-4)


def distribution_d(wh, ax, ay, dist):
    """D(wh) (microfacet.cpp:4-31)."""
    ax = _clamp_alpha(ax)
    ay = _clamp_alpha(ay)
    t2 = vm.tan2_theta(wh)
    c2 = vm.cos2_theta(wh)
    c4 = c2 * c2
    c2p = vm.cos2_phi(wh)
    s2p = vm.sin2_phi(wh)
    finite = torch.isfinite(t2) & (c4 > 1e-16)
    t2 = torch.where(finite, t2, 0.0)
    c4 = torch.where(finite, c4, 1.0)
    d_beck = torch.exp(-t2 * (c2p / (ax * ax) + s2p / (ay * ay))) / (
        PI * ax * ay * c4)
    e = (c2p / (ax * ax) + s2p / (ay * ay)) * t2
    e1 = 1.0 + e
    d_tr = 1.0 / (PI * ax * ay * c4 * (e1 * e1))
    d = torch.where(dist == DIST_BECKMANN, d_beck, d_tr)
    return torch.where(finite, d, 0.0)


def distribution_lambda(w, ax, ay, dist):
    """Lambda(w) (microfacet.cpp:33-66); Beckmann's rational
    approximation with the a >= 1.6 cutoff."""
    ax = _clamp_alpha(ax)
    ay = _clamp_alpha(ay)
    abs_tan = torch.abs(vm.tan_theta(w))
    finite = torch.isfinite(abs_tan)
    abs_tan = torch.where(finite, abs_tan, 0.0)
    alpha = torch.sqrt(vm.maximum(
        vm.cos2_phi(w) * ax * ax + vm.sin2_phi(w) * ay * ay, 1e-12))
    a = 1.0 / vm.maximum(alpha * abs_tan, 1e-16)
    a_c = vm.minimum(a, 1.6)
    lam_beck = torch.where(
        a >= 1.6, 0.0,
        (1.0 - 1.259 * a_c + 0.396 * a_c * a_c)
        / (3.535 * a_c + 2.181 * a_c * a_c))
    at = alpha * abs_tan
    lam_tr = (-1.0 + torch.sqrt(1.0 + at * at)) / 2.0
    lam = torch.where(dist == DIST_BECKMANN, lam_beck, lam_tr)
    return torch.where(finite, lam, 0.0)


def distribution_g1(w, ax, ay, dist):
    return 1.0 / (1.0 + distribution_lambda(w, ax, ay, dist))


def distribution_g(wo, wi, ax, ay, dist):
    return 1.0 / (1.0 + distribution_lambda(wo, ax, ay, dist)
                  + distribution_lambda(wi, ax, ay, dist))


def sample_wh(wo, u, ax, ay, dist):
    """A half-vector on wo's side (microfacet.cpp:77-135): isotropic and
    anisotropic Beckmann, and the Trowbridge-Reitz isotropic inversion
    tan^2 = a^2 u / (1 - u) for TR rows."""
    ax = _clamp_alpha(ax)
    ay = _clamp_alpha(ay)
    log_u = torch.log(vm.maximum(u[..., 0], 1e-30))
    log_u = torch.where(torch.isfinite(log_u), log_u, 0.0)
    iso = ax == ay
    t2_iso = -ax * ax * log_u
    phi_iso = u[..., 1] * TWO_PI
    phi_an = torch.atan(ay / ax * torch.tan(TWO_PI * u[..., 1] + 0.5 * PI))
    phi_an = torch.where(u[..., 1] > 0.5, phi_an + PI, phi_an)
    sp, cp = torch.sin(phi_an), torch.cos(phi_an)
    t2_an = -log_u / (cp * cp / (ax * ax) + sp * sp / (ay * ay))
    t2_beck = torch.where(iso, t2_iso, t2_an)
    phi = torch.where(iso, phi_iso, phi_an)
    t2_tr = ax * ax * u[..., 0] / vm.maximum(1.0 - u[..., 0], 1e-7)
    t2 = torch.where(dist == DIST_BECKMANN, t2_beck, t2_tr)
    cos_t = 1.0 / torch.sqrt(1.0 + t2)
    sin_t = torch.sqrt(vm.maximum(1.0 - cos_t * cos_t, 1e-12))
    wh = vm.spherical_direction(sin_t, cos_t, phi)
    flip = ~vm.same_hemisphere(wo, wh)
    return torch.where(flip[..., None], -wh, wh)


def distribution_pdf(wo, wh, ax, ay, dist):
    """pdf(wh) = D(wh) |cos theta_h| (microfacet.cpp:137-141)."""
    return distribution_d(wh, ax, ay, dist) * vm.abs_cos_theta(wh)
