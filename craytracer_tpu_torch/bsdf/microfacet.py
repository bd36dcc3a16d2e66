"""Local-frame BSDF helpers on component vectors: the isotropic-Beckmann
microfacet distribution, the Oren-Nayar and FresnelBlend diffuse scales
(counterpart of craytracer_tpu/integrator/pallas_shade.py :113-201:
`_lf_sin_theta`, `_lf_cos_phi`, `_lf_sin_phi`, `_on_scale`,
`_fb_diffuse_scale`, `_d_beckmann`, `_lambda_beckmann`,
`_sample_wh_beckmann`; the same functions as
craytracer_tpu/bsdf/microfacet.py and bsdf/bxdf.py `_oren_nayar_f` with
ax == ay and DIST_BECKMANN).

Every function keeps the JAX helper's expression tree and epsilons, and
csrc/shade_core.cuh repeats them line for line. Integer powers are
written as products in the order XLA lowers `x ** n` (x^2 = x*x, x^4 =
x^2 * x^2, x^5 = x * x^4), since `torch.pow` rounds differently.
"""

from __future__ import annotations

import torch

from craytracer_tpu_torch.constants import INV_PI, PI, TWO_PI
from craytracer_tpu_torch.core.math import _safe


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
