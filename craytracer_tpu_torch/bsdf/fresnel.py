"""Fresnel terms (counterpart of craytracer_tpu/bsdf/fresnel.py
`fr_dielectric` :12, `fr_conductor` :32 and `schlick_fresnel` :54).

`fr_dielectric` is elementwise, so it serves both the kernels' per-lane
scalars (pallas_shade.py `_fr_dielectric` :204) and the general route's
vectors. `fr_conductor` is the per-channel form with eta_i = 1
(pallas_shade.py `_fr_conductor_c` :221) that the "shade" route calls;
`fr_conductor_rgb` is the JAX [..., 3] signature, the same arithmetic
(k / eta_i and eta_t / eta_i are exact at eta_i = 1). Same expression
trees and epsilons as the JAX helpers and csrc/shade_core.cuh."""

from __future__ import annotations

import torch

from craytracer_tpu_torch.core import math as vm


def fr_dielectric(cos_theta_i, eta_t, eta_i):
    """Unpolarized dielectric reflectance (calcFresnelDielectric,
    reflection.cpp:52-76): the IORs swap when the ray arrives from inside
    (cos < 0); total internal reflection gives 1."""
    flip = cos_theta_i < 0.0
    ei = torch.where(flip, eta_t, eta_i)
    et = torch.where(flip, eta_i, eta_t)
    ci = torch.abs(cos_theta_i)
    sin_i = torch.sqrt(vm.maximum(1.0 - ci * ci, 1e-12))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    ct = torch.sqrt(vm.maximum(1.0 - sin_t * sin_t, 1e-12))
    r_parl = (et * ci - ei * ct) / vm.maximum(et * ci + ei * ct, 1e-12)
    r_perp = (ei * ci - et * ct) / vm.maximum(ei * ci + et * ct, 1e-12)
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def fr_conductor(c, eta, k):
    """Conductor reflectance of one channel (calcFresnelConductor,
    reflection.cpp:78-157, PBRT form) with eta_i = 1."""
    cc = vm.clip(c, -1.0, 1.0)
    c2 = cc * cc
    s2 = 1.0 - c2
    eta2 = eta * eta
    etak2 = k * k
    t0 = eta2 - etak2 - s2
    a2b2 = torch.sqrt(vm.maximum(t0 * t0 + 4.0 * eta2 * etak2, 1e-12))
    t1 = a2b2 + c2
    a = torch.sqrt(vm.maximum(0.5 * (a2b2 + t0), 1e-12))
    t2 = 2.0 * cc * a
    rs = (t1 - t2) / vm.maximum(t1 + t2, 1e-12)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / vm.maximum(t3 + t4, 1e-12)
    return 0.5 * (rp + rs)


def fr_conductor_rgb(cos_theta_i, eta_t, eta_i, k):
    """RGB conductor reflectance: `eta_t`, `eta_i`, `k` [..., 3],
    cos_theta_i [...]."""
    return fr_conductor(cos_theta_i[..., None], eta_t / eta_i, k / eta_i)


def schlick_fresnel(cos_theta, rs):
    """Schlick's approximation (reflection.cpp:466-482); rs [..., 3].
    (1 - cos)^5 as XLA lowers it: x * (x^2 * x^2)."""
    x = 1.0 - cos_theta
    x2 = x * x
    return rs + (x * (x2 * x2))[..., None] * (1.0 - rs)
