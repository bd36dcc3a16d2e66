"""Light sampling for next-event estimation (counterpart of
craytracer_tpu/lights/lights.py: constant `env_radiance` :37,
`sample_one_light` :164, `sample_light_index` :191 for rect area lights).

The power-CDF pick is searchsorted(side='right') clipped to the last row,
so a u at the CDF's final edge picks the last light, and zero-power rows
(a black env light) keep zero-width intervals and die on pick_p > 0,
exactly as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.scene import types as T


@dataclass(frozen=True)
class LightSample:
    wi: torch.Tensor  # [N, 3] direction to the light sample
    li: torch.Tensor  # [N, 3] incident radiance
    distance: torch.Tensor  # [N] shadow-ray length
    pdf: torch.Tensor  # [N] solid-angle pdf * pick probability
    valid: torch.Tensor  # [N] facing/pdf checks passed


def env_radiance(env: T.EnvLight, direction):
    """getEnvLightIncRadiance for the constant (or absent) env light."""
    if env.kind == 0:
        return torch.zeros_like(direction)
    if env.kind == 1:
        return (env.color * env.intensity).expand(direction.shape)
    raise NotImplementedError(
        "texture env lights are not ported (ROADMAP queue 1, slice E)")


def sample_one_light(scene: T.Scene, u_pick, u2, hit_point, shading_normal):
    """Pick one light by the power CDF and sample a point on it; the pdf
    already includes the pick probability (trace.h:393-396)."""
    lights = scene.lights
    n = hit_point.shape[0]
    num_lights = lights.light_type.shape[0]
    if num_lights == 0:
        z = torch.zeros((n,), dtype=hit_point.dtype, device=hit_point.device)
        return LightSample(wi=torch.zeros_like(hit_point),
                           li=torch.zeros_like(hit_point), distance=z, pdf=z,
                           valid=torch.zeros((n,), dtype=torch.bool,
                                             device=hit_point.device))
    idx = torch.clamp(torch.searchsorted(lights.power_cdf,
                                         u_pick.contiguous(), right=True),
                      0, num_lights - 1)
    pick_p = lights.power[idx]
    ls = sample_light_index(scene, idx, u2, hit_point, shading_normal)
    return LightSample(wi=ls.wi, li=ls.li, distance=ls.distance,
                       pdf=ls.pdf * torch.clamp(pick_p, min=1e-12),
                       valid=ls.valid & (pick_p > 0.0))


def sample_light_index(scene: T.Scene, idx, u2, hit_point, shading_normal):
    """Rect area-light sampling (trace.h:244-254), area -> solid-angle
    conversion (trace.h:298-309) and the facing rejections
    (trace.h:316-323). Every row is a rect light (K1's gate)."""
    lights = scene.lights
    ltype, p0, v1, v2 = (lights.light_type[idx], lights.p0[idx],
                         lights.v1[idx], lights.v2[idx])
    sn, color, intensity = (lights.normal[idx], lights.color[idx],
                            lights.intensity[idx])
    is_rect = ltype == T.LIGHT_AREA_RECT
    sp = p0 + u2[:, 0:1] * v1 + u2[:, 1:2] * v2
    pdf_area = 1.0 / torch.clamp(vm.length(v1) * vm.length(v2), min=1e-12)
    zero3 = torch.zeros_like(hit_point)
    sp = torch.where(is_rect[:, None], sp, zero3)
    sn = torch.where(is_rect[:, None], sn, zero3)
    pdf_area = torch.where(is_rect, pdf_area, torch.zeros_like(pdf_area))

    to_sample = sp - hit_point
    dist = vm.length(to_sample)
    wi = vm.normalize(to_sample)
    conv = vm.dot(to_sample, to_sample) / torch.clamp(
        torch.abs(vm.dot(sn, -wi)), min=1e-12)
    pdf = pdf_area * conv
    li = color * intensity[:, None]
    reject = ((vm.dot(to_sample, sn) > 0.0)
              | (vm.dot(to_sample, shading_normal) < 0.0))
    valid = is_rect & ~reject & (pdf > 1e-12)
    return LightSample(wi=wi, li=li, distance=dist, pdf=pdf, valid=valid)
