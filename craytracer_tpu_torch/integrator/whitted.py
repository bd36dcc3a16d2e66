"""Raycast and Whitted integrators (counterpart of
craytracer_tpu/integrator/whitted.py: `trace_whitted` :31,
`trace_raycast` :106).

The reference declares the RAYCAST and WHITTED trace types
(trace.h:17-23) but ships their dispatch commented out (trace.h:48-73);
the JAX package gives them working wavefront forms, ported here:

* raycast: the first hit's emission plus a sum over EVERY light with a
  shadow test (the classic ray-casting estimator);
* whitted: raycast plus perfect-specular continuation through MIRROR,
  TRANSPARENT and GLASS, the Fresnel branch drawn per lane.

Each light's sample draws its own counter-RNG dimensions (16 + 2 k at
each bounce), the specular sample the path tracer's BSDF dimensions.
Like the JAX functions they evaluate the BSDF on LOCAL vectors and
return L alone. Neither has a kernel of its own (the JAX package keeps
them off its Pallas kernels, pallas_shade.py:1505); with `kernels` on the
card a bvh4 mesh's closest hit goes through K3 and its shadow any hit
through K4 (ops/intersect.py)."""

from __future__ import annotations

import torch

from craytracer_tpu_torch.bsdf.bxdf import (bsdf_f_direct, bsdf_sample,
                                            gather_params)
from craytracer_tpu_torch.constants import K_EPSILON
from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.integrator.wavefront import _offset_ray
from craytracer_tpu_torch.lights.lights import (env_radiance, env_transform,
                                                sample_light_index)
from craytracer_tpu_torch.ops.intersect import (intersect_scene,
                                                shadow_distance)
from craytracer_tpu_torch.sampling.rng import uniforms
from craytracer_tpu_torch.scene import types as T

_DIM_LIGHT = 0  # the path tracer's RNG layout (wavefront.py:37-41)
_DIM_BSDF = 5


@torch.no_grad()
def trace_whitted(scene: T.Scene, origin, direction, seed: int, pixel_ids,
                  spp_index, max_depth: int,
                  specular_continuation: bool = True, kernels: bool = False):
    """L [N, 3]. `specular_continuation=False` gives raycast (one
    bounce)."""
    n = origin.shape[0]
    num_lights = scene.lights.light_type.shape[0]
    mats = scene.materials
    o, d = origin, direction
    beta = torch.ones((n, 3), dtype=origin.dtype, device=origin.device)
    L = torch.zeros_like(beta)
    alive = torch.ones((n,), dtype=torch.bool, device=origin.device)
    for bounce in range((max_depth + 1) if specular_continuation else 1):
        hit = intersect_scene(scene, o, d, kernels=kernels)
        miss = ~hit.hit_mask
        mat_type = mats.mat_type[hit.mat_id.long()]
        emissive_hit = hit.hit_mask & (mat_type == T.MAT_EMISSIVE)
        env_li = env_radiance(scene.env, scene.textures,
                              env_transform(scene.env, d))
        L = L + torch.where((alive & miss)[:, None], beta * env_li, 0.0)
        e_color = mats.color[hit.mat_id.long()]
        e_int = mats.intensity[hit.mat_id.long()]
        L = L + torch.where((alive & emissive_hit)[:, None],
                            beta * e_color * e_int[:, None], 0.0)

        cont = alive & hit.hit_mask & ~emissive_hit
        ft, fb, fn = vm.make_shading_frame(hit.normal, hit.dpdu)
        mp = gather_params(mats, scene.textures, hit.mat_id, hit.uv,
                           lambertian_only=scene.matte_lambertian)
        wo_local = vm.to_local(-d, ft, fb, fn)

        # direct lighting: a deterministic sum over every light
        for li_idx in range(num_lights):
            u2 = uniforms(seed, pixel_ids, spp_index, bounce, 2,
                          _DIM_LIGHT + 16 + 2 * li_idx)
            idx = torch.full((n,), li_idx, dtype=torch.int64,
                             device=o.device)
            ls = sample_light_index(scene, idx, u2, hit.point, fn, ft, fb)
            wi_l = vm.to_local(ls.wi, ft, fb, fn)
            f = bsdf_f_direct(wi_l, wo_local, mp) * torch.abs(
                vm.dot(fn, ls.wi))[:, None]
            want = cont & ls.valid & (f > 0.0).any(dim=-1)
            so = _offset_ray(hit.point, hit.normal, ls.wi)
            # the offset-adjusted bound of the path tracer's shadow test
            d_adj = ls.distance - vm.dot(so - hit.point, ls.wi)
            t_sh = shadow_distance(scene, so, ls.wi, d_adj, kernels=kernels)
            lit = t_sh >= d_adj - vm.maximum(1e-3 * d_adj, K_EPSILON)
            L = L + torch.where(
                (want & lit)[:, None],
                beta * f * ls.li / vm.maximum(ls.pdf, 1e-12)[:, None], 0.0)

        if not specular_continuation:
            break
        # specular continuation only (mirror, transparent, glass)
        u_b = uniforms(seed, pixel_ids, spp_index, bounce, 3, _DIM_BSDF)
        f_s, wi_local, pdf_s, is_spec, _ = bsdf_sample(u_b, wo_local, mp)
        spec = cont & (is_spec | (mat_type == T.MAT_GLASS))
        wi_world = vm.to_world(wi_local, ft, fb, fn)
        weight = f_s * (torch.abs(vm.dot(wi_world, fn))
                        / vm.maximum(pdf_s, 1e-12))[:, None]
        beta = torch.where(spec[:, None], beta * weight, beta)
        alive = spec & (pdf_s > 0.0) & (bounce < max_depth)
        o = torch.where(spec[:, None],
                        _offset_ray(hit.point, hit.normal, wi_world), o)
        d = torch.where(spec[:, None], wi_world, d)
    return L


def trace_raycast(scene: T.Scene, origin, direction, seed: int, pixel_ids,
                  spp_index, kernels: bool = False):
    return trace_whitted(scene, origin, direction, seed, pixel_ids,
                         spp_index, max_depth=0, specular_continuation=False,
                         kernels=kernels)
