"""Wavefront path tracer with next-event estimation, in torch ops
(counterpart of craytracer_tpu/integrator/wavefront.py: `_offset_ray`
:50, the non-fast, non-MIS branch of `_make_bounce_step` :59,
`_init_state` :394, `trace_paths` :416, `render_sample` :581).

This is the plain version of the slice: the bounce loop as one batched
computation per stage over [N] lanes with liveness masks, following the
reference estimator exactly (good_paths counting, NEE only off
non-specular lobes, termination on escape / max depth / emissive hit,
Russian roulette after bounce RR_START). No MIS, stream compaction or
remat: those wait for ROADMAP slices F and G.

`render_sample` is the production entry, the layer above K1: it runs the
whole pass through `fused_pass` (integrator/pass_kernel.py), which asks
the K1 gate (integrator/gate.py) and launches the CUDA kernel for
tensors on the card or runs this module's `trace_paths` for tensors on
the CPU.
"""

from __future__ import annotations

import torch

from craytracer_tpu_torch.bsdf.bxdf import (bsdf_f_direct, bsdf_sample,
                                            gather_params)
from craytracer_tpu_torch.constants import K_EPSILON
from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.integrator.gate import check_estimator
from craytracer_tpu_torch.lights.lights import env_radiance, sample_one_light
from craytracer_tpu_torch.ops.intersect import (intersect_scene,
                                                shadow_distance)
from craytracer_tpu_torch.sampling.rng import uniforms
from craytracer_tpu_torch.scene import types as T

# RNG dimension layout per bounce (wavefront.py:41-46).
_DIM_LIGHT = 0  # light_sample (2)
_DIM_PICK = 4  # light selection rand
_DIM_BSDF = 5  # BSDF sample (2) + fresnel-branch rand
_DIM_RR = 8  # Russian roulette rand
RR_START = 3  # Russian roulette after bounce 3 (trace.h:512-525)


def _offset_ray(point, normal, direction):
    """Nudge origins off the surface along the geometric normal, scaled to
    the local magnitude (the f32-robust replacement for the reference's
    absolute t > K_EPSILON cull)."""
    mag = vm.max3(torch.abs(point), keepdims=True)
    eps = (mag + 1.0) * 1e-4
    side = torch.where(vm.dot(direction, normal, keepdims=True) >= 0.0,
                       1.0, -1.0).to(point.dtype)
    return point + normal * eps * side


def _bounce_step(scene: T.Scene, seed: int, spp_index, max_depth: int,
                 bounce: int, state):
    """One wavefront bounce (_make_bounce_step's XLA branch)."""
    o, d, beta, L, good, alive, prev_sg, rays, shadows, live_hist, pix = state
    hit = intersect_scene(scene, o, d)
    hitm = hit.hit_mask
    miss = ~hitm
    mp = gather_params(scene.materials, hit.mat_id)
    emissive_hit = hitm & (mp.mat_type == T.MAT_EMISSIVE)

    # ---- emitted / env radiance (trace.h:419-455)
    emitted = mp.color_raw * mp.intensity[:, None]
    env_li = env_radiance(scene.env, d)
    add_cond = alive & ((bounce == 0) | prev_sg)
    add_emit = add_cond & emissive_hit
    zero3 = torch.zeros_like(L)
    L = L + torch.where(add_emit[:, None], beta * emitted, zero3)
    add_env = add_cond & miss
    L = L + torch.where(add_env[:, None], beta * env_li, zero3)
    good = good + (add_emit | add_env).to(torch.int32)

    # ---- termination (trace.h:459)
    cont = alive & hitm & ~emissive_hit & (bounce < max_depth)

    # ---- shading frame on sanitized inputs (miss lanes get +z / +x)
    up = torch.zeros_like(hit.normal)
    up[:, 2] = 1.0
    ex = torch.zeros_like(hit.dpdu)
    ex[:, 0] = 1.0
    safe_n = torch.where(hitm[:, None], hit.normal, up)
    safe_dpdu = torch.where(hitm[:, None], hit.dpdu, ex)
    ft, fb, fn = vm.make_shading_frame(safe_n, safe_dpdu)

    # ---- one 9-dim RNG call per bounce, sliced per call site
    u_all = uniforms(seed, pix, spp_index, bounce, 9, 0)

    # ---- NEE (trace.h:466-481); matte is the only NEE material here
    ls = sample_one_light(scene, u_all[:, _DIM_PICK],
                          u_all[:, _DIM_LIGHT:_DIM_LIGHT + 2], hit.point, fn)
    f_nee = bsdf_f_direct(mp) * torch.abs(vm.dot(fn, ls.wi))[:, None]
    want_shadow = (cont & ls.valid
                   & ((f_nee[:, 0] > 0.0) | (f_nee[:, 1] > 0.0)
                      | (f_nee[:, 2] > 0.0)))
    shadow_o = _offset_ray(hit.point, hit.normal, ls.wi)
    # compare against the OFFSET-ADJUSTED light distance
    dist_adj = ls.distance - vm.dot(shadow_o - hit.point, ls.wi)
    # lanes without a shadow ray shoot a far escape ray instead
    shadow_o = torch.where(want_shadow[:, None], shadow_o,
                           torch.full_like(shadow_o, 3.0e18))
    t_shadow = shadow_distance(scene, shadow_o, ls.wi)
    lit = t_shadow >= dist_adj - torch.clamp(1e-3 * dist_adj, min=K_EPSILON)
    nee_scale = f_nee * ls.li / torch.clamp(ls.pdf, min=1e-12)[:, None]
    contrib = torch.where((want_shadow & lit)[:, None], beta * nee_scale,
                          zero3)
    L = L + contrib
    good = good + ((contrib[:, 0] != 0.0) | (contrib[:, 1] != 0.0)
                   | (contrib[:, 2] != 0.0)).to(torch.int32)

    # ---- BSDF sampling (trace.h:484-496)
    f_s, wi_local, pdf_s, is_spec, is_glossy = bsdf_sample(
        u_all[:, _DIM_BSDF:_DIM_BSDF + 3], mp)
    dead_sample = (pdf_s <= 0.0) | ((f_s[:, 0] == 0.0) & (f_s[:, 1] == 0.0)
                                    & (f_s[:, 2] == 0.0))
    wi_world = vm.to_world(wi_local, ft, fb, fn)
    weight = f_s * (torch.abs(vm.dot(wi_world, fn))
                    / torch.clamp(pdf_s, min=1e-12))[:, None]
    new_beta = torch.where(cont[:, None], beta * weight, beta)

    # ---- Russian roulette (trace.h:512-525)
    u_rr = u_all[:, _DIM_RR]
    q = torch.clamp(1.0 - vm.max3(new_beta), min=0.05)
    rr_active = cont & (bounce > RR_START)
    rr_kill = rr_active & (u_rr < q)
    new_beta = torch.where((rr_active & ~rr_kill)[:, None],
                           new_beta / torch.clamp(1.0 - q, min=1e-6)[:, None],
                           new_beta)

    new_alive = cont & ~dead_sample & ~rr_kill
    # retired lanes carry a far +x escape ray
    new_o = torch.where(new_alive[:, None],
                        _offset_ray(hit.point, hit.normal, wi_world),
                        torch.full_like(o, 3.0e18))
    escape_d = torch.zeros_like(d)
    escape_d[:, 0] = 1.0
    new_d = torch.where(new_alive[:, None], wi_world, escape_d)
    new_prev_sg = torch.where(cont, is_spec | is_glossy, prev_sg)
    n_live = alive.sum()
    live_hist = live_hist.clone()
    live_hist[bounce] += n_live
    return (new_o, new_d, new_beta, L, good, new_alive, new_prev_sg,
            rays + n_live, shadows + want_shadow.sum(), live_hist, pix)


def _init_state(origin, direction, max_depth, pixel_ids):
    n = origin.shape[0]
    dev = origin.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return (origin, direction,
            torch.ones((n, 3), dtype=origin.dtype, device=dev),
            torch.zeros((n, 3), dtype=origin.dtype, device=dev),
            torch.zeros((n,), dtype=torch.int32, device=dev),
            torch.ones((n,), dtype=torch.bool, device=dev),
            torch.zeros((n,), dtype=torch.bool, device=dev),
            zero, zero,
            torch.zeros((max_depth + 1,), dtype=torch.int64, device=dev),
            torch.as_tensor(pixel_ids, device=dev).to(torch.int32))


@torch.no_grad()
def trace_paths(scene: T.Scene, origin, direction, seed: int, pixel_ids,
                spp_index, max_depth: int, with_metrics: bool = False):
    """Trace one path per lane. Returns (L[N,3], good_paths[N] int32),
    plus {rays, shadow_rays, bounce_live[depth+1]} when `with_metrics`.
    `spp_index` is an int or a per-lane [N] tensor. The caller has asked
    the K1 gate (integrator/gate.py): this is the core of K1's plain
    version and covers the same scenes."""
    state = _init_state(origin, direction, max_depth, pixel_ids)
    for bounce in range(max_depth + 1):
        state = _bounce_step(scene, seed, spp_index, max_depth, bounce,
                             state)
    L, good = state[3], state[4]
    if with_metrics:
        return L, good, {"rays": state[7], "shadow_rays": state[8],
                         "bounce_live": state[9]}
    return L, good


def render_sample(scene: T.Scene, camera, film, pixel_ids, seed: int,
                  spp_index, max_depth: int, estimator: str = "reference"):
    """One progressive pass (raygen + trace) for `pixel_ids`, through the
    K1 whole-pass route. estimator="reference" divides L by good_paths
    (trace.h:528-529); "physical" returns plain L. A scene outside the K1
    gate raises NotImplementedError naming the ROADMAP item; `fused_pass`
    asks the gate once per pass."""
    from craytracer_tpu_torch.integrator.pass_kernel import fused_pass

    check_estimator(estimator)
    L, good, _ = fused_pass(scene, camera, film, pixel_ids, spp_index, seed,
                            max_depth, raygen="strat")
    if estimator == "physical":
        return L
    norm = torch.where(good > 0, 1.0 / torch.clamp(good, min=1).to(L.dtype),
                       torch.zeros_like(L[:, 0]))
    return L * norm[:, None]
