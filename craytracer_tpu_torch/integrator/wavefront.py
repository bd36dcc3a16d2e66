"""Wavefront path tracer with next-event estimation (counterpart of
craytracer_tpu/integrator/wavefront.py: `_offset_ray` :50, the
non-MIS `_make_bounce_step` :59 with its fast branch :97-134,
`_init_state` :394, `trace_paths` :416, `render_sample` :581).

One bounce is four stages over [N] lanes with liveness masks, exactly as
the JAX fast branch combines them: intersect (ops/intersect.py) -> shade
(K2's contract, integrator/shade_kernel.py: emitted/env add, NEE
candidate and shadow ray, BSDF sample, throughput, Russian roulette, next
ray) -> shadow_distance -> combine (the `lit` test against the
offset-adjusted light distance, then L and good_paths). With
`fast_shade=None` every stage is a plain PyTorch version, on any device:
this is K1's plain version and the plain version of the whole "shade"
route. With `fast_shade="shade"` on the card the stages go through the
kernel wrappers: K3 closest hit (bvh4 scenes, in ray_key order), K2
shade, K4 any hit (bvh4 scenes, behind a ray_key argsort); a table cut
into parts (Scene.tri_parts) takes K3 `_init` and K4 once per part. On
the CPU both values run the plain versions. No MIS, stream compaction or remat:
those wait for ROADMAP slices F and G.

`render_sample` is the production entry: it asks the gate
(integrator/gate.py) once per pass and runs the whole pass through K1
(integrator/pass_kernel.py) for "bounce" scenes, or raygen in torch ops
(stratified_jitter, the thin-lens camera's lens samples and
generate_rays, wavefront.py:624-633) and the "shade" route for the
rest.
"""

from __future__ import annotations

import torch

from craytracer_tpu_torch.camera import THINLENS, generate_rays
from craytracer_tpu_torch.constants import K_EPSILON
from craytracer_tpu_torch.integrator.gate import production_fast_shade
from craytracer_tpu_torch.integrator.shade_kernel import (
    fused_shade, fused_shade_reference)
from craytracer_tpu_torch.ops.intersect import (intersect_scene,
                                                shadow_distance)
from craytracer_tpu_torch.sampling.multijitter import (CAMERA_BOUNCE,
                                                       stratified_jitter)
from craytracer_tpu_torch.sampling.rng import uniforms
from craytracer_tpu_torch.scene import types as T


def camera_rays(camera, film, pixel_ids, seed: int, spp_index, jitter):
    """generate_rays with, for a thin-lens camera, the lens samples the
    JAX render_sample takes: CAMERA_BOUNCE dims 2-3 (wavefront.py:632)."""
    lens_u = (uniforms(seed, pixel_ids, spp_index, CAMERA_BOUNCE, 2, 2)
              if camera.camera_type == THINLENS else None)
    return generate_rays(camera, film, pixel_ids, jitter, lens_u)


def _bounce_step(scene: T.Scene, seed: int, spp_index, max_depth: int,
                 bounce: int, state, kernels: bool):
    """One wavefront bounce: intersect -> shade -> shadow -> combine."""
    o, d, beta, L, good, alive, prev_sg, rays, shadows, live_hist, pix = state
    hit = intersect_scene(scene, o, d, kernels=kernels)
    shade = fused_shade if kernels else fused_shade_reference
    out = shade(scene, d, hit, beta, alive, prev_sg, pix, spp_index, seed,
                bounce, max_depth)
    t_shadow = shadow_distance(scene, out["shadow_o"], out["shadow_d"],
                               out["dist_adj_t"], kernels=kernels)
    dadj = out["dist_adj"]
    lit = t_shadow >= dadj - torch.clamp(1e-3 * dadj, min=K_EPSILON)
    contrib = torch.where((out["want_shadow"] & lit)[:, None],
                          out["contrib_cand"], 0.0)
    L = L + out["L_add"] + contrib
    good = good + out["good_inc"] + (contrib != 0.0).any(dim=1).to(
        torch.int32)
    live_hist = live_hist.clone()
    live_hist[bounce] += alive.sum()
    return (out["new_o"], out["new_d"], out["new_beta"], L, good,
            out["new_alive"], out["new_prev_sg"], rays + alive,
            shadows + out["want_shadow"], live_hist, pix)


def _init_state(origin, direction, max_depth, pixel_ids):
    n = origin.shape[0]
    dev = origin.device
    zero = torch.zeros((n,), dtype=torch.int32, device=dev)
    return (origin, direction,
            torch.ones((n, 3), dtype=origin.dtype, device=dev),
            torch.zeros((n, 3), dtype=origin.dtype, device=dev),
            zero,
            torch.ones((n,), dtype=torch.bool, device=dev),
            torch.zeros((n,), dtype=torch.bool, device=dev),
            zero, zero,
            torch.zeros((max_depth + 1,), dtype=torch.int64, device=dev),
            torch.as_tensor(pixel_ids, device=dev).to(torch.int32)
            .contiguous())


@torch.no_grad()
def _trace(scene: T.Scene, origin, direction, seed: int, pixel_ids,
           spp_index, max_depth: int, kernels: bool):
    """trace_paths' bounce loop for a scene the gate has admitted:
    (L, good, metrics)."""
    if isinstance(spp_index, torch.Tensor) and spp_index.dim() > 0:
        spp_index = spp_index.to(device=origin.device,
                                 dtype=torch.int32).contiguous()
    state = _init_state(origin.contiguous(), direction.contiguous(),
                        max_depth, pixel_ids)
    for bounce in range(max_depth + 1):
        state = _bounce_step(scene, seed, spp_index, max_depth, bounce,
                             state, kernels=kernels)
    return state[3], state[4], {"rays": state[7].sum(),
                                "shadow_rays": state[8].sum(),
                                "bounce_live": state[9],
                                "lane_rays": state[7],
                                "lane_shadow_rays": state[8]}


def trace_paths(scene: T.Scene, origin, direction, seed: int, pixel_ids,
                spp_index, max_depth: int, with_metrics: bool = False,
                fast_shade=None):
    """Trace one path per lane. Returns (L[N,3], good_paths[N] int32),
    plus {rays, shadow_rays, bounce_live[depth+1], and the per-lane
    lane_rays and lane_shadow_rays [N] int32} when `with_metrics`.
    `spp_index` is an int or a per-lane [N] tensor. `fast_shade`: None for
    the plain versions, "shade" for the kernel route on the card (module
    docstring). A scene outside the gate raises NotImplementedError."""
    if fast_shade not in (None, "shade"):
        raise ValueError(f"fast_shade must be None or 'shade', not "
                         f"{fast_shade!r}")
    production_fast_shade(scene, max_depth=max_depth)
    L, good, metrics = _trace(
        scene, origin, direction, seed, pixel_ids, spp_index, max_depth,
        kernels=fast_shade == "shade" and origin.device.type == "cuda")
    return (L, good, metrics) if with_metrics else (L, good)


def render_sample(scene: T.Scene, camera, film, pixel_ids, seed: int,
                  spp_index, max_depth: int, estimator: str = "reference"):
    """One progressive pass (raygen + trace) for `pixel_ids`, through the
    route the gate picks: K1 for "bounce" scenes, the per-bounce K3 -> K2
    -> K4 route for "shade" scenes. estimator="reference" divides L by
    good_paths (trace.h:528-529); "physical" returns plain L. A scene
    outside the gate raises NotImplementedError naming the ROADMAP
    item."""
    from craytracer_tpu_torch.integrator.pass_kernel import _admitted_pass

    mode = production_fast_shade(scene, camera, film, estimator, max_depth)
    if mode == "bounce":
        L, good, _ = _admitted_pass(scene, camera, film, pixel_ids,
                                    spp_index, seed, max_depth,
                                    raygen="strat")
    else:
        pixel_ids = torch.as_tensor(pixel_ids)
        o, d = camera_rays(camera, film, pixel_ids, seed, spp_index,
                           stratified_jitter(seed, pixel_ids, spp_index))
        L, good, _ = _trace(scene, o, d, seed, pixel_ids, spp_index,
                            max_depth, kernels=o.device.type == "cuda")
    if estimator == "physical":
        return L
    norm = torch.where(good > 0, 1.0 / torch.clamp(good, min=1).to(L.dtype),
                       torch.zeros_like(L[:, 0]))
    return L * norm[:, None]
