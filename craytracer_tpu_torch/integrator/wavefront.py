"""Wavefront path tracer with next-event estimation (counterpart of
craytracer_tpu/integrator/wavefront.py: `_offset_ray` :50,
`_make_bounce_step` :59 with its fast branch :97-134 and its general
branch :136-384, MIS included and its per-bounce log record :372-380,
`_init_state` :394, `trace_paths` :416 with stream compaction :499-560,
`trace_paths_logged` :562, `render_sample` :581 with the table sampler
:615-622, the trace-type dispatch :634-638 and the compaction policy
:639-650).

A bounce is four stages over [N] lanes with liveness masks: intersect
(ops/intersect.py) -> shade -> shadow_distance -> combine (the `lit`
test against the offset-adjusted light distance, then L and
good_paths). Two bounce steps share that frame:

- `_bounce_step`, the JAX fast branch: the shade stage is K2's contract
  (integrator/shade_kernel.py: emitted/env add, NEE candidate and shadow
  ray, BSDF sample, throughput, Russian roulette, next ray);
- `_general_step`, the JAX XLA branch: the shade stage is torch ops over
  every lobe (bsdf/bxdf.py), texture (diffuse textures, normal maps and
  the texture env, bsdf/texture.py) and light row (lights/lights.py,
  mesh lights and texel-importance env sampling included), with the
  JAX branch's sanitizations (the +z / +x frame of miss lanes, non-finite
  sample pdfs zeroed, escape rays for retired lanes and unwanted shadow
  rays) and its reference quirks (the NEE lobes evaluated on WORLD
  vectors); under the MIS estimator, the JAX branch's power-heuristic
  weights with their sanitized inputs, on prev_pdf, prev_delta and
  prev_n, which the state tuple carries at its end under MIS only.

With `kernels=False` every stage is a plain PyTorch version, on any
device: K1's plain version and the plain version of the "shade" and
"general" routes. With `kernels=True` on the card the traversal goes
through K3 closest hit (bvh4 scenes, in ray_key order) and K4 any hit
(bvh4 scenes, behind a ray_key argsort), per part (K3 `_init`, K4) for a
table cut into parts (Scene.tri_parts), and `_bounce_step` shades
through K2; `_general_step` has no kernel of its own, and the MIS
estimator runs on it only, as the JAX package keeps MIS off its kernels
(wavefront.py:439, :602).

Stream compaction (`compact_at`, `_trace`): after bounce B - 1 the lanes
are permuted alive-first and the rest of the bounces run on the first
half, and on the second only when one of its lanes lives; the halves
scatter back by lane id. `render_sample` compacts at bounce 2 on traces
of depth 8 or more over a mesh of at least 4,096 triangles in an
accelerator, on the "shade" and "general" routes (`compact_policy`, the
JAX policy; measured on a TPU, so the card's is ROADMAP queue 3 item 6);
K1's pass is dense by construction. `trace_paths_logged` is the non-MIS
general step bounce by bounce with its per-bounce record, which the
Renderer's NaN log writes out.

Gradients (the JAX package's differentiable XLA step, slice G): under
autograd, with a tensor of the scene, camera or film that requires grad, the
gate answers "general" and the bounce loop is plain autograd over
`_general_step`. Its search is detached (ops/intersect.py: K3 and K4 on
the card still find which primitive, at what distance, and whether a
shadow ray is blocked, launched on detached rays) and the fills carry
the gradient. `remat=True` checkpoints each bounce
(torch.utils.checkpoint, the counterpart of jax.checkpoint,
wavefront.py:418-449, :474-493): the backward pass runs the bounce again,
K3 and K4 included, instead of keeping its intermediates. The RNG is a
counter hash of (seed, pixel, spp, bounce, dim), so the recompute draws
the same numbers and needs no RNG state.

Geometry sharding (parallel/geom.py, the JAX hooks `geom_axis` and
`tri_base`, wavefront.py:89-96, :115-116, :288-289): with a geometry axis
both steps reduce the closest hit over the axis' shards right after the
search (`reduce_hit`) and the shadow distance right after the any hit
(an all-reduce MIN); the ray and shadow-ray counters and the live
histogram stay per lane. Without one every path is what it was.

`render_sample` is the production entry: it asks the gate
(integrator/gate.py) once per pass and runs the whole pass through K1
(integrator/pass_kernel.py) for "bounce" scenes, or raygen in torch ops
(stratified_jitter, the thin-lens camera's lens samples and
generate_rays, wavefront.py:624-633) and the per-bounce loop for
"shade" and "general" scenes.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from craytracer_tpu_torch.bsdf.bxdf import (bsdf_f_direct, bsdf_f_nodelta,
                                            bsdf_pdf_balanced, bsdf_sample,
                                            gather_params)
from craytracer_tpu_torch.bsdf.texture import tex_lookup_nearest
from craytracer_tpu_torch.camera import THINLENS, generate_rays
from craytracer_tpu_torch.constants import K_EPSILON
from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.integrator.gate import (needs_grad,
                                                  production_fast_shade)
from craytracer_tpu_torch.integrator.shade_kernel import (
    RR_START, fused_shade, fused_shade_reference)
from craytracer_tpu_torch.lights.lights import (env_pdf, env_radiance,
                                                env_transform,
                                                light_pdf_for_hit,
                                                sample_one_light)
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


def _closest_hit(scene: T.Scene, o, d, kernels: bool, geom_axis, tri_base):
    """intersect_scene, and with a geometry axis the closest of its
    shards' hits (parallel/geom.py `reduce_hit`, wavefront.py:89-96)."""
    hit = intersect_scene(scene, o, d, kernels=kernels)
    if geom_axis is None:
        return hit
    from craytracer_tpu_torch.parallel.geom import reduce_hit

    return reduce_hit(hit, geom_axis, tri_base)


def _shadow_t(scene: T.Scene, o, d, max_dist, kernels: bool, geom_axis):
    """shadow_distance, and with a geometry axis the least over its shards
    (wavefront.py:115-116, :288-289)."""
    t = shadow_distance(scene, o, d, max_dist, kernels=kernels)
    if geom_axis is None:
        return t
    from craytracer_tpu_torch.parallel.geom import reduce_shadow

    return reduce_shadow(t, geom_axis)


def _bounce_step(scene: T.Scene, seed: int, spp_index, max_depth: int,
                 bounce: int, state, kernels: bool, geom_axis=None,
                 tri_base: int = 0):
    """One wavefront bounce: intersect -> shade -> shadow -> combine.
    `geom_axis` (parallel/sharded.py Axis) reduces the hits and shadow
    distances over the geometry shards of its ranks; `tri_base` is this
    shard's first global triangle row."""
    o, d, beta, L, good, alive, prev_sg, rays, shadows, live_hist, pix = \
        state[:11]
    hit = _closest_hit(scene, o, d, kernels, geom_axis, tri_base)
    shade = fused_shade if kernels else fused_shade_reference
    out = shade(scene, d, hit, beta, alive, prev_sg, pix, spp_index, seed,
                bounce, max_depth)
    t_shadow = _shadow_t(scene, out["shadow_o"], out["shadow_d"],
                         out["dist_adj_t"], kernels, geom_axis)
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
            shadows + out["want_shadow"], live_hist, pix) + state[11:]


def _offset_ray(point, normal, direction):
    """Nudge origins off the surface along the geometric normal, by a
    magnitude-relative epsilon (wavefront.py:50-56)."""
    eps = (vm.max3(torch.abs(point), keepdims=True) + 1.0) * 1e-4
    side = torch.where(vm.dot(direction, normal, keepdims=True) >= 0.0,
                       1.0, -1.0)
    return point + normal * eps * side


def _general_step(scene: T.Scene, seed: int, spp_index, max_depth: int,
                  bounce: int, state, kernels: bool, mis: bool = False,
                  log=None, geom_axis=None, tri_base: int = 0):
    """One bounce of the JAX XLA branch (wavefront.py :136-384): intersect
    -> emitted / env add -> NEE through a shadow ray -> BSDF sample ->
    Russian roulette. Same state tuple as `_bounce_step`. `mis` takes the
    MIS estimator's branches (:151-185, :236-255, :258, :292-320,
    :328-332): emission and env weighted by the power heuristic against
    the light strategy at every bounce, NEE on GLASS too, through the
    local wi with the non-delta lobes, weighted against the balanced BSDF
    density, and the balanced BSDF sample. A list `log` gets the bounce's
    record appended (the JAX step's `aux`, wavefront.py:372-380: the hit's
    t, the throughput entering the bounce, the emitted, env and NEE
    contributions, the BSDF sample's pdf, liveness); asking for it leaves
    every output as it was. `geom_axis` and `tri_base` as for
    `_bounce_step`."""
    o, d, beta, L, good, alive, prev_sg, rays, shadows, live_hist, pix = \
        state[:11]
    if mis:
        prev_pdf, prev_delta, prev_n = state[11:14]
    present = frozenset(scene.mat_types_present)
    hit = _closest_hit(scene, o, d, kernels, geom_axis, tri_base)
    hitm = hit.hit_mask
    textured = scene.textures.texels.shape[0] > 1
    mp = gather_params(scene.materials, scene.textures, hit.mat_id, hit.uv,
                       lambertian_only=scene.matte_lambertian)
    mat_type = mp.mat_type
    emissive_hit = hitm & (mat_type == T.MAT_EMISSIVE)

    # ---- emitted / env radiance (trace.h:419-455): the emission of the
    # table color, the env through its transform (and texture); good_paths
    # counts every counted escape, black or not (trace.h:427-444)
    emitted = mp.color_raw * mp.intensity[:, None]
    env_li = (torch.zeros_like(d) if scene.env.kind == 0 else
              env_radiance(scene.env, scene.textures,
                           env_transform(scene.env, d)))
    if mis:
        # every bounce adds, weighted against the light strategy (weight 1
        # at bounce 0 and after a delta lobe); the light strategy has no
        # density below the previous shading normal. The ratios take
        # sanitized inputs: a delta lobe's prev_pdf is inf.
        no_compete = prev_delta | (bounce == 0)
        p_l = light_pdf_for_hit(scene, hit.group, hit.prim, hit.point, o, d,
                                hit_normal=hit.normal)
        p_l = torch.where(vm.dot(d, prev_n) >= 0.0, p_l, 0.0)
        pp_s = torch.where(no_compete | ~torch.isfinite(prev_pdf), 1.0,
                           prev_pdf)
        pl_s = torch.where(no_compete | ~torch.isfinite(p_l), 0.0, p_l)
        w_emit = torch.where(no_compete, 1.0, pp_s * pp_s / vm.maximum(
            pp_s * pp_s + pl_s * pl_s, 1e-20))
        add_emit = alive & emissive_hit
        L = L + torch.where(add_emit[:, None],
                            beta * emitted * w_emit[:, None], 0.0)
        p_env = env_pdf(scene, d, prev_n)
        pe_s = torch.where(no_compete | ~torch.isfinite(p_env), 0.0, p_env)
        w_env = torch.where(no_compete, 1.0, pp_s * pp_s / vm.maximum(
            pp_s * pp_s + pe_s * pe_s, 1e-20))
        add_env = alive & ~hitm
        L = L + torch.where(add_env[:, None], beta * env_li * w_env[:, None],
                            0.0)
    else:
        add_cond = alive & (prev_sg | (bounce == 0))
        add_emit = add_cond & emissive_hit
        add_env = add_cond & ~hitm
        emit_c = torch.where(add_emit[:, None], beta * emitted, 0.0)
        env_c = torch.where(add_env[:, None], beta * env_li, 0.0)
        L = L + emit_c
        L = L + env_c
    good = good + (add_emit | add_env).to(torch.int32)
    cont = alive & hitm & ~emissive_hit & (bounce < max_depth)

    # ---- shading frame (computeLocalBasis, trace.h:132-146), from +z and
    # +x on miss lanes
    up = torch.zeros_like(hit.normal)
    up[:, 2] = 1.0
    ex = torch.zeros_like(hit.dpdu)
    ex[:, 0] = 1.0
    ft, fb, fn = vm.make_shading_frame(
        torch.where(hitm[:, None], hit.normal, up),
        torch.where(hitm[:, None], hit.dpdu, ex))
    if textured:
        # normal mapping on MATTE rows with a normal map
        # (getSmoothTriangleShadeRec, shapes/triangle.cpp:270-292;
        # Material_hasNormalMap, materials.cpp:190-204): the texel 2c - 1
        # as a tangent-space normal, the frame rebuilt around it
        tex_n = tex_lookup_nearest(scene.textures, mp.normal_tex,
                                   hit.uv) * 2.0 - 1.0
        n_pert = vm.normalize(vm.to_world(tex_n, ft, fb, fn))
        use_nm = (mp.normal_tex >= 0) & (mat_type == T.MAT_MATTE)
        ft, fb, fn = vm.make_shading_frame(
            torch.where(use_nm[:, None], n_pert, fn), hit.dpdu)
    wo_world = -d
    wo_local = vm.to_local(wo_world, ft, fb, fn)
    u_all = uniforms(seed, pix, spp_index, bounce, 9, 0)

    # ---- NEE (trace.h:466-481): not on MIRROR or TRANSPARENT, nor on
    # GLASS but under MIS. The reference estimator evaluates the diffuse
    # lobes on the WORLD vectors (the reference's BSDF_f quirk,
    # reflection.cpp:719-735); MIS evaluates every non-delta lobe on the
    # local wi, which is +z where no light sample is valid.
    spec = (mat_type == T.MAT_MIRROR) | (mat_type == T.MAT_TRANSPARENT)
    nee_mat = ~spec if mis else ~(spec | (mat_type == T.MAT_GLASS))
    ls = sample_one_light(scene, u_all[:, 4], u_all[:, 0:2], hit.point, fn,
                          ft, fb)
    abs_cos = torch.abs(vm.dot(fn, ls.wi))[:, None]
    if mis:
        wi_l = torch.where((ls.valid & hitm)[:, None],
                           vm.to_local(ls.wi, ft, fb, fn), up)
        f_nee = bsdf_f_nodelta(wi_l, wo_local, mp, present=present) * abs_cos
    else:
        f_nee = bsdf_f_direct(ls.wi, wo_world, mp, present=present) * abs_cos
    want_shadow = cont & nee_mat & ls.valid & (f_nee > 0.0).any(dim=1)
    shadow_o = _offset_ray(hit.point, hit.normal, ls.wi)
    dist_adj = ls.distance - vm.dot(shadow_o - hit.point, ls.wi)
    # lanes that do not want the result shoot an escape ray
    shadow_o = torch.where(want_shadow[:, None], shadow_o, 3.0e18)
    t_shadow = _shadow_t(scene, shadow_o, ls.wi,
                         torch.where(want_shadow, dist_adj, 0.0), kernels,
                         geom_axis)
    lit = t_shadow >= dist_adj - vm.maximum(1e-3 * dist_adj, K_EPSILON)
    nee_scale = f_nee * ls.li / vm.maximum(ls.pdf, 1e-12)[:, None]
    if mis:
        # the power heuristic against the balanced BSDF density; a delta
        # light (the row the pick lands on) keeps weight 1. The pdf takes
        # +z where the weight is not used.
        n_lights = scene.lights.light_type.shape[0]
        ltype_l = (scene.lights.light_type[torch.clamp(torch.searchsorted(
            scene.lights.power_cdf, u_all[:, 4].contiguous(), right=True),
            0, n_lights - 1)] if n_lights else torch.zeros_like(hit.mat_id))
        is_delta_l = ((ltype_l == T.LIGHT_DIRECTIONAL)
                      | (ltype_l == T.LIGHT_POINT))
        skip_w = is_delta_l | ~want_shadow
        p_b = bsdf_pdf_balanced(torch.where(skip_w[:, None], up, wi_l),
                                wo_local, mp, present=present)
        pb_s = torch.where(skip_w | ~torch.isfinite(p_b), 0.0, p_b)
        pl2_s = torch.where(skip_w, 1.0, ls.pdf)
        w_l = torch.where(is_delta_l, 1.0, pl2_s * pl2_s / vm.maximum(
            pl2_s * pl2_s + pb_s * pb_s, 1e-20))
        nee_scale = nee_scale * w_l[:, None]
    contrib = torch.where((want_shadow & lit)[:, None], beta * nee_scale,
                          0.0)
    L = L + contrib
    good = good + (contrib != 0.0).any(dim=1).to(torch.int32)

    # ---- BSDF sampling (trace.h:484-496); a non-finite pdf is a dead
    # sample
    f_s, wi_local, pdf_s, is_spec, is_glossy = bsdf_sample(
        u_all[:, 5:8], wo_local, mp, balanced=mis, present=present)
    pdf_s = torch.where(torch.isfinite(pdf_s), pdf_s, 0.0)
    dead = (pdf_s <= 0.0) | (f_s == 0.0).all(dim=1)
    wi_world = vm.to_world(wi_local, ft, fb, fn)
    weight = f_s * (torch.abs(vm.dot(wi_world, fn))
                    / vm.maximum(pdf_s, 1e-12))[:, None]
    new_beta = torch.where(cont[:, None], beta * weight, beta)

    # ---- Russian roulette (trace.h:512-525)
    q = vm.maximum(1.0 - vm.max3(new_beta), 0.05)
    rr_active = cont & (bounce > RR_START)
    rr_kill = rr_active & (u_all[:, 8] < q)
    new_beta = torch.where((rr_active & ~rr_kill)[:, None],
                           new_beta / vm.maximum(1.0 - q, 1e-6)[:, None],
                           new_beta)
    new_alive = cont & ~dead & ~rr_kill
    # retired lanes carry an escape ray: a far origin heading +x
    new_o = torch.where(new_alive[:, None],
                        _offset_ray(hit.point, hit.normal, wi_world), 3.0e18)
    new_d = torch.where(new_alive[:, None], wi_world, ex)
    live_hist = live_hist.clone()
    live_hist[bounce] += alive.sum()
    if log is not None:
        if mis:
            emit_c = torch.where(add_emit[:, None], beta * emitted, 0.0)
            env_c = torch.where(add_env[:, None], beta * env_li, 0.0)
        log.append({"t": hit.t, "beta": beta,
                    "emissive_indirect_contrib": emit_c,
                    "env_indirect_contrib": env_c, "direct_contrib": contrib,
                    "new_sample_pdf": pdf_s, "alive": alive})
    new = (new_o, new_d, new_beta, L, good, new_alive,
           torch.where(cont, is_spec | is_glossy, prev_sg), rays + alive,
           shadows + want_shadow, live_hist, pix)
    if mis:
        new += (torch.where(cont, pdf_s, prev_pdf),
                torch.where(cont, is_spec, prev_delta),
                torch.where(cont[:, None], fn, prev_n))
    return new + state[len(new):]


def _init_state(origin, direction, max_depth, pixel_ids, mis: bool = False,
                lanes: bool = False):
    """The bounce loop's state tuple: o, d, beta, L, good, alive, prev_sg,
    the per-lane ray and shadow-ray counts, the live histogram and the
    pixel ids; then the MIS estimator's three fields when `mis`, and last
    the lane ids when `lanes` (the JAX state's `lane`, by which stream
    compaction scatters back). Every field but the histogram is per lane;
    the steps carry the fields past their own through unchanged."""
    n = origin.shape[0]
    dev = origin.device
    zero = torch.zeros((n,), dtype=torch.int32, device=dev)
    state = (origin, direction,
            torch.ones((n, 3), dtype=origin.dtype, device=dev),
            torch.zeros((n, 3), dtype=origin.dtype, device=dev),
            zero,
            torch.ones((n,), dtype=torch.bool, device=dev),
            torch.zeros((n,), dtype=torch.bool, device=dev),
            zero, zero,
            torch.zeros((max_depth + 1,), dtype=torch.int64, device=dev),
            torch.as_tensor(pixel_ids, device=dev).to(torch.int32)
            .contiguous())
    if mis:
        # wavefront.py:405-407: the previous bounce's BSDF pdf, whether
        # its lobe was a delta (true at the camera), its shading normal
        # (+z at the camera)
        state += (torch.zeros((n,), dtype=origin.dtype, device=dev),
                  torch.ones((n,), dtype=torch.bool, device=dev),
                  torch.tensor([0.0, 0.0, 1.0], dtype=origin.dtype,
                               device=dev).expand(n, 3))
    if lanes:
        state += (torch.arange(n, dtype=torch.int32, device=dev),)
    return state


class CompactionCount:
    """How many traces compacted (`traces`), and in how many of them the
    second half had a live lane and ran (`hi`)."""

    def __init__(self):
        self.traces = 0
        self.hi = 0


COMPACTION = CompactionCount()


def compact_policy(scene: T.Scene, max_depth: int) -> int:
    """The bounce after which a trace compacts, 0 for none: the JAX
    render_sample's policy (wavefront.py:639-650), 2 for a trace of depth
    8 or more on a scene whose at least 4,096 triangles sit in an
    accelerator, else 0. It was measured on a TPU; the card's own policy
    is ROADMAP queue 3 item 6."""
    n_tris = scene.triangles.mat_id.shape[0]
    return 2 if (max_depth >= 8 and scene.accel != "none"
                 and n_tris >= 4096) else 0


def _trace(scene: T.Scene, origin, direction, seed: int, pixel_ids,
           spp_index, max_depth: int, kernels: bool, general: bool = False,
           mis: bool = False, remat: bool = False, compact_at: int = 0,
           geom_axis=None, tri_base: int = 0):
    """trace_paths' bounce loop for a scene the gate has admitted, through
    `_general_step` (with the MIS estimator when `mis`) when `general`,
    `mis` or `remat`, else `_bounce_step`: (L, good, metrics). `remat`
    checkpoints each bounce (module docstring).

    `compact_at` = B > 0 compacts the stream (the JAX
    trace_paths(compact_at=B), wavefront.py:499-560): after bounce B - 1
    every per-lane field is permuted alive lanes first (a stable argsort
    of ~alive), the per-lane spp with them; bounces B..max_depth run on
    the first half, then on the second half only if any of its lanes is
    alive (one host read on the card); the halves are scattered back by
    lane id. Every lane still runs its own bounces on its own random
    numbers, so L, good and the counters equal the dense trace's, and the
    live histogram adds each half's live lanes into the same slot. The
    read of whether the second half runs agrees across a geometry axis:
    its ranks hold the same lanes. `geom_axis` and `tri_base` as for
    `_bounce_step`."""
    per_lane = isinstance(spp_index, torch.Tensor) and spp_index.dim() > 0
    if per_lane:
        spp_index = spp_index.to(device=origin.device,
                                 dtype=torch.int32).contiguous()
    n = origin.shape[0]
    compact = bool(compact_at) and compact_at <= max_depth and n >= 2
    state = _init_state(origin.contiguous(), direction.contiguous(),
                        max_depth, pixel_ids, mis, lanes=compact)

    def run(state, spp, bounces):
        for bounce in bounces:
            if remat:
                # no torch RNG runs inside, so no RNG state to keep
                state = torch.utils.checkpoint.checkpoint(
                    _general_step, scene, seed, spp, max_depth, bounce,
                    state, kernels, mis, use_reentrant=False,
                    preserve_rng_state=False, geom_axis=geom_axis,
                    tri_base=tri_base)
            elif general or mis:
                state = _general_step(scene, seed, spp, max_depth, bounce,
                                      state, kernels=kernels, mis=mis,
                                      geom_axis=geom_axis, tri_base=tri_base)
            else:
                state = _bounce_step(scene, seed, spp, max_depth, bounce,
                                     state, kernels=kernels,
                                     geom_axis=geom_axis, tri_base=tri_base)
        return state

    metrics = {}
    if not compact:
        state = run(state, spp_index, range(max_depth + 1))
        L, good, lane_rays, lane_shadows = state[3], state[4], state[7], \
            state[8]
    else:
        state = run(state, spp_index, range(compact_at))
        order = torch.argsort((~state[5]).to(torch.uint8), stable=True)
        state = tuple(x if i == 9 else x[order] for i, x in enumerate(state))
        spp_c = spp_index[order] if per_lane else spp_index
        half = n // 2
        tail = range(compact_at, max_depth + 1)

        def part(sl, hist):
            return tuple(hist if i == 9 else x[sl]
                         for i, x in enumerate(state))

        lo = run(part(slice(0, half), state[9]),
                 spp_c[:half] if per_lane else spp_c, tail)
        hi = part(slice(half, n), lo[9])
        hi_ran = bool(hi[5].any())
        if hi_ran:
            hi = run(hi, spp_c[half:] if per_lane else spp_c, tail)
        COMPACTION.traces += 1
        COMPACTION.hi += int(hi_ran)
        metrics["compact_hi"] = hi_ran
        lane = torch.cat([lo[-1], hi[-1]]).long()
        inv = torch.empty_like(lane)
        inv[lane] = torch.arange(n, device=lane.device)

        def back(i):
            return torch.cat([lo[i], hi[i]])[inv]

        L, good, lane_rays, lane_shadows = back(3), back(4), back(7), back(8)
        state = hi
    metrics.update({"rays": lane_rays.sum(), "shadow_rays": lane_shadows.sum(),
                    "bounce_live": state[9], "lane_rays": lane_rays,
                    "lane_shadow_rays": lane_shadows})
    return L, good, metrics


def trace_paths(scene: T.Scene, origin, direction, seed: int, pixel_ids,
                spp_index, max_depth: int, with_metrics: bool = False,
                fast_shade=None, general: bool = False, mis: bool = False,
                remat: bool = False, compact_at: int = 0, geom_axis=None,
                tri_base: int = 0):
    """Trace one path per lane. Returns (L[N,3], good_paths[N] int32),
    plus {rays, shadow_rays, bounce_live[depth+1], and the per-lane
    lane_rays and lane_shadow_rays [N] int32, and compact_hi when the
    trace compacted} when `with_metrics`.
    `spp_index` is an int or a per-lane [N] tensor. `fast_shade`: None for
    the plain versions, "shade" for the kernels on the card (module
    docstring). A "general" scene takes `_general_step`; `general=True`
    asks for it on any admitted scene (the JAX trace_paths'
    fast_shade=False), and so does a trace under autograd whose scene,
    origins or directions require grad. `mis=True` traces the MIS
    estimator, which only the general step has. `remat=True` checkpoints
    each bounce of the general step (the JAX trace_paths' remat, which
    forces its XLA step). `compact_at=B` compacts the stream after bounce
    B - 1 (`_trace`). `geom_axis` and `tri_base` reduce the hits over a
    geometry axis (`_bounce_step`). A scene outside the gate raises
    NotImplementedError."""
    if fast_shade not in (None, "shade"):
        raise ValueError(f"fast_shade must be None or 'shade', not "
                         f"{fast_shade!r}")
    mode = production_fast_shade(scene, max_depth=max_depth,
                                 estimator="mis" if mis else "reference")
    L, good, metrics = _trace(
        scene, origin, direction, seed, pixel_ids, spp_index, max_depth,
        kernels=fast_shade == "shade" and origin.device.type == "cuda",
        general=(general or mode == "general"
                 or needs_grad(origin, direction)), mis=mis, remat=remat,
        compact_at=compact_at, geom_axis=geom_axis, tri_base=tri_base)
    return (L, good, metrics) if with_metrics else (L, good)


@torch.no_grad()
def trace_paths_logged(scene: T.Scene, origin, direction, seed: int,
                       pixel_ids, spp_index, max_depth: int):
    """The logging tracer (the JAX trace_paths_logged, wavefront.py
    :562-578, the wavefront form of pathTraceLogging + SampleLog,
    trace.h:176-219, 535-684): the non-MIS general step, bounce by bounce,
    with its per-bounce record. Returns (L, good, log), log mapping each
    SampleLog field to a [max_depth + 1, N, ...] tensor. On the card the
    search of a bvh4 mesh goes through K3 and K4."""
    production_fast_shade(scene, max_depth=max_depth)
    kernels = origin.device.type == "cuda"
    state = _init_state(origin.contiguous(), direction.contiguous(),
                        max_depth, pixel_ids)
    records = []
    for bounce in range(max_depth + 1):
        state = _general_step(scene, seed, spp_index, max_depth, bounce,
                              state, kernels=kernels, log=records)
    log = {k: torch.stack([r[k] for r in records]) for k in records[0]}
    return state[3], state[4], log


def film_jitter(seed: int, pixel_ids, spp_index, sampler=None):
    """The camera rays' film jitter: the table `sampler`'s points
    (sampling/tables.py) when given, else stratified_jitter
    (wavefront.py:615-622)."""
    if sampler is None:
        return stratified_jitter(seed, pixel_ids, spp_index)
    from craytracer_tpu_torch.sampling.tables import table_sample

    return table_sample(sampler, seed, pixel_ids, spp_index, dim=0)


def render_sample(scene: T.Scene, camera, film, pixel_ids, seed: int,
                  spp_index, max_depth: int, estimator: str = "reference",
                  general: bool = False, kernels=None,
                  trace_type: str = "PATHTRACE", sampler=None,
                  compact_at=None, geom_axis=None, tri_base: int = 0,
                  with_metrics: bool = False):
    """One progressive pass (raygen + trace) for `pixel_ids`, through the
    route the gate picks: K1 for "bounce" scenes, the per-bounce K3 -> K2
    -> K4 route for "shade" scenes, the per-bounce general step (with K3
    and K4 for a bvh4 scene) for "general" scenes. `general=True` asks
    for the general step on any admitted scene (the JAX render_sample's
    fast_shade=False). Under autograd, with a scene, camera or film tensor
    that requires grad, the gate answers "general" (module docstring).
    `kernels` applies to the per-bounce routes: None launches their
    kernels for rays on the card, False runs their plain versions on any
    device, True takes the kernels' wrappers on any device (on CPU
    tensors each wrapper runs its plain version, behind the route's sorts
    and a cut table's part chain). estimator="reference" divides L by
    good_paths (trace.h:528-529); "physical" and "mis" (always the
    general step) return plain L. A scene outside the gate raises
    NotImplementedError naming the ROADMAP item.

    `sampler` (sampling/tables.py SampleTable) takes the film jitter from
    its table: on a "bounce" scene K1 then traces the camera rays made
    here (its external-ray mode, wavefront.py:601, :456-468).
    `trace_type` "WHITTED" or "RAYCAST" traces integrator/whitted.py
    instead of the path tracer (wavefront.py:634-638). `compact_at` None
    takes `compact_policy` on the per-bounce routes; an int forces it.
    K1's pass is dense by construction.

    `geom_axis` (parallel/sharded.py Axis) and `tri_base`: `scene` is one
    geometry shard (parallel/geom.py), and every bounce reduces the hits
    and shadow distances over the axis' shards. A "bounce" scene then takes
    the per-bounce "shade" route (JAX skips its megakernel, wavefront.py
    :603, :443), and the route and the compaction bounce, which the gate
    and `compact_policy` pick from the shard's padded triangle count, are
    checked to agree across the axis.

    `with_metrics` returns (image, good_paths, metrics) as trace_paths
    does, on the path tracer's routes."""
    from craytracer_tpu_torch.integrator.pass_kernel import _admitted_pass

    mode = production_fast_shade(scene, camera, film, estimator, max_depth,
                                 trace_type)
    if geom_axis is not None:
        if trace_type != "PATHTRACE":
            raise NotImplementedError("geometry sharding traces PATHTRACE "
                                      "only, as the JAX package does")
        mode = "shade" if mode == "bounce" else mode
    pixel_ids = torch.as_tensor(pixel_ids)
    if mode == "bounce" and not general and sampler is None:
        # no autograd here (the gate said so): a leaf that requires grad
        # reaches K1 detached
        L, good, metrics = _admitted_pass(
            T.detached(scene), T.detached(camera), T.detached(film),
            pixel_ids, spp_index, seed, max_depth, raygen="strat")
        return _result(L, good, metrics, estimator, with_metrics)
    o, d = camera_rays(camera, film, pixel_ids, seed, spp_index,
                       film_jitter(seed, pixel_ids, spp_index, sampler))
    on_card = o.device.type == "cuda"
    kernels = on_card if kernels is None else bool(kernels)
    if trace_type != "PATHTRACE":
        from craytracer_tpu_torch.integrator.whitted import trace_whitted

        if with_metrics:
            raise ValueError("with_metrics: the path tracer's only")
        return trace_whitted(scene, o, d, seed, pixel_ids, spp_index,
                             max_depth, trace_type == "WHITTED",
                             kernels=kernels)
    if mode == "bounce" and not general:
        L, good, metrics = _admitted_pass(
            T.detached(scene), T.detached(camera), T.detached(film),
            pixel_ids, spp_index, seed, max_depth, raygen=None,
            rays=(o.detach(), d.detach()))
    else:
        if compact_at is None:
            compact_at = compact_policy(scene, max_depth)
        if geom_axis is not None:
            from craytracer_tpu_torch.parallel.geom import check_same_route

            check_same_route(geom_axis, mode, compact_at, o.device)
        L, good, metrics = _trace(
            scene, o, d, seed, pixel_ids, spp_index, max_depth,
            kernels=kernels, general=general or mode == "general",
            mis=estimator == "mis", compact_at=compact_at,
            geom_axis=geom_axis, tri_base=tri_base)
    return _result(L, good, metrics, estimator, with_metrics)


def _result(L, good, metrics, estimator, with_metrics):
    img = _normalize(L, good, estimator)
    return (img, good, metrics) if with_metrics else img


def _normalize(L, good, estimator):
    if estimator in ("physical", "mis"):
        return L
    norm = torch.where(good > 0, 1.0 / torch.clamp(good, min=1).to(L.dtype),
                       torch.zeros_like(L[:, 0]))
    return L * norm[:, None]
