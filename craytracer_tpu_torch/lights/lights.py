"""Light sampling for next-event estimation over hit queues, the general
route's (counterpart of craytracer_tpu/lights/lights.py: `LightSample`
:29, `env_radiance` :37, `light_pdf_for_hit` :54, `env_pdf` :129,
`sample_one_light` :164, `sample_light_index` :191).

`uniformSampleOneLight` + `estimateDirect` (trace.h:221-397) as one
masked computation: the light is picked by the normalized power CDF
(`searchsorted(side="right")`, clipped to the table), then every light
type the scene holds samples masked for every lane (rows: rect :220,
sphere :229, disk :248, the env light :263-324, a texture env by its
texel CDF when env.importance is set and by the cosine hemisphere
otherwise, mesh lights :326-368, directional and point :397-420), with
the area -> solid-angle pdf and the facing rejections of the reference.
Types absent from Scene.light_types_present are skipped, not evaluated
and masked, as the JAX code compiles them away. The caller fires the
shadow ray. `light_pdf_for_hit` and `env_pdf` give the MIS estimator the
light strategy's density for a direction the BSDF sampled: the density
with which `sample_one_light` would have produced it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from craytracer_tpu_torch.bsdf.texture import (nearest_texel_xy,
                                               tex_lookup_nearest)
from craytracer_tpu_torch.constants import (INV_PI, JITTERED_UP, PI, TMAX,
                                            TWO_PI)
from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.sampling.mappings import (map_to_disk_polar,
                                                    map_to_hemisphere_cosine)
from craytracer_tpu_torch.scene import types as T


@dataclass(frozen=True)
class LightSample:
    wi: torch.Tensor  # [N, 3] direction to the light sample
    li: torch.Tensor  # [N, 3] incident radiance
    distance: torch.Tensor  # [N] shadow-ray length
    pdf: torch.Tensor  # [N] solid-angle pdf times the pick probability
    valid: torch.Tensor  # [N] facing and pdf checks passed


def env_radiance(env: T.EnvLight, textures: T.TexturePack, direction):
    """getEnvLightIncRadiance (lights.cpp:233-248): none, a constant, or
    the nearest texel of the lat-long map (cartesianToSpherical ->
    sphericalToUV -> getTexColor) times the intensity; `direction` is
    already through env.transform."""
    if env.kind == 0:
        return torch.zeros_like(direction)
    if env.kind == 1:
        return (env.color * env.intensity).expand_as(direction)
    theta, phi = vm.cartesian_to_spherical(direction)
    u, v = vm.spherical_to_uv(theta, phi)
    tid = env.tex_id.expand(direction.shape[:-1])
    return tex_lookup_nearest(textures, tid,
                              torch.stack([u, v], dim=-1)) * env.intensity


def env_transform(env: T.EnvLight, d):
    """env.transform @ d per lane (the einsum "ij,nj->ni")."""
    return d @ env.transform.T


def light_pdf_for_hit(scene: T.Scene, hit_group, hit_prim, hit_point,
                      prev_point, wi, hit_normal=None):
    """The solid-angle density times the pick probability with which
    `sample_one_light` from `prev_point` would have produced direction
    `wi` landing on primitive (hit_group, hit_prim) at `hit_point`; 0
    where the hit is not a light row (the row whose src_group/src_prim
    match, or for a mesh triangle its tri_light_id). One-sided area
    lights use the signed cosine (no density on their back), mesh lights
    |cos| against `hit_normal`."""
    lights = scene.lights
    n_lights = lights.light_type.shape[0]
    if n_lights == 0:
        return torch.zeros(hit_group.shape, dtype=hit_point.dtype,
                           device=hit_point.device)
    match = ((lights.src_group[None, :] == hit_group[:, None])
             & (lights.src_prim[None, :] == hit_prim[:, None]))  # [N, L]
    idx = match.to(torch.int32).argmax(dim=1)
    found = match.any(dim=1)
    ml = scene.mesh_lights
    if ml.surface_area.shape[0] > 0:
        tri_lid = ml.tri_light_id[torch.clamp(
            hit_prim.to(torch.int64), 0, ml.tri_light_id.shape[0] - 1)]
        mesh_found = (hit_group == T.GROUP_TRIANGLE) & (tri_lid >= 0)
        idx = torch.where(mesh_found, torch.clamp(tri_lid, min=0).to(
            idx.dtype), idx)
        found = found | mesh_found
    ltype, p0, v1, v2 = (lights.light_type[idx], lights.p0[idx],
                         lights.v1[idx], lights.v2[idx])
    lnormal, radius, pick_p = (lights.normal[idx], lights.radius[idx],
                               lights.power[idx])
    present = scene.light_types_present

    def use(*codes):
        return not present or any(c in present for c in codes)

    # the area density each type's sampler has at the hit point
    pdf_area = torch.zeros_like(hit_point[:, 0])
    sn = lnormal
    if use(T.LIGHT_AREA_RECT):
        pdf_rect = 1.0 / vm.maximum(vm.length(v1) * vm.length(v2), 1e-12)
        pdf_area = torch.where(ltype == T.LIGHT_AREA_RECT, pdf_rect,
                               pdf_area)
    if use(T.LIGHT_AREA_SPHERE):
        n_s = vm.normalize(hit_point - p0)  # the sphere's normal at the hit
        z_axis = vm.normalize(prev_point - p0)
        cos_local = vm.maximum(vm.dot(n_s, z_axis), 0.0)
        pdf_sph = cos_local / vm.maximum(2.0 * PI * PI * radius * radius,
                                         1e-12)
        is_sph = ltype == T.LIGHT_AREA_SPHERE
        pdf_area = torch.where(is_sph, pdf_sph, pdf_area)
        sn = torch.where(is_sph[:, None], n_s, sn)
    if use(T.LIGHT_AREA_DISK):
        pdf_dsk = 1.0 / (PI * vm.maximum(radius * radius, 1e-12))
        pdf_area = torch.where(ltype == T.LIGHT_AREA_DISK, pdf_dsk,
                               pdf_area)
    if ml.surface_area.shape[0] > 0 and use(T.LIGHT_MESH):
        mlid = torch.clamp(lights.mesh_light_id[idx], min=0).to(torch.int64)
        pdf_msh = 1.0 / vm.maximum(ml.surface_area[mlid], 1e-9)
        pdf_area = torch.where(ltype == T.LIGHT_MESH, pdf_msh, pdf_area)

    is_mesh = ltype == T.LIGHT_MESH
    if hit_normal is not None:
        sn = torch.where(is_mesh[:, None], hit_normal, sn)
    to_hit = hit_point - prev_point
    cos_signed = vm.dot(sn, -wi)
    cos_l = torch.where(is_mesh, torch.abs(cos_signed), cos_signed)
    pdf_sa = pdf_area * vm.length_sq(to_hit) / vm.maximum(cos_l, 1e-6)
    return torch.where(found & (cos_l > 0.0), pdf_sa * pick_p, 0.0)


def env_pdf(scene: T.Scene, wi, prev_normal):
    """The env light's NEE density for escape direction `wi` from a vertex
    with shading normal `prev_normal`, times its pick probability: the
    texel CDF's density of the looked-up texel over its solid angle when
    env.importance is set (0 below the horizon, where that sampler
    rejects), else the cosine hemisphere about the normal, `wi` taken
    back through the env transform."""
    lights = scene.lights
    if lights.light_type.shape[0] == 0 or scene.env.kind == 0:
        return torch.zeros(wi.shape[:-1], dtype=wi.dtype, device=wi.device)
    env_pick = torch.where(lights.light_type == T.LIGHT_ENV, lights.power,
                           0.0).sum()
    env = scene.env
    if env.importance:
        H, W = env.imp_h, env.imp_w
        theta, phi = vm.cartesian_to_spherical(env_transform(env, wi))
        u, v = vm.spherical_to_uv(theta, phi)
        x, y = nearest_texel_xy(
            torch.tensor(W, dtype=torch.int32, device=wi.device),
            torch.tensor(H, dtype=torch.int32, device=wi.device), u, v)
        p_tex = env.flat_pdf[(y * W + x).to(torch.int64)]
        omega = (TWO_PI / W) * (PI / H) * vm.maximum(torch.sin(theta), 1e-6)
        facing = vm.dot(wi, prev_normal) >= 0.0
        return torch.where(facing, p_tex / omega * env_pick, 0.0)
    wi_local = wi @ env.transform  # the einsum "ji,nj->ni"
    cos_t = vm.maximum(vm.dot(wi_local, prev_normal), 0.0)
    return cos_t * INV_PI * env_pick


def sample_one_light(scene: T.Scene, u_pick, u2, hit_point, shading_normal,
                     frame_t, frame_b) -> LightSample:
    """Pick one light by the power CDF and sample it; the pdf includes the
    pick probability (uniformSampleOneLight, trace.h:393-396)."""
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
    ls = sample_light_index(scene, idx, u2, hit_point, shading_normal,
                            frame_t, frame_b)
    return dataclasses.replace(ls, pdf=ls.pdf * vm.maximum(pick_p, 1e-12),
                               valid=ls.valid & (pick_p > 0.0))


def sample_light_index(scene: T.Scene, idx, u2, hit_point, shading_normal,
                       frame_t, frame_b) -> LightSample:
    """Sample light `idx` ([N] int64) for every lane: the estimateDirect
    sampling block (trace.h:230-314) and the delta lights (Light_sample_Li,
    lights.cpp:309-327)."""
    lights = scene.lights
    present = scene.light_types_present

    def use(*codes):
        return not present or any(c in present for c in codes)

    ltype = lights.light_type[idx]
    p0, v1, v2 = lights.p0[idx], lights.v1[idx], lights.v2[idx]
    lnormal, radius = lights.normal[idx], lights.radius[idx]
    color, intensity = lights.color[idx], lights.intensity[idx]
    sp = torch.zeros_like(hit_point)
    sn = torch.zeros_like(hit_point)
    pdf_area = torch.zeros_like(hit_point[:, 0])
    is_rect = ltype == T.LIGHT_AREA_RECT
    is_sph = ltype == T.LIGHT_AREA_SPHERE
    is_dsk = ltype == T.LIGHT_AREA_DISK
    is_env = ltype == T.LIGHT_ENV
    is_msh = ltype == T.LIGHT_MESH
    is_dir = ltype == T.LIGHT_DIRECTIONAL
    is_pnt = ltype == T.LIGHT_POINT

    if use(T.LIGHT_AREA_RECT):
        # RECT (trace.h:244-254): a uniform point, pdf 1 / (|w| |h|)
        sp_rect = p0 + u2[:, 0:1] * v1 + u2[:, 1:2] * v2
        pdf_rect = 1.0 / vm.maximum(vm.length(v1) * vm.length(v2), 1e-12)
        sp = torch.where(is_rect[:, None], sp_rect, sp)
        sn = torch.where(is_rect[:, None], lnormal, sn)
        pdf_area = torch.where(is_rect, pdf_rect, pdf_area)

    if use(T.LIGHT_AREA_SPHERE):
        # SPHERE (trace.h:230-243): a cosine hemisphere about the center ->
        # hit axis; pdf 1 / (2 pi r^2) |h.z| / pi
        z_axis = vm.normalize(hit_point - p0)
        zt, zb, _ = vm.orthonormal_basis(z_axis)
        h = map_to_hemisphere_cosine(u2)
        h_world = vm.to_world(h, zt, zb, z_axis)
        pdf_sph = (1.0 / (2.0 * PI * vm.maximum(radius * radius, 1e-12))
                   * vm.abs_cos_theta(h) * INV_PI)
        sp = torch.where(is_sph[:, None], p0 + h_world * radius[:, None], sp)
        sn = torch.where(is_sph[:, None], h_world, sn)
        pdf_area = torch.where(is_sph, pdf_sph, pdf_area)

    if use(T.LIGHT_AREA_DISK):
        # DISK (trace.h:255-270): the polar disk map in the
        # (JITTERED_UP x n, ...) basis; pdf 1 / (pi r^2)
        jup = torch.tensor(JITTERED_UP, dtype=hit_point.dtype,
                           device=hit_point.device).expand_as(lnormal)
        x_axis = vm.normalize(vm.cross(jup, lnormal))
        y_axis = vm.cross(x_axis, lnormal)
        dsk = map_to_disk_polar(u2)
        sp_dsk = p0 + (dsk[:, 0:1] * x_axis
                       + dsk[:, 1:2] * y_axis) * radius[:, None]
        pdf_dsk = 1.0 / (PI * vm.maximum(radius * radius, 1e-12))
        sp = torch.where(is_dsk[:, None], sp_dsk, sp)
        sn = torch.where(is_dsk[:, None], lnormal, sn)
        pdf_area = torch.where(is_dsk, pdf_dsk, pdf_area)

    ml = scene.mesh_lights
    if ml.tri_index.shape[0] > 0 and use(T.LIGHT_MESH):
        # MESH (MeshLight_genSample, lights.cpp:139-232): a triangle by a
        # 32-step binary search over the light's area CDF, uniform
        # barycentrics inside it (r1 the CDF residual), pdf 1 / area
        sp_m, sn_m, pdf_m = _sample_mesh(scene, lights.mesh_light_id[idx],
                                         u2)
        sp = torch.where(is_msh[:, None], sp_m, sp)
        sn = torch.where(is_msh[:, None], sn_m, sn)
        pdf_area = torch.where(is_msh, pdf_m, pdf_area)

    # area lights: solid-angle conversion (trace.h:298-309) and the facing
    # rejections (trace.h:316-323)
    to_sample = sp - hit_point
    wi = vm.normalize(to_sample)
    dist = vm.length(to_sample)
    pdf = pdf_area * (vm.length_sq(to_sample) / vm.maximum(
        torch.abs(vm.dot(sn, -wi)), 1e-12))
    li = color * intensity[:, None]
    reject = ((vm.dot(to_sample, sn) > 0.0)
              | (vm.dot(to_sample, shading_normal) < 0.0))

    if use(T.LIGHT_ENV):
        if scene.env.importance:
            wi_env, li_env, pdf_env = _sample_env_texels(scene, u2)
        else:
            # ENV (trace.h:272-296): a cosine hemisphere about the
            # shading normal through the env transform; solid-angle pdf
            h_env = map_to_hemisphere_cosine(u2)
            wi_env = env_transform(scene.env, vm.to_world(
                h_env, frame_t, frame_b, shading_normal))
            li_env = env_radiance(scene.env, scene.textures, wi_env)
            pdf_env = torch.abs(vm.dot(wi_env, shading_normal)) * INV_PI
        m = is_env[:, None]
        wi = torch.where(m, wi_env, wi)
        li = torch.where(m, li_env, li)
        pdf = torch.where(is_env, pdf_env, pdf)
        dist = torch.where(is_env, scene.env.world_radius, dist)
        reject = torch.where(is_env, vm.dot(wi_env, shading_normal) < 0.0,
                             reject)

    if use(T.LIGHT_DIRECTIONAL, T.LIGHT_POINT):
        # delta lights (lights.h:18-34): pdf 1; p0 is the direction toward
        # a directional light and the position of a point light, whose
        # radius slot holds its 1/d^2 attenuation flag (lights.cpp:41-55)
        wi_pnt_raw = p0 - hit_point
        dist_pnt = vm.length(wi_pnt_raw)
        atten = torch.where(radius > 0.0, 1.0 / vm.maximum(
            dist_pnt * dist_pnt, 1e-6), 1.0)
        wi = torch.where(is_dir[:, None], vm.normalize(p0), wi)
        li = torch.where(is_dir[:, None], color * intensity[:, None], li)
        wi = torch.where(is_pnt[:, None], vm.normalize(wi_pnt_raw), wi)
        li = torch.where(is_pnt[:, None],
                         color * (intensity * atten)[:, None], li)
        delta = is_dir | is_pnt
        pdf = torch.where(delta, 1.0, pdf)
        dist = torch.where(is_dir, TMAX, dist)
        dist = torch.where(is_pnt, dist_pnt, dist)
        reject = torch.where(delta, vm.dot(wi, shading_normal) < 0.0, reject)

    valid = ((is_rect | is_sph | is_dsk | is_msh | is_env | is_dir | is_pnt)
             & ~reject & (pdf > 1e-12))
    return LightSample(wi=wi, li=li, distance=dist, pdf=pdf, valid=valid)


def _sample_mesh(scene: T.Scene, mlid_raw, u2):
    """A point on mesh light `mlid_raw` per lane (lights.py:326-368): the
    triangle whose CDF entry is the first >= u2[:, 0] in the light's
    range, found by the JAX code's 32-step binary search, its point
    (1 - sqrt r1) v0 + sqrt r1 (1 - r2) v1 + sqrt r1 r2 v2 with r1 the
    CDF residual; (point, face normal, area pdf)."""
    ml = scene.mesh_lights
    n_cdf = ml.cdf.shape[0]
    mlid = torch.clamp(mlid_raw.to(torch.int64), min=0)
    start = ml.light_offset[mlid].to(torch.int64)
    end = ml.light_offset[torch.clamp(
        mlid + 1, max=ml.light_offset.shape[0] - 1)].to(torch.int64)
    last = torch.maximum(end - 1, start)
    u_cdf = u2[:, 0]
    lo, hi = start, last
    for _ in range(32):
        mid = (lo + hi) // 2
        go_right = ml.cdf[torch.clamp(mid, 0, n_cdf - 1)] < u_cdf
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(
            go_right, hi, mid)
    pos = torch.minimum(torch.maximum(lo, start), last)
    prev_cdf = torch.where(pos > start,
                           ml.cdf[torch.clamp(pos - 1, 0, n_cdf - 1)], 0.0)
    cur_cdf = ml.cdf[torch.clamp(pos, 0, n_cdf - 1)]
    r1 = vm.clip((u_cdf - prev_cdf) / vm.maximum(cur_cdf - prev_cdf, 1e-9),
                 0.0, 1.0)
    tri = ml.tri_index[torch.clamp(pos, 0, ml.tri_index.shape[0] - 1)].to(
        torch.int64)
    tr = scene.triangles
    sqrt_r1 = torch.sqrt(r1)[:, None]
    r2 = u2[:, 1:2]
    sp = ((1.0 - sqrt_r1) * tr.v0[tri] + sqrt_r1 * (1.0 - r2) * tr.v1[tri]
          + sqrt_r1 * r2 * tr.v2[tri])
    pdf = 1.0 / vm.maximum(ml.surface_area[mlid], 1e-9)
    return sp, tr.face_normal[tri], pdf


def _sample_env_texels(scene: T.Scene, u2):
    """The texture env's texel-importance sample (lights.py:263-311): a
    texel (r, c) drawn by its CDF (u2[:, 0], searchsorted side="right"),
    jittered inside the cell getTexColor maps to it (the column by the
    CDF residual, u mod 1; the row by u2[:, 1], its negative half wrapped
    to the far pole), as a lookup direction; returns (world direction
    through transform^T, radiance, solid-angle pdf p_texel / texel solid
    angle)."""
    env = scene.env
    H, W = env.imp_h, env.imp_w
    u_cdf = u2[:, 0]
    tix = torch.clamp(torch.searchsorted(env.flat_cdf, u_cdf.contiguous(),
                                         right=True), 0, H * W - 1)
    p_tex = env.flat_pdf[tix]
    prev_cdf = torch.where(tix > 0, env.flat_cdf[torch.clamp(tix - 1,
                                                             min=0)], 0.0)
    ju = vm.clip((u_cdf - prev_cdf) / vm.maximum(p_tex, 1e-12), 0.0, 1.0)
    r = (tix // W).to(u_cdf.dtype)
    c = (tix % W).to(u_cdf.dtype)
    u_ll = torch.fmod((c - 0.5 + ju) / W, 1.0)
    u_ll = torch.where(u_ll < 0.0, u_ll + 1.0, u_ll)  # jnp.mod's sign rule
    v_raw = (r - 0.5 + u2[:, 1]) / H
    v_ll = vm.clip(torch.where(v_raw < 0.0, 1.0 + v_raw, v_raw), 0.0, 1.0)
    theta = v_ll * PI
    phi = u_ll * TWO_PI - PI
    st = torch.sin(theta)
    d_look = torch.stack([st * torch.cos(phi), torch.cos(theta),
                          st * torch.sin(phi)], dim=-1)
    wi = d_look @ env.transform  # the einsum "ji,nj->ni"
    li = env_radiance(env, scene.textures, d_look)
    omega = (TWO_PI / W) * (PI / H) * vm.maximum(st, 1e-6)
    return wi, li, p_tex / omega
