"""Batched ray-primitive intersection (counterpart of
craytracer_tpu/ops/intersect.py: `sphere_ts` :61, `rect_ts` :117,
`triangle_ts` :163, `_newton_t` :318, `_fill_sphere` :325, `_fill_rect`
:355, `_fill_triangle` :380, `intersect_scene` :518, `shadow_distance`
:685).

Two phases over [N] ray batches, as in the JAX package: a search that
finds the closest primitive per group and keeps the earlier group on a
tie (strict < across groups, in the group order spheres, rects,
triangles), and a fill that re-derives t (one Newton step for spheres),
normal (flat or smooth), dpdu and uv for the winning primitive only.
Spheres (with their phi/theta clip window in the atan2/acos form) and
rects are always brute force over [N, M] (ray, primitive) pairs.
Triangles are brute force too in an accel="none" scene; in an
accel="bvh4" scene they go through the fat-row BVH4 (accel/bvh4.py):
with `kernels=True`, K3 for the closest hit inside the ray_key coherence
sort (ops/raysort.py), as intersect.py:609-620 runs the Pallas kernel,
and K4 for the shadow any hit behind a ray_key argsort (:737-747); with
`kernels=False`, the plain traversal. The tracer
(integrator/wavefront.py) asks for the kernels only for rays on the
card.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from craytracer_tpu_torch.accel import bvh4_kernel
from craytracer_tpu_torch.accel.bvh4 import bvh4_any_hit, bvh4_closest_hit
from craytracer_tpu_torch.constants import K_EPSILON, PI, TMAX, TWO_PI
from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.core.solvers import solve_quadratic
from craytracer_tpu_torch.ops.raysort import sorted_traversal
from craytracer_tpu_torch.scene import types as T


@dataclass(frozen=True)
class Hit:
    """SoA hit record (intersect.py:34-49)."""

    t: torch.Tensor  # [N]
    group: torch.Tensor  # [N] int32 GROUP_*, -1 for miss
    prim: torch.Tensor  # [N] int32 index within group
    point: torch.Tensor  # [N, 3]
    normal: torch.Tensor  # [N, 3]
    dpdu: torch.Tensor  # [N, 3]
    uv: torch.Tensor  # [N, 2]
    mat_id: torch.Tensor  # [N] int32

    @property
    def hit_mask(self):
        return self.t < TMAX


def _cols(v):
    """[M, 3] -> three [1, M] rows."""
    return v[None, :, 0], v[None, :, 1], v[None, :, 2]


def sphere_ts(o, d, s: T.Spheres):
    """Partial-sphere hit distances (rayIntersectSphere,
    shapes/sphere.cpp:33-86) over [N, M] pairs: the quadratic's roots, each
    accepted only inside the clip window |atan2(x, z)| <= phi, theta in
    [min_theta, max_theta]. As in the reference, acos((y - cy) / r) is
    unclamped: |cos| > 1 misses."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    cx, cy, cz = _cols(s.center)
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c = (ocx * ocx + ocy * ocy + ocz * ocz) - (s.radius * s.radius)[None, :]
    _, t0, t1 = solve_quadratic(a, b, c)

    def accept(t):
        hx = ox + t * dx - cx
        hy = oy + t * dy - cy
        hz = oz + t * dz - cz
        phi = torch.atan2(hx, hz)  # the reference's atan2(x, z)
        cos_raw = hy / s.radius[None, :]
        theta = torch.acos(torch.clamp(cos_raw, -1.0, 1.0))
        ok = ((t > K_EPSILON) & (t < TMAX)
              & (torch.abs(phi) <= s.phi[None, :])
              & (theta >= s.min_theta[None, :])
              & (theta <= s.max_theta[None, :])
              & (torch.abs(cos_raw) <= 1.0))
        return torch.where(ok, t, TMAX)

    return torch.minimum(accept(t0), accept(t1))


def rect_ts(o, d, r: T.Rects):
    """rayIntersectRect (shapes/rect.cpp:3-54) over [N, M] pairs."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    pxr, pyr, pzr = _cols(r.point)
    nx, ny, nz = _cols(r.normal)
    wx, wy, wz = _cols(r.width)
    hx, hy, hz = _cols(r.height)
    denom = dx * nx + dy * ny + dz * nz
    t = ((pxr - ox) * nx + (pyr - oy) * ny + (pzr - oz) * nz) / vm._safe(denom)
    qx = ox + t * dx - pxr
    qy = oy + t * dy - pyr
    qz = oz + t * dz - pzr
    u = (qx * wx + qy * wy + qz * wz) / (wx * wx + wy * wy + wz * wz)
    v = (qx * hx + qy * hy + qz * hz) / (hx * hx + hy * hy + hz * hz)
    ok = (t > K_EPSILON) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    return torch.where(ok, t, TMAX)


def triangle_ts(o, d, tr: T.Triangles):
    """Moller-Trumbore over [N, M] pairs (shapes/triangle.cpp:14-79)."""
    e1 = tr.v1 - tr.v0
    e2 = tr.v2 - tr.v0
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = _cols(tr.v0)
    e1x, e1y, e1z = _cols(e1)
    e2x, e2y, e2z = _cols(e2)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / vm._safe(det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    beta = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    gamma = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0)
          & (t > K_EPSILON))
    return torch.where(ok, t, TMAX)


def _fill_sphere(o, d, t, idx, s: T.Spheres):
    """Sphere attributes (fillShadeRecSphere, shapes/sphere.cpp:4-31): one
    Newton step on F(t) = |o + t d - c|^2 - r^2 (the JAX fill's
    `_newton_t`, whose detached derivative changes no value), the normal
    from the refined point, uv from atan2/acos, dpdu ~ (-(z-cz), 0,
    x-cx)."""
    c, r, mat_id = s.center[idx], s.radius[idx], s.mat_id[idx]
    oc = o + t[:, None] * d - c
    F = vm.dot(oc, oc) - r * r
    Fp = 2.0 * vm.dot(oc, d)
    t_diff = t - F / vm._safe(Fp)
    hp = o + t_diff[:, None] * d
    n = vm.normalize(hp - c)
    rel = hp - c
    phi = torch.atan2(rel[:, 0], rel[:, 2])
    phi_w = torch.where(phi < 0, phi + TWO_PI, phi)
    theta = torch.acos(torch.clamp(rel[:, 1] / vm._safe(r), -1.0 + 1e-6,
                                   1.0 - 1e-6))
    uv = torch.stack([phi_w / TWO_PI, theta / PI], dim=-1)
    dpdu = vm.normalize(torch.stack([-rel[:, 2], torch.zeros_like(t),
                                     rel[:, 0]], dim=-1))
    return n, dpdu, uv, mat_id, t_diff


def _fill_rect(o, d, t, idx, r: T.Rects):
    n, w, p0, mat_id = r.normal[idx], r.width[idx], r.point[idx], r.mat_id[idx]
    h = r.height[idx]
    t_diff = vm.dot(p0 - o, n) / vm._safe(vm.dot(d, n))
    hp = o + t_diff[:, None] * d
    q = hp - p0
    u = vm.dot(q, w) / vm.dot(w, w)
    v = vm.dot(q, h) / vm.dot(h, h)
    # face the normal toward wo, negating dpdu with it (rect.cpp:36-46)
    flip = (vm.dot(-d, n) < 0.0)[:, None]
    n = torch.where(flip, -n, n)
    dpdu = vm.normalize(torch.where(flip, -w, w))
    return n, dpdu, torch.stack([u, v], dim=-1), mat_id, t_diff


def _fill_triangle(o, d, t, idx, tr: T.Triangles):
    v0, v1, v2 = tr.v0[idx], tr.v1[idx], tr.v2[idx]
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = vm.cross(d, e2)
    det = vm.dot(e1, pvec)
    inv_det = 1.0 / vm._safe(det)
    tvec = o - v0
    beta = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, e1)
    gamma = vm.dot(d, qvec) * inv_det
    t_diff = vm.dot(e2, qvec) * inv_det
    alpha = 1.0 - beta - gamma
    ns = vm.normalize(alpha[:, None] * tr.n0[idx] + beta[:, None] * tr.n1[idx]
                      + gamma[:, None] * tr.n2[idx])
    n = torch.where(tr.smooth[idx][:, None], ns, tr.face_normal[idx])
    # standalone triangles face the ray (shapes/triangle.cpp:160-166)
    flip = (tr.double_sided[idx] & (vm.dot(-d, n) < 0.0))[:, None]
    n = torch.where(flip, -n, n)
    uv = (alpha[:, None] * tr.uv0[idx] + beta[:, None] * tr.uv1[idx]
          + gamma[:, None] * tr.uv2[idx])
    uv = uv - torch.floor(uv)
    return n, vm.normalize(e1), uv, tr.mat_id[idx], t_diff


# intersect_scene's group order (intersect.py:504-511), restricted to the
# groups the port's builder emits
_GROUPS = (
    (T.GROUP_SPHERE, "spheres", sphere_ts, _fill_sphere),
    (T.GROUP_RECT, "rects", rect_ts, _fill_rect),
    (T.GROUP_TRIANGLE, "triangles", triangle_ts, _fill_triangle),
)


def _tri_closest(scene: T.Scene, o, d, kernels: bool):
    """(t, index) of the closest triangle per ray (index 0 on a miss)."""
    if scene.accel == "bvh4":
        if kernels:
            t, tri = sorted_traversal(
                lambda oo, dd: bvh4_kernel.bvh4_closest_hit_kernel(
                    scene.tri_bvh, oo, dd), o, d)
        else:
            t, tri = bvh4_closest_hit(scene.tri_bvh, o, d)
        return t, torch.clamp(tri, min=0).to(torch.int64)
    return torch.min(triangle_ts(o, d, scene.triangles), dim=1)


@torch.no_grad()
def intersect_scene(scene: T.Scene, o, d, kernels: bool = False) -> Hit:
    """Closest hit across the primitive groups: first minimum within a
    group, strict < across groups (the reference's tie-break order).
    `kernels` routes a bvh4 scene's triangles through K3."""
    n = o.shape[0]
    best_t = torch.full((n,), TMAX, dtype=o.dtype, device=o.device)
    best_group = torch.full((n,), T.GROUP_NONE, dtype=torch.int32,
                            device=o.device)
    best_idx = torch.zeros((n,), dtype=torch.int64, device=o.device)
    for gid, name, ts_fn, _ in _GROUPS:
        group = getattr(scene, name)
        if group.mat_id.shape[0] == 0:
            continue
        if gid == T.GROUP_TRIANGLE:
            gmin, gidx = _tri_closest(scene, o, d, kernels)
        else:
            gmin, gidx = torch.min(ts_fn(o, d, group), dim=1)
        better = gmin < best_t
        best_t = torch.where(better, gmin, best_t)
        best_group = torch.where(better, gid, best_group)
        best_idx = torch.where(better, gidx, best_idx)

    hit = best_t < TMAX
    normal = torch.zeros_like(o)
    normal[:, 2] = 1.0
    dpdu = torch.zeros_like(o)
    dpdu[:, 0] = 1.0
    uv = torch.zeros((n, 2), dtype=o.dtype, device=o.device)
    mat_id = torch.zeros((n,), dtype=torch.int32, device=o.device)
    t_out = best_t
    # fills see t = 1 on miss lanes (whose values are discarded), not TMAX
    t_fill = torch.where(hit, best_t, 1.0)
    for gid, name, _, fill_fn in _GROUPS:
        group = getattr(scene, name)
        if group.mat_id.shape[0] == 0:
            continue
        # clamp: lanes of other groups index this group's table too; their
        # values are discarded by the select below
        idx = torch.clamp(best_idx, max=group.mat_id.shape[0] - 1)
        g_n, g_dpdu, g_uv, g_mat, g_t = fill_fn(o, d, t_fill, idx, group)
        sel = best_group == gid
        normal = torch.where(sel[:, None], g_n, normal)
        dpdu = torch.where(sel[:, None], g_dpdu, dpdu)
        uv = torch.where(sel[:, None], g_uv, uv)
        mat_id = torch.where(sel, g_mat, mat_id)
        t_out = torch.where(sel, g_t, t_out)
    point = torch.where(hit[:, None], o + t_out[:, None] * d,
                        torch.zeros_like(o))
    return Hit(t=t_out, group=best_group, prim=best_idx.to(torch.int32),
               point=point, normal=normal, dpdu=dpdu, uv=uv, mat_id=mat_id)


@torch.no_grad()
def shadow_distance(scene: T.Scene, o, d, max_dist=None,
                    kernels: bool = False):
    """Hit distance for shadow rays: the minimum over the brute-force
    groups, and for a bvh4 scene's triangles the any hit under `max_dist`
    (t < max_dist when occluded, TMAX otherwise). `kernels` routes that
    any hit through K4 in ray_key order."""
    n = o.shape[0]
    best_t = torch.full((n,), TMAX, dtype=o.dtype, device=o.device)
    for gid, name, ts_fn, _ in _GROUPS:
        group = getattr(scene, name)
        if group.mat_id.shape[0] == 0:
            continue
        if gid == T.GROUP_TRIANGLE and scene.accel == "bvh4":
            md = (torch.full_like(best_t, TMAX) if max_dist is None
                  else max_dist)
            if kernels:
                t = sorted_traversal(
                    lambda oo, dd, mm: bvh4_kernel.bvh4_any_hit_kernel(
                        scene.tri_bvh, oo, dd, mm), o, d, md)
            else:
                t = bvh4_any_hit(scene.tri_bvh, o, d, md)
        else:
            t = ts_fn(o, d, group).min(dim=1).values
        best_t = torch.minimum(best_t, t)
    return best_t
