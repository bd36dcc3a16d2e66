"""Batched ray-primitive intersection (counterpart of
craytracer_tpu/ops/intersect.py: `sphere_ts` :61, `plane_ts` :102,
`rect_ts` :117, `disk_ts` :143, `triangle_ts` :163, the instanced
search `_instanced_object_rays` :198, `_aabox_ts` :209, `_cyl_ts` :223,
`_cap_ts` :245, `_torus_ts` :257, `instanced_ts` :280, the fills
`_newton_t` :318, `_fill_sphere` :325, `_fill_plane` :347, `_fill_rect`
:355, `_fill_disk` :370, `_fill_triangle` :380, `_fill_instanced` :410,
`intersect_scene` :518, `shadow_distance` :685).

Two phases over [N] ray batches, as in the JAX package: a search that
finds the closest primitive per group and keeps the earlier group on a
tie (strict < across groups, in the group order spheres, planes, rects,
disks, triangles, instanced), and a fill that re-derives t (one Newton
step for spheres and instanced shapes), normal, dpdu and uv for the
winning primitive only. Planes, disks and instanced shapes give the
Duff tangent of their (faced) normal as dpdu. Every group but triangles
is brute force over [N, M] (ray, primitive) pairs; an instanced row runs
every kind's formula in its object space (box slab test, open cylinder,
solid-cylinder cap, torus quartic) and keeps its own kind's. Triangles
are brute force too in an accel="none" scene; in an accel="bvh4" scene
they go through the fat-row BVH4 (accel/bvh4.py): with `kernels=True`,
K3 for the closest hit inside the ray_key coherence sort
(ops/raysort.py), as intersect.py:609-620 runs the Pallas kernel, and K4
for the shadow any hit behind a ray_key argsort (:737-747); a scene whose
table was cut into parts (Scene.tri_parts, accel/bvh4_parts.py) walks
the parts instead, K3 `_init` part after part inside the same sort
(:583-616) and K4 per part behind it (:752-766); with `kernels=False`,
the plain traversal of the monolithic table. The tracer
(integrator/wavefront.py) asks for the kernels only for rays on the
card. No Pallas kernel intersects the instanced shapes (pallas_shade.py
:1536-1537): they stay torch ops on every route. Affine products are
written out as ((a0 x + a1 y) + a2 z) + b, the order K1 uses.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from craytracer_tpu_torch.accel import bvh4_kernel, bvh4_parts
from craytracer_tpu_torch.accel.bvh4 import bvh4_any_hit, bvh4_closest_hit
from craytracer_tpu_torch.constants import K_EPSILON, PI, TMAX, TWO_PI
from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.core.aabb import ray_aabb
from craytracer_tpu_torch.core.solvers import solve_quadratic, solve_quartic
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


def plane_ts(o, d, p: T.Planes):
    """rayIntersectPlane (shapes/plane.cpp:4-19) over [N, M] pairs."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    pxp, pyp, pzp = _cols(p.point)
    nx, ny, nz = _cols(p.normal)
    denom = dx * nx + dy * ny + dz * nz
    t = ((pxp - ox) * nx + (pyp - oy) * ny + (pzp - oz) * nz) / vm._safe(denom)
    return torch.where(t > K_EPSILON, t, TMAX)


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


def disk_ts(o, d, k: T.Disks):
    """rayIntersectDisk (shapes/disk.cpp:3-32) over [N, M] pairs."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    cx, cy, cz = _cols(k.center)
    nx, ny, nz = _cols(k.normal)
    denom = dx * nx + dy * ny + dz * nz
    t = ((cx - ox) * nx + (cy - oy) * ny + (cz - oz) * nz) / vm._safe(denom)
    qx = ox + t * dx - cx
    qy = oy + t * dy - cy
    qz = oz + t * dz - cz
    ok = (t > K_EPSILON) & ((qx * qx + qy * qy + qz * qz)
                            <= (k.radius * k.radius)[None, :])
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


def _affine(a, v, b=None):
    """a [..., 3, 3] applied to v [..., 3] (broadcast), plus b [..., 3]."""
    r = (a[..., 0] * v[..., None, 0] + a[..., 1] * v[..., None, 1]
         + a[..., 2] * v[..., None, 2])
    return r if b is None else r + b


def _instanced_object_rays(o, d, inst: T.Instanced):
    """World rays into each instance's object space, [N, M, 3] (transformRay
    in rayIntersectInstanced, shapes/instanced.cpp:48-105). The direction
    is not renormalized, so t parametrizes the world ray."""
    a = inst.inv_transform[None, :, :, :3]
    b = inst.inv_transform[None, :, :, 3]
    return _affine(a, o[:, None, :], b), _affine(a, d[:, None, :])


def _aabox_ts(oo, od, half):
    """The canonical box [-half, half] (initBox, shapes/box.cpp:4-20;
    rayIntersectAABox, shapes/generic.cpp:311-418): the entry distance
    from outside, the exit distance from inside."""
    _, tn, tf = ray_aabb(oo, 1.0 / vm._safe(od), -half, half,
                         -math.inf, math.inf)
    ok = (tn < tf) & (tf > K_EPSILON)
    return torch.where(ok, torch.where(tn > K_EPSILON, tn, tf), TMAX)


def _cyl_ts(oo, od, phi_max, radius=1.0, half_h=1.0):
    """The canonical open cylinder: radius 1, |y| <= 1, |atan2(x, z)| <=
    phi (rayIntersectGenericOpenCylinder, shapes/generic.cpp:34-80)."""
    a = od[..., 0] * od[..., 0] + od[..., 2] * od[..., 2]
    b = 2.0 * (oo[..., 0] * od[..., 0] + oo[..., 2] * od[..., 2])
    c = oo[..., 0] * oo[..., 0] + oo[..., 2] * oo[..., 2] - radius * radius
    _, t0, t1 = solve_quadratic(a, b, c)

    def accept(t):
        hp = oo + t[..., None] * od
        phi = torch.atan2(hp[..., 0], hp[..., 2])
        ok = ((t > K_EPSILON) & (t < TMAX)
              & (torch.abs(hp[..., 1]) <= half_h)
              & (torch.abs(phi) <= phi_max))
        return torch.where(ok, t, TMAX)

    return torch.minimum(accept(t0), accept(t1))


def _cap_ts(oo, od, radius, y):
    """A cap disk at height y with normal sign(y) y-hat
    (initCompoundSolidCylinder, shapes/cylinder.cpp:36-60)."""
    n_sign = torch.sign(y)
    denom = od[..., 1] * n_sign
    t = (y - oo[..., 1]) * n_sign / vm._safe(denom)
    hp_x = oo[..., 0] + t * od[..., 0]
    hp_z = oo[..., 2] + t * od[..., 2]
    ok = (t > K_EPSILON) & (hp_x * hp_x + hp_z * hp_z <= radius * radius)
    return torch.where(ok, t, TMAX)


def _torus_ts(oo, od, swept, tube, phi_max):
    """The canonical torus quartic (rayIntersectGenericTorus,
    shapes/generic.cpp:156-222) with its phi clip applied as intended,
    three Newton steps, as the JAX search takes them."""
    sum_d = vm.dot(od, od)
    e = vm.dot(oo, oo) - swept * swept - tube * tube
    f = vm.dot(oo, od)
    four_a2 = 4.0 * swept * swept
    c4 = sum_d * sum_d
    c3 = 4.0 * sum_d * f
    c2 = (2.0 * sum_d * e + 4.0 * f * f
          + four_a2 * (od[..., 1] * od[..., 1]))
    c1 = 4.0 * f * e + 2.0 * four_a2 * oo[..., 1] * od[..., 1]
    c0 = e * e - four_a2 * (tube * tube - oo[..., 1] * oo[..., 1])
    inv = 1.0 / vm._safe(c4)
    roots, valid = solve_quartic(c3 * inv, c2 * inv, c1 * inv, c0 * inv,
                                 newton_iters=3)
    roots = torch.where(valid & (roots > K_EPSILON), roots, TMAX)
    t = roots.amin(dim=-1)
    hp = oo + t[..., None] * od
    phi = torch.atan2(hp[..., 0], hp[..., 2])
    return torch.where((t < TMAX) & (torch.abs(phi) <= phi_max), t, TMAX)


def instanced_ts(o, d, inst: T.Instanced):
    """[N, M] distances for instanced rows: every kind's formula runs for
    every row and the row's kind picks one (the switch-free dispatch)."""
    oo, od = _instanced_object_rays(o, d, inst)
    p = inst.params[None, :, :]
    kind = inst.kind[None, :]
    t = torch.where(kind == T.INST_AABOX, _aabox_ts(oo, od, p[..., 0:3] / 2.0),
                    TMAX)
    t = torch.where(kind == T.INST_OPEN_CYLINDER, _cyl_ts(oo, od, p[..., 0]),
                    t)
    t = torch.where(kind == T.INST_TORUS,
                    _torus_ts(oo, od, p[..., 0], p[..., 1], p[..., 2]), t)
    return torch.where(kind == T.INST_DISK,
                       _cap_ts(oo, od, p[..., 0], p[..., 1]), t)


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


def _fill_plane(o, d, t, idx, p: T.Planes):
    """Planes never flip their normal (_fill_plane)."""
    n, p0 = p.normal[idx], p.point[idx]
    t_diff = vm.dot(p0 - o, n) / vm._safe(vm.dot(d, n))
    tang, _, _ = vm.orthonormal_basis(n)
    return n, tang, torch.zeros_like(o[:, :2]), p.mat_id[idx], t_diff


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


def _fill_disk(o, d, t, idx, k: T.Disks):
    """Disks face the ray (_fill_disk)."""
    n, c0 = k.normal[idx], k.center[idx]
    t_diff = vm.dot(c0 - o, n) / vm._safe(vm.dot(d, n))
    n = torch.where((vm.dot(-d, n) < 0.0)[:, None], -n, n)
    tang, _, _ = vm.orthonormal_basis(n)
    return n, tang, torch.zeros_like(o[:, :2]), k.mat_id[idx], t_diff


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


def _dominant_axis(rel):
    """sign(rel[k]) e_k for k = argmax |rel| (first of a tie; sign 0 at
    0): the box face a point lies on."""
    ax = torch.argmax(torch.abs(rel), dim=-1, keepdim=True)
    sgn = torch.sign(torch.gather(rel, -1, ax))
    return sgn * torch.nn.functional.one_hot(ax[:, 0], 3).to(rel.dtype)


def _fill_instanced(o, d, t, idx, inst: T.Instanced):
    """Instanced fill (_fill_instanced): the object-space ray, one Newton
    step on the kind's implicit along the ray, the object normal (box:
    the dominant face; cylinder: per normal_type; torus: the gradient,
    faced toward the ray; cap: sign(y) y-hat), pushed to world space
    through normal_mat; boxes and caps face the ray; the open cylinder's
    uv."""
    a, nm, kind = inst.inv_transform[idx], inst.normal_mat[idx], inst.kind[idx]
    p, ntype = inst.params[idx], inst.normal_type[idx]
    oo = _affine(a[:, :, :3], o, a[:, :, 3])
    od = _affine(a[:, :, :3], d)
    hp = oo + t[:, None] * od
    swept, tube = p[:, 0], p[:, 1]
    half = p[:, 0:3] / 2.0
    nf = _dominant_axis(hp / vm._safe(half))
    F_box = vm.dot(hp, nf) - vm.dot(half, torch.abs(nf))
    Fp_box = vm.dot(od, nf)
    F_cyl = hp[:, 0] * hp[:, 0] + hp[:, 2] * hp[:, 2] - 1.0
    Fp_cyl = 2.0 * (hp[:, 0] * od[:, 0] + hp[:, 2] * od[:, 2])
    et = vm.dot(hp, hp) - swept * swept - tube * tube
    F_tor = (et * et + 4.0 * swept * swept
             * (hp[:, 1] * hp[:, 1] - tube * tube))
    Fp_tor = (4.0 * et * vm.dot(hp, od)
              + 8.0 * swept * swept * hp[:, 1] * od[:, 1])
    F_cap = hp[:, 1] - p[:, 1]
    F = torch.where(kind == T.INST_AABOX, F_box, 0.0)
    Fp = torch.where(kind == T.INST_AABOX, Fp_box, 1.0)
    for k, Fk, Fpk in ((T.INST_OPEN_CYLINDER, F_cyl, Fp_cyl),
                       (T.INST_TORUS, F_tor, Fp_tor),
                       (T.INST_DISK, F_cap, od[:, 1])):
        F = torch.where(kind == k, Fk, F)
        Fp = torch.where(kind == k, Fpk, Fp)
    t_diff = t - F / vm._safe(Fp)
    hp = oo + t_diff[:, None] * od

    n_box = _dominant_axis(hp / vm._safe(half))
    zero = torch.zeros_like(t)
    n_side = torch.stack([hp[:, 0], zero, hp[:, 2]], dim=-1)
    flip_open = (ntype == T.NORMAL_OPEN) & (vm.dot(-od, n_side) < 0)
    n_cyl = torch.where(flip_open[:, None], -n_side, n_side)
    n_cyl = torch.where((ntype == T.NORMAL_CONCAVE)[:, None], -n_side, n_cyl)
    uv_cyl = torch.stack([torch.atan2(hp[:, 2], hp[:, 0]) / vm._safe(p[:, 0]),
                          (hp[:, 1] + 1.0) / 2.0], dim=-1)
    g = vm.dot(hp, hp) - (swept * swept + tube * tube)
    n_tor = torch.stack([4.0 * hp[:, 0] * g,
                         4.0 * hp[:, 1] * (g + 2.0 * swept * swept),
                         4.0 * hp[:, 2] * g], dim=-1)
    n_tor = torch.where((vm.dot(-od, n_tor) < 0)[:, None], -n_tor, n_tor)
    n_cap = torch.stack([zero, torch.sign(p[:, 1]), zero], dim=-1)
    n_obj = torch.where((kind == T.INST_AABOX)[:, None], n_box, n_side)
    for k, nk in ((T.INST_OPEN_CYLINDER, n_cyl), (T.INST_TORUS, n_tor),
                  (T.INST_DISK, n_cap)):
        n_obj = torch.where((kind == k)[:, None], nk, n_obj)
    n = vm.normalize(_affine(nm, n_obj))
    box_or_cap = (kind == T.INST_AABOX) | (kind == T.INST_DISK)
    n = torch.where((box_or_cap & (vm.dot(n, d) > 0.0))[:, None], -n, n)
    tang, _, _ = vm.orthonormal_basis(n)
    uv = torch.where((kind == T.INST_OPEN_CYLINDER)[:, None], uv_cyl,
                     torch.zeros_like(uv_cyl))
    return n, tang, uv, inst.mat_id[idx], t_diff


# intersect_scene's group order (intersect.py:504-511)
_GROUPS = (
    (T.GROUP_SPHERE, "spheres", sphere_ts, _fill_sphere),
    (T.GROUP_PLANE, "planes", plane_ts, _fill_plane),
    (T.GROUP_RECT, "rects", rect_ts, _fill_rect),
    (T.GROUP_DISK, "disks", disk_ts, _fill_disk),
    (T.GROUP_TRIANGLE, "triangles", triangle_ts, _fill_triangle),
    (T.GROUP_INSTANCED, "instanced", instanced_ts, _fill_instanced),
)


def _tri_closest(scene: T.Scene, o, d, kernels: bool):
    """(t, index) of the closest triangle per ray (index 0 on a miss)."""
    if scene.accel == "bvh4":
        if kernels and scene.tri_parts is not None:
            t, tri = sorted_traversal(
                lambda oo, dd: bvh4_parts.parts_closest_hit_kernel(
                    scene.tri_parts, oo, dd), o, d)
        elif kernels:
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
    `kernels` routes a bvh4 scene's triangles through K3 (K3 `_init` per
    part when the table was cut into parts)."""
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
    any hit through K4 in ray_key order (per part when the table was cut
    into parts)."""
    n = o.shape[0]
    best_t = torch.full((n,), TMAX, dtype=o.dtype, device=o.device)
    for gid, name, ts_fn, _ in _GROUPS:
        group = getattr(scene, name)
        if group.mat_id.shape[0] == 0:
            continue
        if gid == T.GROUP_TRIANGLE and scene.accel == "bvh4":
            md = (torch.full_like(best_t, TMAX) if max_dist is None
                  else max_dist)
            if kernels and scene.tri_parts is not None:
                t = sorted_traversal(
                    lambda oo, dd, mm: bvh4_parts.parts_any_hit_kernel(
                        scene.tri_parts, oo, dd, mm), o, d, md)
            elif kernels:
                t = sorted_traversal(
                    lambda oo, dd, mm: bvh4_kernel.bvh4_any_hit_kernel(
                        scene.tri_bvh, oo, dd, mm), o, d, md)
            else:
                t = bvh4_any_hit(scene.tri_bvh, o, d, md)
        else:
            t = ts_fn(o, d, group).min(dim=1).values
        best_t = torch.minimum(best_t, t)
    return best_t
