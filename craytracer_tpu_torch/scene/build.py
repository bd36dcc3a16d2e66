"""Host-side scene builder: Python API -> scene tensors (counterpart of
craytracer_tpu/scene/build.py; `beckmann_roughness_to_alpha` :31,
`_affine_inverse_rows` :65, `SceneBuilder` :84, the material adders
:112-159, `add_texture` :171, `add_sphere` :181, `add_plane` :185,
`add_rect` :191, `add_disk` :199, `add_triangle` :205,
`add_triangles_array` :222, `add_mesh` :254, the instanced adders
:290-323, `add_directional_light` :327, `add_point_light` :331,
`set_env_light` :340, `_scene_bounds` :355, `build` :405,
`_build_textures` :626, `_build_lights` :645).

The accumulation runs in numpy with the JAX builder's exact arithmetic
(same dtypes, same order), so both packages emit bit-identical tables:
all seven material types (MATTE with its Oren-Nayar A/B, MIRROR,
TRANSPARENT, EMISSIVE, PLASTIC, GLASS, METAL with its eta/k presets and
the microfacet alphas and distribution) with their diffuse and normal
map texture ids, the packed texel pool, spheres with their phi/theta
clip window, planes, rects, disks, triangles, the instanced boxes, open
and solid cylinders (a tube and two INST_DISK caps) and tori behind
their world -> object affines, the area lights derived from emissive
rects, spheres and disks, the mesh lights of emissive meshes with their
area CDFs, the directional and point lights, the light power in either
mode ("reference": the reference's product-of-components area power and
mesh lights at 0; "principled": mean color x intensity x area for every
area and mesh light), the normalized power CDF, the env light (constant,
or a texture with the fixed rot-y and its texel CDF), the env world
radius (instanced shapes bounded through their affines), mesh triangles
baked to world space (flat or smooth), the SAH fat-row BVH4
(accel/bvh4.py) and, for 256 or more spheres with an accelerator asked
for, the sphere BVH4 (accel/bvh4_sphere.py). A mesh's triangles are
baked in one numpy pass; their face normals equal the JAX builder's
per-triangle ones bit for bit (`_face_normals`). The other accelerators
raise NotImplementedError naming the ROADMAP item that will port them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from craytracer_tpu_torch.constants import METAL_PRESETS, PI
from craytracer_tpu_torch.core.math import euler_to_mat3, rotate_y
from craytracer_tpu_torch.scene import types as T

def beckmann_roughness_to_alpha(roughness: float) -> float:
    """BeckmannRoughnessToAlpha (microfacet.h:26-32; build.py:31-41)."""
    roughness = max(roughness, 1e-3)
    x = math.log(roughness)
    return (
        1.62142
        + 0.819955 * x
        + 0.1734 * x * x
        + 0.0171201 * x**3
        + 0.000640711 * x**4
    )


def _affine_inverse_rows(location, scale, orientation):
    """The world -> object affine S^-1 R^-1 T^-1 [3, 4] and the normal
    matrix R S^-1 = (M^-1)^T for M = T R S, both f32, computed in f64 as
    build.py:65-81 does (scene/scenefile.h:497-507)."""
    loc = np.asarray(location, np.float64)
    sc = np.asarray(scale, np.float64)
    rot = euler_to_mat3(orientation).astype(np.float64)
    inv_s = np.diag(1.0 / sc)
    m3 = inv_s @ rot.T
    t = m3 @ (-loc)
    inv_transform = np.concatenate([m3, t[:, None]], axis=1)
    return inv_transform.astype(np.float32), (rot @ inv_s).astype(np.float32)


@dataclass
class _Mat:
    name: str
    mat_type: int
    color: tuple = (0.0, 0.0, 0.0)
    ks: tuple = (0.0, 0.0, 0.0)
    sigma: float = 0.0
    ior_in: float = 1.5
    ior_out: float = 1.0
    cf_in: tuple = (1.0, 1.0, 1.0)
    cf_out: tuple = (1.0, 1.0, 1.0)
    eta: tuple = (1.0, 1.0, 1.0)
    k: tuple = (0.0, 0.0, 0.0)
    alphax: float = 0.0
    alphay: float = 0.0
    distrib: int = T.DIST_BECKMANN
    intensity: float = 0.0
    diffuse_tex: int = -1
    normal_tex: int = -1


def _face_normals(v0, v1, v2):
    """[T, 3] f32 face normals equal bit for bit to add_triangle's
    per-triangle ones (build.py:211-213): cross of the f32 edges in f64,
    over np.linalg.norm of that one vector, [0, 0, 1] when it is 0.
    np.linalg.norm of a 3-vector is BLAS ddot, whose summation order
    differs from a vectorized sum in the last f64 bit; the f32 result is
    taken vectorized where a margin of 2^-48 around the norm cannot
    change it, and from np.linalg.norm row by row elsewhere (a handful
    of rows in a million)."""
    fn = np.cross((v1 - v0).astype(np.float64), (v2 - v0).astype(np.float64))
    sq = fn[:, 0] * fn[:, 0] + fn[:, 1] * fn[:, 1] + fn[:, 2] * fn[:, 2]
    norm = np.sqrt(sq)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        out = (fn / (norm * (1.0 - 2.0 ** -48))).astype(np.float32)
        hi = (fn / (norm * (1.0 + 2.0 ** -48))).astype(np.float32)
    unsure = ((out != hi).any(axis=1) | ~(sq > 1e-280)
              | ~np.isfinite(sq))
    for i in np.flatnonzero(unsure):
        n = np.linalg.norm(fn[i])
        out[i] = (fn[i] / n if n > 0 else np.array([0.0, 0.0, 1.0])
                  ).astype(np.float32)
    return out


class SceneBuilder:
    """Accumulates primitives, meshes, materials and the env light, then
    `build()`s the Scene (build.py:84-833)."""

    def __init__(self):
        self._mats: list[_Mat] = []
        self._mat_index: dict[str, int] = {}
        self._spheres = []
        self._planes = []
        self._rects = []
        self._disks = []
        self._instanced = []
        # the JAX builder's per-triangle list as [T]-row blocks of the 13
        # triangle columns (a single triangle is a block of one row; a
        # mesh one block), in the order they were added
        self._triangles = []
        self._n_listed = 0  # rows in self._triangles
        self._bulk_triangles = []  # add_triangles_array's blocks, after them
        self._tri_columns = None  # merged columns, set by build()
        self._extra_lights = []  # directional and point lights
        self._env: Optional[dict] = None
        self._textures = []  # [H, W, 3] f32 each
        self._tex_index: dict[str, int] = {}
        self._mesh_light_ranges = []  # (start, end, mat_id) triangle rows
        self.add_material(_Mat(name="__default__", mat_type=T.MAT_MATTE,
                               color=(0.5, 0.5, 0.5)))

    # -- materials ---------------------------------------------------------

    def add_material(self, mat: _Mat) -> int:
        idx = len(self._mats)
        self._mats.append(mat)
        self._mat_index[mat.name] = idx
        return idx

    def add_matte(self, name, color=(0.5, 0.5, 0.5), sigma=0.0,
                  diffuse_tex=-1, normal_tex=-1):
        return self.add_material(_Mat(name=name, mat_type=T.MAT_MATTE,
                                      color=tuple(color), sigma=float(sigma),
                                      diffuse_tex=diffuse_tex,
                                      normal_tex=normal_tex))

    def add_mirror(self, name, color=(1.0, 1.0, 1.0)):
        return self.add_material(_Mat(name=name, mat_type=T.MAT_MIRROR,
                                      color=tuple(color)))

    def add_transparent(self, name, ior_in=1.5, ior_out=1.0, cf_in=(1, 1, 1),
                        cf_out=(1, 1, 1)):
        return self.add_material(_Mat(
            name=name, mat_type=T.MAT_TRANSPARENT, ior_in=float(ior_in),
            ior_out=float(ior_out), cf_in=tuple(cf_in), cf_out=tuple(cf_out)))

    def add_emissive(self, name, color=(1.0, 1.0, 1.0), intensity=1.0):
        return self.add_material(_Mat(name=name, mat_type=T.MAT_EMISSIVE,
                                      color=tuple(color),
                                      intensity=float(intensity)))

    def add_plastic(self, name, kd=(0.5, 0.5, 0.5), ks=(0.5, 0.5, 0.5),
                    roughness=0.1, diffuse_tex=-1):
        """FresnelBlend: the raw roughness is the alpha
        (BSDF_addFresnelBlendSpecular, reflection.cpp:945-963)."""
        return self.add_material(_Mat(
            name=name, mat_type=T.MAT_PLASTIC, color=tuple(kd), ks=tuple(ks),
            alphax=float(roughness), alphay=float(roughness), ior_in=1.5,
            ior_out=1.0, diffuse_tex=diffuse_tex))

    def add_glass(self, name, roughness=0.0, ior_in=1.5, ior_out=1.0):
        """Rough dielectric: roughness maps to alpha
        (BSDF_addMicrofacetFresnel, reflection.cpp:916-929)."""
        a = beckmann_roughness_to_alpha(float(roughness))
        return self.add_material(_Mat(
            name=name, mat_type=T.MAT_GLASS, alphax=a, alphay=a,
            ior_in=float(ior_in), ior_out=float(ior_out)))

    def add_metal(self, name, preset="GOLD", roughness=0.05, eta=None,
                  k=None):
        """Conductor microfacet: the raw roughness is the alpha
        (BSDF_addMicrofacetReflectionMetal, reflection.cpp:886-907); an
        unknown preset name is GOLD."""
        if eta is None or k is None:
            eta, k = METAL_PRESETS.get(preset.upper(), METAL_PRESETS["GOLD"])
        return self.add_material(_Mat(
            name=name, mat_type=T.MAT_METAL, eta=tuple(eta), k=tuple(k),
            alphax=float(roughness), alphay=float(roughness)))

    def material_id(self, name) -> int:
        if isinstance(name, int):
            return name
        return self._mat_index.get(name, 0)

    # -- textures ----------------------------------------------------------

    def add_texture(self, name: str, data: np.ndarray) -> int:
        """The texture's id; a name added before keeps its first image."""
        if name in self._tex_index:
            return self._tex_index[name]
        self._textures.append(np.asarray(data, np.float32))
        self._tex_index[name] = len(self._textures) - 1
        return self._tex_index[name]

    # -- primitives --------------------------------------------------------

    def add_sphere(self, center, radius, mat, phi=PI, min_theta=0.0,
                   max_theta=PI):
        """A sphere clipped to |atan2(x, z)| <= phi and theta in
        [min_theta, max_theta] (shapes/sphere.cpp:33-86)."""
        self._spheres.append((np.asarray(center, np.float32), float(radius),
                              float(phi), float(min_theta), float(max_theta),
                              self.material_id(mat)))

    def add_plane(self, point, normal, mat):
        n = np.asarray(normal, np.float64)
        n = n / np.linalg.norm(n)
        self._planes.append((np.asarray(point, np.float32),
                             n.astype(np.float32), self.material_id(mat)))

    def add_rect(self, point, width, height, mat):
        w = np.asarray(width, np.float64)
        h = np.asarray(height, np.float64)
        n = np.cross(w, h)
        n = n / np.linalg.norm(n)
        self._rects.append((np.asarray(point, np.float32), w.astype(np.float32),
                            h.astype(np.float32), n.astype(np.float32),
                            self.material_id(mat)))

    def add_disk(self, center, normal, radius, mat):
        n = np.asarray(normal, np.float64)
        n = n / np.linalg.norm(n)
        self._disks.append((np.asarray(center, np.float32),
                            n.astype(np.float32), float(radius),
                            self.material_id(mat)))

    def add_triangle(self, v0, v1, v2, mat, n0=None, n1=None, n2=None,
                     uv0=(0, 0), uv1=(0, 0), uv2=(0, 0), smooth=False,
                     double_sided=True):
        """One triangle (build.py:205-220): face normal in f64, vertex
        normals default to it."""
        v0 = np.asarray(v0, np.float32)
        v1 = np.asarray(v1, np.float32)
        v2 = np.asarray(v2, np.float32)
        fn = np.cross((v1 - v0).astype(np.float64),
                      (v2 - v0).astype(np.float64))
        norm = np.linalg.norm(fn)
        fn = (fn / norm if norm > 0 else np.array([0.0, 0.0, 1.0])
              ).astype(np.float32)
        n0 = fn if n0 is None else np.asarray(n0, np.float32)
        n1 = fn if n1 is None else np.asarray(n1, np.float32)
        n2 = fn if n2 is None else np.asarray(n2, np.float32)
        row = (v0, v1, v2, n0, n1, n2, np.asarray(uv0, np.float32),
               np.asarray(uv1, np.float32), np.asarray(uv2, np.float32), fn,
               np.asarray(bool(smooth)), np.asarray(bool(double_sided)),
               np.asarray(self.material_id(mat), np.int32))
        self._triangles.append(tuple(x[None] for x in row))
        self._n_listed += 1

    def add_triangles_array(self, v0, v1, v2, mat, normals=None, uvs=None,
                            smooth=False, double_sided=False):
        """Bulk-add a triangle soup ([T, 3] corner arrays; `normals` and
        `uvs` optional per-corner triples), build.py:222-249. Returns the
        (start, end) triangle range."""
        v0 = np.asarray(v0, np.float32).reshape(-1, 3)
        v1 = np.asarray(v1, np.float32).reshape(-1, 3)
        v2 = np.asarray(v2, np.float32).reshape(-1, 3)
        t = v0.shape[0]
        fn = np.cross((v1 - v0).astype(np.float64),
                      (v2 - v0).astype(np.float64))
        lens = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = (fn / np.where(lens > 0, lens, 1.0)).astype(np.float32)
        n0, n1, n2 = (fn, fn, fn) if normals is None else [
            np.asarray(x, np.float32) for x in normals]
        z2 = np.zeros((t, 2), np.float32)
        uv0, uv1, uv2 = (z2, z2, z2) if uvs is None else [
            np.asarray(x, np.float32) for x in uvs]
        mat_id = self.material_id(mat)
        start = self.num_triangles()
        self._bulk_triangles.append((
            v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, fn,
            np.full(t, bool(smooth)), np.full(t, bool(double_sided)),
            np.full(t, mat_id, np.int32)))
        if self._mats[mat_id].mat_type == T.MAT_EMISSIVE:
            self._mesh_light_ranges.append((start, start + t, mat_id))
        return start, start + t

    def num_triangles(self) -> int:
        return self._n_listed + sum(b[0].shape[0]
                                    for b in self._bulk_triangles)

    def add_mesh(self, positions, indices, mat, normals=None, uvs=None,
                 smooth=False, scaling=(1, 1, 1), location=(0, 0, 0),
                 orientation=(0, 0, 0)):
        """Bake a mesh's triangles into world space (generateMeshTriangles,
        buildscene.h:214-314; build.py:254-288): vertices through T R S,
        normals through R S^-1; one-sided triangles. An emissive mesh is a
        mesh light. Returns the (start, end) triangle range."""
        pos = np.asarray(positions, np.float64).reshape(-1, 3)
        idx = np.asarray(indices, np.int64).reshape(-1, 3)
        rot = euler_to_mat3(orientation).astype(np.float64)
        m = rot @ np.diag(np.asarray(scaling, np.float64))
        nm = rot @ np.diag(1.0 / np.asarray(scaling, np.float64))
        world = pos @ m.T + np.asarray(location, np.float64)
        if normals is not None and len(np.asarray(normals)) > 0:
            nrm = np.asarray(normals, np.float64).reshape(-1, 3) @ nm.T
            lens = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = nrm / np.where(lens > 0, lens, 1.0)
        else:
            nrm = None
            smooth = False
        uv = (np.asarray(uvs, np.float32).reshape(-1, 2)
              if uvs is not None and len(np.asarray(uvs)) else None)
        mat_id = self.material_id(mat)
        t = idx.shape[0]
        v = [world[idx[:, k]].astype(np.float32) for k in range(3)]
        fn = _face_normals(*v)
        n = ([nrm[idx[:, k]].astype(np.float32) for k in range(3)]
             if nrm is not None else [fn, fn, fn])
        z2 = np.zeros((t, 2), np.float32)
        uvk = ([uv[idx[:, k]] for k in range(3)] if uv is not None
               else [z2, z2, z2])
        start = self._n_listed
        if t:
            self._triangles.append((
                *v, *n, *uvk, fn, np.full(t, bool(smooth)),
                np.zeros(t, bool), np.full(t, mat_id, np.int32)))
            self._n_listed += t
        if self._mats[mat_id].mat_type == T.MAT_EMISSIVE:
            self._mesh_light_ranges.append((start, self._n_listed, mat_id))
        return start, self._n_listed

    def _add_instanced(self, kind, params, mat, location, scale,
                       orientation, normal_type=T.NORMAL_OPEN):
        inv_t, nmat = _affine_inverse_rows(location, scale, orientation)
        p = np.zeros(4, np.float32)
        p[: len(params)] = params
        self._instanced.append((inv_t, nmat, int(kind), p, int(normal_type),
                                self.material_id(mat)))

    def add_box(self, length, height, width, mat, location=(0, 0, 0),
                scale=(1, 1, 1), orientation=(0, 0, 0)):
        """A box of dims (length, height, width) centered on the origin
        of its object space (initBox, shapes/box.cpp:4-20)."""
        self._add_instanced(T.INST_AABOX, [length, height, width], mat,
                            location, scale, orientation)

    def add_open_cylinder(self, phi, mat, location=(0, 0, 0),
                          scale=(1, 1, 1), orientation=(0, 0, 0),
                          normal_type=T.NORMAL_OPEN):
        self._add_instanced(T.INST_OPEN_CYLINDER, [phi, 1.0, 1.0], mat,
                            location, scale, orientation, normal_type)

    def add_solid_cylinder(self, mat, location=(0, 0, 0), scale=(1, 1, 1),
                           orientation=(0, 0, 0)):
        """A convex tube and two INST_DISK caps at y = +-1
        (initSolidCylinder, shapes/cylinder.cpp:23-60)."""
        self._add_instanced(T.INST_OPEN_CYLINDER, [PI, 1.0, 1.0], mat,
                            location, scale, orientation, T.NORMAL_CONVEX)
        self._add_instanced(T.INST_DISK, [1.0, 1.0, 0.0], mat, location,
                            scale, orientation)
        self._add_instanced(T.INST_DISK, [1.0, -1.0, 0.0], mat, location,
                            scale, orientation)

    def add_torus(self, swept_radius, tube_radius, phi, mat,
                  location=(0, 0, 0), scale=(1, 1, 1), orientation=(0, 0, 0)):
        self._add_instanced(T.INST_TORUS, [swept_radius, tube_radius, phi],
                            mat, location, scale, orientation)

    # -- lights ------------------------------------------------------------

    def add_directional_light(self, toward, color=(1, 1, 1), intensity=1.0):
        """A delta directional light; `toward` points at the light."""
        self._extra_lights.append((T.LIGHT_DIRECTIONAL,
                                   np.asarray(toward, np.float32),
                                   tuple(color), float(intensity), 0.0))

    def add_point_light(self, point, color=(1, 1, 1), intensity=1.0,
                        dist_atten=True):
        """A delta point light; the radius slot holds the 1/d^2
        attenuation flag (PointLight.dist_atten, lights.h:25-34)."""
        self._extra_lights.append((T.LIGHT_POINT,
                                   np.asarray(point, np.float32),
                                   tuple(color), float(intensity),
                                   1.0 if dist_atten else 0.0))

    def set_env_light(self, kind, color=(1, 1, 1), intensity=1.0, tex_id=-1,
                      rotate_y_angle=0.0, importance=False):
        """kind "constant" or "texture" (a lat-long map, texture `tex_id`,
        seen through rot-y(`rotate_y_angle`); the scene parser gives the
        reference's fixed -0.76, buildscene.h:516). `importance` samples
        the map by its texel CDF instead of the cosine hemisphere
        (build.py:340-351)."""
        self._env = dict(kind=kind, color=tuple(color),
                         intensity=float(intensity), tex_id=int(tex_id),
                         rotate_y_angle=float(rotate_y_angle),
                         importance=bool(importance))

    # -- build -------------------------------------------------------------

    def _scene_bounds(self):
        mins = np.full(3, np.inf)
        maxs = np.full(3, -np.inf)

        def cover(p):
            nonlocal mins, maxs
            mins = np.minimum(mins, p)
            maxs = np.maximum(maxs, p)

        for c, r, *_ in self._spheres:
            cover(c - r)
            cover(c + r)
        for p, w, h, n, m in self._rects:
            for q in (p, p + w, p + h, p + w + h):
                cover(q)
        for c, n, r, m in self._disks:
            cover(c - r)
            cover(c + r)
        cols = self._tri_columns  # set by build() before the lights
        if cols[0].shape[0] > 0:
            for c in cols[:3]:
                cover(c.min(axis=0))
                cover(c.max(axis=0))
        for inv_t, nmat, kind, p, nt, m in self._instanced:
            # the corners of the canonical shape's object-space bound,
            # pushed through the inverse of the stored affine
            fwd = np.linalg.inv(inv_t[:, :3])
            t = inv_t[:, 3]
            if kind == T.INST_AABOX:
                half = np.array([p[0], p[1], p[2]], np.float64) / 2.0
            elif kind == T.INST_TORUS:
                s = p[0] + p[1]
                half = np.array([s, p[1], s], np.float64)
            else:
                half = np.array([1.0, 1.0, 1.0], np.float64)
            for sx in (-1, 1):
                for sy in (-1, 1):
                    for sz in (-1, 1):
                        cover(fwd @ (half * [sx, sy, sz] - t))
        if not np.all(np.isfinite(mins)):
            mins = np.zeros(3)
            maxs = np.ones(3)
        return mins, maxs

    def build(self, accel: str = "auto", light_power: str = "reference",
              device=None) -> T.Scene:
        """accel: 'none', 'bvh4', or 'auto' (bvh4 from 64 triangles, as
        build.py:485-487 resolves it); unless it is 'none', 256 or more
        spheres also get the sphere BVH4. light_power: 'reference' (the
        reference's preprocessLights: product-of-components area power,
        mesh lights at 0, buildscene.h:875-923) or 'principled' (mean
        color x intensity x area for every area and mesh light, so mesh
        lights get NEE samples). The scene goes to `device`: the CUDA card
        unless the caller asks for another (scene/types.py
        `resolve_device`)."""
        if light_power not in ("reference", "principled"):
            raise ValueError(f"light_power {light_power!r}")
        device = T.resolve_device(device)
        f32 = np.float32
        n_tris = self.num_triangles()
        # the sphere BVH4 keys off the request, not the triangle count
        # (build.py:483, :578-590)
        index_spheres = accel != "none" and len(self._spheres) >= 256
        if accel == "auto":
            accel = "bvh4" if n_tris >= 64 else "none"
        if n_tris == 0:
            accel = "none"
        if accel not in ("none", "bvh4"):
            raise NotImplementedError(
                f"accel={accel!r} is not ported to craytracer_tpu_torch yet "
                "(ROADMAP queue 1, slice I)")

        def soa(rows, spec):
            if not rows:
                return [np.zeros((0,) + s, d) for s, d in spec]
            cols = list(zip(*rows))
            return [np.asarray(c, dtype=d).reshape((len(rows),) + s)
                    for c, (s, d) in zip(cols, spec)]

        def tensors(cls, arrays):
            return cls(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in arrays))

        spheres = tensors(T.Spheres, soa(self._spheres, [((3,), f32)]
                                         + [((), f32)] * 4
                                         + [((), np.int32)]))
        planes = tensors(T.Planes, soa(self._planes, [((3,), f32),
                                                      ((3,), f32),
                                                      ((), np.int32)]))
        rects = tensors(T.Rects, soa(self._rects, [((3,), f32)] * 4
                                     + [((), np.int32)]))
        disks = tensors(T.Disks, soa(self._disks, [((3,), f32), ((3,), f32),
                                                   ((), f32), ((), np.int32)]))
        tv = soa([], [((3,), f32)] * 6 + [((2,), f32)] * 3
                 + [((3,), f32), ((), bool), ((), bool), ((), np.int32)])
        blocks = self._triangles + self._bulk_triangles
        if blocks:
            tv = [np.concatenate([blk[c] for blk in blocks], axis=0)
                  for c in range(13)]
        self._tri_columns = tv  # corners by global index for the bounds
        triangles = tensors(T.Triangles, tv)
        tri_bvh = tri_parts = None
        if accel == "bvh4":
            from craytracer_tpu_torch.accel import bvh4_parts
            from craytracer_tpu_torch.accel.bvh4 import build_bvh4

            tri_bvh = build_bvh4(tv[0], tv[1], tv[2])
            # past the part budget, also cut the table into parts
            # (scene/build.py:535-541); the monolithic table stays
            budget = bvh4_parts.PART_BUDGET_BYTES
            if tri_bvh.fat.numel() * 4 > budget:
                tri_parts = bvh4_parts.partition_bvh4(tri_bvh, budget)
        sph_bvh = None
        if index_spheres:
            from craytracer_tpu_torch.accel.bvh4_sphere import (
                build_bvh4_spheres)

            sph_bvh = build_bvh4_spheres(
                spheres.center.numpy(), spheres.radius.numpy(),
                spheres.phi.numpy(), spheres.min_theta.numpy(),
                spheres.max_theta.numpy())
        instanced = tensors(T.Instanced, soa(
            self._instanced, [((3, 4), f32), ((3, 3), f32), ((), np.int32),
                              ((4,), f32), ((), np.int32), ((), np.int32)]))

        mats = self._mats

        def col(field, dtype=f32):
            return np.asarray([getattr(m, field) for m in mats], dtype)

        materials = tensors(T.Materials, [
            col("mat_type", np.int32), col("color"), col("ks"), col("sigma"),
            np.asarray([self._on_a(m.sigma) for m in mats], f32),
            np.asarray([self._on_b(m.sigma) for m in mats], f32),
            col("ior_in"), col("ior_out"), col("cf_in"), col("cf_out"),
            col("eta"), col("k"), col("alphax"), col("alphay"),
            col("distrib", np.int32),
            col("intensity"),
            col("diffuse_tex", np.int32), col("normal_tex", np.int32),
        ])
        lights, mesh_lights, env = self._build_lights(mats, light_power)
        mat_type = materials.mat_type.numpy()
        scene = T.Scene(
            spheres=spheres, planes=planes, rects=rects, disks=disks,
            triangles=triangles, instanced=instanced, materials=materials,
            lights=lights, mesh_lights=mesh_lights, env=env,
            textures=self._build_textures(), tri_bvh=tri_bvh,
            tri_parts=tri_parts, sph_bvh=sph_bvh, accel=accel,
            mat_types_present=tuple(sorted(int(t) for t in
                                           np.unique(mat_type))),
            light_types_present=tuple(sorted(
                int(t) for t in np.unique(lights.light_type.numpy()))),
            light_types_picked=T.light_types_picked(
                lights.light_type.numpy(), lights.power.numpy()),
            matte_lambertian=bool(np.all(
                materials.on_b.numpy()[mat_type == T.MAT_MATTE] == 0.0)),
            smooth_triangles=bool(tv[10].any()),
            microfacet_iso_beckmann=T.microfacet_iso_beckmann(
                mat_type, materials.alphax.numpy(),
                materials.alphay.numpy(), materials.distrib.numpy()),
            sphere_clips_in_domain=T.sphere_clips_in_domain(
                spheres.phi.numpy(), spheres.min_theta.numpy(),
                spheres.max_theta.numpy()),
            instanced_aabox_only=T.instanced_aabox_only(
                instanced.kind.numpy()),
        )
        return scene.to(device)

    @staticmethod
    def _on_a(sigma_deg):
        s = math.radians(sigma_deg)
        s2 = s * s
        return 1.0 - s2 / (2.0 * (s2 + 0.33))

    @staticmethod
    def _on_b(sigma_deg):
        s = math.radians(sigma_deg)
        s2 = s * s
        return 0.45 * s2 / (s2 + 0.09)

    def _build_textures(self) -> T.TexturePack:
        """Every texture's texels in one [T, 3] pool, with each one's
        offset, width and height (build.py:626-643)."""
        if not self._textures:
            return T.empty_texture_pack()
        offsets, ws, hs = [], [], []
        cursor = 0
        for tex in self._textures:
            offsets.append(cursor)
            hs.append(tex.shape[0])
            ws.append(tex.shape[1])
            cursor += tex.shape[0] * tex.shape[1]
        return T.TexturePack(
            texels=torch.from_numpy(np.concatenate(
                [tex.reshape(-1, 3) for tex in self._textures], axis=0)),
            offset=torch.tensor(offsets, dtype=torch.int32),
            width=torch.tensor(ws, dtype=torch.int32),
            height=torch.tensor(hs, dtype=torch.int32))

    def _env_table(self, env_cfg):
        """A texture env's texel distribution (build.py:792-833): texel
        luminance (negatives clamped) times the solid-angle weight of its
        row under getTexColor's addressing, row r the theta band
        pi (r -+ 0.5) / h and row 0 both pole slivers, in float64, then
        its inclusive cumsum and the probabilities as float32."""
        tex = np.asarray(self._textures[env_cfg["tex_id"]], np.float64)
        h, w = tex.shape[0], tex.shape[1]
        lum = np.maximum(tex, 0.0).mean(axis=-1)
        r = np.arange(h)
        dcos = np.cos(np.pi * (r - 0.5) / h) - np.cos(np.pi * (r + 0.5) / h)
        dcos[0] = 2.0 * (1.0 - np.cos(0.5 * np.pi / h))
        lum = lum * dcos[:, None]
        p = (lum / max(lum.sum(), 1e-30)).reshape(-1)
        return dict(flat_cdf=torch.from_numpy(np.cumsum(p).astype(np.float32)),
                    flat_pdf=torch.from_numpy(p.astype(np.float32)),
                    importance=1 if env_cfg["importance"] else 0,
                    imp_h=h, imp_w=w)

    def _build_lights(self, mats, light_power):
        """Area lights from emissive rects, spheres and disks, mesh lights
        from emissive meshes, the delta lights, the env light row, the
        power rule of the build's mode and the normalized CDF
        (build.py:645-833)."""
        f32 = np.float32
        rows = []  # (type, p0, v1, v2, normal, radius, color, intensity,
        #              area, mesh_id, src_group, src_prim)
        for i, (p, w, h, n, mat_id) in enumerate(self._rects):
            m = mats[mat_id]
            if m.mat_type == T.MAT_EMISSIVE:
                area = float(np.linalg.norm(w) * np.linalg.norm(h))
                rows.append((T.LIGHT_AREA_RECT, p, w, h, n, 0.0, m.color,
                             m.intensity, area, -1, T.GROUP_RECT, i))
        for i, (c, r, phi, mn, mx, mat_id) in enumerate(self._spheres):
            m = mats[mat_id]
            if m.mat_type == T.MAT_EMISSIVE:
                area = float(4.0 * PI * r * r)
                rows.append((T.LIGHT_AREA_SPHERE, c, np.zeros(3, f32),
                             np.zeros(3, f32), np.zeros(3, f32), r, m.color,
                             m.intensity, area, -1, T.GROUP_SPHERE, i))
        for i, (c, n, r, mat_id) in enumerate(self._disks):
            m = mats[mat_id]
            if m.mat_type == T.MAT_EMISSIVE:
                area = float(PI * r * r)
                rows.append((T.LIGHT_AREA_DISK, c, np.zeros(3, f32),
                             np.zeros(3, f32), n, r, m.color, m.intensity,
                             area, -1, T.GROUP_DISK, i))
        # mesh lights: each emissive mesh's triangle range, with its
        # per-triangle area CDF (initMeshLights, buildscene.h:749-833)
        cols = self._tri_columns
        ml_tri, ml_cdf, ml_off, ml_area = [], [], [0], []
        for k, (start, end, mat_id) in enumerate(self._mesh_light_ranges):
            m = mats[mat_id]
            v0, v1, v2 = (c[start:end] for c in cols[:3])
            areas = (0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0),
                                          axis=-1)).tolist()
            ml_tri.extend(range(start, end))
            total = sum(areas) or 1.0
            ml_cdf.extend((np.cumsum(areas) / total).tolist())
            ml_off.append(len(ml_tri))
            ml_area.append(total)
            rows.append((T.LIGHT_MESH, np.zeros(3, f32), np.zeros(3, f32),
                         np.zeros(3, f32), np.zeros(3, f32), 0.0, m.color,
                         m.intensity, total, k, -1, -1))
        # the delta lights: the reference gives them power 0
        # (buildscene.h:878-918); the JAX builder mean(color) x intensity
        for ltype, p0, color, inten, flag in self._extra_lights:
            rows.append((ltype, p0, np.zeros(3, f32), np.zeros(3, f32),
                         np.zeros(3, f32), flag, color, inten,
                         float(np.mean(color) * inten), -1, -1, -1))

        env_cfg = self._env
        mins, maxs = self._scene_bounds()
        world_radius = float(2.0 * np.linalg.norm(maxs - mins))
        if env_cfg is not None and env_cfg["intensity"] > 0.0:
            rows.append((T.LIGHT_ENV, np.zeros(3, f32), np.zeros(3, f32),
                         np.zeros(3, f32), np.zeros(3, f32), 0.0,
                         env_cfg["color"], env_cfg["intensity"], world_radius,
                         -1, -1, -1))

        principled = light_power == "principled"
        powers = []
        for row in rows:
            ltype, _, _, _, _, radius, color, inten, area = row[:9]
            c = np.asarray(color, np.float64)
            if ltype == T.LIGHT_ENV:
                powers.append(float(c.mean() * inten * world_radius))
            elif ltype in (T.LIGHT_DIRECTIONAL, T.LIGHT_POINT):
                powers.append(float(c.mean() * inten))
            elif ltype == T.LIGHT_MESH and not principled:
                # preprocessLights' switch skips mesh lights: power 0,
                # never picked, seen only as emissive hits
                powers.append(0.0)
            elif principled:
                powers.append(float(c.mean() * inten * area))
            else:
                powers.append(float((c[0] * c[1] * c[2]) / 3.0 * inten * area))
        total_p = sum(powers)
        if total_p <= 0.0 and rows:
            powers = [1.0 / len(rows)] * len(rows)
        elif rows:
            powers = [p / total_p for p in powers]

        n = len(rows)

        def t(values, dtype, shape):
            return torch.from_numpy(np.asarray(values, dtype).reshape(shape))

        lights = T.Lights(
            light_type=t([r[0] for r in rows], np.int32, (n,)),
            p0=t(np.array([r[1] for r in rows], f32), f32, (n, 3)),
            v1=t(np.array([r[2] for r in rows], f32), f32, (n, 3)),
            v2=t(np.array([r[3] for r in rows], f32), f32, (n, 3)),
            normal=t(np.array([r[4] for r in rows], f32), f32, (n, 3)),
            radius=t([r[5] for r in rows], f32, (n,)),
            color=t(np.array([r[6] for r in rows], f32), f32, (n, 3)),
            intensity=t([r[7] for r in rows], f32, (n,)),
            power=t(powers, f32, (n,)),
            power_cdf=t(np.cumsum(powers, dtype=np.float64), f32, (n,)),
            mesh_light_id=t([r[9] for r in rows], np.int32, (n,)),
            src_group=t([r[10] for r in rows], np.int32, (n,)),
            src_prim=t([r[11] for r in rows], np.int32, (n,)),
        )
        tri_light_id = np.full(max(cols[0].shape[0], 1), -1, np.int32)
        for row_idx, row in enumerate(rows):
            if row[0] == T.LIGHT_MESH:
                start, end, _ = self._mesh_light_ranges[row[9]]
                tri_light_id[start:end] = row_idx
        mesh_lights = T.MeshLights(
            tri_index=t(ml_tri, np.int32, (len(ml_tri),)),
            cdf=t(ml_cdf, f32, (len(ml_cdf),)),
            light_offset=t(ml_off, np.int32, (len(ml_off),)),
            surface_area=t(ml_area, f32, (len(ml_area),)),
            tri_light_id=torch.from_numpy(tri_light_id))
        if env_cfg is None:
            env = T.EnvLight(
                color=torch.zeros(3, dtype=torch.float32),
                intensity=torch.tensor(0.0, dtype=torch.float32),
                transform=torch.eye(3, dtype=torch.float32),
                world_radius=torch.tensor(world_radius, dtype=torch.float32),
                tex_id=torch.tensor(-1, dtype=torch.int32), kind=0)
        else:
            kind = 1 if env_cfg["kind"] == "constant" else 2
            angle = env_cfg["rotate_y_angle"]
            transform = (rotate_y(angle) if angle != 0.0
                         else torch.eye(3, dtype=torch.float32))
            # the CDF is built for every texture env: the Renderer turns
            # importance on under the physical estimator
            # (integrator/render.py); env.importance stays as authored
            imp = (self._env_table(env_cfg)
                   if kind == 2 and 0 <= env_cfg["tex_id"] < len(
                       self._textures) else {})
            env = T.EnvLight(
                color=torch.tensor(env_cfg["color"], dtype=torch.float32),
                intensity=torch.tensor(env_cfg["intensity"],
                                       dtype=torch.float32),
                transform=transform,
                world_radius=torch.tensor(world_radius, dtype=torch.float32),
                tex_id=torch.tensor(env_cfg["tex_id"], dtype=torch.int32),
                kind=kind, **imp)
        return lights, mesh_lights, env
