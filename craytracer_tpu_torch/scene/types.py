"""Flat SoA scene model as tensor dataclasses (counterpart of
craytracer_tpu/scene/types.py:1-299).

Field names, shapes and dtypes follow the JAX pytrees leaf for leaf, so a
test can compare the two packages' scenes field by field. A group the
scene lacks (or the port does not render yet: mesh lights) is still
present, as zero-row tensors, exactly as the JAX builder emits it. The static fields `accel`,
`mat_types_present`, `light_types_present` and `matte_lambertian` stay
plain Python values, as do BVH4Arrays' `n_tris`, `leaf_size` and
`stack_size` (accel/bvh4.py:56-72). `smooth_triangles` (not in the JAX
Scene) records whether any triangle is smooth, and
`microfacet_iso_beckmann`, `sphere_clips_in_domain` and
`instanced_aabox_only` (not in the JAX Scene either) record what the JAX gate reads from table values
(pallas_shade.py:1538-1553, :1580-1589), so the route gate reads them
without a device sync.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# Material type codes (types.py:18-25).
MAT_INVALID = 0
MAT_MATTE = 1
MAT_MIRROR = 2
MAT_TRANSPARENT = 3
MAT_EMISSIVE = 4
MAT_PLASTIC = 5
MAT_GLASS = 6
MAT_METAL = 7

DIST_BECKMANN = 0

# Instanced-primitive kinds and cylinder normal rules (types.py:31-41).
INST_AABOX = 0
INST_OPEN_CYLINDER = 1
INST_TORUS = 2
INST_DISK = 3  # the caps of a solid cylinder
NORMAL_OPEN = 0
NORMAL_CONVEX = 1
NORMAL_CONCAVE = 2

# Light type codes (types.py:45-51).
LIGHT_AREA_RECT = 0
LIGHT_AREA_SPHERE = 1
LIGHT_AREA_DISK = 2
LIGHT_ENV = 3
LIGHT_MESH = 4
LIGHT_DIRECTIONAL = 5
LIGHT_POINT = 6

# Geometry group ids used in hit records (types.py:54-60).
GROUP_NONE = -1
GROUP_SPHERE = 0
GROUP_PLANE = 1
GROUP_RECT = 2
GROUP_DISK = 3
GROUP_TRIANGLE = 4
GROUP_INSTANCED = 5


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    asks for another (`device="cpu"`). Raises when the card is asked for,
    by default or by name, and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("craytracer_tpu_torch runs on a CUDA card by "
                           "default and none is available; pass "
                           "device='cpu' (--device cpu) to run the plain "
                           "PyTorch version on the CPU")
    return dev


def to_device(obj, device):
    """Copy every tensor leaf of a (nested) dataclass or tuple to
    `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        return tuple(to_device(x, device) for x in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


def microfacet_iso_beckmann(mat_type, alphax, alphay, distrib) -> bool:
    """Every PLASTIC, METAL and GLASS row is isotropic Beckmann
    (alphax == alphay, DIST_BECKMANN): the only microfacet form the
    kernels port (fast_shade_ok, pallas_shade.py:1576-1589)."""
    mf = np.isin(np.asarray(mat_type), [MAT_PLASTIC, MAT_METAL, MAT_GLASS])
    return bool((np.asarray(alphax)[mf] == np.asarray(alphay)[mf]).all()
                and (np.asarray(distrib)[mf] == DIST_BECKMANN).all())


def sphere_clips_in_domain(phi, min_theta, max_theta) -> bool:
    """Every sphere clip lies where K1's cosine-space window equals the
    atan2/acos window: phi <= pi, thetas in [0, pi], with 1e-5 slack
    (fast_shade_mode, pallas_shade.py:1541-1553)."""
    sp, mn, mx = (np.asarray(x) for x in (phi, min_theta, max_theta))
    eps = 1e-5
    return bool((sp <= np.pi + eps).all()
                and (mn >= -eps).all() and (mn <= np.pi + eps).all()
                and (mx >= -eps).all() and (mx <= np.pi + eps).all())


def instanced_aabox_only(kind) -> bool:
    """Every instanced row is a box, the only kind K1's table holds
    (fast_shade_mode, pallas_shade.py:1535-1540)."""
    return bool((np.asarray(kind) == INST_AABOX).all())


@dataclass(frozen=True)
class Spheres:
    center: torch.Tensor  # [N, 3]
    radius: torch.Tensor  # [N]
    phi: torch.Tensor  # [N]
    min_theta: torch.Tensor  # [N]
    max_theta: torch.Tensor  # [N]
    mat_id: torch.Tensor  # [N] int32


@dataclass(frozen=True)
class Planes:
    point: torch.Tensor  # [N, 3]
    normal: torch.Tensor  # [N, 3]
    mat_id: torch.Tensor  # [N]


@dataclass(frozen=True)
class Rects:
    point: torch.Tensor  # [N, 3]
    width: torch.Tensor  # [N, 3] edge vector
    height: torch.Tensor  # [N, 3] edge vector
    normal: torch.Tensor  # [N, 3] normalize(width x height)
    mat_id: torch.Tensor  # [N]


@dataclass(frozen=True)
class Disks:
    center: torch.Tensor  # [N, 3]
    normal: torch.Tensor  # [N, 3]
    radius: torch.Tensor  # [N]
    mat_id: torch.Tensor  # [N]


@dataclass(frozen=True)
class Triangles:
    v0: torch.Tensor  # [N, 3]
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor  # [N, 3] vertex normals (face normal when flat)
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor  # [N, 2]
    uv1: torch.Tensor
    uv2: torch.Tensor
    face_normal: torch.Tensor  # [N, 3]
    smooth: torch.Tensor  # [N] bool
    double_sided: torch.Tensor  # [N] bool: standalone triangles face the ray
    mat_id: torch.Tensor  # [N]


@dataclass(frozen=True)
class Instanced:
    """Canonical shapes behind a world -> object affine: rays are pulled
    into object space, normals pushed out through `normal_mat`."""

    inv_transform: torch.Tensor  # [N, 3, 4] world -> object affine
    normal_mat: torch.Tensor  # [N, 3, 3] (M^-1)^T for object normals
    kind: torch.Tensor  # [N] int32 INST_*
    params: torch.Tensor  # [N, 4] per kind (ops/intersect.py)
    normal_type: torch.Tensor  # [N] int32 NORMAL_* (cylinders)
    mat_id: torch.Tensor  # [N]


@dataclass(frozen=True)
class Materials:
    mat_type: torch.Tensor  # [M] int32
    color: torch.Tensor  # [M, 3]
    ks: torch.Tensor  # [M, 3]
    sigma: torch.Tensor  # [M]
    on_a: torch.Tensor  # [M] Oren-Nayar A
    on_b: torch.Tensor  # [M] Oren-Nayar B
    ior_in: torch.Tensor
    ior_out: torch.Tensor
    cf_in: torch.Tensor  # [M, 3]
    cf_out: torch.Tensor
    eta: torch.Tensor  # [M, 3]
    k: torch.Tensor  # [M, 3]
    alphax: torch.Tensor
    alphay: torch.Tensor
    distrib: torch.Tensor  # [M] int32
    intensity: torch.Tensor  # [M] emissive scale
    diffuse_tex: torch.Tensor  # [M] int32
    normal_tex: torch.Tensor  # [M] int32


@dataclass(frozen=True)
class Lights:
    light_type: torch.Tensor  # [L] int32
    p0: torch.Tensor  # [L, 3]
    v1: torch.Tensor  # [L, 3] rect width edge
    v2: torch.Tensor  # [L, 3] rect height edge
    normal: torch.Tensor  # [L, 3]
    radius: torch.Tensor  # [L]
    color: torch.Tensor  # [L, 3]
    intensity: torch.Tensor  # [L]
    power: torch.Tensor  # [L] normalized selection probabilities
    power_cdf: torch.Tensor  # [L] inclusive prefix sum of power
    mesh_light_id: torch.Tensor  # [L] int32
    src_group: torch.Tensor  # [L] int32
    src_prim: torch.Tensor  # [L] int32


@dataclass(frozen=True)
class MeshLights:
    tri_index: torch.Tensor
    cdf: torch.Tensor
    light_offset: torch.Tensor
    surface_area: torch.Tensor
    tri_light_id: torch.Tensor


@dataclass(frozen=True)
class EnvLight:
    """`kind` is static: 0 none, 1 constant, 2 texture."""

    color: torch.Tensor  # [3]
    intensity: torch.Tensor  # scalar
    transform: torch.Tensor  # [3, 3]
    world_radius: torch.Tensor  # scalar
    tex_id: torch.Tensor  # int32 scalar
    kind: int = 0
    flat_cdf: Optional[torch.Tensor] = None
    flat_pdf: Optional[torch.Tensor] = None
    importance: int = 0
    imp_h: int = 0
    imp_w: int = 0


@dataclass(frozen=True)
class TexturePack:
    texels: torch.Tensor  # [T, 3]
    offset: torch.Tensor  # [K] int32
    width: torch.Tensor  # [K] int32
    height: torch.Tensor  # [K] int32


def empty_texture_pack(device="cpu") -> TexturePack:
    return TexturePack(
        texels=torch.zeros((1, 3), dtype=torch.float32, device=device),
        offset=torch.zeros((1,), dtype=torch.int32, device=device),
        width=torch.ones((1,), dtype=torch.int32, device=device),
        height=torch.ones((1,), dtype=torch.int32, device=device),
    )


@dataclass(frozen=True)
class BVH4Arrays:
    """The 4-wide fat-row BVH (accel/bvh4.py BVH4Arrays :56): one f32 row
    per node, [0:12) four child mins, [12:24) four child maxs, [24:28)
    child node ids (-1: leaf or empty slot), then per slot `leaf_size`
    inlined triangles of 10 columns (v0, e1, e2, id; id -1 pads), the row
    padded to 128 columns. `stack_size` bounds the traversal stack."""

    fat: torch.Tensor  # [M, 128] f32
    n_tris: int = 0
    leaf_size: int = 2
    stack_size: int = 128


@dataclass(frozen=True)
class Scene:
    """The whole scene. Of the JAX Scene's accel slots the port carries
    `tri_bvh` (accel="bvh4") and, for a fat table past the part budget,
    `tri_parts` (accel/bvh4_parts.py), the table cut into a tuple of
    BVH4Arrays beside the monolithic one, as the JAX Scene does
    (scene/types.py:265-271); tri_shadow/tri_cam/sph_bvh belong to
    accelerators the port does not build (ROADMAP slice I)."""

    spheres: Spheres
    planes: Planes
    rects: Rects
    disks: Disks
    triangles: Triangles
    instanced: Instanced
    materials: Materials
    lights: Lights
    mesh_lights: MeshLights
    env: EnvLight
    textures: TexturePack
    tri_bvh: Optional[BVH4Arrays] = None
    tri_parts: Optional[tuple] = None  # of BVH4Arrays: (top, subtrees...)
    accel: str = "none"
    mat_types_present: tuple = ()
    light_types_present: tuple = ()
    matte_lambertian: bool = False
    smooth_triangles: bool = False  # any triangle interpolates normals
    microfacet_iso_beckmann: bool = True
    sphere_clips_in_domain: bool = True
    instanced_aabox_only: bool = True  # every instanced row is an AABOX

    @property
    def device(self) -> torch.device:
        return self.materials.color.device

    def to(self, device) -> "Scene":
        return to_device(self, device)
