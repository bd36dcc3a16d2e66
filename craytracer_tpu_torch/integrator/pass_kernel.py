"""K1, the whole-pass path-tracing kernel (counterpart of
craytracer_tpu/integrator/pallas_shade.py: `_pass_kernel` :781 with
`_camera_raygen` :696, `_brute_hit` :533, `_brute_closest` :471,
`_brute_any` :509, `_sphere_t` :363 and `_shade_core` :874, launched by
`fused_pass` :1667). The gate that decides which scenes K1 takes is
integrator/gate.py ("bounce" scenes): up to 64 rows of spheres (clip
windows in the kernel's domain), planes, rects, disks, flat triangles
and instanced boxes (every instanced row a box); all seven material
types with isotropic Beckmann lobes; rect and sphere area lights; a
constant or black env light; a pinhole or thin-lens camera; depth < 31.

One launch runs a whole spp-pass: raygen, then for every bounce the
closest hit over the prim table, shading, NEE with a shadow any-hit,
throughput and Russian roulette. The CUDA C++ source is
csrc/pass_kernel.cu, whose shading is csrc/shade_core.cuh (shared with
K2): persistent warps, as many blocks as fit on the card, whose threads
take the next path index when a path ends. It is instantiated for the
matte-only and the full core, each with and without plane/disk rows and
box rows (the C entry picks one from the row counts); it is compiled
with nvcc for sm_90a at first use into craytracer_tpu_torch/_build/ and
bound through a plain C ABI with ctypes (cuda_build.py).

`fused_pass` is the wrapper: for CPU tensors it takes the plain version
`fused_pass_reference` (the ported raygen followed by the plain
`trace_paths`); for CUDA tensors it launches K1 or raises. It never falls
back. `KERNEL.launches` counts K1's launches with the raygen inside.
With `raygen=None` and `rays=(o, d)` K1 takes external rays, one [N, 3]
origin and direction per lane, as the JAX kernel does with raygen=None
(`fused_pass` :1758-1768, `_pass_kernel` :806-808): `render_sample` with
a table sampler on a "bounce" scene traces the sampler's camera rays
through it (wavefront.py:601, :456-468). Everything after the raygen is
the same code; no lane is padded, where the JAX kernel pads its last
block with escape rays. `RAYS_KERNEL.launches` counts that mode's
launches (the C entry `k1_pass_rays_launch`).
"""

from __future__ import annotations

import ctypes

import torch

from craytracer_tpu_torch.camera import THINLENS, film_dims
from craytracer_tpu_torch.cuda_build import CudaLibrary, LaunchCount
from craytracer_tpu_torch.integrator.gate import (MAX_DEPTH, MAX_LIGHTS,
                                                  MAX_MATS, MAX_PRIMS,
                                                  production_fast_shade,
                                                  shade_features)
from craytracer_tpu_torch.integrator.shade_kernel import (RR_START,
                                                          material_light_rows)
from craytracer_tpu_torch.integrator.wavefront import _trace, camera_rays
from craytracer_tpu_torch.sampling.multijitter import (CAMERA_BOUNCE,
                                                       stratified_jitter)
from craytracer_tpu_torch.sampling.rng import MASK32, uniforms
from craytracer_tpu_torch.scene import types as T

# table layout handed to the kernel (floats): camera at 0, env radiance at
# _ENV, then from _MATS the material, light and prim rows. The column
# layouts are pallas_shade.py's (_meta_operands :1613, fused_pass
# :1707-1750), unread columns included, so K1's remaining gate features
# need no format change.
_ENV, _MATS = 18, 24


def _k1_gate(scene, camera, film, max_depth):
    """K1 takes "bounce" scenes only; any other raises."""
    if production_fast_shade(scene, camera, film,
                             max_depth=max_depth) != "bounce":
        raise NotImplementedError(
            "outside K1's gate (an instanced row that is not a box, a bvh4 "
            "accel or a sphere BVH4, more than 64 rows, smooth triangles, a sphere clip "
            "outside the kernel's domain, depth > 30, or shading only the "
            "general route does): render_sample traces it per bounce; "
            "ROADMAP queue 2, K1")


# ---------------------------------------------------------------------------
# The plain version


@torch.no_grad()
def fused_pass_reference(scene: T.Scene, camera, film, pixel_ids, spp_index,
                         seed: int, max_depth: int, raygen: str = "strat",
                         rays=None):
    """Plain PyTorch version of K1: the ported raygen (stratified_jitter
    or the plain CAMERA_BOUNCE jitter, a thin-lens camera's lens samples,
    then generate_rays), or with raygen=None the external `rays` (o, d),
    followed by the ported trace_paths in torch ops. Same contract as
    `fused_pass`; a scene outside the K1 gate raises
    NotImplementedError."""
    _k1_gate(scene, camera, film, max_depth)
    return _pass_reference(scene, camera, film, pixel_ids, spp_index, seed,
                           max_depth, raygen, rays)


def _check_raygen(raygen, rays):
    if raygen not in ("strat", "plain", None):
        raise ValueError(f"raygen must be 'strat', 'plain' or None, not "
                         f"{raygen!r}")
    if (raygen is None) != (rays is not None):
        raise ValueError("external rays go with raygen=None, and only there")


def _pass_reference(scene, camera, film, pixel_ids, spp_index, seed,
                    max_depth, raygen, rays=None):
    """fused_pass_reference for a scene the gate has admitted."""
    _check_raygen(raygen, rays)
    if raygen is None:
        o, d = rays
        return _trace(scene, o, d, seed, pixel_ids, spp_index, max_depth,
                      kernels=False)
    if raygen == "strat":
        jitter = stratified_jitter(seed, pixel_ids, spp_index)
    elif raygen == "plain":
        jitter = uniforms(seed, pixel_ids, spp_index, CAMERA_BOUNCE, 2, 0)
    o, d = camera_rays(camera, film, pixel_ids, seed, spp_index, jitter)
    return _trace(scene, o, d, seed, pixel_ids, spp_index, max_depth,
                  kernels=False)


# ---------------------------------------------------------------------------
# K1 on the card


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k1_pass_launch.argtypes = [vp, ci, vp, vp, ci, ctypes.c_int * 8,
                                   ctypes.c_uint, ci, ci, ci, ci, ci, ci, vp,
                                   vp, vp, vp]
    lib.k1_pass_launch.restype = ci
    lib.k1_pass_rays_launch.argtypes = [vp, ci, vp, vp, vp, vp, ci,
                                        ctypes.c_int * 8, ctypes.c_uint, ci,
                                        ci, ci, vp, vp, vp, vp]
    lib.k1_pass_rays_launch.restype = ci


LIBRARY = CudaLibrary("pass_kernel", headers=("shade_core.cuh",), bind=_bind)
SOURCE = LIBRARY.source


class PassKernel(LaunchCount):
    """K1's launcher on PyTorch's current stream. `launches` counts the
    launches made through `launch`."""

    def launch(self, tables, counts, pix, spp, seed: int, max_depth: int,
               strat: bool, width: int, full: bool, thinlens: bool = False,
               rays=None):
        """One K1 launch over len(pix) lanes on `tables` with the row
        `counts` of `table_counts`, with the full shading core (every
        lobe) if `full`, else the matte-only one, and the thin-lens raygen
        if `thinlens`, else the pinhole; with `rays` (o, d: contiguous f32
        [N, 3] on the card) on those rays instead of the raygen. Returns
        (L [N,3] f32, counters [4,N] i32: good, rays, shadow_rays, alive
        bitmask)."""
        n = pix.shape[0]
        dev = pix.device
        n_mats, n_lights, *n_rows = counts
        n_prims = sum(n_rows)
        n_floats = (_MATS + 19 * (n_mats + n_lights) + 16 * n_prims
                    + 9 * n_rows[-1])
        if (dev.type != "cuda" or tables.device != dev or spp.device != dev
                or tables.dtype != torch.float32 or pix.dtype != torch.int32
                or spp.dtype != torch.int32 or pix.dim() != 1
                or spp.shape != pix.shape or tables.shape != (n_floats,)
                or not (tables.is_contiguous() and pix.is_contiguous()
                        and spp.is_contiguous())):
            raise ValueError("K1 takes contiguous CUDA tensors: f32 tables "
                             f"[{n_floats}], i32 pix [N], i32 spp [N]")
        if not (1 <= n_lights <= MAX_LIGHTS and 1 <= n_mats <= MAX_MATS
                and n_prims <= MAX_PRIMS
                and 0 <= max_depth <= MAX_DEPTH and width > 0):
            raise ValueError("K1 table sizes or depth out of range")
        if rays is not None and not all(
                r.device == dev and r.dtype == torch.float32
                and r.shape == (n, 3) and r.is_contiguous() for r in rays):
            raise ValueError("K1's external rays are contiguous f32 [N, 3] "
                             "CUDA tensors on the lanes' device")
        lib = LIBRARY.load()
        L = torch.empty((n, 3), dtype=torch.float32, device=dev)
        g = torch.empty((4, n), dtype=torch.int32, device=dev)
        next_path = torch.empty(1, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if rays is None:
            err = lib.k1_pass_launch(
                tables.data_ptr(), tables.numel(), pix.data_ptr(),
                spp.data_ptr(), n, (ctypes.c_int * 8)(*counts),
                int(seed) & MASK32, max_depth, RR_START, int(strat),
                int(thinlens), width, int(full), next_path.data_ptr(),
                L.data_ptr(), g.data_ptr(), stream)
        else:
            err = lib.k1_pass_rays_launch(
                tables.data_ptr(), tables.numel(), pix.data_ptr(),
                spp.data_ptr(), rays[0].data_ptr(), rays[1].data_ptr(), n,
                (ctypes.c_int * 8)(*counts), int(seed) & MASK32, max_depth,
                RR_START, int(full), next_path.data_ptr(), L.data_ptr(),
                g.data_ptr(), stream)
        LIBRARY.check(err, "K1")
        self.launches += 1
        return L, g


KERNEL = PassKernel()  # the raygen inside
RAYS_KERNEL = PassKernel()  # external rays


def kernel_tables(scene: T.Scene, camera, film):
    """Pack camera, env radiance, material, light, prim and box rows into
    one f32 tensor on the scene's device (layouts as _meta_operands :1613
    and fused_pass :1694-1781). The camera row ends with focal_length and
    lens_radius for the thin-lens raygen. Prim rows (16 columns) come in
    intersect_scene group order: spheres (center, radius, then cos(phi),
    cos(min_theta), cos(max_theta), computed in f64 and rounded once),
    planes (point, normal), rects (point, width, height, normal), disks
    (center, radius in column 6, normal) and triangles (v0, e1, e2, face
    normal, double_sided in column 13), each with its mat_id in column
    12. Planes and disks leave columns 3-5 zero: K1 takes their dpdu,
    and a box's, as the Duff tangent of the faced normal, as their plain
    fills do.
    Box rows (25 columns) follow: inv_transform [3, 4] and normal_mat
    [3, 3] row-major, the half extents, mat_id."""
    dev = scene.device
    f32 = torch.float32
    fl, fh, pxl = film_dims(film, camera)
    cam = torch.cat([camera.position, camera.x_axis, camera.y_axis,
                     camera.z_axis,
                     torch.stack([camera.focal_dist, fl, fh, pxl,
                                  camera.focal_length, camera.lens_radius])])
    env_li, mt, lt = material_light_rows(scene)

    def z(rows, cols=1):
        return torch.zeros((rows, cols), dtype=f32, device=dev)

    def mat(g):
        return g.mat_id[:, None].to(f32)

    s = scene.spheres
    n = s.mat_id.shape[0]
    clip = torch.stack([s.phi, s.min_theta, s.max_theta], dim=-1)
    pt_sph = torch.cat([s.center, s.radius[:, None],
                        torch.cos(clip.double()).to(f32), z(n, 5), mat(s),
                        z(n, 3)], dim=-1)
    p = scene.planes
    n = p.mat_id.shape[0]
    pt_pl = torch.cat([p.point, z(n, 6), p.normal, mat(p), z(n, 3)], dim=-1)
    r = scene.rects
    pt_rect = torch.cat([r.point, r.width, r.height, r.normal, mat(r),
                         z(r.mat_id.shape[0], 3)], dim=-1)
    k = scene.disks
    n = k.mat_id.shape[0]
    pt_dsk = torch.cat([k.center, z(n, 3), k.radius[:, None], z(n, 2),
                        k.normal, mat(k), z(n, 3)], dim=-1)
    tr = scene.triangles
    n = tr.mat_id.shape[0]
    pt_tri = torch.cat([tr.v0, tr.v1 - tr.v0, tr.v2 - tr.v0, tr.face_normal,
                        mat(tr), tr.double_sided[:, None].to(f32), z(n, 2)],
                       dim=-1)
    inst = scene.instanced
    n = inst.mat_id.shape[0]
    bt = torch.cat([inst.inv_transform.reshape(n, 12),
                    inst.normal_mat.reshape(n, 9),
                    inst.params[:, 0:3] * 0.5, mat(inst)], dim=-1)
    pad = torch.zeros(_MATS - _ENV - 3, dtype=f32, device=dev)
    return torch.cat([cam.to(f32), env_li, pad, mt.reshape(-1),
                      lt.reshape(-1)] + [t.reshape(-1) for t in (
                          pt_sph, pt_pl, pt_rect, pt_dsk, pt_tri, bt)]
                     ).contiguous()


def table_counts(scene: T.Scene):
    """(n_mats, n_lights, n_sph, n_pl, n_rects, n_dsk, n_tris, n_box): the
    row counts of `kernel_tables`, as K1's launch takes them."""
    return (scene.materials.mat_type.shape[0],
            scene.lights.light_type.shape[0],
            *(getattr(scene, g).mat_id.shape[0] for g in (
                "spheres", "planes", "rects", "disks", "triangles",
                "instanced")))


@torch.no_grad()
def fused_pass(scene: T.Scene, camera, film, pixel_ids, spp_index,
               seed: int, max_depth: int, raygen: str = "strat", rays=None):
    """Whole-pass wrapper: returns (L[N,3], good[N] int32, metrics dict
    with `rays`/`shadow_rays` scalars, the `bounce_live` histogram and the
    per-lane `lane_rays`/`lane_shadow_rays`) — the trace_paths contract.
    `raygen` "strat" or "plain" makes the camera rays in the kernel;
    None takes `rays` = (o, d), [N, 3] each. `pixel_ids` decides the
    device: a CPU tensor takes the plain version, a CUDA tensor launches
    K1. Forward-only, as in the JAX package (pallas_shade.py:47). A scene
    outside K1's gate raises NotImplementedError."""
    _k1_gate(scene, camera, film, max_depth)
    return _admitted_pass(scene, camera, film, pixel_ids, spp_index, seed,
                          max_depth, raygen, rays)


@torch.no_grad()
def _admitted_pass(scene: T.Scene, camera, film, pixel_ids, spp_index,
                   seed: int, max_depth: int, raygen: str = "strat",
                   rays=None):
    """fused_pass for a scene the gate has admitted as "bounce"
    (render_sample asks the gate once per pass)."""
    pixel_ids = torch.as_tensor(pixel_ids)
    _check_raygen(raygen, rays)
    for t in (*T.tensor_leaves(scene), *T.tensor_leaves(camera),
              *T.tensor_leaves(film), *(rays or ())):
        if t.requires_grad:
            raise ValueError("K1 is forward-only: an input requires grad")
        if t.device != pixel_ids.device:
            raise ValueError(f"scene/camera on {t.device}, pixel ids on "
                             f"{pixel_ids.device}")
    if pixel_ids.device.type == "cpu":
        return _pass_reference(scene, camera, film, pixel_ids, spp_index,
                               seed, max_depth, raygen, rays)
    if pixel_ids.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, not {pixel_ids.device}")
    n = pixel_ids.shape[0]
    pix = pixel_ids.to(torch.int32).contiguous()
    if isinstance(spp_index, torch.Tensor) and spp_index.dim() > 0:
        if spp_index.shape != (n,):
            raise ValueError("per-lane spp must have one entry per lane")
        spp = spp_index.to(device=pix.device, dtype=torch.int32).contiguous()
    else:
        spp = torch.full((n,), int(spp_index), dtype=torch.int32,
                         device=pix.device)
    if rays is not None:
        rays = tuple(r.to(torch.float32).contiguous() for r in rays)
    L, g = (KERNEL if rays is None else RAYS_KERNEL).launch(
        kernel_tables(scene, camera, film), table_counts(scene), pix, spp,
        seed, max_depth, raygen == "strat", int(film.width),
        shade_features(scene) != 0, camera.camera_type == THINLENS, rays)
    bits = torch.arange(max_depth + 1, dtype=torch.int32, device=pix.device)
    bounce_live = ((g[3][:, None] >> bits) & 1).sum(dim=0)
    metrics = {"rays": g[1].sum(), "shadow_rays": g[2].sum(),
               "bounce_live": bounce_live, "lane_rays": g[1],
               "lane_shadow_rays": g[2]}
    return L, g[0], metrics
