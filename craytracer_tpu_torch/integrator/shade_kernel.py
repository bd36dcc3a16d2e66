"""K2, one bounce's shading for an external hit record (counterpart of
craytracer_tpu/integrator/pallas_shade.py: `fused_shade` :1846 with
`_shade_kernel` :240, `_shade_core` :874, `_meta_operands` :1613 and
`_unpack_outputs` :1643).

`fused_shade` is the wrapper: for CPU tensors it takes the plain version
`fused_shade_reference`; for CUDA tensors it launches K2
(csrc/shade_kernel.cu, whose shading is csrc/shade_core.cuh, shared with
K1) or raises. It never falls back. `KERNEL.launches` counts K2
launches. Both return the dict of `_unpack_outputs`: L_add, shadow_o,
shadow_d, dist_adj, dist_adj_t, contrib_cand, new_o, new_d, new_beta
([N, 3] / [N] f32), good_inc ([N] int32), want_shadow, new_alive,
new_prev_sg ([N] bool). Forward-only, as in the JAX package
(pallas_shade.py:47). Covers the materials and lights the port's gate
admits (integrator/gate.py): Lambertian MATTE, EMISSIVE, rect area
lights, a constant or black env light.
"""

from __future__ import annotations

import ctypes

import torch

from craytracer_tpu_torch.constants import INV_PI, TMAX
from craytracer_tpu_torch.cuda_build import CudaLibrary, LaunchCount
from craytracer_tpu_torch.integrator.gate import MAX_LIGHTS, MAX_MATS
from craytracer_tpu_torch.sampling.mappings import map_to_hemisphere_cosine
from craytracer_tpu_torch.sampling.rng import MASK32, uniforms
from craytracer_tpu_torch.scene import types as T

RR_START = 3  # Russian roulette after bounce 3 (trace.h:512-525)
_F3 = ("L_add", "shadow_o", "shadow_d", "contrib_cand", "new_o", "new_d",
       "new_beta")


def env_radiance(scene: T.Scene):
    """The constant env light's radiance [3] f32; black without one."""
    env = scene.env
    if env.kind == 1:
        return (env.color * env.intensity).to(torch.float32)
    return torch.zeros(3, dtype=torch.float32, device=scene.device)


def material_light_rows(scene: T.Scene):
    """(env radiance [3], material rows [M, 19], light rows [L, 19]) in
    the column layouts of _meta_operands (pallas_shade.py:1613), unread
    columns included."""
    f32 = torch.float32
    m = scene.materials
    mt = torch.stack([m.mat_type.to(f32), m.color[:, 0], m.color[:, 1],
                      m.color[:, 2], m.on_a, m.intensity, m.on_b, m.alphax,
                      m.ks[:, 0], m.ks[:, 1], m.ks[:, 2],
                      m.eta[:, 0], m.eta[:, 1], m.eta[:, 2],
                      m.k[:, 0], m.k[:, 1], m.k[:, 2], m.ior_in, m.ior_out],
                     dim=-1)
    li = scene.lights
    lt = torch.cat([li.p0, li.v1, li.v2, li.normal,
                    li.color * li.intensity[:, None], li.radius[:, None],
                    li.power_cdf[:, None], li.power[:, None],
                    li.light_type[:, None].to(f32)], dim=-1)
    return env_radiance(scene), mt, lt


def shade_tables(scene: T.Scene):
    """K2's table: env radiance and a pad, then the material and light
    rows (csrc/shade_kernel.cu)."""
    env_li, mt, lt = material_light_rows(scene)
    pad = torch.zeros(1, dtype=torch.float32, device=scene.device)
    return torch.cat([env_li, pad, mt.reshape(-1), lt.reshape(-1)])


def _normalize3(x, y, z):
    n2 = x * x + y * y + z * z
    inv = torch.where(n2 > 1e-20, 1.0 / torch.sqrt(torch.clamp(n2, min=1e-20)),
                      0.0)
    return x * inv, y * inv, z * inv


# ---------------------------------------------------------------------------
# The plain version


@torch.no_grad()
def fused_shade_reference(scene: T.Scene, d, hit, beta, alive, prev_sg, pix,
                          spp, seed: int, bounce: int, max_depth: int,
                          rr_start: int = RR_START):
    """Plain PyTorch version of K2: `_shade_core` in torch ops, formula for
    formula (same expression trees and epsilons), over [N] lanes."""
    hitm = hit.t < TMAX
    mid = hit.mat_id.to(torch.int64).clamp(0, scene.materials.mat_type
                                           .shape[0] - 1)
    mats = scene.materials
    mtype = mats.mat_type[mid]
    cr, cg, cb = mats.color[mid].unbind(1)
    on_a, inten = mats.on_a[mid], mats.intensity[mid]
    env_li = env_radiance(scene)
    dx, dy, dz = d.unbind(1)
    px, py, pz = hit.point.unbind(1)
    nx, ny, nz = hit.normal.unbind(1)
    ux, uy, uz = hit.dpdu.unbind(1)
    bx, by, bz = beta.unbind(1)

    # ---- emitted / env add (trace.h:419-455)
    emissive_hit = hitm & (mtype == T.MAT_EMISSIVE)
    add_cond = alive & (prev_sg | (bounce == 0))
    add_emit = add_cond & emissive_hit
    add_env = add_cond & ~hitm
    l_add = torch.stack([
        torch.where(add_emit, b * (c * inten), 0.0)
        + torch.where(add_env, b * e, 0.0)
        for b, c, e in ((bx, cr, env_li[0]), (by, cg, env_li[1]),
                        (bz, cb, env_li[2]))], dim=1)
    good_inc = (add_emit | add_env).to(torch.int32)
    cont = alive & hitm & ~emissive_hit & (bounce < max_depth)

    # ---- shading frame (make_shading_frame on sanitized inputs)
    snx = torch.where(hitm, nx, 0.0)
    sny = torch.where(hitm, ny, 0.0)
    snz = torch.where(hitm, nz, 1.0)
    sux = torch.where(hitm, ux, 1.0)
    suy = torch.where(hitm, uy, 0.0)
    suz = torch.where(hitm, uz, 0.0)
    ndu = snx * sux + sny * suy + snz * suz
    tx = sux - ndu * snx
    ty = suy - ndu * sny
    tz = suz - ndu * snz
    t_len2 = tx * tx + ty * ty + tz * tz
    s = torch.where(snz >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + snz)
    ntx, nty, ntz = _normalize3(tx, ty, tz)
    use_t = t_len2 > 1e-12
    ftx = torch.where(use_t, ntx, 1.0 + s * snx * snx * a)
    fty = torch.where(use_t, nty, s * (snx * sny * a))
    ftz = torch.where(use_t, ntz, -s * snx)
    fbx, fby, fbz = _normalize3(sny * ftz - snz * fty, snz * ftx - snx * ftz,
                                snx * fty - sny * ftx)
    fnx, fny, fnz = snx, sny, snz

    # ---- counter RNG: dims 0,1 light, 4 pick, 5,6 bsdf, 8 rr
    u = uniforms(seed, pix, spp, bounce, 9, 0)
    u_l0, u_l1, u_pick = u[:, 0], u[:, 1], u[:, 4]
    u_rr = u[:, 8]

    # ---- NEE: power-CDF pick (searchsorted side='right' + clip), rect
    # sample, area -> solid angle, facing rejections (trace.h:221-397)
    li = scene.lights
    n_lights = li.light_type.shape[0]
    idx = torch.clamp(torch.searchsorted(li.power_cdf, u_pick.contiguous(),
                                         right=True), 0, n_lights - 1)
    p0, v1, v2, ln = li.p0[idx], li.v1[idx], li.v2[idx], li.normal[idx]
    l_rgb = (li.color * li.intensity[:, None])[idx]
    pick_p = li.power[idx]
    sp = p0 + u_l0[:, None] * v1 + u_l1[:, None] * v2
    len_v1 = torch.sqrt(torch.clamp(v1[:, 0] * v1[:, 0] + v1[:, 1] * v1[:, 1]
                                    + v1[:, 2] * v1[:, 2], min=1e-20))
    len_v2 = torch.sqrt(torch.clamp(v2[:, 0] * v2[:, 0] + v2[:, 1] * v2[:, 1]
                                    + v2[:, 2] * v2[:, 2], min=1e-20))
    pdf_area = 1.0 / torch.clamp(len_v1 * len_v2, min=1e-12)
    lnx, lny, lnz = ln.unbind(1)
    tox, toy, toz = sp[:, 0] - px, sp[:, 1] - py, sp[:, 2] - pz
    dist2 = tox * tox + toy * toy + toz * toz
    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
    wix, wiy, wiz = _normalize3(tox, toy, toz)
    conv = dist2 / torch.clamp(torch.abs(lnx * -wix + lny * -wiy
                                         + lnz * -wiz), min=1e-12)
    pdf_sa = pdf_area * conv
    reject = (((tox * lnx + toy * lny + toz * lnz) > 0.0)
              | ((tox * fnx + toy * fny + toz * fnz) < 0.0))
    valid = ~reject & (pdf_sa > 1e-12) & (pick_p > 0.0)
    pdf_nee = pdf_sa * torch.clamp(pick_p, min=1e-12)

    # NEE eval: Lambertian matte, |cos| at the shading normal
    is_matte = mtype == T.MAT_MATTE
    abs_cos = torch.abs(fnx * wix + fny * wiy + fnz * wiz)
    f_fac = torch.where(is_matte, on_a * INV_PI, 0.0)
    f_r, f_g, f_b = (cr * f_fac) * abs_cos, (cg * f_fac) * abs_cos, \
        (cb * f_fac) * abs_cos
    want_shadow = cont & valid & ((f_r > 0.0) | (f_g > 0.0) | (f_b > 0.0))

    # shadow origin offset along the raw hit normal (_offset_ray)
    mag = torch.maximum(torch.maximum(torch.abs(px), torch.abs(py)),
                        torch.abs(pz))
    eps = (mag + 1.0) * 1e-4
    side = torch.where((wix * nx + wiy * ny + wiz * nz) >= 0.0, 1.0, -1.0)
    shox, shoy, shoz = px + nx * eps * side, py + ny * eps * side, \
        pz + nz * eps * side
    dist_adj = dist - ((shox - px) * wix + (shoy - py) * wiy
                       + (shoz - pz) * wiz)
    shadow_o = torch.where(want_shadow[:, None],
                           torch.stack([shox, shoy, shoz], dim=1), 3.0e18)
    inv_pdf = 1.0 / torch.clamp(pdf_nee, min=1e-12)
    contrib = torch.stack([
        torch.where(want_shadow, b * (f * l_rgb[:, k] * inv_pdf), 0.0)
        for k, (b, f) in enumerate(((bx, f_r), (by, f_g), (bz, f_b)))],
        dim=1)

    # ---- BSDF sample: MATTE cosine hemisphere (dims 5,6)
    wlx, wly, wlz = map_to_hemisphere_cosine(u[:, 5:7]).unbind(1)
    pdf_s = torch.where(is_matte, wlz * INV_PI, 0.0)
    fs_fac = on_a * INV_PI
    fs_r = torch.where(is_matte, cr * fs_fac, 0.0)
    fs_g = torch.where(is_matte, cg * fs_fac, 0.0)
    fs_b = torch.where(is_matte, cb * fs_fac, 0.0)
    wlx = torch.where(is_matte, wlx, 0.0)
    wly = torch.where(is_matte, wly, 0.0)
    wlz = torch.where(is_matte, wlz, 1.0)
    dead = (pdf_s <= 0.0) | ((fs_r == 0.0) & (fs_g == 0.0) & (fs_b == 0.0))
    wwx = wlx * ftx + wly * fbx + wlz * fnx
    wwy = wlx * fty + wly * fby + wlz * fny
    wwz = wlx * ftz + wly * fbz + wlz * fnz
    w_cos = torch.abs(wwx * fnx + wwy * fny + wwz * fnz)
    w_scale = w_cos / torch.clamp(pdf_s, min=1e-12)
    nb = torch.stack([torch.where(cont, b * (f * w_scale), b)
                      for b, f in ((bx, fs_r), (by, fs_g), (bz, fs_b))], 1)

    # ---- Russian roulette (trace.h:512-525)
    max_c = torch.maximum(torch.maximum(nb[:, 0], nb[:, 1]), nb[:, 2])
    q = torch.clamp(1.0 - max_c, min=0.05)
    rr_active = cont & (bounce > rr_start)
    rr_kill = rr_active & (u_rr < q)
    inv_q = 1.0 / torch.clamp(1.0 - q, min=1e-6)
    nb = torch.where((rr_active & ~rr_kill)[:, None], nb * inv_q[:, None], nb)

    new_alive = cont & ~dead & ~rr_kill
    side2 = torch.where((wwx * nx + wwy * ny + wwz * nz) >= 0.0, 1.0, -1.0)
    new_o = torch.where(new_alive[:, None], torch.stack(
        [px + nx * eps * side2, py + ny * eps * side2,
         pz + nz * eps * side2], dim=1), 3.0e18)
    escape_d = torch.zeros_like(d)
    escape_d[:, 0] = 1.0
    new_d = torch.where(new_alive[:, None],
                        torch.stack([wwx, wwy, wwz], dim=1), escape_d)
    return {
        "L_add": l_add, "shadow_o": shadow_o,
        "shadow_d": torch.stack([wix, wiy, wiz], dim=1),
        "dist_adj": dist_adj,
        "dist_adj_t": torch.where(want_shadow, dist_adj, 0.0),
        "contrib_cand": contrib, "new_o": new_o, "new_d": new_d,
        "new_beta": nb, "good_inc": good_inc, "want_shadow": want_shadow,
        "new_alive": new_alive,
        # matte lobes are neither specular nor glossy
        "new_prev_sg": ~cont & prev_sg,
    }


# ---------------------------------------------------------------------------
# K2 on the card


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k2_shade_launch.argtypes = ([vp, ci, ci, ci] + [vp] * 11
                                    + [ci, ci, ctypes.c_uint, ci, ci, ci]
                                    + [vp] * 4)
    lib.k2_shade_launch.restype = ci


LIBRARY = CudaLibrary("shade_kernel", headers=("shade_core.cuh",),
                      bind=_bind)


KERNEL = LaunchCount()  # K2 launches through `fused_shade`


def _check_lanes(n, dev, floats3=(), lanes=()):
    for name, x in floats3:
        if (x.device != dev or x.dtype != torch.float32 or x.shape != (n, 3)
                or not x.is_contiguous()):
            raise ValueError(f"K2 takes {name} as a contiguous f32 [N, 3] "
                             f"tensor on {dev}")
    for name, x, dtype in lanes:
        if (x.device != dev or x.dtype != dtype or x.shape != (n,)
                or not x.is_contiguous()):
            raise ValueError(f"K2 takes {name} as a contiguous {dtype} [N] "
                             f"tensor on {dev}")


@torch.no_grad()
def fused_shade(scene: T.Scene, d, hit, beta, alive, prev_sg, pix, spp,
                seed: int, bounce: int, max_depth: int,
                rr_start: int = RR_START):
    """One bounce's shading: the dict described in the module docstring.
    `d`'s device decides: a CPU tensor takes the plain version, a CUDA
    tensor launches K2. `spp` is an int or a per-lane [N] tensor."""
    dev = d.device
    n = d.shape[0]
    for x in (d, hit.point, hit.normal, hit.dpdu, beta):
        if x.requires_grad:
            raise ValueError("K2 is forward-only: an input requires grad")
    if dev.type == "cpu":
        return fused_shade_reference(scene, d, hit, beta, alive, prev_sg, pix,
                                     spp, seed, bounce, max_depth, rr_start)
    if dev.type != "cuda":
        raise ValueError(f"K2 runs on CUDA tensors, not {dev}")
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device}, rays on {dev}")
    n_mats = scene.materials.mat_type.shape[0]
    n_lights = scene.lights.light_type.shape[0]
    if not (1 <= n_lights <= MAX_LIGHTS and 1 <= n_mats <= MAX_MATS):
        raise ValueError("K2 table sizes out of range")
    per_lane = isinstance(spp, torch.Tensor) and spp.dim() > 0
    _check_lanes(n, dev, (("d", d), ("hit.point", hit.point),
                          ("hit.normal", hit.normal), ("hit.dpdu", hit.dpdu),
                          ("beta", beta)),
                 (("hit.t", hit.t, torch.float32),
                  ("hit.mat_id", hit.mat_id, torch.int32),
                  ("alive", alive, torch.bool),
                  ("prev_sg", prev_sg, torch.bool),
                  ("pix", pix, torch.int32))
                 + ((("spp", spp, torch.int32),) if per_lane else ()))
    tab = shade_tables(scene)
    f3 = torch.empty((7, n, 3), dtype=torch.float32, device=dev)
    f1 = torch.empty((2, n), dtype=torch.float32, device=dev)
    io = torch.empty((4, n), dtype=torch.int32, device=dev)
    lib = LIBRARY.load()
    err = lib.k2_shade_launch(
        tab.data_ptr(), tab.numel(), n_mats, n_lights, d.data_ptr(),
        hit.point.data_ptr(), hit.normal.data_ptr(), hit.dpdu.data_ptr(),
        beta.data_ptr(), hit.t.data_ptr(), hit.mat_id.data_ptr(),
        alive.data_ptr(), prev_sg.data_ptr(), pix.data_ptr(),
        spp.data_ptr() if per_lane else None, 0 if per_lane else int(spp),
        n, int(seed) & MASK32, int(bounce), int(max_depth), int(rr_start),
        f3.data_ptr(), f1.data_ptr(), io.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    LIBRARY.check(err, "K2")
    KERNEL.launches += 1
    out = dict(zip(_F3, f3.unbind(0)))
    out.update(dist_adj=f1[0], dist_adj_t=f1[1], good_inc=io[0],
               want_shadow=io[1] != 0, new_alive=io[2] != 0,
               new_prev_sg=io[3] != 0)
    return out
