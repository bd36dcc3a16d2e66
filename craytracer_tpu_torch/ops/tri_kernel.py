"""K6, the brute-force ray x triangle closest hit (counterpart of
craytracer_tpu/ops/pallas_tri.py: `pack_triangles` :122,
`pallas_triangle_closest` :90 with `_kernel` :35).

`pack_triangles` lays the triangles out as the SoA table [9, T'] (v0, e1,
e2 components), padded with degenerate triangles to a multiple of 128.
`triangle_closest` is the plain version: Moller-Trumbore over every
(ray, triangle) pair in torch ops, ray chunk by ray chunk, with the |det|
< 1e-20 guard, tt > K_EPSILON, and the first minimum of t per ray (ties to
the lowest index). `triangle_closest_kernel` is the wrapper: for CPU
tensors it takes the plain version; for CUDA tensors it launches the CUDA
C++ kernel (csrc/tri_closest.cu: one ray per thread, triangle tiles
staged through shared memory) or raises. `KERNEL.launches` counts K6
launches. Nothing in the renderer routes to K6, as nothing in the JAX
package routes to its TPU counterpart; chip_smoke.py holds and times it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from craytracer_tpu_torch.constants import K_EPSILON, TMAX
from craytracer_tpu_torch.cuda_build import CudaLibrary, LaunchCount

TRI_TILE = 128
PAIRS_PER_CHUNK = 1 << 24  # (ray, triangle) pairs per plain-version chunk


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k6_tri_launch.argtypes = [vp, vp, ci, vp, ci, vp, vp, vp]
    lib.k6_tri_launch.restype = ci


LIBRARY = CudaLibrary("tri_closest", bind=_bind)
KERNEL = LaunchCount()  # K6 launches


def pack_triangles(v0, v1, v2, device="cpu"):
    """[T, 3] corners -> the padded [9, T'] f32 SoA table (v0, e1 = v1 -
    v0, e2 = v2 - v0; T' the next multiple of 128, at least 128; the pads
    all zero) on `device`."""
    v0 = np.asarray(v0, np.float32)
    t = v0.shape[0]
    t_pad = max(TRI_TILE, -(-t // TRI_TILE) * TRI_TILE)
    out = np.zeros((9, t_pad), np.float32)
    out[0:3, :t] = v0.T
    out[3:6, :t] = (np.asarray(v1, np.float32) - v0).T
    out[6:9, :t] = (np.asarray(v2, np.float32) - v0).T
    return torch.from_numpy(out).to(device)


@torch.no_grad()
def triangle_closest(o, d, tri_soa):
    """(t [N] f32, idx [N] int32): each ray's closest triangle of the
    [9, T'] table; TMAX / -1 on a miss."""
    n = o.shape[0]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        r[None, :] for r in tri_soa.unbind(0))
    t_out = torch.empty((n,), dtype=torch.float32, device=o.device)
    idx_out = torch.empty((n,), dtype=torch.int32, device=o.device)
    step = max(1, PAIRS_PER_CHUNK // max(1, tri_soa.shape[1]))
    for s in range(0, n, step):
        oo, dd = o[s:s + step], d[s:s + step]
        ox, oy, oz = oo[:, 0:1], oo[:, 1:2], oo[:, 2:3]
        dx, dy, dz = dd[:, 0:1], dd[:, 1:2], dd[:, 2:3]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        beta = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        gamma = (dx * qx + dy * qy + dz * qz) * inv_det
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = ((beta >= 0.0) & (gamma >= 0.0) & (beta + gamma <= 1.0)
              & (tt > K_EPSILON))
        t, idx = torch.where(ok, tt, TMAX).min(dim=1)
        t_out[s:s + step] = t
        idx_out[s:s + step] = torch.where(t < TMAX, idx, -1).to(torch.int32)
    return t_out, idx_out


@torch.no_grad()
def triangle_closest_kernel(o, d, tri_soa):
    """(t [N] f32, idx [N] int32): K6 for CUDA tensors, the plain version
    for CPU tensors."""
    dev = o.device
    n = o.shape[0]
    for x in (o, d, tri_soa):
        if x.requires_grad:
            raise ValueError("K6 is forward-only: an input requires grad")
        if x.device != dev:
            raise ValueError(f"K6 inputs on {x.device} and {dev}")
    if dev.type == "cpu":
        return triangle_closest(o, d, tri_soa)
    if dev.type != "cuda":
        raise ValueError(f"K6 runs on CUDA tensors, not {dev}")
    if not (o.dtype == d.dtype == tri_soa.dtype == torch.float32
            and o.shape == d.shape == (n, 3) and o.is_contiguous()
            and d.is_contiguous() and tri_soa.dim() == 2
            and tri_soa.shape[0] == 9 and tri_soa.shape[1] > 0
            and tri_soa.shape[1] % TRI_TILE == 0
            and tri_soa.is_contiguous()):
        raise ValueError("K6 takes contiguous f32 CUDA tensors: o, d [N, 3], "
                         f"tri_soa [9, T'] with T' a multiple of {TRI_TILE} "
                         "(pack_triangles)")
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return t, idx
    lib = LIBRARY.load()
    err = lib.k6_tri_launch(o.data_ptr(), d.data_ptr(), n, tri_soa.data_ptr(),
                            tri_soa.shape[1], t.data_ptr(), idx.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    LIBRARY.check(err, "K6")
    KERNEL.launches += 1
    return t, idx
