"""K3, K3 `_init` and K4, the BVH4 closest-hit and any-hit kernels
(counterpart of craytracer_tpu/accel/pallas_bvh4.py:
`pallas_bvh4_closest_hit` :583 with `_traversal_kernel` :146,
`pallas_bvh4_closest_hit_init` :399 with `_make_traversal_kernel_init`
:126, `pallas_bvh4_any_hit` :547 with `_anyhit_kernel` :451).

The CUDA C++ source is csrc/bvh4_traverse.cu with the walk of
csrc/bvh4_walk.cuh (see their notes): one ray per thread in the plain
version's visit order; a pop skips the (empty) slots of internal
children, and on a table past the L2 those of empty children too, which
is exact on every table the port hands to a kernel (`build_bvh4`,
`partition_bvh4` and `interop.scene_from_numpy` check it, accel/bvh4.py
`check_leaf_slots`); on a table past the L2 each pop prefetches the rows
of the children it pushes.
`bvh4_closest_hit_kernel`,
`bvh4_closest_hit_init_kernel` (the closest hit from a carried best hit,
the per-part step of accel/bvh4_parts.py) and `bvh4_any_hit_kernel` are
the wrappers: for CPU tensors they take the plain versions (accel/bvh4.py
`bvh4_closest_hit`, `bvh4_closest_hit_init`, `bvh4_any_hit`); for CUDA
tensors they launch the kernel or raise. They never fall back.
`CLOSEST.launches`, `CLOSEST_INIT.launches` and `ANY.launches` count K3,
K3 `_init` and K4 launches.
"""

from __future__ import annotations

import ctypes

import torch

from craytracer_tpu_torch.accel.bvh4 import (FAT_COLS, LEAF_SIZE, MAX_STACK,
                                             bvh4_any_hit, bvh4_closest_hit,
                                             bvh4_closest_hit_init)
from craytracer_tpu_torch.cuda_build import CudaLibrary, LaunchCount
from craytracer_tpu_torch.scene.types import BVH4Arrays


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k3_closest_launch.argtypes = [vp, ci, ci, vp, vp, ci, vp, vp, vp]
    lib.k3_closest_launch.restype = ci
    lib.k3_closest_init_launch.argtypes = [vp, ci, ci, vp, vp, vp, vp, ci,
                                           vp, vp, vp]
    lib.k3_closest_init_launch.restype = ci
    lib.k4_any_launch.argtypes = [vp, ci, ci, vp, vp, vp, ci, vp, vp]
    lib.k4_any_launch.restype = ci


LIBRARY = CudaLibrary("bvh4_traverse", headers=("bvh4_walk.cuh",),
                      bind=_bind)


CLOSEST = LaunchCount()  # K3 launches
CLOSEST_INIT = LaunchCount()  # K3 `_init` launches
ANY = LaunchCount()  # K4 launches


def _check(bvh: BVH4Arrays, o, d, md=None, tri0=None) -> bool:
    """Validate the inputs (`md`: max_dist or a carried t0, [N] f32;
    `tri0`: a carried triangle id, [N] int32); True when they lie on the
    card."""
    dev = o.device
    n = o.shape[0]
    fat = bvh.fat
    for x in (o, d, fat) + tuple(y for y in (md, tri0) if y is not None):
        if x.requires_grad:
            raise ValueError("K3/K4 are forward-only: an input requires grad")
        if x.device != dev:
            raise ValueError(f"BVH4 traversal inputs on {x.device} and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"K3/K4 run on CUDA tensors, not {dev}")
    ok = (o.dtype == d.dtype == fat.dtype == torch.float32
          and o.shape == d.shape == (n, 3) and o.is_contiguous()
          and d.is_contiguous() and fat.dim() == 2
          and fat.shape[1] == FAT_COLS and fat.is_contiguous()
          and fat.data_ptr() % 16 == 0 and bvh.leaf_size == LEAF_SIZE
          and 1 <= bvh.stack_size <= MAX_STACK)
    if md is not None:
        ok = (ok and md.dtype == torch.float32 and md.shape == (n,)
              and md.is_contiguous())
    if tri0 is not None:
        ok = (ok and tri0.dtype == torch.int32 and tri0.shape == (n,)
              and tri0.is_contiguous())
    if not ok:
        raise ValueError(
            "K3/K4 take contiguous CUDA tensors: o, d [N, 3] f32, max_dist "
            "or t0 [N] f32, tri0 [N] int32, fat [M, "
            f"{FAT_COLS}] f32 (16-byte aligned), leaf size {LEAF_SIZE}, "
            f"stack size <= {MAX_STACK}")
    return True


@torch.no_grad()
def bvh4_closest_hit_kernel(bvh: BVH4Arrays, o, d):
    """Closest hit (t [N] f32, triangle id [N] int32; TMAX / -1 on a
    miss): K3 for CUDA tensors, the plain traversal for CPU tensors."""
    if not _check(bvh, o, d):
        return bvh4_closest_hit(bvh, o, d)
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    tri = torch.empty((n,), dtype=torch.int32, device=o.device)
    if n == 0:
        return t, tri
    lib = LIBRARY.load()
    err = lib.k3_closest_launch(
        bvh.fat.data_ptr(), bvh.fat.shape[0], int(bvh.stack_size),
        o.data_ptr(), d.data_ptr(), n, t.data_ptr(), tri.data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream)
    LIBRARY.check(err, "K3")
    CLOSEST.launches += 1
    return t, tri


@torch.no_grad()
def bvh4_closest_hit_init_kernel(bvh: BVH4Arrays, o, d, t0, tri0):
    """Closest hit from the carried best hit (t0 [N] f32, tri0 [N] int32):
    K3 `_init` for CUDA tensors, the plain traversal for CPU tensors."""
    if not _check(bvh, o, d, t0, tri0):
        return bvh4_closest_hit_init(bvh, o, d, t0, tri0)
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    tri = torch.empty((n,), dtype=torch.int32, device=o.device)
    if n == 0:
        return t, tri
    lib = LIBRARY.load()
    err = lib.k3_closest_init_launch(
        bvh.fat.data_ptr(), bvh.fat.shape[0], int(bvh.stack_size),
        o.data_ptr(), d.data_ptr(), t0.data_ptr(), tri0.data_ptr(), n,
        t.data_ptr(), tri.data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream)
    LIBRARY.check(err, "K3 _init")
    CLOSEST_INIT.launches += 1
    return t, tri


@torch.no_grad()
def bvh4_any_hit_kernel(bvh: BVH4Arrays, o, d, max_dist):
    """Shadow any hit (t [N] f32: < max_dist when occluded, else TMAX):
    K4 for CUDA tensors, the plain traversal for CPU tensors."""
    if not _check(bvh, o, d, max_dist):
        return bvh4_any_hit(bvh, o, d, max_dist)
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    if n == 0:
        return t
    lib = LIBRARY.load()
    err = lib.k4_any_launch(
        bvh.fat.data_ptr(), bvh.fat.shape[0], int(bvh.stack_size),
        o.data_ptr(), d.data_ptr(), max_dist.data_ptr(), n, t.data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream)
    LIBRARY.check(err, "K4")
    ANY.launches += 1
    return t
