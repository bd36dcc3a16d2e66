"""K5, the split-table BVH4 closest hit (counterpart of
craytracer_tpu/accel/pallas_bvh4.py: `pallas_bvh4_closest_hit_hbm` :837
with `_traversal_kernel_split` :683).

The table is split into a compact topology table, the fat rows' first 32
columns (boxes and child ids, 128 bytes a row), and the leaf triangle
columns, read from the fat table. The CUDA C++ source is
csrc/bvh4_split.cu (one ray per thread, the plain walk's visit order,
the top topology rows in shared memory, leaf columns read only for leaf
children; see its note). `bvh4_closest_hit_split_kernel` is the wrapper:
for CPU tensors it takes the plain version, accel/bvh4.py
`bvh4_closest_hit_init` (the same function); for CUDA tensors it
launches K5 or raises. `SPLIT.launches` counts K5 launches. Nothing
routes to K5, as nothing routes to its TPU counterpart (measured slower
than the resident walk, pallas_bvh4.py:648-663); chip_smoke.py holds and
times it.
"""

from __future__ import annotations

import ctypes

import torch

from craytracer_tpu_torch.accel import bvh4_kernel
from craytracer_tpu_torch.accel.bvh4 import bvh4_closest_hit_init
from craytracer_tpu_torch.constants import TMAX
from craytracer_tpu_torch.cuda_build import CudaLibrary, LaunchCount
from craytracer_tpu_torch.scene.types import BVH4Arrays

TOPO_COLS = 32


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.k5_split_launch.argtypes = [vp, vp, ci, ci, vp, vp, vp, vp, ci, vp,
                                    vp, vp]
    lib.k5_split_launch.restype = ci


LIBRARY = CudaLibrary("bvh4_split", headers=("bvh4_walk.cuh",), bind=_bind)
SPLIT = LaunchCount()  # K5 launches


def split_topology(bvh: BVH4Arrays):
    """The topology table: [M, 32] f32, the fat rows' boxes, child ids and
    four unused columns, contiguous."""
    return bvh.fat[:, :TOPO_COLS].contiguous()


@torch.no_grad()
def bvh4_closest_hit_split_kernel(bvh: BVH4Arrays, o, d, t0=None, tri0=None,
                                  topo=None):
    """Closest hit (t [N] f32, tri [N] int32) over the split table, from
    the carried best hit (t0, tri0) when given, else from TMAX / -1: K5 for
    CUDA tensors, the plain traversal for CPU tensors. `topo` is
    `split_topology(bvh)`, made here when not given."""
    if (t0 is None) != (tri0 is None):
        raise ValueError("K5 takes t0 and tri0 together")
    on_card = bvh4_kernel._check(bvh, o, d, t0, tri0)
    if not on_card:
        if t0 is None:
            t0 = torch.full((o.shape[0],), TMAX, dtype=torch.float32,
                            device=o.device)
            tri0 = torch.full((o.shape[0],), -1, dtype=torch.int32,
                              device=o.device)
        return bvh4_closest_hit_init(bvh, o, d, t0, tri0)
    if topo is None:
        topo = split_topology(bvh)
    m = bvh.fat.shape[0]
    if not (topo.device == o.device and topo.dtype == torch.float32
            and topo.shape == (m, TOPO_COLS) and topo.is_contiguous()
            and topo.data_ptr() % 16 == 0):
        raise ValueError(f"K5 takes the topology table as a contiguous f32 "
                         f"[{m}, {TOPO_COLS}] tensor on {o.device}")
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    tri = torch.empty((n,), dtype=torch.int32, device=o.device)
    if n == 0:
        return t, tri
    lib = LIBRARY.load()
    err = lib.k5_split_launch(
        topo.data_ptr(), bvh.fat.data_ptr(), m, int(bvh.stack_size),
        o.data_ptr(), d.data_ptr(), None if t0 is None else t0.data_ptr(),
        None if tri0 is None else tri0.data_ptr(), n, t.data_ptr(),
        tri.data_ptr(), torch.cuda.current_stream(o.device).cuda_stream)
    LIBRARY.check(err, "K5")
    SPLIT.launches += 1
    return t, tri
