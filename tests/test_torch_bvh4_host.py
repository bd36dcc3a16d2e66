"""K2's, K3's and K4's CUDA sources, built for the CPU, against their plain
PyTorch versions.

As tests/test_torch_k1_host.py does for K1: csrc/shade_kernel.cu and
csrc/bvh4_traverse.cu are compiled with the host C++ compiler against a
stub `cuda_runtime.h` (qualifiers as empty macros, float4 and __ldg as
plain C++, the shared table as a static array) with each `<<<...>>>`
launch replaced by a loop over lanes, and their C entry points are called
through ctypes on CPU tensors. Built with -ffp-contract=off, as the card
build uses --fmad=false.

Bars, on scenes/parity_mesh.txt (320 triangles, 90 fat rows): K3's t and
triangle ids and K4's t equal the plain traversal's on every lane
(camera rays, the rays of bounces 1 and 3 of a plain pass, seeded random
rays with 1% escape lanes; and seeded rays through a soup of 3,000
random triangles, where an any hit's first occluder is often not the
closest, so K4's t checks its visit order: dropping K4's early exit
fails it); K2's float outputs within 1e-5 (absolute + relative) of
fused_shade_reference and its int outputs equal on every lane, at
bounces 0, 2 and 5 with per-lane spp (the host libm's sinf/cosf may
differ from torch's by an ulp). Measured: every K3/K4 lane bit-equal.

Skips when no C++ compiler is on the PATH."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from craytracer_tpu_torch.accel.bvh4 import (build_bvh4, bvh4_any_hit,
                                             bvh4_closest_hit)
from craytracer_tpu_torch.camera import Film, generate_rays
from craytracer_tpu_torch.cuda_build import CSRC
from craytracer_tpu_torch.integrator import shade_kernel as sk
from craytracer_tpu_torch.integrator.wavefront import _bounce_step, _init_state
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.ops.intersect import intersect_scene
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(REPO, "scenes", "parity_mesh.txt")
SEED = 5

STUB = """#pragma once
#include <math.h>
#include <stdint.h>
#include <algorithm>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
#define __restrict__
typedef void* cudaStream_t;
typedef int cudaError_t;
struct float4 { float x, y, z, w; };
static inline float4 __ldg(const float4* p) { return *p; }
struct host_dim3 { int x; };
static host_dim3 threadIdx, blockIdx, blockDim;
static inline void __syncthreads() {}
static inline int cudaGetLastError() { return 0; }
static inline const char* cudaGetErrorString(int) { return "host build"; }
using std::min;
using std::max;
namespace { float tab[1 << 14]; }
#define HOST_LAUNCH(blocks, threads) \\
  blockDim.x = 1; threadIdx.x = 0; \\
  for (blockIdx.x = 0; blockIdx.x < (blocks) * (threads); ++blockIdx.x)
"""


def _host_build(tmp_path_factory, stem, n_launches):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel sources")
    d = tmp_path_factory.mktemp(f"{stem}_host")
    (d / "cuda_runtime.h").write_text(STUB)
    src, n = re.subn(r"(\w+(?:<\w+>)?)<<<\s*(\w+),\s*(\w+)[^>]*>>>\(",
                     r"HOST_LAUNCH(\2, \3) \1(",
                     (CSRC / f"{stem}.cu").read_text())
    assert n == n_launches
    (d / f"{stem}.cpp").write_text(src)
    lib = d / f"lib{stem}.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-I", str(d),
                    "-I", str(CSRC), "-o", str(lib), str(d / f"{stem}.cpp")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    trav = _host_build(tmp_path_factory, "bvh4_traverse", 2)
    from craytracer_tpu_torch.accel.bvh4_kernel import _bind

    _bind(trav)
    shade = _host_build(tmp_path_factory, "shade_kernel", 1)
    sk._bind(shade)
    return trav, shade


@pytest.fixture(scope="module")
def mesh():
    scene, cam, film = load_scene_file(MESH, device="cpu")
    return scene, cam, Film(fov=film.fov, width=24, height=24)


def _pass_records(scene, cam, film, depths):
    """Per-bounce (ray state, hit record) of one plain pass with per-lane
    spp over two samples per pixel."""
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32).repeat(2)
    spp = 3 + torch.arange(2, dtype=torch.int32).repeat_interleave(n)
    o, d = generate_rays(cam, film, pix, stratified_jitter(SEED, pix, spp))
    state = _init_state(o, d, 5, pix)
    records = {}
    for bounce in range(6):
        if bounce in depths:
            hit = intersect_scene(scene, state[0], state[1])
            records[bounce] = (state, hit, spp)
        state = _bounce_step(scene, SEED, spp, 5, bounce, state,
                             kernels=False)
    return records


def _soup():
    """A BVH4 over 3,000 scattered random triangles, whose boxes overlap
    so much that an any hit's first triangle is often not the closest."""
    rng = np.random.default_rng(3)
    base = rng.uniform(-5, 5, (3000, 3))
    v = [(base + rng.normal(0, 0.6, (3000, 3))).astype(np.float32)
         for _ in range(3)]
    bvh = build_bvh4(*v)
    o = rng.uniform(-7, 7, (2000, 3)).astype(np.float32)
    d = rng.normal(size=(2000, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return bvh, torch.from_numpy(o), torch.from_numpy(d)


def _rays(scene, cam, film, kind):
    if kind == "random":
        rng = np.random.default_rng(11)
        n = 2000
        o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
        o[:, 1] = np.abs(o[:, 1])
        d = rng.normal(size=(n, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        o[: n // 100] = 3.0e18  # escape lanes
        d[: n // 100] = (1.0, 0.0, 0.0)
        return torch.from_numpy(o), torch.from_numpy(d)
    if kind == "camera":
        pix = torch.arange(film.num_pixels, dtype=torch.int32)
        return generate_rays(cam, film, pix, stratified_jitter(SEED, pix, 0))
    bounce = int(kind[-1])
    state, _, _ = _pass_records(scene, cam, film, (bounce,))[bounce]
    return state[0].contiguous(), state[1].contiguous()


@pytest.mark.parametrize("kind", ["camera", "bounce1", "bounce3", "random",
                                  "soup"])
def test_k3_k4_sources_match_plain_traversal(host_libs, mesh, kind):
    trav, _ = host_libs
    scene, cam, film = mesh
    if kind == "soup":
        bvh, o, d = _soup()
    else:
        bvh = scene.tri_bvh
        o, d = _rays(scene, cam, film, kind)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32)
    tri = torch.empty(n, dtype=torch.int32)
    assert trav.k3_closest_launch(
        bvh.fat.data_ptr(), bvh.fat.shape[0], bvh.stack_size, o.data_ptr(),
        d.data_ptr(), n, t.data_ptr(), tri.data_ptr(), None) == 0
    t_ref, tri_ref = bvh4_closest_hit(bvh, o, d)
    assert torch.equal(tri, tri_ref) and torch.equal(t, t_ref)
    hit = t_ref < 3e38
    assert hit.any() and (~hit).any()

    # any hit under a max_dist around the closest hit: occluded and clear
    # lanes, zero max_dist lanes (no shadow ray) and far max_dist lanes
    # (where the visit order decides which occluder is found) included
    md = torch.where(hit, t_ref * torch.linspace(0.5, 1.5, n), 5.0)
    md[1::3] = 1e30
    md[::7] = 0.0
    ta = torch.empty(n, dtype=torch.float32)
    assert trav.k4_any_launch(
        bvh.fat.data_ptr(), bvh.fat.shape[0], bvh.stack_size, o.data_ptr(),
        d.data_ptr(), md.data_ptr(), n, ta.data_ptr(), None) == 0
    ta_ref = bvh4_any_hit(bvh, o, d, md)
    assert torch.equal(ta, ta_ref)
    assert (ta_ref < md).any() and (ta_ref >= md).any()


@pytest.mark.parametrize("bounce", [0, 2, 5])
def test_k2_source_matches_plain_shade(host_libs, mesh, bounce):
    _, shade = host_libs
    scene, cam, film = mesh
    state, hit, spp = _pass_records(scene, cam, film, (bounce,))[bounce]
    o, d, beta, _, _, alive, prev_sg, _, _, _, pix = state
    ref = sk.fused_shade_reference(scene, d, hit, beta, alive, prev_sg, pix,
                                   spp, SEED, bounce, 5)
    n = d.shape[0]
    tab = sk.shade_tables(scene)
    f3 = torch.empty((7, n, 3), dtype=torch.float32)
    f1 = torch.empty((2, n), dtype=torch.float32)
    io = torch.empty((4, n), dtype=torch.int32)
    args = [x.contiguous() for x in (d, hit.point, hit.normal, hit.dpdu,
                                     beta, hit.t, hit.mat_id, alive,
                                     prev_sg, pix, spp)]
    assert shade.k2_shade_launch(
        tab.data_ptr(), tab.numel(), scene.materials.mat_type.shape[0],
        scene.lights.light_type.shape[0], *[a.data_ptr() for a in args],
        0, n, SEED, bounce, 5, sk.RR_START, 0, f3.data_ptr(), f1.data_ptr(),
        io.data_ptr(), None) == 0
    got = dict(zip(sk._F3, f3.unbind(0)))
    got.update(dist_adj=f1[0], dist_adj_t=f1[1])
    for key, val in got.items():
        assert torch.allclose(val, ref[key], rtol=1e-5, atol=1e-5), key
    for row, key in enumerate(("good_inc", "want_shadow", "new_alive",
                               "new_prev_sg")):
        assert torch.equal(io[row], ref[key].to(torch.int32)), key
    assert bool(alive.any())
