"""K1's (and K2's) CUDA source, built for the CPU, against the plain
PyTorch versions.

A CUDA kernel has no interpret mode, but K1's per-lane code is plain C++
inside CUDA qualifiers. This test compiles csrc/pass_kernel.cu (and
csrc/shade_kernel.cu) with the host C++ compiler, a stub `cuda_runtime.h`
(qualifiers as empty macros, the shared table as a static array) and the
`<<<...>>>` launch replaced by a loop over lanes with one-lane blocks,
then calls the same C entry point the wrapper calls, through ctypes, on
CPU tensors, at both instantiations of the shading core: the matte-only
core on parity_cornell, the full core on parity_cornell, parity_mix and
the sphere scenes of torch_sphere_scenes.py (mirror and clipped sphere,
sphere light, Oren-Nayar / plastic / metal, glass / transparent), and
on the planes-and-disks and instanced-box scenes of torch_prim_scenes.py
and a thin-lens parity_cornell, in both jitter variants. K1 is
held to the card's bar: >= 99.9% of lanes with equal good and L within
1e-4 (rtol and atol), ray and shadow-ray counters within 0.1% and exact
at depth 0, and the per-bounce histogram of live lanes exact; at these
settings every lane agrees and the counters are identical. K2 is held to
its card bar: floats within 1e-5, the int outputs equal on >= 99.9% of
lanes. Built with -ffp-contract=off, as the card build uses --fmad=false;
the host libm's sinf/cosf/expf/logf may differ from torch's by an ulp,
and K1 tests the sphere clip window in cosine space where the plain
version uses atan2/acos.

Skips when no C++ compiler is on the PATH."""

import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from craytracer_tpu_torch.camera import (THINLENS, Film, generate_rays,
                                        make_camera)
from craytracer_tpu_torch.integrator import pass_kernel as pk
from craytracer_tpu_torch.integrator import shade_kernel as sk
from craytracer_tpu_torch.integrator.gate import shade_features
from craytracer_tpu_torch.integrator.wavefront import _bounce_step, _init_state
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.ops.intersect import intersect_scene
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter
from craytracer_tpu_torch.scene.build import SceneBuilder

import torch_prim_scenes as prim_scenes
import torch_sphere_scenes as sphere_scenes

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "parity_cornell.txt")
MIX = os.path.join(REPO, "scenes", "parity_mix.txt")

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
struct k1_dim3 { int x; };
static k1_dim3 threadIdx, blockIdx, blockDim;
static inline void __syncthreads() {}
static inline int cudaGetLastError() { return 0; }
static inline const char* cudaGetErrorString(int) { return "host build"; }
using std::min;
using std::max;
namespace { float tab[1 << 14]; }
#define K1_HOST_LAUNCH(blocks, threads) \\
  blockDim.x = 1; threadIdx.x = 0; \\
  for (blockIdx.x = 0; blockIdx.x < (blocks) * (threads); ++blockIdx.x)
"""


def _host_build(tmp_path_factory, source, bind):
    """`source` (a csrc/*.cu path) built as C++ for the CPU, with its
    launches turned into lane loops; `bind` sets the ctypes signatures."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel sources")
    d = tmp_path_factory.mktemp(f"{source.stem}_host")
    (d / "cuda_runtime.h").write_text(STUB)
    src, n_launch = re.subn(
        r"(\w+(?:<\w+>)?)<<<\s*(\w+),\s*(\w+)[^>]*>>>\(",
        r"K1_HOST_LAUNCH(\2, \3) \1(", source.read_text())
    assert n_launch == 1
    (d / f"{source.stem}.cpp").write_text(src)
    lib = d / f"lib{source.stem}_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-I", str(d),
                    "-I", str(source.parent), "-o", str(lib),
                    str(d / f"{source.stem}.cpp")], check=True,
                   capture_output=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    bind(so)
    return so


@pytest.fixture(scope="module")
def k1_host(tmp_path_factory):
    return _host_build(tmp_path_factory, pk.SOURCE, pk._bind)


@pytest.fixture(scope="module")
def k2_host(tmp_path_factory):
    return _host_build(tmp_path_factory, sk.LIBRARY.source, sk._bind)


def _run_host(so, scene, cam, film, pix, spp, seed, depth, raygen,
              full):
    tab = pk.kernel_tables(scene, cam, film)
    n = pix.shape[0]
    L = torch.empty((n, 3), dtype=torch.float32)
    g = torch.empty((4, n), dtype=torch.int32)
    err = so.k1_pass_launch(
        tab.data_ptr(), tab.numel(), pix.data_ptr(), spp.data_ptr(), n,
        (ctypes.c_int * 8)(*pk.table_counts(scene)), seed, depth,
        pk.RR_START, int(raygen == "strat"),
        int(cam.camera_type == THINLENS), film.width, full, L.data_ptr(),
        g.data_ptr(), None)
    assert err == 0
    return L, g


def _check_k1(out, ref, depth):
    (L, g), (Lr, goodr, mr) = out, ref
    same = g[0] == goodr
    close = ((L - Lr).abs() <= 1e-4 + 1e-4 * Lr.abs()).all(dim=1)
    assert (same & close).double().mean().item() >= 0.999
    for row, key in ((1, "rays"), (2, "shadow_rays")):
        a, b = int(g[row].sum()), int(mr[key])
        assert a == b if depth == 0 else abs(a - b) <= 1e-3 * max(b, 1)
    bits = torch.arange(depth + 1, dtype=torch.int32)
    live = ((g[3][:, None] >> bits) & 1).sum(dim=0)
    assert torch.equal(live, mr["bounce_live"])


@pytest.mark.parametrize("raygen", ["strat", "plain"])
@pytest.mark.parametrize("depth", [0, 2, 5])
def test_k1_source_matches_plain_version(k1_host, depth, raygen):
    scene, cam, film = load_scene_file(CORNELL, device="cpu")
    film = Film(fov=film.fov, width=40, height=32)
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32).repeat(2)
    spp = (3 + torch.arange(2, dtype=torch.int32).repeat_interleave(n))
    ref = pk.fused_pass_reference(scene, cam, film, pix, spp, 7, depth,
                                  raygen=raygen)
    assert shade_features(scene) == 0
    for full in (0, 1):  # Cornell takes the matte-only core
        _check_k1(_run_host(k1_host, scene, cam, film, pix, spp, 7, depth,
                            raygen, full), ref, depth)


def _scene(name):
    """(scene, camera, film, depth) of parity_mix at 48x48 or a
    torch_sphere_scenes.py scene at its 32x32 view."""
    if name == "parity_mix":
        scene, cam, film = load_scene_file(MIX, device="cpu")
        return scene, cam, Film(fov=film.fov, width=48, height=48), 5
    b = SceneBuilder()
    eye, look, fov, depth = sphere_scenes.SCENES[name](b)
    return (b.build(device="cpu"), make_camera(eye, look, device="cpu"),
            Film(fov=torch.tensor(fov), width=32, height=32), depth)


SCENES = ["parity_mix", *sphere_scenes.SCENES]


@pytest.mark.parametrize("name", SCENES)
def test_k1_source_full_core_on_sphere_scenes(k1_host, name):
    """The full core (every lobe, sphere lights, spheres in the prim
    table) against the plain version at depth 0 and at the scene's
    depth."""
    scene, cam, film, depth = _scene(name)
    assert shade_features(scene) != 0 and scene.spheres.mat_id.shape[0]
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32).repeat(2)
    spp = (3 + torch.arange(2, dtype=torch.int32).repeat_interleave(n))
    for dp in (0, depth):
        ref = pk.fused_pass_reference(scene, cam, film, pix, spp, 7, dp)
        _check_k1(_run_host(k1_host, scene, cam, film, pix, spp, 7, dp,
                            "strat", 1), ref, dp)


PRIM_SCENES = ["plane_disk", "aabox", "thinlens_cornell"]


def _prim_scene(name):
    """(scene, camera, film, depth): a torch_prim_scenes.py scene at its
    32x32 view, or parity_cornell at 40x32 with a thin-lens camera."""
    if name == "thinlens_cornell":
        scene, cam, film = load_scene_file(CORNELL, device="cpu")
        return (scene, prim_scenes.thinlens(cam),
                Film(fov=film.fov, width=40, height=32), 5)
    b = SceneBuilder()
    eye, look, fov, depth = prim_scenes.SCENES[name](b)
    return (b.build(device="cpu"), make_camera(eye, look, device="cpu"),
            Film(fov=torch.tensor(fov), width=32, height=32), depth)


@pytest.mark.parametrize("raygen", ["strat", "plain"])
@pytest.mark.parametrize("name", PRIM_SCENES)
def test_k1_source_on_planes_disks_boxes_thinlens(k1_host, name, raygen):
    """Planes and disks in the prim table, the box table (slab test, face
    Newton step, dominant-axis normal, zero dpdu) and the thin-lens raygen
    against the plain version at depth 0 and the scene's depth, on the
    core the wrapper picks."""
    scene, cam, film, depth = _prim_scene(name)
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32).repeat(2)
    spp = (3 + torch.arange(2, dtype=torch.int32).repeat_interleave(n))
    full = int(shade_features(scene) != 0)
    for dp in (0, depth):
        ref = pk.fused_pass_reference(scene, cam, film, pix, spp, 7, dp,
                                      raygen=raygen)
        _check_k1(_run_host(k1_host, scene, cam, film, pix, spp, 7, dp,
                            raygen, full), ref, dp)


@pytest.mark.parametrize("name", ["parity_mix", "glass_spheres"])
def test_k2_source_full_core_matches_plain_shade(k2_host, name):
    """K2's full core on the hit records of bounces 0, 2 and 4 of one
    plain pass."""
    scene, cam, film, _ = _scene(name)
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32)
    spp = torch.full((n,), 2, dtype=torch.int32)
    o, d = generate_rays(cam, film, pix, stratified_jitter(7, pix, spp))
    state = _init_state(o, d, 5, pix)
    tab = sk.shade_tables(scene)
    for bounce in range(5):
        hit = intersect_scene(scene, state[0], state[1])
        if bounce in (0, 2, 4):
            _, dd, beta, _, _, alive, prev_sg, _, _, _, _ = state
            ref = sk.fused_shade_reference(scene, dd, hit, beta, alive,
                                           prev_sg, pix, spp, 7, bounce, 5)
            f3 = torch.empty((7, n, 3), dtype=torch.float32)
            f1 = torch.empty((2, n), dtype=torch.float32)
            io = torch.empty((4, n), dtype=torch.int32)
            args = [x.contiguous() for x in (dd, hit.point, hit.normal,
                                             hit.dpdu, beta, hit.t,
                                             hit.mat_id, alive, prev_sg, pix,
                                             spp)]
            assert k2_host.k2_shade_launch(
                tab.data_ptr(), tab.numel(),
                scene.materials.mat_type.shape[0],
                scene.lights.light_type.shape[0],
                *[a.data_ptr() for a in args], 0, n, 7, bounce, 5,
                sk.RR_START, 1, f3.data_ptr(), f1.data_ptr(),
                io.data_ptr(), None) == 0
            got = dict(zip(sk._F3, f3.unbind(0)))
            got.update(dist_adj=f1[0], dist_adj_t=f1[1])
            for key, val in got.items():
                assert torch.allclose(val, ref[key], rtol=1e-5,
                                      atol=1e-5), (bounce, key)
            for row, key in enumerate(("good_inc", "want_shadow",
                                       "new_alive", "new_prev_sg")):
                agree = (io[row] == ref[key].to(torch.int32)).double()
                assert agree.mean().item() >= 0.999, (bounce, key)
            assert bool(alive.any())
        state = _bounce_step(scene, 7, spp, 5, bounce, state, kernels=False)
