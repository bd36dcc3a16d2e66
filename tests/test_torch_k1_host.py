"""K1's (and K2's) CUDA source, built for the CPU, against the plain
PyTorch versions.

A CUDA kernel has no interpret mode, but K1's per-lane code is plain C++
inside CUDA qualifiers. tests/torch_cuda_host.py compiles
csrc/pass_kernel.cu (and csrc/shade_kernel.cu) with the host C++
compiler and a stub `cuda_runtime.h` that runs each block's threads as
threads, with shared memory, block and warp barriers and the warp votes,
shuffles and atomics K1's persistent warps take their paths with; the
stub's occupancy answer makes the launch 2 blocks of 128 threads, so
every thread runs many paths. The tests call the same C entry point the
wrapper calls, through ctypes, on CPU tensors, at every instantiation
the launcher picks: the matte-only core on parity_cornell, the full core
on parity_cornell, parity_mix and the sphere scenes of
torch_sphere_scenes.py (mirror and clipped sphere, sphere light,
Oren-Nayar / plastic / metal, glass / transparent), and the
planes-and-disks and instanced-box scenes of torch_prim_scenes.py and a
thin-lens parity_cornell, in both jitter variants; and a lane count that
is not a multiple of the warp or the block, with the outputs prefilled.
K1 is held to the card's bars: on every lane `good`, the ray and
shadow-ray counts and the alive mask equal the plain version's, L within
2e-5 (absolute + relative), and the per-bounce histogram of live lanes
equal. K2, built once per feature mask it is run with
(tests/torch_k2_host.py: parity_mix's, glass_spheres' and every bit), is
held to its card bar: floats within 1e-5, the count and the flags equal
on every lane. Built with -ffp-contract=off, as the card build uses
--fmad=false; the host libm's sinf/cosf/expf/logf may differ from
torch's by an ulp, and K1 tests the sphere clip window in cosine space
where the plain version uses atan2/acos.

Skips when no C++ compiler is on the PATH."""

import ctypes
import os

import pytest
import torch

from craytracer_tpu_torch.camera import (THINLENS, Film, generate_rays,
                                        make_camera)
from craytracer_tpu_torch.constants import TMAX
from craytracer_tpu_torch.integrator import pass_kernel as pk
from craytracer_tpu_torch.integrator import shade_kernel as sk
from craytracer_tpu_torch.integrator.gate import F_ALL, shade_features
from craytracer_tpu_torch.integrator.wavefront import _bounce_step, _init_state
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.ops.intersect import intersect_scene
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter
from craytracer_tpu_torch.scene.build import SceneBuilder

import torch_prim_scenes as prim_scenes
import torch_sphere_scenes as sphere_scenes
from torch_cuda_host import host_build
from torch_k2_host import check_k2, k2_lib, run_k2

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "parity_cornell.txt")
MIX = os.path.join(REPO, "scenes", "parity_mix.txt")
L_TOL = 2e-5


@pytest.fixture(scope="module")
def k1_host(tmp_path_factory):
    so = host_build(tmp_path_factory, "pass_kernel", 1)
    pk._bind(so)
    return so


def _run_host(so, scene, cam, film, pix, spp, seed, depth, raygen,
              full):
    """One launch through the C entry point, L and g prefilled with NaN
    and -1."""
    tab = pk.kernel_tables(scene, cam, film)
    n = pix.shape[0]
    L = torch.full((n, 3), float("nan"), dtype=torch.float32)
    g = torch.full((4, n), -1, dtype=torch.int32)
    next_path = torch.empty(1, dtype=torch.int32)
    err = so.k1_pass_launch(
        tab.data_ptr(), tab.numel(), pix.data_ptr(), spp.data_ptr(), n,
        (ctypes.c_int * 8)(*pk.table_counts(scene)), seed, depth,
        pk.RR_START, int(raygen == "strat"),
        int(cam.camera_type == THINLENS), film.width, full,
        next_path.data_ptr(), L.data_ptr(), g.data_ptr(), None)
    assert err == 0
    assert int(next_path) >= n  # every path index was handed out
    return L, g


def _check_k1(out, ref, depth):
    """The card's bars on every lane (module docstring)."""
    (L, g), (Lr, goodr, mr) = out, ref
    assert torch.equal(g[0], goodr)
    assert torch.equal(g[1], mr["lane_rays"])
    assert torch.equal(g[2], mr["lane_shadow_rays"])
    assert torch.equal(g[3], (1 << mr["lane_rays"]) - 1)
    assert ((L - Lr).abs() <= L_TOL + L_TOL * Lr.abs()).all()
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


@pytest.mark.parametrize("name", list(prim_scenes.MATTE_SCENES))
def test_k1_source_at_every_instantiation(k1_host, name):
    """Matte-only scenes with planes and disks, planes and boxes, or boxes
    alone, on the matte-only and the full core: with Cornell's two cores
    they reach all eight of the launcher's instantiations."""
    b = SceneBuilder()
    eye, look, fov, depth = prim_scenes.build_matte(name, b)
    scene = b.build(device="cpu")
    cam = make_camera(eye, look, device="cpu")
    film = Film(fov=torch.tensor(fov), width=32, height=32)
    assert shade_features(scene) == 0
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32).repeat(2)
    spp = (3 + torch.arange(2, dtype=torch.int32).repeat_interleave(n))
    ref = pk.fused_pass_reference(scene, cam, film, pix, spp, 7, depth)
    for full in (0, 1):
        _check_k1(_run_host(k1_host, scene, cam, film, pix, spp, 7, depth,
                            "strat", full), ref, depth)


@pytest.mark.parametrize("full", [0, 1])
def test_k1_source_on_a_partial_warp(k1_host, full):
    """48x48x2 + 7 lanes, not a multiple of the warp or the block, with
    L and g prefilled: every path's outputs are written and equal the
    plain version's, on both cores."""
    scene, cam, film = load_scene_file(CORNELL, device="cpu")
    film = Film(fov=film.fov, width=48, height=48)
    n = film.num_pixels
    pix = torch.cat([torch.arange(n, dtype=torch.int32).repeat(2),
                     torch.arange(7, dtype=torch.int32) * 97])
    spp = torch.cat([3 + torch.arange(2, dtype=torch.int32)
                     .repeat_interleave(n), torch.full((7,), 9,
                                                       dtype=torch.int32)])
    assert pix.shape[0] % 32 and pix.shape[0] % 128
    ref = pk.fused_pass_reference(scene, cam, film, pix, spp, 7, 5)
    L, g = _run_host(k1_host, scene, cam, film, pix, spp, 7, 5, "strat",
                     full)
    assert not torch.isnan(L).any()
    assert bool((g >= 0).all()) and bool((g[1] > 0).all())
    _check_k1((L, g), ref, 5)


DEADLOCK = """
#include <cuda_runtime.h>
namespace {
__global__ void stuck(int* out) {
  // thread 5 waits for its warp, the warp for the block: neither comes
  if (threadIdx.x == 5) __syncwarp(); else __syncthreads();
  out[threadIdx.x] = 1;
}
}  // namespace
extern "C" int stuck_launch(int* out) {
  stuck<<<1, 64>>>(out);
  return (int)cudaGetLastError();
}
"""


def test_host_stub_barrier_gives_up(tmp_path_factory):
    """Barriers that wait on each other make the launch return an error
    after the stub's timeout, instead of hanging."""
    so = host_build(tmp_path_factory, "stuck", 1, timeout_s=1.0,
                    text=DEADLOCK)
    out = torch.zeros(64, dtype=torch.int32)
    assert so.stuck_launch(ctypes.c_void_p(out.data_ptr())) == 702


@pytest.mark.parametrize("name", ["parity_mix", "glass_spheres"])
def test_k2_source_full_core_matches_plain_shade(tmp_path_factory, name):
    """K2 built for the scene's feature mask, on the hit records of bounces
    0, 2 and 4 of one plain pass."""
    scene, cam, film, _ = _scene(name)
    lib = k2_lib(tmp_path_factory, shade_features(scene))
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32)
    spp = torch.full((n,), 2, dtype=torch.int32)
    o, d = generate_rays(cam, film, pix, stratified_jitter(7, pix, spp))
    state = _init_state(o, d, 5, pix)
    for bounce in range(5):
        hit = intersect_scene(scene, state[0], state[1])
        if bounce in (0, 2, 4):
            _, dd, beta, _, _, alive, prev_sg, _, _, _, _ = state
            args = (scene, dd, hit, beta, alive, prev_sg, pix, spp, 7,
                    bounce, 5)
            check_k2(run_k2(lib, *args), sk.fused_shade_reference(*args),
                     bounce)
            assert bool(alive.any())
        state = _bounce_step(scene, 7, spp, 5, bounce, state, kernels=False)


def every_material(b):
    """glossy_spheres (Oren-Nayar and Lambertian matte, plastic, mirror,
    metal, a rect lamp) with glass_spheres' glass and thin balls and an
    emissive ball (a sphere light): every material type and mask bit."""
    eye, look, fov, _ = sphere_scenes.glossy_spheres(b)
    b.add_glass("glass", ior_in=1.5, ior_out=1.0, roughness=0.05)
    b.add_transparent("thin", ior_in=1.5, ior_out=1.0)
    b.add_emissive("bulb", (1.0, 0.8, 0.6), 30.0)
    b.add_sphere((-1.2, 2.6, 1.6), 0.5, "glass")
    b.add_sphere((1.4, 2.4, 1.8), 0.5, "thin")
    b.add_sphere((0.0, 3.0, -1.5), 0.4, "bulb")
    return eye, look, fov


def test_k2_source_every_material_type_in_each_block(tmp_path_factory):
    """K2 with every branch (mask F_ALL), on bounce-1 hit records reordered
    so that each full block of 128 lanes holds every material type and
    misses, and lanes whose path ends beside live ones; 2,299 lanes (a
    ragged last block) handed in as views 4 bytes (1 for the flags) past
    an aligned start."""
    b = SceneBuilder()
    eye, look, fov = every_material(b)
    scene = b.build(device="cpu")
    assert shade_features(scene) == F_ALL
    cam = make_camera(eye, look, device="cpu")
    film = Film(fov=torch.tensor(fov), width=48, height=48)
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32)
    spp = torch.full((n,), 1, dtype=torch.int32)
    o, d = generate_rays(cam, film, pix, stratified_jitter(7, pix, spp))
    state = _init_state(o, d, 5, pix)
    state = _bounce_step(scene, 7, spp, 5, 0, state, kernels=False)
    hit = intersect_scene(scene, state[0], state[1])
    # round robin over the kinds (material types, misses 0), each kind's
    # lanes in their order
    kind = torch.where(hit.t < TMAX, scene.materials.mat_type[
        hit.mat_id.long()], 0)
    rank = torch.zeros_like(kind)
    for k in kind.unique():
        sel = kind == k
        rank[sel] = torch.arange(int(sel.sum()), dtype=kind.dtype)
    order = torch.argsort(rank * 8 + kind, stable=True)[:n - 5]
    windows = kind[order][:(n - 5) // 128 * 128].reshape(-1, 128)
    assert all(len(w.unique()) == 8 for w in windows[:4])

    def off16(x):
        """`x` reordered, as a contiguous view 4 bytes past an aligned
        start."""
        buf = torch.empty(x[order].numel() + 1, dtype=x.dtype)
        view = buf[1:].view(x[order].shape)
        view.copy_(x[order])
        return view

    _, dd, beta, _, _, alive, prev_sg, _, _, _, _ = state
    hit_o = type(hit)(**{f: off16(getattr(hit, f)) if f in (
        "t", "point", "normal", "dpdu", "mat_id") else getattr(hit, f)[order]
        for f in hit.__dataclass_fields__})
    args = (scene, off16(dd), hit_o, off16(beta), off16(alive),
            off16(prev_sg), off16(pix), off16(spp), 7, 1, 5)
    lib = k2_lib(tmp_path_factory, F_ALL)
    check_k2(run_k2(lib, *args), sk.fused_shade_reference(*args))
