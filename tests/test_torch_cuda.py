"""K1-K6 and P1 on the card: each CUDA kernel against its plain PyTorch
version, the launch counts, and the wrappers' refusals; the general
route, whose traversal is K3 and K4, under the MIS estimator too; the
sphere field's "shade" route through K2; the torch-op accelerators' passes
through K2 (K3 for hybrid), AO through K4 and the HTTP live view; slice
H's ray- and geometry-sharded passes as two rank processes on the card
(gloo), K3 per ray shard, and the XL fullscene's triangle count. These
cases carry the
`cuda` marker (pytest.ini) and need a CUDA card and nvcc; without a card
they skip. The file imports no JAX, so on a machine with the card (and
no JAX) it runs on its own, without tests/conftest.py (which imports
JAX):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import ctypes
import dataclasses
import os

import pytest
import torch

from craytracer_tpu_torch.accel import bvh4_kernel as bk
from craytracer_tpu_torch.accel.bvh4 import bvh4_any_hit, bvh4_closest_hit
from craytracer_tpu_torch.camera import Film, generate_rays, make_camera
from craytracer_tpu_torch.constants import TMAX
from craytracer_tpu_torch.integrator import pass_kernel as pk
from craytracer_tpu_torch.integrator import shade_kernel as sk
from craytracer_tpu_torch.integrator import wavefront as wf
from craytracer_tpu_torch.integrator.gate import production_fast_shade
from craytracer_tpu_torch.interop import numpy_leaves, scene_from_numpy
from craytracer_tpu_torch.inverse import CUBLAS_CONFIG
from craytracer_tpu_torch.io.objloader import load_obj
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.ops.intersect import intersect_scene
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter
from craytracer_tpu_torch.scene import types as T
from craytracer_tpu_torch.scene.build import SceneBuilder

import torch_general_scenes as general_scenes
import torch_prim_scenes as prim_scenes
import torch_sphere_scenes as sphere_scenes

pytestmark = pytest.mark.cuda
# before the first cuBLAS call: the env light's matmul in the bit-exact
# resume case (craytracer_tpu_torch/inverse.py)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_CONFIG)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "parity_cornell.txt")
PRIMS = os.path.join(REPO, "scenes", "parity_prims.txt")
TEXTURED = os.path.join(REPO, "scenes", "parity_textured.txt")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _cornell(dev, size=48):
    scene, cam, film = load_scene_file(CORNELL, device=dev)
    return scene, cam, Film(fov=film.fov, width=size, height=size)


def _assert_pass_bars(out, ref):
    """A kernel route's whole pass against the plain version, the North
    star's bars on every lane: `good`, the ray and shadow-ray counts and
    the per-bounce histogram of live lanes equal, L within 2e-5 (absolute
    + relative)."""
    (L, good, m), (Lr, goodr, mr) = out, ref
    assert torch.equal(good, goodr)
    for key in ("lane_rays", "lane_shadow_rays", "rays", "shadow_rays",
                "bounce_live"):
        assert torch.equal(m[key], mr[key]), key
    assert ((L - Lr).abs() <= 2e-5 + 2e-5 * Lr.abs()).all()


@pytest.mark.parametrize("raygen", ["strat", "plain"])
@pytest.mark.parametrize("depth", [0, 2, 5])
def test_k1_matches_plain_version(cuda, depth, raygen):
    """Cornell (the matte-only core) with per-lane spp: _assert_k1_bars."""
    scene, cam, film = _cornell(cuda)
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32, device=cuda).repeat(2)
    spp = 3 + torch.arange(2, dtype=torch.int32,
                           device=cuda).repeat_interleave(n)
    args = (scene, cam, film, pix, spp, 7, depth)
    before = pk.KERNEL.launches
    out = pk.fused_pass(*args, raygen=raygen)
    assert pk.KERNEL.launches == before + 1
    _assert_pass_bars(out, pk.fused_pass_reference(*args, raygen=raygen))


@pytest.mark.parametrize("full", [0, 1])
def test_k1_partial_warp_writes_every_path(cuda, full):
    """48x48x2 + 7 lanes (not a multiple of the warp or the block) through
    K1's C entry point, with L and g prefilled with NaN and -1: every
    path's outputs are written and equal the plain version's, on both
    cores."""
    scene, cam, film = _cornell(cuda)
    n = film.num_pixels
    ar = torch.arange(n, dtype=torch.int32, device=cuda)
    pix = torch.cat([ar.repeat(2), ar[:7] * 97])
    spp = torch.cat([3 + torch.arange(2, dtype=torch.int32, device=cuda)
                     .repeat_interleave(n), torch.full_like(ar[:7], 9)])
    m = pix.shape[0]
    assert m % 32 and m % 128
    tab = pk.kernel_tables(scene, cam, film)
    L = torch.full((m, 3), float("nan"), device=cuda)
    g = torch.full((4, m), -1, dtype=torch.int32, device=cuda)
    next_path = torch.empty(1, dtype=torch.int32, device=cuda)
    lib = pk.LIBRARY.load()
    err = lib.k1_pass_launch(
        tab.data_ptr(), tab.numel(), pix.data_ptr(), spp.data_ptr(), m,
        (ctypes.c_int * 8)(*pk.table_counts(scene)), 7, 5, pk.RR_START, 1,
        0, film.width, full, next_path.data_ptr(), L.data_ptr(),
        g.data_ptr(), torch.cuda.current_stream().cuda_stream)
    pk.LIBRARY.check(err, "K1")
    torch.cuda.synchronize()
    assert int(next_path) >= m
    assert not torch.isnan(L).any() and bool((g >= 0).all())
    _assert_pass_bars(_as_pass(L, g, 5), pk.fused_pass_reference(
        scene, cam, film, pix, spp, 7, 5))
    assert torch.equal(g[3], (1 << g[1]) - 1)


def _as_pass(L, g, depth):
    """A K1 launch's (L, g) as fused_pass returns them."""
    bits = torch.arange(depth + 1, dtype=torch.int32, device=g.device)
    return L, g[0], {"lane_rays": g[1], "lane_shadow_rays": g[2],
                     "rays": g[1].sum(), "shadow_rays": g[2].sum(),
                     "bounce_live": ((g[3][:, None] >> bits) & 1).sum(0)}


@pytest.mark.parametrize("name", list(prim_scenes.MATTE_SCENES))
def test_k1_at_every_instantiation(cuda, name):
    """Matte-only scenes with planes and disks, planes and boxes, or boxes
    alone, on the matte-only and the full core (with Cornell's cores,
    all eight instantiations): _assert_k1_bars."""
    from craytracer_tpu_torch.camera import make_camera
    from craytracer_tpu_torch.scene.build import SceneBuilder

    b = SceneBuilder()
    eye, look, fov, depth = prim_scenes.build_matte(name, b)
    scene = b.build(device=cuda)
    cam = make_camera(eye, look, device=cuda)
    film = Film(fov=torch.tensor(fov, device=cuda), width=48, height=48)
    assert pk.shade_features(scene) == 0
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32, device=cuda).repeat(2)
    spp = 3 + torch.arange(2, dtype=torch.int32,
                           device=cuda).repeat_interleave(n)
    ref = pk.fused_pass_reference(scene, cam, film, pix, spp, 7, depth)
    tab = pk.kernel_tables(scene, cam, film)
    for full in (False, True):
        L, g = pk.KERNEL.launch(tab, pk.table_counts(scene), pix, spp, 7,
                                depth, True, film.width, full)
        _assert_pass_bars(_as_pass(L, g, depth), ref)


def test_k1_refuses_scenes_outside_its_gate(cuda):
    """A torus (the "shade" route's) and depth 31 stay out of K1."""
    scene, cam, film = _cornell(cuda, 8)
    pix = torch.arange(64, dtype=torch.int32, device=cuda)
    torus, _, _ = load_scene_file(PRIMS, device=cuda)
    before = pk.KERNEL.launches
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pk.fused_pass(torus, cam, film, pix, 0, 0, 5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pk.fused_pass(scene, cam, film, pix, 0, 0, 31)
    assert pk.KERNEL.launches == before


def test_k1_refuses_mixed_devices(cuda):
    scene, cam, film = _cornell(cuda, 8)
    with pytest.raises(ValueError, match="pixel ids"):
        pk.fused_pass(scene, cam, film, torch.arange(64), 0, 0, 2)


# ---- slice B: K2, K3 and K4 on the card

MESH = os.path.join(REPO, "scenes", "parity_mesh.txt")


def _mesh(dev, size=32):
    scene, cam, film = load_scene_file(MESH, device=dev)
    film = Film(fov=film.fov, width=size, height=size)
    pix = torch.arange(film.num_pixels, dtype=torch.int32, device=dev)
    o, d = generate_rays(cam, film, pix, stratified_jitter(3, pix, 1))
    return scene, cam, film, pix, o, d


def test_k3_k4_match_plain_traversal(cuda):
    """K3's t and ids and K4's t equal the plain traversal's on every lane
    (same visit order, --fmad=false), camera rays and random rays."""
    scene, _, _, _, o, d = _mesh(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    o_r = torch.rand((4096, 3), generator=gen, device=cuda) * 5.0 - 2.5
    d_r = torch.nn.functional.normalize(
        torch.randn((4096, 3), generator=gen, device=cuda), dim=1)
    for oo, dd in ((o, d), (o_r, d_r)):
        before = (bk.CLOSEST.launches, bk.ANY.launches)
        t, tri = bk.bvh4_closest_hit_kernel(scene.tri_bvh, oo, dd)
        t_p, tri_p = bvh4_closest_hit(scene.tri_bvh, oo, dd)
        assert torch.equal(t, t_p) and torch.equal(tri, tri_p)
        md = torch.where(t_p < 3e38, t_p * 1.25, 4.0)
        ta = bk.bvh4_any_hit_kernel(scene.tri_bvh, oo, dd, md)
        assert torch.equal(ta, bvh4_any_hit(scene.tri_bvh, oo, dd, md))
        assert (bk.CLOSEST.launches, bk.ANY.launches) == (before[0] + 1,
                                                          before[1] + 1)


@pytest.mark.parametrize("bounce", [0, 2])
def test_k2_matches_plain_shade(cuda, bounce):
    """K2's outputs against fused_shade_reference on a plain pass's hit
    records: floats within 1e-5 (absolute + relative), ints equal."""
    scene, _, _, pix, o, d = _mesh(cuda)
    spp = torch.full_like(pix, 1)
    state = wf._init_state(o, d, 5, pix)
    for b in range(bounce):
        state = wf._bounce_step(scene, 3, spp, 5, b, state, kernels=False)
    hit = intersect_scene(scene, state[0], state[1])
    args = (scene, state[1], hit, state[2], state[5], state[6], state[10],
            spp, 3, bounce, 5)
    before = sk.KERNEL.launches
    got = sk.fused_shade(*args)
    assert sk.KERNEL.launches == before + 1
    ref = sk.fused_shade_reference(*args)
    for key, val in ref.items():
        if val.dtype == torch.float32:
            assert torch.allclose(got[key], val, rtol=1e-5, atol=1e-5), key
        else:
            assert torch.equal(got[key], val), key


@pytest.mark.parametrize("depth", [0, 2, 5])
def test_shade_route_matches_plain_pass(cuda, depth):
    """trace_paths through K3 -> K2 -> K4 (with the ray_key sorts) against
    the plain trace_paths, on every lane: phase 8 of chip_smoke.py at
    32x32."""
    scene, _, _, pix, o, d = _mesh(cuda)
    out = wf.trace_paths(scene, o, d, 3, pix, 1, depth, with_metrics=True,
                         fast_shade="shade")
    ref = wf.trace_paths(scene, o, d, 3, pix, 1, depth, with_metrics=True)
    _assert_pass_bars(out, ref)


@pytest.mark.parametrize("depth", [0, 2, 5])
def test_general_route_matches_plain_pass(cuda, depth):
    """The general step through K3 and K4 against the general step with
    the plain traversal, on every lane; K3 and K4 launch once a bounce,
    K2 never."""
    scene, _, _, pix, o, d = _mesh(cuda)
    before = (bk.CLOSEST.launches, bk.ANY.launches, sk.KERNEL.launches)
    out = wf.trace_paths(scene, o, d, 3, pix, 1, depth, with_metrics=True,
                         fast_shade="shade", general=True)
    assert (bk.CLOSEST.launches, bk.ANY.launches, sk.KERNEL.launches) == (
        before[0] + depth + 1, before[1] + depth + 1, before[2])
    ref = wf.trace_paths(scene, o, d, 3, pix, 1, depth, with_metrics=True,
                         general=True)
    _assert_pass_bars(out, ref)


def test_general_scene_renders_through_k3_k4(cuda):
    """A scene only the general route shades (a disk light, a constant
    env light, an anisotropic Trowbridge-Reitz metal mesh) through
    render_sample: K3 and K4 once a bounce, no K1 or K2, finite."""
    b = SceneBuilder()
    shapes = [(s.positions, s.indices) for s in load_obj(
        os.path.join(REPO, "scenes", "icosphere_small.obj"))[0]]
    eye, look, fov, depth = general_scenes.mesh_env_disk(b, shapes)
    scene = scene_from_numpy(general_scenes.make_anisotropic(
        numpy_leaves(b.build(device="cpu"))), device=cuda)
    cam = make_camera(eye, look, device=cuda)
    film = Film(fov=torch.tensor(fov, device=cuda), width=32, height=32)
    assert production_fast_shade(scene, cam, film) == "general"
    pix = torch.arange(film.num_pixels, dtype=torch.int32, device=cuda)
    counts = (pk.KERNEL, sk.KERNEL, bk.CLOSEST, bk.ANY)
    before = [c.launches for c in counts]
    out = wf.render_sample(scene, cam, film, pix, 0, 0, depth)
    got = [c.launches - b0 for c, b0 in zip(counts, before)]
    assert got == [0, 0, depth + 1, depth + 1]
    assert bool(torch.isfinite(out).all()) and float(out.mean()) > 0


def test_textured_general_route_through_k3_k4(cuda, monkeypatch):
    """scenes/parity_textured.txt (a textured rect and quad mesh, an EXR
    texture env) with a bvh4 table: the general step through K3 and K4
    against the general step with the plain traversal at depth 5, on
    every lane; K3 and K4 launch once a bounce, K1 and K2 never."""
    monkeypatch.setenv("CRAY_TEX_FLOAT_DIV255", "1")
    scene, cam, film = load_scene_file(TEXTURED, accel="bvh4", device=cuda)
    film = Film(fov=film.fov, width=32, height=32)
    assert scene.tri_bvh is not None and scene.env.kind == 2
    assert production_fast_shade(scene, cam, film) == "general"
    pix = torch.arange(film.num_pixels, dtype=torch.int32, device=cuda)
    o, d = generate_rays(cam, film, pix, stratified_jitter(3, pix, 1))
    counts = (pk.KERNEL, sk.KERNEL, bk.CLOSEST, bk.ANY)
    before = [c.launches for c in counts]
    out = wf.trace_paths(scene, o, d, 3, pix, 1, 5, with_metrics=True,
                         fast_shade="shade")
    assert [c.launches - b0 for c, b0 in zip(counts, before)] == [0, 0, 6, 6]
    ref = wf.trace_paths(scene, o, d, 3, pix, 1, 5, with_metrics=True)
    _assert_pass_bars(out, ref)
    assert int(out[2]["shadow_rays"]) > 0


def test_slice_b_wrappers_refuse_bad_inputs(cuda):
    """The wrappers check device, dtype, shape and contiguity before the
    foreign call, and no CUDA input is traced on the CPU."""
    scene, _, _, pix, o, d = _mesh(cuda)
    bvh = scene.tri_bvh
    before = (bk.CLOSEST.launches, bk.ANY.launches, sk.KERNEL.launches)
    with pytest.raises(ValueError):
        bk.bvh4_closest_hit_kernel(bvh, o.t().contiguous().t(), d)
    with pytest.raises(ValueError):
        bk.bvh4_closest_hit_kernel(bvh, o.double(), d.double())
    with pytest.raises(ValueError):
        bk.bvh4_any_hit_kernel(bvh, o, d, torch.ones(3, device=cuda))
    with pytest.raises(ValueError):
        bk.bvh4_closest_hit_kernel(bvh, o.cpu(), d.cpu())
    hit = intersect_scene(scene, o, d)
    with pytest.raises(ValueError):
        sk.fused_shade(scene, d, hit, torch.ones_like(o).double(),
                       torch.ones_like(pix, dtype=torch.bool),
                       torch.zeros_like(pix, dtype=torch.bool), pix, 0, 3,
                       0, 5)
    assert (bk.CLOSEST.launches, bk.ANY.launches,
            sk.KERNEL.launches) == before


# ---- slice C2: spheres and every material through K1 and K2

MIX = os.path.join(REPO, "scenes", "parity_mix.txt")


def _sphere_scene(dev, name, size=48):
    """(scene, camera, film, depth): parity_mix or a scene of
    torch_sphere_scenes.py."""
    if name == "parity_mix":
        scene, cam, film = load_scene_file(MIX, device=dev)
        return scene, cam, Film(fov=film.fov, width=size, height=size), 5
    from craytracer_tpu_torch.camera import make_camera
    from craytracer_tpu_torch.scene.build import SceneBuilder

    b = SceneBuilder()
    eye, look, fov, depth = sphere_scenes.SCENES[name](b)
    return (b.build(device=dev), make_camera(eye, look, device=dev),
            Film(fov=torch.tensor(fov, device=dev), width=size, height=size),
            depth)


@pytest.mark.parametrize("name", ["parity_mix", "mirror_spheres",
                                  "sphere_light", "glossy_spheres",
                                  "glass_spheres"])
def test_k1_full_core_matches_plain_version(cuda, name):
    """K1's full core (spheres with the cosine-space clip window, every
    lobe, sphere lights) against the plain version, _assert_k1_bars, at
    depth 0 and the scene's depth."""
    scene, cam, film, depth = _sphere_scene(cuda, name)
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32, device=cuda).repeat(2)
    spp = 3 + torch.arange(2, dtype=torch.int32,
                           device=cuda).repeat_interleave(n)
    for dp in (0, depth):
        before = pk.KERNEL.launches
        out = pk.fused_pass(scene, cam, film, pix, spp, 7, dp)
        assert pk.KERNEL.launches == before + 1
        _assert_pass_bars(out, pk.fused_pass_reference(scene, cam, film, pix,
                                                     spp, 7, dp))


@pytest.mark.parametrize("name", ["parity_mix", "glass_spheres"])
def test_k2_full_core_matches_plain_shade(cuda, name):
    """K2's full core on bounce 0, 1 and 4 hit records of a plain pass:
    floats within 1e-5, ints equal on every lane."""
    scene, cam, film, _ = _sphere_scene(cuda, name, 64)
    pix = torch.arange(film.num_pixels, dtype=torch.int32, device=cuda)
    spp = torch.full_like(pix, 1)
    o, d = generate_rays(cam, film, pix, stratified_jitter(3, pix, spp))
    state = wf._init_state(o, d, 5, pix)
    for b in range(5):
        hit = intersect_scene(scene, state[0], state[1])
        if b in (0, 1, 4):
            args = (scene, state[1], hit, state[2], state[5], state[6],
                    state[10], spp, 3, b, 5)
            got = sk.fused_shade(*args)
            ref = sk.fused_shade_reference(*args)
            for key, val in ref.items():
                if val.dtype == torch.float32:
                    assert torch.allclose(got[key], val, rtol=1e-5,
                                          atol=1e-5), (b, key)
                else:
                    assert torch.equal(got[key], val), (b, key)
        state = wf._bounce_step(scene, 3, spp, 5, b, state, kernels=False)


# ---- slice D: planes, disks, boxes and thin-lens in K1; parity_prims
# through the "shade" route


def _prim_scene(dev, name, size=48):
    """(scene, camera, film, depth): a torch_prim_scenes.py scene, or
    parity_cornell with a thin-lens camera."""
    if name == "thinlens_cornell":
        scene, cam, film = _cornell(dev, size)
        return scene, prim_scenes.thinlens(cam), film, 5
    from craytracer_tpu_torch.camera import make_camera
    from craytracer_tpu_torch.scene.build import SceneBuilder

    b = SceneBuilder()
    eye, look, fov, depth = prim_scenes.SCENES[name](b)
    return (b.build(device=dev), make_camera(eye, look, device=dev),
            Film(fov=torch.tensor(fov, device=dev), width=size, height=size),
            depth)


@pytest.mark.parametrize("raygen", ["strat", "plain"])
@pytest.mark.parametrize("name", ["plane_disk", "aabox", "thinlens_cornell"])
def test_k1_prims_match_plain_version(cuda, name, raygen):
    """Planes, disks, the box table and the thin-lens raygen in K1 against
    the plain version, _assert_k1_bars, at depth 0 and the scene's
    depth."""
    scene, cam, film, depth = _prim_scene(cuda, name)
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32, device=cuda).repeat(2)
    spp = 3 + torch.arange(2, dtype=torch.int32,
                           device=cuda).repeat_interleave(n)
    for dp in (0, depth):
        before = pk.KERNEL.launches
        out = pk.fused_pass(scene, cam, film, pix, spp, 7, dp, raygen=raygen)
        assert pk.KERNEL.launches == before + 1
        _assert_pass_bars(out, pk.fused_pass_reference(
            scene, cam, film, pix, spp, 7, dp, raygen=raygen))


def _prims(dev, size=48):
    scene, cam, film = load_scene_file(PRIMS, device=dev)
    film = Film(fov=film.fov, width=size, height=size)
    pix = torch.arange(film.num_pixels, dtype=torch.int32, device=dev)
    o, d = generate_rays(cam, film, pix, stratified_jitter(3, pix, 1))
    return scene, pix, o, d


@pytest.mark.parametrize("depth", [0, 2, 5])
def test_parity_prims_shade_route_matches_plain_pass(cuda, depth):
    """parity_prims through trace_paths(fast_shade="shade"): one K2 launch
    per bounce and nothing else, against the plain trace_paths."""
    scene, pix, o, d = _prims(cuda)
    before = (pk.KERNEL.launches, sk.KERNEL.launches, bk.CLOSEST.launches)
    out = wf.trace_paths(scene, o, d, 3, pix, 1, depth, with_metrics=True,
                         fast_shade="shade")
    assert (pk.KERNEL.launches, sk.KERNEL.launches,
            bk.CLOSEST.launches) == (before[0], before[1] + depth + 1,
                                     before[2])
    ref = wf.trace_paths(scene, o, d, 3, pix, 1, depth, with_metrics=True)
    _assert_pass_bars(out, ref)


def test_k2_matches_plain_shade_on_prims_hits(cuda):
    """K2 on parity_prims' hit records (torus, box and disk fills with
    their Duff-tangent dpdu) of bounces 0, 1 and 4: floats within 1e-5,
    ints equal on every lane."""
    scene, pix, o, d = _prims(cuda)
    spp = torch.full_like(pix, 1)
    state = wf._init_state(o, d, 5, pix)
    for b in range(5):
        hit = intersect_scene(scene, state[0], state[1])
        if b in (0, 1, 4):
            args = (scene, state[1], hit, state[2], state[5], state[6],
                    state[10], spp, 3, b, 5)
            got = sk.fused_shade(*args)
            ref = sk.fused_shade_reference(*args)
            for key, val in ref.items():
                if val.dtype == torch.float32:
                    assert torch.allclose(got[key], val, rtol=1e-5,
                                          atol=1e-5), (b, key)
                else:
                    assert torch.equal(got[key], val), (b, key)
        state = wf._bounce_step(scene, 3, spp, 5, b, state, kernels=False)


# ---- slice J: partitioned tables (K3 `_init`, K4 per part), K5, K6, P1


def _city_parts(dev, tris=5120, size=32):
    """A small city whose table is cut at a fifth of its bytes (17 parts),
    the same scene uncut, and camera rays of 2 spp at size x size."""
    from craytracer_tpu_torch.accel import bvh4_parts
    from craytracer_tpu_torch.camera import make_camera
    from craytracer_tpu_torch.scene.city import city_builder

    whole = city_builder(tris).build(device=dev)
    mp = pytest.MonkeyPatch()
    mp.setattr(bvh4_parts, "PART_BUDGET_BYTES",
               whole.tri_bvh.fat.numel() * 4 // 5)
    try:
        cut = city_builder(tris).build(device=dev)
    finally:
        mp.undo()
    cam = make_camera((4, 6, 6), (-3, 2, -3), device=dev)
    film = Film(fov=torch.tensor(0.8726646, device=dev), width=size,
                height=size)
    pix = torch.arange(size * size, dtype=torch.int32, device=dev).repeat(2)
    spp = torch.arange(2, dtype=torch.int32,
                       device=dev).repeat_interleave(size * size)
    o, d = generate_rays(cam, film, pix, stratified_jitter(11, pix, spp))
    return whole, cut, pix, spp, o, d


def test_k3_init_and_k5_match_plain_traversal(cuda):
    """K3 `_init` and K5 (with and without a carried hit) equal the plain
    traversal on every lane, on every part with the best hit of the parts
    before it carried and on the whole table."""
    from craytracer_tpu_torch.accel import bvh4_split_kernel as sp
    from craytracer_tpu_torch.accel.bvh4 import bvh4_closest_hit_init

    whole, cut, _, _, o, d = _city_parts(cuda)
    assert len(cut.tri_parts) >= 3
    n = o.shape[0]
    t = torch.full((n,), TMAX, device=cuda)
    tri = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    for p in cut.tri_parts + (whole.tri_bvh,):
        before = (bk.CLOSEST_INIT.launches, sp.SPLIT.launches)
        t_p, tri_p = bvh4_closest_hit_init(p, o, d, t, tri)
        t_k, tri_k = bk.bvh4_closest_hit_init_kernel(p, o, d, t, tri)
        assert torch.equal(t_k, t_p) and torch.equal(tri_k, tri_p)
        t_s, tri_s = sp.bvh4_closest_hit_split_kernel(p, o, d, t, tri)
        assert torch.equal(t_s, t_p) and torch.equal(tri_s, tri_p)
        t_0, tri_0 = sp.bvh4_closest_hit_split_kernel(p, o, d)
        t_3, tri_3 = bk.bvh4_closest_hit_kernel(p, o, d)
        assert torch.equal(t_0, t_3) and torch.equal(tri_0, tri_3)
        assert (bk.CLOSEST_INIT.launches, sp.SPLIT.launches) == (
            before[0] + 1, before[1] + 2)
        t, tri = t_p, tri_p
    assert bool((tri >= 0).any())


@pytest.mark.parametrize("depth", [0, 2, 5])
def test_parts_route_matches_monolithic_route(cuda, depth):
    """trace_paths through the parts (K3 `_init` per part and bounce, K4
    per part) against the same scene's monolithic K3 / K4 route: counters
    exact, L and good equal on >= 99.9% of lanes (exact-t ties may pick
    another triangle)."""
    whole, cut, pix, spp, o, d = _city_parts(cuda)
    k = len(cut.tri_parts)
    before = (bk.CLOSEST.launches, bk.CLOSEST_INIT.launches, bk.ANY.launches)
    Lk, gk, mk = wf.trace_paths(cut, o, d, 11, pix, spp, depth,
                                with_metrics=True, fast_shade="shade")
    assert (bk.CLOSEST.launches, bk.CLOSEST_INIT.launches,
            bk.ANY.launches) == (before[0], before[1] + k * (depth + 1),
                                 before[2] + k * (depth + 1))
    Lm, gm, mm = wf.trace_paths(whole, o, d, 11, pix, spp, depth,
                                with_metrics=True, fast_shade="shade")
    same = (gk == gm) & (Lk == Lm).all(dim=1)
    assert same.double().mean().item() >= 0.999
    for key in ("rays", "shadow_rays"):
        assert int(mk[key]) == int(mm[key])


def test_k6_matches_plain_triangle_closest(cuda):
    """K6's t and idx equal the plain version's on every lane, exact-t
    ties (a repeated block of triangles) to the lowest index."""
    import numpy as np

    from craytracer_tpu_torch.ops import tri_kernel as tk

    rng = np.random.default_rng(4)
    base = rng.uniform(-10, 10, (1000, 3))
    v = [base + rng.normal(0, 1, (1000, 3)) for _ in range(3)]
    v = [np.concatenate([x, x[:200]]) for x in v]
    soa = tk.pack_triangles(*v, device=cuda)
    o = torch.from_numpy(rng.uniform(-15, 15, (5000, 3)).astype(
        np.float32)).to(cuda)
    d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(
        size=(5000, 3)).astype(np.float32)).to(cuda), dim=1)
    before = tk.KERNEL.launches
    t, idx = tk.triangle_closest_kernel(o, d, soa)
    assert tk.KERNEL.launches == before + 1
    t_p, idx_p = tk.triangle_closest(o, d, soa)
    assert torch.equal(t, t_p) and torch.equal(idx, idx_p)
    assert bool((idx >= 0).any()) and not bool((idx >= 1000).any())
    with pytest.raises(ValueError):
        tk.triangle_closest_kernel(o, d, soa[:, :100].contiguous())


@pytest.mark.parametrize("mode", ["empty", "rowload", "cols", "colsdir",
                                  "box", "mt", "full"])
def test_p1_matches_plain_probe(cuda, mode):
    """P1's t and sink equal the plain version's on every lane: the parity
    mesh's fat table, 4 packets of camera rays, 48 pops."""
    from craytracer_tpu_torch.profiling import pop_probe as pp

    scene, _, _, _, o, d = _mesh(cuda)
    o, d = o[:128].contiguous(), d[:128].contiguous()
    before = pp.KERNEL.launches
    t, sink = pp.pop_probe_kernel(scene.tri_bvh.fat, o, d, mode, 48)
    assert pp.KERNEL.launches == before + 1
    t_p, sink_p = pp.pop_probe(scene.tri_bvh.fat, o, d, mode, 48)
    assert torch.equal(t, t_p) and torch.equal(sink, sink_p)
    with pytest.raises(ValueError):
        pp.pop_probe_kernel(scene.tri_bvh.fat, o[:100], d[:100], mode, 48)


def test_sphere_field_shade_route_through_k2(cuda):
    """The 2,000-sphere field (its sphere BVH4 walked in torch ops) through
    trace_paths with K2 against the plain trace_paths at depth 5, on every
    lane; K2 launches once a bounce and nothing else."""
    from craytracer_tpu_torch.scene.sphere_field import (sphere_field,
                                                         sphere_field_view)

    scene = sphere_field(2000, device=cuda)
    cam, film = sphere_field_view(2000, 32, device=cuda)
    assert scene.sph_bvh is not None
    assert production_fast_shade(scene, cam, film) == "shade"
    pix = torch.arange(film.num_pixels, dtype=torch.int32, device=cuda)
    o, d = generate_rays(cam, film, pix, stratified_jitter(3, pix, 1))
    counts = (pk.KERNEL, sk.KERNEL, bk.CLOSEST, bk.ANY)
    before = [c.launches for c in counts]
    out = wf.trace_paths(scene, o, d, 3, pix, 1, 5, with_metrics=True,
                         fast_shade="shade")
    assert [c.launches - b0 for c, b0 in zip(counts, before)] == [0, 6, 0, 0]
    ref = wf.trace_paths(scene, o, d, 3, pix, 1, 5, with_metrics=True)
    _assert_pass_bars(out, ref)
    assert int(out[2]["shadow_rays"]) > 0


@pytest.mark.parametrize("depth", [2, 5])
def test_mis_general_route_matches_plain_pass(cuda, depth):
    """The MIS estimator through K3 and K4 against the same estimator with
    the plain traversal on the mesh, on every lane."""
    scene, _, _, pix, o, d = _mesh(cuda)
    assert production_fast_shade(scene, estimator="mis") == "general"
    before = (bk.CLOSEST.launches, bk.ANY.launches, sk.KERNEL.launches)
    out = wf.trace_paths(scene, o, d, 3, pix, 1, depth, with_metrics=True,
                         fast_shade="shade", mis=True)
    assert (bk.CLOSEST.launches, bk.ANY.launches, sk.KERNEL.launches) == (
        before[0] + depth + 1, before[1] + depth + 1, before[2])
    ref = wf.trace_paths(scene, o, d, 3, pix, 1, depth, with_metrics=True,
                         mis=True)
    _assert_pass_bars(out, ref)


def _mesh_mid_grad(dev, kernels, remat=False, estimator="physical"):
    """(loss, d loss / d material colors, d loss / d camera position,
    launches) of the mean 64x64 image of scenes/parity_mesh_mid.txt, 2
    spp, depth 2, through the kernels (kernels=True) or the plain
    traversal, trace_paths on render_sample's camera rays."""
    from craytracer_tpu_torch.interop import with_grad

    scene, cam, film = load_scene_file(
        os.path.join(REPO, "scenes", "parity_mesh_mid.txt"), device=dev)
    film = Film(fov=film.fov, width=64, height=64)
    mats, (color,) = with_grad(scene.materials, "color")
    scene = dataclasses.replace(scene, materials=mats)
    cam, (pos,) = with_grad(cam, "position")
    assert production_fast_shade(scene, cam, film, estimator) == "general"
    pix = torch.arange(film.num_pixels, dtype=torch.int32, device=dev)
    before = (bk.CLOSEST.launches, bk.ANY.launches, pk.KERNEL.launches,
              sk.KERNEL.launches)
    loss = 0.0
    for k in range(2):
        o, d = wf.camera_rays(cam, film, pix, 5, k,
                              stratified_jitter(5, pix, k))
        L, _ = wf.trace_paths(scene, o, d, 5, pix, k, 2,
                              fast_shade="shade" if kernels else None,
                              mis=estimator == "mis", remat=remat)
        loss = loss + L.mean()
    gc, gp = torch.autograd.grad(loss, [color, pos])
    after = (bk.CLOSEST.launches, bk.ANY.launches, pk.KERNEL.launches,
             sk.KERNEL.launches)
    return loss.detach(), gc, gp, tuple(a - b for a, b in zip(after, before))


@pytest.mark.parametrize("estimator", ["physical", "mis"])
def test_grad_through_kernels_matches_plain_traversal(cuda, estimator):
    """One gradient on parity_mesh_mid at 64x64 under autograd: the route
    is "general", K3 and K4 search (detached) once per bounce and pass,
    K1 and K2 never launch; the loss equals the plain traversal's bit for
    bit, and the gradients agree within rtol 1e-5 + 1e-5 max|g| (the
    backward's atomic sums may add in another order)."""
    lk, gck, gpk, nk = _mesh_mid_grad(cuda, True, estimator=estimator)
    lp, gcp, gpp, np_ = _mesh_mid_grad(cuda, False, estimator=estimator)
    assert nk == (6, 6, 0, 0) and np_ == (0, 0, 0, 0)
    assert torch.equal(lk, lp)
    for gk, gp in ((gck, gcp), (gpk, gpp)):
        assert torch.isfinite(gk).all() and float(gk.abs().max()) > 0.0
        tol = 1e-5 * float(gp.abs().max())
        assert ((gk - gp).abs() <= tol + 1e-5 * gp.abs()).all()


def test_remat_grad_on_card(cuda):
    """remat=True checkpoints each bounce: K3 and K4 launch again in the
    recompute (twice per bounce and pass), and the gradients equal the
    stored graph's (rtol 1e-5 + 1e-5 max|g|)."""
    lk, gck, gpk, nk = _mesh_mid_grad(cuda, True)
    lr, gcr, gpr, nr = _mesh_mid_grad(cuda, True, remat=True)
    assert nk == (6, 6, 0, 0) and nr == (12, 12, 0, 0)
    assert torch.equal(lk, lr)
    for a, b in ((gcr, gck), (gpr, gpk)):
        assert ((a - b).abs() <= 1e-5 * float(b.abs().max())
                + 1e-5 * b.abs()).all()


def _assert_resume_bit_exact(d, ck):
    """InverseRenderer on `d` (inverse_mesh_demo.demo's pieces): 2 steps +
    save + load + 2 steps equal 4 straight steps bit for bit, params and
    the optimizer's state."""
    from craytracer_tpu_torch.examples import inverse_mesh_demo as demo
    from craytracer_tpu_torch.inverse import InverseRenderer

    def fresh():
        return InverseRenderer(d["scene"], d["cam"], d["film"], d["target"],
                               d["params0"], d["apply_fn"], d["config"],
                               clip_fn=demo.clip_fn)

    a = fresh()
    for _ in range(4):
        a.step()
    b = fresh()
    for _ in range(2):
        b.step()
    b.save_state(ck)
    c = fresh().load_state(ck)
    for _ in range(2):
        c.step()
    for k in a.params:
        assert torch.equal(a.params[k], c.params[k]), k
    sa, sc = a.opt.state_dict()["state"], c.opt.state_dict()["state"]
    for k in sa:
        for name, v in sa[k].items():
            assert torch.equal(v.cpu(), sc[k][name].cpu()), name
    assert a.history == c.history and a.nan_steps == 0


def test_inverse_resume_bit_exact_on_card(cuda, tmp_path):
    """InverseRenderer on the card at 32x32 on the inverse mesh demo's
    scene: 2 steps + save + load + 2 steps equal 4 straight steps bit for
    bit, params and the optimizer's state (deterministic accumulation)."""
    from craytracer_tpu_torch.examples import inverse_mesh_demo as demo

    d = demo.demo(size=32, tex=64, steps=4, device=cuda)
    _assert_resume_bit_exact(d, str(tmp_path / "inv.pt"))


def test_inverse_resume_bit_exact_env_light_on_card(cuda, tmp_path,
                                                    monkeypatch):
    """The same resume with a constant env light added to the demo's
    scene: its rotation is a cuBLAS matmul in the forward and the
    backward pass, bit-exact with CUBLAS_WORKSPACE_CONFIG set before the
    first cuBLAS call (this module sets it at import)."""
    from craytracer_tpu_torch.examples import inverse_mesh_demo as demo

    class EnvBuilder(SceneBuilder):
        def build(self, *args, **kwargs):
            self.set_env_light("constant", (0.6, 0.7, 0.9), 0.5)
            return super().build(*args, **kwargs)

    monkeypatch.setattr(demo, "SceneBuilder", EnvBuilder)
    d = demo.demo(size=32, tex=64, steps=4, device=cuda)
    assert d["scene"].env.kind == 1
    _assert_resume_bit_exact(d, str(tmp_path / "inv.pt"))


# ---- slice F: K1 on external rays, compaction, WHITTED / RAYCAST,
# AOVs, the Renderer's resume and the command line on the card

MESH_MID = os.path.join(REPO, "scenes", "parity_mesh_mid.txt")
MIX = os.path.join(REPO, "scenes", "parity_mix.txt")


@pytest.mark.parametrize("path", [CORNELL, MIX])
def test_k1_external_rays_match_plain_version(cuda, path):
    """K1's external-ray mode on a multijittered table's camera rays,
    against its plain version: the pass bars; one count on RAYS_KERNEL."""
    from craytracer_tpu_torch.sampling.tables import make_sample_table

    scene, cam, film = load_scene_file(path, device=cuda)
    film = Film(fov=film.fov, width=40, height=24)
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32, device=cuda).repeat(2)
    spp = 3 + torch.arange(2, dtype=torch.int32,
                           device=cuda).repeat_interleave(n)
    table = make_sample_table("multijittered", 16, 5, seed=1, device=cuda)
    o, d = wf.camera_rays(cam, film, pix, 7, spp,
                          wf.film_jitter(7, pix, spp, table))
    before = (pk.KERNEL.launches, pk.RAYS_KERNEL.launches)
    out = pk.fused_pass(scene, cam, film, pix, spp, 7, 5, raygen=None,
                        rays=(o, d))
    assert (pk.KERNEL.launches, pk.RAYS_KERNEL.launches) == (
        before[0], before[1] + 1)
    _assert_pass_bars(out, pk.fused_pass_reference(
        scene, cam, film, pix, spp, 7, 5, raygen=None, rays=(o, d)))


def test_compaction_on_card_equals_dense(cuda):
    """parity_mesh_mid at depth 8 through K3 -> K2 -> K4: compacted after
    bounce 2 bit-equal with dense (L, good, lane counters, histogram), the
    launches 2 + 7 x (1 + hi) each; compacted against its plain version
    within the pass bars."""
    scene, cam, film = load_scene_file(MESH_MID, device=cuda)
    film = Film(fov=film.fov, width=64, height=64)
    pix = torch.arange(film.num_pixels, dtype=torch.int32,
                       device=cuda).repeat(2)
    spp = torch.arange(2, dtype=torch.int32,
                       device=cuda).repeat_interleave(film.num_pixels)
    o, d = wf.camera_rays(cam, film, pix, 7, spp,
                          stratified_jitter(7, pix, spp))
    before = (bk.CLOSEST.launches, sk.KERNEL.launches, bk.ANY.launches)
    comp = wf.trace_paths(scene, o, d, 7, pix, spp, 8, with_metrics=True,
                          fast_shade="shade", compact_at=2)
    per = 2 + 7 * (1 + int(comp[2]["compact_hi"]))
    assert (bk.CLOSEST.launches, sk.KERNEL.launches, bk.ANY.launches) == (
        before[0] + per, before[1] + per, before[2] + per)
    dense = wf.trace_paths(scene, o, d, 7, pix, spp, 8, with_metrics=True,
                           fast_shade="shade")
    assert torch.equal(comp[0], dense[0]) and torch.equal(comp[1], dense[1])
    for k in ("lane_rays", "lane_shadow_rays", "bounce_live"):
        assert torch.equal(comp[2][k], dense[2][k]), k
    _assert_pass_bars(comp, wf.trace_paths(
        scene, o, d, 7, pix, spp, 8, with_metrics=True, compact_at=2))


def test_whitted_raycast_and_aovs_on_card(cuda):
    """WHITTED and RAYCAST through K3 / K4 against the plain traversal (L
    within 2e-5), the AOVs through K3 bit-equal with the plain ones."""
    from craytracer_tpu_torch.integrator.aov import render_aovs
    from craytracer_tpu_torch.integrator.whitted import trace_whitted

    scene, cam, film = load_scene_file(MESH_MID, device=cuda)
    film = Film(fov=film.fov, width=48, height=40)
    pix = torch.arange(film.num_pixels, dtype=torch.int32, device=cuda)
    o, d = wf.camera_rays(cam, film, pix, 7, 2, stratified_jitter(7, pix, 2))
    for depth, cont in ((3, True), (0, False)):
        before = bk.CLOSEST.launches
        Lk = trace_whitted(scene, o, d, 7, pix, 2, depth, cont, kernels=True)
        assert bk.CLOSEST.launches == before + depth + 1
        Lp = trace_whitted(scene, o, d, 7, pix, 2, depth, cont)
        assert torch.allclose(Lk, Lp, rtol=2e-5, atol=2e-5)
    ak = render_aovs(scene, cam, film)
    ap = render_aovs(scene, cam, film, kernels=False)
    assert all(torch.equal(ak[k], ap[k]) for k in ak)


def test_renderer_resume_and_cli_on_card(cuda, tmp_path):
    """The Renderer on the card: 2 + 2 spp resumed from its .npz bit-equal
    with 4 straight, tiles within 1e-6; the command line's --spp-batch 0
    resolves to B = 7 at 512x512 on parity_mesh_mid."""
    from craytracer_tpu_torch.integrator.render import (RenderConfig,
                                                        Renderer,
                                                        auto_spp_batch)
    from craytracer_tpu_torch.io.imagestate import (load_image_state,
                                                    save_image_state)

    scene, cam, film = _cornell(cuda, 64)
    cfg = dict(max_depth=5, seed=3)
    straight = Renderer(scene, cam, film, RenderConfig(num_samples=4, **cfg))
    straight.render()
    half = Renderer(scene, cam, film, RenderConfig(num_samples=2, **cfg))
    half.render()
    save_image_state(str(tmp_path / "s"), half.accum, half.spp_done, 3)
    acc, spp, seed = load_image_state(str(tmp_path / "s"))
    resumed = Renderer(scene, cam, film, RenderConfig(num_samples=2, **cfg))
    resumed.resume_from(acc, spp)
    resumed.render()
    assert torch.equal(resumed.accum, straight.accum)
    tiled = Renderer(scene, cam, film, RenderConfig(num_samples=4,
                                                    tile_pixels=1000, **cfg))
    tiled.render()
    assert ((tiled.accum - straight.accum).abs() <= 4e-6).all()
    mesh, mcam, mfilm = load_scene_file(MESH_MID, device=cuda)
    mfilm = Film(fov=mfilm.fov, width=512, height=512)
    r = Renderer(mesh, mcam, mfilm, RenderConfig(spp_batch=0))
    assert r.spp_batch == 7 == auto_spp_batch("cuda", "bvh4", 20480,
                                              512 * 512)


@pytest.mark.parametrize("accel", ["bvh", "bvh4q", "grid", "binned",
                                   "hybrid"])
def test_accelerator_pass_on_card(cuda, accel):
    """parity_mesh_mid with each torch-op accelerator at 64x64, depth 5:
    the kernel route (K2 a bounce, K3 too for hybrid, never K4) against
    its plain version, and the closest hits against K3 on the bvh4
    table's camera rays (ids equal; binned's t within its 1e-4 bar)."""
    mesh_mid = os.path.join(REPO, "scenes", "parity_mesh_mid.txt")
    scene, cam, film = load_scene_file(mesh_mid, accel=accel, device=cuda)
    bvh4, _, _ = load_scene_file(mesh_mid, device=cuda)
    film = Film(fov=film.fov, width=64, height=64)
    pix = torch.arange(film.num_pixels, dtype=torch.int32, device=cuda)
    spp = torch.zeros_like(pix)
    o, d = wf.camera_rays(cam, film, pix, 0, spp, wf.film_jitter(0, pix,
                                                                 spp))
    for c in (sk.KERNEL, bk.CLOSEST, bk.ANY):
        c.launches = 0
    out = wf.trace_paths(scene, o, d, 0, pix, spp, 5, with_metrics=True,
                         fast_shade="shade")
    assert (sk.KERNEL.launches, bk.CLOSEST.launches, bk.ANY.launches) == (
        6, 6 if accel == "hybrid" else 0, 0)
    _assert_pass_bars(out, wf.trace_paths(scene, o, d, 0, pix, spp, 5,
                                          with_metrics=True))
    from craytracer_tpu_torch.ops.intersect import _tri_closest

    t_a, tri_a = _tri_closest(scene, o, d, kernels=True)
    t_r, tri_r = bk.bvh4_closest_hit_kernel(bvh4.tri_bvh, o, d)
    sel = tri_r >= 0
    assert torch.equal(tri_a[sel], tri_r[sel].long())
    tol = 1e-4 if accel == "binned" else 0.0
    assert ((t_a - t_r)[sel].abs() <= tol * t_r[sel].abs() + tol).all()
    assert (t_a[~sel] == TMAX).all()


def test_ao_and_live_view_on_card(cuda, tmp_path):
    """ao_test on a bvh4 mesh launches K4 once and equals the plain any
    hit; a Renderer with serve_port=-1 serves the frame it rendered."""
    import json
    import urllib.request

    from craytracer_tpu_torch.integrator.render import (RenderConfig,
                                                        Renderer)
    from craytracer_tpu_torch.io.teximage import read_png
    from craytracer_tpu_torch.sampling.rng import uniforms
    from craytracer_tpu_torch.utils.ao import ao_test

    mesh_mid = os.path.join(REPO, "scenes", "parity_mesh_mid.txt")
    scene, cam, film = load_scene_file(mesh_mid, device=cuda)
    film = Film(fov=film.fov, width=64, height=64)
    pix = torch.arange(film.num_pixels, dtype=torch.int32, device=cuda)
    o, d = wf.camera_rays(cam, film, pix, 0, 0, wf.film_jitter(0, pix, 0))
    hit = intersect_scene(scene, o, d)
    keep = hit.t < TMAX
    u2 = uniforms(0, pix[keep], 0, 0, 2)
    bk.ANY.launches = 0
    t_k = ao_test(scene, hit.point[keep], hit.normal[keep], u2)
    assert bk.ANY.launches == 1
    assert torch.equal(t_k, ao_test(scene, hit.point[keep],
                                    hit.normal[keep], u2, kernels=False))
    r = Renderer(*_cornell(cuda, 32), RenderConfig(num_samples=3,
                                                   serve_port=-1))
    r.render()
    try:
        url = f"http://127.0.0.1:{r.live.port}"
        status = json.loads(urllib.request.urlopen(url + "/status",
                                                   timeout=5).read())
        assert status == {"spp": 3, "total": 3, "nan": 0}
        (tmp_path / "f.png").write_bytes(urllib.request.urlopen(
            url + "/frame.png", timeout=5).read())
        assert read_png(str(tmp_path / "f.png")).shape == (32, 32, 3)
    finally:
        r.live.stop()


@pytest.fixture(scope="module")
def sharded_world():
    """Phase 49 (a) and (b) of chip_smoke.py at 64x64: Cornell over 2 ray
    ranks and parity_mesh_mid over 2 geometry shards, both ranks on
    cuda:0 over gloo, the kernels built here first; with the one-process
    passes on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    from craytracer_tpu_torch.parallel import dryrun

    cases = []
    for path, mesh in ((CORNELL, (2, 1)), (MESH_MID, (1, 2))):
        scene, cam, film = load_scene_file(path, device="cpu")
        cases.append(dict(kind="render", mesh=mesh, scene=scene, camera=cam,
                          film=Film(fov=film.fov, width=64, height=64),
                          depth=5, seed=3, spp=[0, 63]))
    dryrun.prebuild([c["scene"] for c in cases])
    results, _ = dryrun.launch(2, cases, "gloo", None, timeout=300)
    dev = torch.device("cuda", 0)
    refs = []
    for c in cases:
        pix = torch.arange(64 * 64, dtype=torch.int32, device=dev)
        refs.append([wf.render_sample(
            T.to_device(c["scene"], dev), T.to_device(c["camera"], dev),
            T.to_device(c["film"], dev), pix, 3, spp, 5, with_metrics=True)
            for spp in c["spp"]])
    return results, refs


def test_ray_sharded_pass_on_card(sharded_world):
    """Two ray ranks: one K1 launch per rank per pass and nothing else; L,
    good and both counters of every lane bit-equal with the one-process
    pass."""
    results, refs = sharded_world
    for r in results:
        for p, (L, good, m) in zip(r[0]["passes"], refs[0]):
            assert p["counts"] == dict.fromkeys(p["counts"], 0) | {
                "k1_pass": 1}
            assert torch.equal(p["L"], L.cpu())
            assert torch.equal(p["good"], good.cpu())
            assert torch.equal(p["lane_rays"], m["lane_rays"].cpu())
            assert torch.equal(p["lane_shadow_rays"],
                               m["lane_shadow_rays"].cpu())


def test_geom_sharded_pass_on_card(sharded_world):
    """Two geometry shards of parity_mesh_mid on the "shade" route: K3 =
    K2 = K4 = 6 per rank per pass at depth 5, K1 never; good and both
    counters equal and L within 2e-5 of the one-process pass on every
    lane."""
    results, refs = sharded_world
    for r in results:
        for p, (L, good, m) in zip(r[1]["passes"], refs[1]):
            assert p["counts"] == dict.fromkeys(p["counts"], 0) | {
                "k2_shade": 6, "k3_bvh4_closest": 6, "k4_bvh4_any": 6}
            assert torch.equal(p["good"], good.cpu())
            assert torch.equal(p["lane_rays"], m["lane_rays"].cpu())
            assert torch.equal(p["lane_shadow_rays"],
                               m["lane_shadow_rays"].cpu())
            Lr = L.cpu()
            assert ((p["L"] - Lr).abs() <= 2e-5 + 2e-5 * Lr.abs()).all()


@pytest.mark.parametrize("variant", ["whole", "parts"])
def test_k3_per_ray_shard_on_card(cuda, variant):
    """tests/test_pallas_shard.py's counterpart on the card: the rays split
    into 8 contiguous shards, each through K3 (K3 `_init` per part for the
    parts), bit-equal with unsharded K3 on every lane."""
    from craytracer_tpu_torch.accel import bvh4_parts
    from craytracer_tpu_torch.accel.bvh4 import build_bvh4
    from craytracer_tpu_torch.scene.city import icosphere

    v, f = icosphere(2)
    bvh = T.to_device(build_bvh4(v[f[:, 0]] * 3, v[f[:, 1]] * 3,
                                 v[f[:, 2]] * 3), cuda)
    gen = torch.Generator().manual_seed(3)
    n = 128 * 8
    o = torch.tensor([[0.0, 0.5, 8.0]]).repeat(n, 1).to(cuda)
    d = torch.randn((n, 3), generator=gen)
    d[:, 2] -= 1.5
    d = (d / d.norm(dim=1, keepdim=True)).to(cuda)
    before = (bk.CLOSEST.launches, bk.CLOSEST_INIT.launches)
    if variant == "parts":
        parts = bvh4_parts.partition_bvh4(bvh, bvh.fat.numel())
        assert len(parts) > 1
        got = [bvh4_parts.parts_closest_hit_kernel(parts, oo, dd)
               for oo, dd in zip(o.chunk(8), d.chunk(8))]
        assert bk.CLOSEST_INIT.launches == before[1] + 8 * len(parts)
    else:
        got = [bk.bvh4_closest_hit_kernel(bvh, oo, dd)
               for oo, dd in zip(o.chunk(8), d.chunk(8))]
        assert bk.CLOSEST.launches == before[0] + 8
    t_ref, i_ref = bk.bvh4_closest_hit_kernel(bvh, o, d)
    assert torch.equal(torch.cat([g[0] for g in got]), t_ref)
    assert torch.equal(torch.cat([g[1] for g in got]), i_ref)
    assert int((t_ref < 1e8).sum()) > 50


def test_xl_fullscene_triangle_count(cuda):
    """The XL fullscene's OBJ text at its default 450 spheres holds
    2,568,192 triangles, as triangle_count says (a full-size scene: the
    card's machine generates it)."""
    from craytracer_tpu_torch.scene import fullscene

    text = fullscene.obj_text(fullscene.SPHERES_XL, xl=True)
    assert text.count("\nf ") == fullscene.triangle_count(
        fullscene.SPHERES_XL, xl=True) == 2_568_192
