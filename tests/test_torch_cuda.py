"""K1-K6 and P1 on the card: each CUDA kernel against its plain PyTorch
version, the launch counts, and the wrappers' refusals. These
cases carry the
`cuda` marker (pytest.ini) and need a CUDA card and nvcc; without a card
they skip. The file imports no JAX, so on a machine with the card (and
no JAX) it runs on its own, without tests/conftest.py (which imports
JAX):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import os

import pytest
import torch

from craytracer_tpu_torch.accel import bvh4_kernel as bk
from craytracer_tpu_torch.accel.bvh4 import bvh4_any_hit, bvh4_closest_hit
from craytracer_tpu_torch.camera import Film, generate_rays
from craytracer_tpu_torch.constants import TMAX
from craytracer_tpu_torch.integrator import pass_kernel as pk
from craytracer_tpu_torch.integrator import shade_kernel as sk
from craytracer_tpu_torch.integrator import wavefront as wf
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.ops.intersect import intersect_scene
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter
from craytracer_tpu_torch.scene import types as T

import torch_prim_scenes as prim_scenes
import torch_sphere_scenes as sphere_scenes

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "parity_cornell.txt")
PRIMS = os.path.join(REPO, "scenes", "parity_prims.txt")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _cornell(dev, size=48):
    scene, cam, film = load_scene_file(CORNELL, device=dev)
    return scene, cam, Film(fov=film.fov, width=size, height=size)


@pytest.mark.parametrize("raygen", ["strat", "plain"])
@pytest.mark.parametrize("depth", [0, 2, 5])
def test_k1_matches_plain_version(cuda, depth, raygen):
    """>= 99.9% of lanes with equal good and L within 1e-4 (rtol and
    atol); rays and shadow_rays within 0.1%, exact at depth 0."""
    scene, cam, film = _cornell(cuda)
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32, device=cuda).repeat(2)
    spp = 3 + torch.arange(2, dtype=torch.int32,
                           device=cuda).repeat_interleave(n)
    args = (scene, cam, film, pix, spp, 7, depth)
    before = pk.KERNEL.launches
    L, good, m = pk.fused_pass(*args, raygen=raygen)
    assert pk.KERNEL.launches == before + 1
    Lr, goodr, mr = pk.fused_pass_reference(*args, raygen=raygen)
    same = good == goodr
    close = ((L - Lr).abs() <= 1e-4 + 1e-4 * Lr.abs()).all(dim=1)
    assert (same & close).double().mean().item() >= 0.999
    for key in ("rays", "shadow_rays"):
        a, b = int(m[key]), int(mr[key])
        assert a == b if depth == 0 else abs(a - b) <= 1e-3 * max(b, 1)
    assert torch.equal(m["bounce_live"].cpu(), mr["bounce_live"].cpu())


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
    the plain trace_paths: phase 8 of chip_smoke.py at 32x32."""
    scene, _, _, pix, o, d = _mesh(cuda)
    Lk, gk, mk = wf.trace_paths(scene, o, d, 3, pix, 1, depth,
                                with_metrics=True, fast_shade="shade")
    Lp, gp, mp = wf.trace_paths(scene, o, d, 3, pix, 1, depth,
                                with_metrics=True)
    same = gk == gp
    close = ((Lk - Lp).abs() <= 1e-4 + 1e-4 * Lp.abs()).all(dim=1)
    assert (same & close).double().mean().item() >= 0.999
    for key in ("rays", "shadow_rays"):
        assert int(mk[key]) == int(mp[key])


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
    lobe, sphere lights) against the plain version, with the bars of
    test_k1_matches_plain_version, at depth 0 and the scene's depth."""
    scene, cam, film, depth = _sphere_scene(cuda, name)
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32, device=cuda).repeat(2)
    spp = 3 + torch.arange(2, dtype=torch.int32,
                           device=cuda).repeat_interleave(n)
    for dp in (0, depth):
        before = pk.KERNEL.launches
        L, good, m = pk.fused_pass(scene, cam, film, pix, spp, 7, dp)
        assert pk.KERNEL.launches == before + 1
        Lr, goodr, mr = pk.fused_pass_reference(scene, cam, film, pix, spp,
                                                7, dp)
        same = good == goodr
        close = ((L - Lr).abs() <= 1e-4 + 1e-4 * Lr.abs()).all(dim=1)
        assert (same & close).double().mean().item() >= 0.999
        for key in ("rays", "shadow_rays"):
            a, b = int(m[key]), int(mr[key])
            assert a == b if dp == 0 else abs(a - b) <= 1e-3 * max(b, 1)


@pytest.mark.parametrize("name", ["parity_mix", "glass_spheres"])
def test_k2_full_core_matches_plain_shade(cuda, name):
    """K2's full core on bounce 0, 1 and 4 hit records of a plain pass:
    floats within 1e-5, ints equal on >= 99.9% of lanes."""
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
                    agree = (got[key] == val).double().mean().item()
                    assert agree >= 0.999, (b, key)
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
    the plain version, with the bars of test_k1_matches_plain_version, at
    depth 0 and the scene's depth."""
    scene, cam, film, depth = _prim_scene(cuda, name)
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32, device=cuda).repeat(2)
    spp = 3 + torch.arange(2, dtype=torch.int32,
                           device=cuda).repeat_interleave(n)
    for dp in (0, depth):
        before = pk.KERNEL.launches
        L, good, m = pk.fused_pass(scene, cam, film, pix, spp, 7, dp,
                                   raygen=raygen)
        assert pk.KERNEL.launches == before + 1
        Lr, goodr, mr = pk.fused_pass_reference(scene, cam, film, pix, spp,
                                                7, dp, raygen=raygen)
        same = good == goodr
        close = ((L - Lr).abs() <= 1e-4 + 1e-4 * Lr.abs()).all(dim=1)
        assert (same & close).double().mean().item() >= 0.999
        for key in ("rays", "shadow_rays"):
            a, b = int(m[key]), int(mr[key])
            assert a == b if dp == 0 else abs(a - b) <= 1e-3 * max(b, 1)


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
    Lk, gk, mk = wf.trace_paths(scene, o, d, 3, pix, 1, depth,
                                with_metrics=True, fast_shade="shade")
    assert (pk.KERNEL.launches, sk.KERNEL.launches,
            bk.CLOSEST.launches) == (before[0], before[1] + depth + 1,
                                     before[2])
    Lp, gp, mp = wf.trace_paths(scene, o, d, 3, pix, 1, depth,
                                with_metrics=True)
    same = gk == gp
    close = ((Lk - Lp).abs() <= 1e-4 + 1e-4 * Lp.abs()).all(dim=1)
    assert (same & close).double().mean().item() >= 0.999
    for key in ("rays", "shadow_rays"):
        assert int(mk[key]) == int(mp[key])


def test_k2_matches_plain_shade_on_prims_hits(cuda):
    """K2 on parity_prims' hit records (torus, box and disk fills with
    their Duff-tangent dpdu) of bounces 0, 1 and 4: floats within 1e-5,
    ints equal on >= 99.9% of lanes."""
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
                    agree = (got[key] == val).double().mean().item()
                    assert agree >= 0.999, (b, key)
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
