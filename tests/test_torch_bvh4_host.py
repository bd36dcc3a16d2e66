"""K2's, K3's, K3 `_init`'s, K4's, K5's and K6's CUDA sources, built for the
CPU, against their plain PyTorch versions.

As tests/test_torch_k1_host.py does for K1: csrc/shade_kernel.cu,
csrc/bvh4_traverse.cu, csrc/bvh4_split.cu, csrc/tri_closest.cu and
csrc/pop_probe.cu are compiled with the host C++ compiler against the
stub `cuda_runtime.h` of tests/torch_cuda_host.py (each block's threads
run as threads, with the block's shared memory, block and warp barriers,
and the warp votes and shuffles), and their C entry points are called
through ctypes on CPU tensors. Built with -ffp-contract=off, as the card
build uses --fmad=false.

Bars, on scenes/parity_mesh.txt (320 triangles, 90 fat rows): K3's t and
triangle ids and K4's t equal the plain traversal's on every lane
(camera rays, the rays of bounces 1 and 3 of a plain pass, seeded random
rays with 1% escape lanes; and seeded rays through a soup of 3,000
random triangles, where an any hit's first occluder is often not the
closest, so K4's t checks its visit order: dropping K4's early exit
fails it), in both forms of the kernel: the stub device's L2 (50 MB)
holds these tables, and a build whose L2 holds none takes the form for
tables past the L2. Both forms also carry the route's chains across the
soup's parts bit for bit: K3 `_init` part after part with the best hit
carried, K4 part after part with max_dist 0 on the lanes an earlier part
occluded. Every table build_bvh4 and partition_bvh4 make keeps its
internal children's slots empty (the kernels skip them), and
check_leaf_slots raises on a doctored row. K2's mask-0 build
(tests/torch_k2_host.py): its float outputs within 1e-5 (absolute +
relative) of
fused_shade_reference and its int outputs equal on every lane, at
bounces 0, 2 and 5 with per-lane spp (the host libm's sinf/cosf may
differ from torch's by an ulp). Measured: every K3/K4 lane bit-equal.
K3 `_init` and K5 (with and without a carried hit: half the lanes carry
t at half their closest hit with id 7777, as tests/test_pallas_kernel.py
:167-175 does) on the same rays and on every part of the soup's table cut
at a fifth of its bytes (the top part's cut children -1), and K6 on
random triangles with a duplicated block (exact-t ties): t and ids equal
the plain versions' on every lane; the blocks stage their shared memory
together (K5's top topology rows, K6's triangle tiles). P1 (the packet
of a warp: its stack filled by its lanes, shuffle minima and votes) in
all 7 modes on the inputs of tests/test_torch_pop_probe.py: t and sink
equal the plain version's on every lane.

Skips when no C++ compiler is on the PATH."""

import os

import numpy as np
import pytest
import torch

from craytracer_tpu_torch.accel.bvh4 import (build_bvh4, bvh4_any_hit,
                                             bvh4_closest_hit,
                                             bvh4_closest_hit_init,
                                             check_leaf_slots)
from craytracer_tpu_torch.accel.bvh4_parts import partition_bvh4
from craytracer_tpu_torch.accel.bvh4_split_kernel import split_topology
from craytracer_tpu_torch.camera import Film, generate_rays
from craytracer_tpu_torch.constants import TMAX
from craytracer_tpu_torch.integrator import shade_kernel as sk
from craytracer_tpu_torch.integrator.wavefront import _bounce_step, _init_state
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.ops.intersect import intersect_scene
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter

from torch_cuda_host import host_build
from torch_k2_host import check_k2, k2_lib, run_k2

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(REPO, "scenes", "parity_mesh.txt")
SEED = 5


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    trav = host_build(tmp_path_factory, "bvh4_traverse", 2)
    from craytracer_tpu_torch.accel.bvh4_kernel import _bind

    _bind(trav)
    return trav, k2_lib(tmp_path_factory, 0)


@pytest.fixture(scope="module")
def past_l2_lib(tmp_path_factory):
    """bvh4_traverse.cu built against a device whose L2 holds no table, so
    every launch takes the form for tables past the L2 (the next pop's row
    prefetched; a no-op on the host, whose walk is the same code)."""
    from craytracer_tpu_torch.accel.bvh4_kernel import _bind

    lib = host_build(tmp_path_factory, "bvh4_traverse", 2, l2_bytes=0)
    _bind(lib)
    return lib


def _launch_k3(lib, bvh, o, d, t0=None, tri0=None):
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32)
    tri = torch.empty(n, dtype=torch.int32)
    head = (bvh.fat.data_ptr(), bvh.fat.shape[0], bvh.stack_size,
            o.data_ptr(), d.data_ptr())
    if t0 is None:
        err = lib.k3_closest_launch(*head, n, t.data_ptr(),
                                    tri.data_ptr(), None)
    else:
        err = lib.k3_closest_init_launch(*head, t0.data_ptr(),
                                         tri0.data_ptr(), n,
                                         t.data_ptr(), tri.data_ptr(), None)
    assert err == 0
    return t, tri


def _launch_k4(lib, bvh, o, d, md):
    t = torch.empty(o.shape[0], dtype=torch.float32)
    assert lib.k4_any_launch(
        bvh.fat.data_ptr(), bvh.fat.shape[0], bvh.stack_size, o.data_ptr(),
        d.data_ptr(), md.data_ptr(), o.shape[0], t.data_ptr(),
        None) == 0
    return t


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


def _any_md(t_ref):
    """max_dist around the closest hit: occluded and clear lanes, zero
    max_dist lanes (no shadow ray) and far max_dist lanes (where the visit
    order decides which occluder is found)."""
    n = t_ref.shape[0]
    hit = t_ref < 3e38
    md = torch.where(hit, t_ref * torch.linspace(0.5, 1.5, n), 5.0)
    md[1::3] = 1e30
    md[::7] = 0.0
    return md


@pytest.mark.parametrize("l2", ["fits", "past"])
@pytest.mark.parametrize("kind", ["camera", "bounce1", "bounce3", "random",
                                  "soup"])
def test_k3_k4_sources_match_plain_traversal(host_libs, past_l2_lib, mesh,
                                             kind, l2):
    trav = host_libs[0] if l2 == "fits" else past_l2_lib
    scene, cam, film = mesh
    if kind == "soup":
        bvh, o, d = _soup()
    else:
        bvh = scene.tri_bvh
        o, d = _rays(scene, cam, film, kind)
    t, tri = _launch_k3(trav, bvh, o, d)
    t_ref, tri_ref = bvh4_closest_hit(bvh, o, d)
    assert torch.equal(tri, tri_ref) and torch.equal(t, t_ref)
    hit = t_ref < 3e38
    assert hit.any() and (~hit).any()

    md = _any_md(t_ref)
    ta = _launch_k4(trav, bvh, o, d, md)
    ta_ref = bvh4_any_hit(bvh, o, d, md)
    assert torch.equal(ta, ta_ref)
    assert (ta_ref < md).any() and (ta_ref >= md).any()


@pytest.mark.parametrize("l2", ["fits", "past"])
def test_k3_init_k4_sources_across_the_soups_parts(host_libs, past_l2_lib,
                                                   l2):
    """The route's chains over the soup's parts (its table cut at a fifth
    of its bytes): K3 `_init` part after part with the best hit of the
    parts before carried in, K4 part after part with max_dist 0 on the
    lanes an earlier part occluded (and on every seventh lane from the
    start); each launch bit-equal with the plain version on every lane."""
    trav = host_libs[0] if l2 == "fits" else past_l2_lib
    bvh, o, d = _soup()
    parts = partition_bvh4(bvh, bvh.fat.numel() * 4 // 5)
    assert len(parts) >= 3
    n = o.shape[0]
    t = torch.full((n,), TMAX)
    tri = torch.full((n,), -1, dtype=torch.int32)
    replaced = 0
    for p in parts:
        got = _launch_k3(trav, p, o, d, t, tri)
        want = bvh4_closest_hit_init(p, o, d, t, tri)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        replaced += int((want[1] != tri).sum())
        t, tri = want
    assert replaced > n // 4 and torch.equal(t, bvh4_closest_hit(bvh, o, d)[0])

    md0 = _any_md(t)
    best = torch.full((n,), TMAX)
    md, occluded = md0, []
    for p in parts:
        got = _launch_k4(trav, p, o, d, md)
        want = bvh4_any_hit(p, o, d, md)
        assert torch.equal(got, want)
        best = torch.minimum(best, want)
        occluded.append(int((best < md0).sum()))
        md = torch.where(best < md0, 0.0, md0)
    assert 0 < occluded[-2] and occluded[1] < occluded[-1]
    assert torch.equal(best < md0, bvh4_any_hit(bvh, o, d, md0) < md0)


def test_every_table_keeps_internal_children_slots_empty(mesh):
    """K3, K3 `_init`, K4 and K5 skip internal children's slots, and past
    the L2 empty children's: every table build_bvh4 and partition_bvh4
    make holds no triangle in such a child's slots (parity_mesh, the soup,
    the soup's parts), and check_leaf_slots raises on a row that does."""
    scene, _, _ = mesh
    soup, _, _ = _soup()
    tables = [scene.tri_bvh, soup, *partition_bvh4(
        soup, soup.fat.numel() * 4 // 5)]
    for b in tables:
        check_leaf_slots(b.fat.numpy())
    fat = torch.cat([b.fat for b in tables])
    internal = fat[:, 24:28] >= 0
    ids = fat[:, 28:108].reshape(-1, 4, 2, 10)[..., 9]
    assert internal.any() and (ids >= 0).any()
    assert not (internal[:, :, None] & (ids >= 0)).any()
    empty = fat[:, 0:12:3] > fat[:, 12:24:3]
    assert empty.any() and not (empty[:, :, None] & (ids >= 0)).any()
    fat = soup.fat.numpy().copy()
    row, c = np.argwhere(fat[:, 24:28] >= 0)[0]
    fat[row, 28 + 20 * c + 19] = 5.0  # a triangle id in slot 1
    with pytest.raises(ValueError, match=f"fat row {row}: internal child"):
        check_leaf_slots(fat)
    fat = soup.fat.numpy().copy()
    empty = fat[:, 0:12:3] > fat[:, 12:24:3]
    assert empty.any()
    row, c = np.argwhere(empty)[0]
    fat[row, 28 + 20 * c + 9] = 5.0  # a triangle id in slot 0
    with pytest.raises(ValueError, match=f"fat row {row}: empty child"):
        check_leaf_slots(fat)


@pytest.mark.parametrize("bounce", [0, 2, 5])
def test_k2_source_matches_plain_shade(host_libs, mesh, bounce):
    _, shade = host_libs
    scene, cam, film = mesh
    state, hit, spp = _pass_records(scene, cam, film, (bounce,))[bounce]
    o, d, beta, _, _, alive, prev_sg, _, _, _, pix = state
    args = (scene, d, hit, beta, alive, prev_sg, pix, spp, SEED, bounce, 5)
    check_k2(run_k2(shade, *args), sk.fused_shade_reference(*args))
    assert bool(alive.any())


@pytest.fixture(scope="module")
def split_libs(tmp_path_factory):
    from craytracer_tpu_torch.accel import bvh4_split_kernel
    from craytracer_tpu_torch.ops import tri_kernel

    split = host_build(tmp_path_factory, "bvh4_split", 2)
    bvh4_split_kernel._bind(split)
    tri = host_build(tmp_path_factory, "tri_closest", 1)
    tri_kernel._bind(tri)
    return split, tri


def _carried(t_ref, tri_ref):
    """Half the lanes carry a hit at half their closest t (id 7777), the
    rest TMAX / -1 (tests/test_pallas_kernel.py:167-175)."""
    n = t_ref.shape[0]
    even = torch.arange(n) % 2 == 0
    t0 = torch.where(even & (t_ref < TMAX), t_ref * 0.5,
                     torch.full_like(t_ref, TMAX))
    tri0 = torch.where(t0 < TMAX, 7777, -1).to(torch.int32)
    return t0, tri0


@pytest.mark.parametrize("kind", ["camera", "bounce1", "random", "soup",
                                  "soup_parts"])
def test_k3_init_k5_sources_match_plain_traversal(host_libs, split_libs, mesh,
                                                  kind):
    trav, _ = host_libs
    split, _ = split_libs
    scene, cam, film = mesh
    if kind.startswith("soup"):
        bvh, o, d = _soup()
    else:
        bvh = scene.tri_bvh
        o, d = _rays(scene, cam, film, kind)
    tables = ([bvh] if kind != "soup_parts"
              else partition_bvh4(bvh, bvh.fat.numel() * 4 // 5))
    assert len(tables) >= (3 if kind == "soup_parts" else 1)
    n = o.shape[0]
    assert (bvh4_closest_hit(bvh, o, d)[0] < TMAX).sum() > 50
    for part in tables:
        t_ref, tri_ref = bvh4_closest_hit(part, o, d)
        t0, tri0 = _carried(t_ref, tri_ref)
        ref_init = bvh4_closest_hit_init(part, o, d, t0, tri0)
        if (t_ref < TMAX).any():  # the carried hits win somewhere
            assert not torch.equal(ref_init[1], tri_ref)
        topo = split_topology(part)
        m, s = part.fat.shape[0], part.stack_size
        for carry in (False, True):
            want = ref_init if carry else (t_ref, tri_ref)
            for lib in ("k3_init", "k5"):
                if lib == "k3_init" and not carry:
                    continue
                t = torch.empty(n, dtype=torch.float32)
                tri = torch.empty(n, dtype=torch.int32)
                c = ((t0.data_ptr(), tri0.data_ptr()) if carry
                     else (None, None))
                if lib == "k3_init":
                    err = trav.k3_closest_init_launch(
                        part.fat.data_ptr(), m, s, o.data_ptr(), d.data_ptr(),
                        *c, n, t.data_ptr(), tri.data_ptr(), None)
                else:
                    err = split.k5_split_launch(
                        topo.data_ptr(), part.fat.data_ptr(), m, s,
                        o.data_ptr(), d.data_ptr(), *c, n, t.data_ptr(),
                        tri.data_ptr(), None)
                assert err == 0
                assert torch.equal(t, want[0]), (lib, carry)
                assert torch.equal(tri, want[1]), (lib, carry)


def test_k6_source_matches_plain_triangle_closest(split_libs):
    from craytracer_tpu_torch.ops.tri_kernel import (pack_triangles,
                                                     triangle_closest)

    _, tri = split_libs
    rng = np.random.default_rng(4)
    base = rng.uniform(-10, 10, (300, 3))
    v = [base + rng.normal(0, 1, (300, 3)) for _ in range(3)]
    v = [np.concatenate([x, x[:40]]) for x in v]  # exact-t ties
    soa = pack_triangles(*v)
    o = torch.from_numpy(rng.uniform(-15, 15, (700, 3)).astype(np.float32))
    d = rng.normal(size=(700, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True))
                         .astype(np.float32))
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32)
    idx = torch.empty(n, dtype=torch.int32)
    assert tri.k6_tri_launch(o.data_ptr(), d.data_ptr(), n, soa.data_ptr(),
                             soa.shape[1], t.data_ptr(), idx.data_ptr(),
                             None) == 0
    t_ref, idx_ref = triangle_closest(o, d, soa)
    assert torch.equal(t, t_ref) and torch.equal(idx, idx_ref)
    assert (idx_ref >= 0).sum() > 50 and (idx_ref < 40).any()


def test_p1_source_matches_plain_probe(tmp_path_factory):
    """P1 in every mode against `pop_probe`, on test_torch_pop_probe.py's
    inputs: an icosphere(2) scaled by 3, three packets of rays aimed at
    it, 64 pops of the LCG stack."""
    from craytracer_tpu_torch.profiling import pop_probe as pp
    from craytracer_tpu_torch.scene.city import icosphere

    p1 = host_build(tmp_path_factory, "pop_probe", 1)
    pp._bind(p1)
    v, f = icosphere(2)
    fat = build_bvh4(*(v[f[:, k]] * 3 for k in range(3))).fat
    rng = np.random.default_rng(1)
    n = 3 * pp.PACKET
    o = np.tile([[0.0, 0.5, 8.0]], (n, 1)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] -= 1.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    for mode in pp.MODES:
        t = torch.empty(n, dtype=torch.float32)
        sink = torch.empty(n, dtype=torch.int32)
        assert p1.p1_launch(fat.data_ptr(), fat.shape[0], o.data_ptr(),
                            d.data_ptr(), n, 64, pp.MODES.index(mode),
                            t.data_ptr(), sink.data_ptr(), None) == 0
        t_ref, sink_ref = pp.pop_probe(fat, o, d, mode, 64)
        assert torch.equal(t, t_ref) and torch.equal(sink, sink_ref), mode
        if mode in ("box", "full"):
            assert (sink != 0).all()
        if mode in ("mt", "full"):
            assert (t < 1e30).sum() > 8  # triangles were hit
