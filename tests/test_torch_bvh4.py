"""The plain BVH4 traversal (craytracer_tpu_torch/accel/bvh4.py, the plain
version of K3 and K4) against the JAX package: `bvh4_closest_hit` /
`bvh4_any_hit` (the XLA while-loop) and `pallas_bvh4_closest_hit` /
`pallas_bvh4_any_hit` in interpret mode, on the same fat table.

Inputs: the camera rays of scenes/parity_mesh.txt (32x32) and the rays
of tests/test_pallas_kernel.py:37-136 (an icosphere(2) scaled by 3, a
camera-like bundle and random rays, 500 each), each with 1% escape lanes
(origin 3e18, direction +x, as retired wavefront lanes arrive).

Bars: hit masks and triangle ids equal on >= 99.9% of lanes, t within
rtol 1e-5 where the ids agree, any-hit verdicts (t < max_dist) equal on
every lane. The JAX tests hold XLA and Pallas to rtol 1e-6; between the
packages the bar is 1e-5 because XLA's CPU backend contracts
multiply-adds into FMAs (45,909 of 100,000 seeded Moller-Trumbore t
values differ from op-by-op f32), while the port rounds every operation
on its own, as K3/K4 do with --fmad=false. Measured on these inputs:
ids and hit masks equal on every lane, t within 7.8e-7 relative on the
camera and bundle rays and 1.8e-6 on the random rays (2 of 72 hit lanes
above 1e-6); on 20,000 random rays through parity_mesh_mid, up to
5.4e-6. The ray_key sort is a pure
permutation: sorted and unsorted traversals agree bit for bit, and the
keys equal the JAX package's.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.accel import bvh4 as jb
from craytracer_tpu.accel.pallas_bvh4 import (pallas_bvh4_any_hit,
                                              pallas_bvh4_closest_hit)
from craytracer_tpu.ops.raysort import ray_key as j_ray_key
from craytracer_tpu_torch.accel.bvh4 import (build_bvh4, bvh4_any_hit,
                                             bvh4_closest_hit)
from craytracer_tpu_torch.camera import Film, generate_rays
from craytracer_tpu_torch.constants import TMAX
from craytracer_tpu_torch.interop import numpy_leaves
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.ops.raysort import ray_key, sorted_traversal
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter
from torch_jax_native import (  # noqa: F401
    SAH_WARNING_IS_ERROR, ensure_jax_native, jax_native)

torch.set_num_threads(2)
pytestmark = SAH_WARNING_IS_ERROR
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(REPO, "scenes", "parity_mesh.txt")


def _ico3():
    """The JAX tests' mesh: icosphere(2) scaled by 3, built by both
    packages with the port's settings (leaf 2, SAH)."""
    sys.path.insert(0, os.path.join(REPO, "scenes"))
    from make_fixtures import icosphere

    v, f = icosphere(2)
    tris = [(v[f[:, k]] * 3).astype(np.float32) for k in range(3)]
    return build_bvh4(*tris), jb.build_bvh4(*tris, leaf_size=2, split="sah")


def _escape(o, d):
    k = max(1, o.shape[0] // 100)
    o[:k] = 3.0e18
    d[:k] = (1.0, 0.0, 0.0)
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.fixture(scope="module", params=["mesh_camera", "ico_bundle",
                                        "ico_random"])
def case(request):
    kind = request.param
    if kind == "mesh_camera":
        scene, cam, film = load_scene_file(MESH, device="cpu")
        film = Film(fov=film.fov, width=32, height=32)
        pix = torch.arange(film.num_pixels, dtype=torch.int32)
        o, d = generate_rays(cam, film, pix, stratified_jitter(1, pix, 0))
        o, d = _escape(o.numpy().copy(), d.numpy().copy())
        return scene.tri_bvh, None, o, d
    ours, ref = _ico3()
    if kind == "ico_bundle":  # test_pallas_bvh4_traversal_matches_xla
        rng = np.random.default_rng(1)
        o = np.tile([[0.0, 0.5, 8.0]], (500, 1)).astype(np.float32)
        d = rng.normal(size=(500, 3)).astype(np.float32)
        d[:, 2] -= 1.5
    else:  # test_pallas_bvh4_push_modes_match_xla
        rng = np.random.default_rng(7)
        o = rng.uniform(-6, 6, (500, 3)).astype(np.float32)
        d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = _escape(o, d)
    return ours, ref, o, d


def _jax_bvh(ours, ref):
    if ref is not None:
        np.testing.assert_array_equal(np.asarray(ref.fat), ours.fat.numpy())
        assert ref.stack_size == ours.stack_size
        return ref
    leaves = numpy_leaves(ours)
    return jb.BVH4Arrays(fat=jnp.asarray(leaves["fat"]),
                         n_tris=ours.n_tris, leaf_size=ours.leaf_size,
                         stack_size=ours.stack_size)


def _check_closest(t, tri, t_ref, tri_ref):
    t_ref, tri_ref = np.asarray(t_ref), np.asarray(tri_ref)
    t, tri = t.numpy(), tri.numpy()
    assert ((t < TMAX) == (t_ref < TMAX)).mean() >= 0.999
    same = tri == tri_ref
    assert same.mean() >= 0.999
    hit = same & (t_ref < TMAX)
    assert hit.sum() > 50
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5)
    n_esc = max(1, t.shape[0] // 100)
    assert (t[:n_esc] == TMAX).all() and (tri[:n_esc] == -1).all()
    assert not np.isnan(t).any()


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_closest_hit_matches_jax(case, ref):
    ours, jref, o, d = case
    jbvh = _jax_bvh(ours, jref)
    t, tri = bvh4_closest_hit(ours, o, d)
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    if ref == "xla":
        out = jb.bvh4_closest_hit(jbvh, jo, jd)
    else:
        out = pallas_bvh4_closest_hit(jbvh, jo, jd, interpret=True)
    _check_closest(t, tri, *out)


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_any_hit_verdicts_match_jax(case, ref):
    ours, jref, o, d = case
    jbvh = _jax_bvh(ours, jref)
    rng = np.random.default_rng(2)
    md = rng.uniform(0.5, 20.0, o.shape[0]).astype(np.float32)
    md[::9] = 0.0  # lanes without a shadow ray
    jo, jd, jmd = (jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                   jnp.asarray(md))
    fn = jb.bvh4_any_hit if ref == "xla" else (
        lambda *a: pallas_bvh4_any_hit(*a, interpret=True))
    t_ref = np.asarray(fn(jbvh, jo, jd, jmd))
    t = bvh4_any_hit(ours, o, d, torch.from_numpy(md)).numpy()
    occ = t < md
    np.testing.assert_array_equal(occ, t_ref < md)
    assert occ.sum() > 20 and (~occ).sum() > 20


def test_sorted_traversal_is_a_pure_permutation(case):
    ours, _, o, d = case
    t, tri = bvh4_closest_hit(ours, o, d)
    ts, tris = sorted_traversal(lambda a, b: bvh4_closest_hit(ours, a, b),
                                o, d)
    assert torch.equal(t, ts) and torch.equal(tri, tris)
    key = ray_key(o, d)
    ref = np.asarray(j_ray_key(jnp.asarray(o.numpy()), jnp.asarray(d.numpy())))
    np.testing.assert_array_equal(key.numpy(), ref.astype(np.int64))
    assert not torch.equal(torch.argsort(key, stable=True),
                           torch.arange(o.shape[0]))


def test_nan_rays_miss():
    """A NaN ray misses (min/max propagate NaN), as K3/K4 return at once."""
    ours, _ = _ico3()
    o = torch.tensor([[float("nan"), 0.0, 8.0], [0.0, 0.5, 8.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, float("nan"), -1.0]])
    t, tri = bvh4_closest_hit(ours, o, d)
    assert (t == TMAX).all() and (tri == -1).all()
    ta = bvh4_any_hit(ours, o, d, torch.tensor([20.0, float("nan")]))
    assert (ta == TMAX).all()


def test_jax_native_recovers_after_a_failed_load(monkeypatch):
    """A worker that lost the build race is left with the JAX loader's
    `_TRIED` set and no library, and would build median trees from then
    on; ensure_jax_native reloads it, and the SAH build then matches the
    port's table (no median-fallback warning, which this module makes an
    error)."""
    from craytracer_tpu import native as jn

    monkeypatch.setattr(jn, "_LIB", None)
    monkeypatch.setattr(jn, "_TRIED", True)
    assert jn._load() is None
    lib = ensure_jax_native()
    assert lib is not None and jn._load() is lib
    ours, ref = _ico3()
    np.testing.assert_array_equal(np.asarray(ref.fat), ours.fat.numpy())
