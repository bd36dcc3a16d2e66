"""The sphere BVH4 (craytracer_tpu_torch/accel/bvh4_sphere.py) against the
JAX package's (craytracer_tpu/accel/bvh4_sphere.py).

- The fat rows and stack bound bit-equal with `build_bvh4_spheres` at
  leaf size 2: on the 600-sphere scene of tests/test_accel.py:192-226
  through both builders, on bench_spheres.py's 2,000-sphere field (the
  JAX `build_scene(2000, "bvh4")` against the port's `sphere_field`), on
  seeded clipped spheres and on a one-leaf table.
- Closest-hit t and sphere ids and the any-hit t per lane on 4,096 seeded
  rays, against `bvh4s_closest_hit` / `bvh4s_any_hit`: ids and the
  occluded mask equal on every lane, t within 5e-6 on 95% of the hitting
  lanes and 5e-5 on all. XLA:CPU contracts the discriminant b*b - 4c
  into a multiply-add; on a grazing hit it cancels and the root's
  relative error grows as b^2/disc (measured up to 2.4e-5 where
  disc/b^2 ~ 1e-5), which the port, one op at a time, does not share.
- The counterpart of test_sphere_bvh_matches_brute_force: the port's
  image through the table equals its brute-force image at the JAX test's
  bar on every lane but BRUTE_EXCUSED, whose camera ray grazes a sphere's
  pole: there the reference's unclamped-acos rejection (|cos| > 1,
  sphere.cpp:57) is f32 luck (ops/intersect.py:86-90 in the JAX
  package), and `sphere_ts` forms the hit point from world coordinates
  (cos 1.00017: rejected, the far root wins) where the traversal forms it
  from o - c (cos 0.99995: the near root).
- The slice as a whole: the port's `trace_paths` ("shade" route, and the
  general step) against the JAX XLA `trace_paths` on the 600-sphere scene
  at 24x24 x 2 spp, depth 0, 2, 5: `good`, the ray and shadow-ray counts
  and the live histogram equal, L within 2e-5 (rtol and atol) but on the
  EXCUSED lanes, where a grazing sphere hit moves the path: there JAX's
  own fori program and its unrolled step differ from each other by up
  to 4.4e-4, and the port is held within 1e-3 (rtol and atol) of the
  fori program (measured 4.6e-4).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.accel import bvh4_sphere as jbs
from craytracer_tpu.camera import Film as JFilm
from craytracer_tpu.camera import make_camera as j_make_camera
from craytracer_tpu.integrator.wavefront import trace_paths as j_trace
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.accel import bvh4_sphere as tbs
from craytracer_tpu_torch.camera import Film, make_camera
from craytracer_tpu_torch.integrator.gate import production_fast_shade
from craytracer_tpu_torch.integrator.wavefront import (render_sample,
                                                       trace_paths)
from craytracer_tpu_torch.scene.build import SceneBuilder
from craytracer_tpu_torch.scene.sphere_field import (sphere_field,
                                                     sphere_field_view)
from torch_general_check import BAR, SEED, jax_rays
from torch_jax_native import jax_native  # noqa: F401

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# lanes of the 24x24 x 2 spp pass where a grazing sphere hit moves the
# path past the bar (measured on an x86 CPU)
EXCUSED = {2: (885,), 5: (279, 301, 369, 451, 808, 847, 848, 854, 875,
                          879, 885, 939)}
EXCUSED_BAR = dict(rtol=1e-3, atol=1e-3)
BRUTE_EXCUSED = (209,)


def _scene600(builder, accel, **kw):
    """tests/test_accel.py:200-211's 600 random spheres over a floor."""
    rng = np.random.default_rng(5)
    b = builder()
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_emissive("l", (1, 1, 1), 30.0)
    b.add_rect((-40, 0, -40), (80, 0, 0), (0, 0, 80), "w")
    b.add_rect((-4, 30, -4), (8, 0, 0), (0, 0, 8), "l")
    for _ in range(600):
        c = rng.uniform(-20, 20, 3)
        c[1] = rng.uniform(0.5, 6.0)
        b.add_sphere(tuple(c), rng.uniform(0.3, 0.9), "w")
    return b.build(accel=accel, **kw)


def _clipped(n, seed=3):
    """n seeded spheres (f32 arrays as a scene holds them), clipped in phi
    and theta."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.uniform(-15, 15, (n, 3)).astype(f32),
            rng.uniform(0.3, 1.5, n).astype(f32),
            rng.uniform(0.5, np.pi, n).astype(f32),
            rng.uniform(0.0, 1.0, n).astype(f32),
            rng.uniform(2.0, np.pi, n).astype(f32))


def _bench_field(n):
    sys.path.insert(0, REPO)
    try:
        import bench_spheres
    finally:
        sys.path.remove(REPO)
    return bench_spheres.build_scene(n, "bvh4")


def _tables(name):
    """(JAX SphereBVH4, port SphereBVH4)."""
    if name == "scene600":
        return (_scene600(JBuilder, "bvh4").sph_bvh,
                _scene600(SceneBuilder, "bvh4", device="cpu").sph_bvh)
    if name == "field2000":
        return _bench_field(2000).sph_bvh, sphere_field(
            2000, device="cpu").sph_bvh
    arrays = _clipped(300 if name == "clipped" else 2)
    return (jbs.build_bvh4_spheres(*arrays, leaf_size=2),
            tbs.build_bvh4_spheres(*arrays))


@pytest.mark.parametrize("name", ["scene600", "field2000", "clipped",
                                  "one leaf"])
def test_fat_rows_bit_equal(name):
    jt, tt = _tables(name)
    assert tt.leaf_size == jt.leaf_size == 2
    assert (tt.n_prims, tt.stack_size) == (jt.n_prims, jt.stack_size)
    assert tt.fat.shape[1] == 128
    np.testing.assert_array_equal(tt.fat.numpy(), np.asarray(jt.fat))


def _rays(n=4096, seed=11):
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-25, 25, n), rng.uniform(0.2, 12, n),
                  rng.uniform(-25, 25, n)], axis=1).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, rng.uniform(0.5, 30.0, n).astype(np.float32)


def _hold_t(t, ref, hit):
    rel = np.abs(t - ref)[hit] / np.abs(ref[hit])
    assert np.quantile(rel, 0.95) <= 5e-6 and rel.max() <= 5e-5, (
        np.quantile(rel, 0.95), rel.max())


@pytest.mark.parametrize("name", ["scene600", "clipped"])
def test_traversal_matches_jax(name):
    jt, tt = _tables(name)
    o, d, md = _rays()
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    t, sid = tbs.bvh4s_closest_hit(tt, torch.from_numpy(o),
                                   torch.from_numpy(d))
    rt, rid = (np.asarray(x) for x in jbs.bvh4s_closest_hit(jt, jo, jd))
    np.testing.assert_array_equal(sid.numpy(), rid)
    hit = rid >= 0
    assert hit.mean() > 0.05
    _hold_t(t.numpy(), rt, hit)
    ta = tbs.bvh4s_any_hit(tt, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(md)).numpy()
    ra = np.asarray(jbs.bvh4s_any_hit(jt, jo, jd, jnp.asarray(md)))
    occluded = ra < md
    np.testing.assert_array_equal(ta < md, occluded)
    assert occluded.mean() > 0.02
    _hold_t(ta, ra, occluded)


def test_sphere_bvh_matches_brute_force():
    """tests/test_accel.py:192-226 through the port: the 600-sphere image
    through the sphere BVH4 equals the brute-force one."""
    s_acc = _scene600(SceneBuilder, "bvh4", device="cpu")
    s_brt = _scene600(SceneBuilder, "none", device="cpu")
    assert s_acc.sph_bvh is not None and s_brt.sph_bvh is None
    cam = make_camera((0, 18, 45), (0, 2, 0))
    film = Film(fov=torch.tensor(np.radians(45.0), dtype=torch.float32),
                width=24, height=24)
    assert production_fast_shade(s_acc, cam, film) == "shade"
    ids = torch.arange(film.width * film.height, dtype=torch.int32)
    img_a = render_sample(s_acc, cam, film, ids, 3, 0, 3, "physical").numpy()
    img_b = render_sample(s_brt, cam, film, ids, 3, 0, 3, "physical").numpy()
    keep = np.ones(img_a.shape[0], bool)
    keep[list(BRUTE_EXCUSED)] = False
    np.testing.assert_allclose(img_a[keep], img_b[keep], rtol=2e-4,
                               atol=2e-4)
    assert img_a.mean() > 0.01


@pytest.fixture(scope="module")
def slice600():
    js = _scene600(JBuilder, "bvh4")
    ts = _scene600(SceneBuilder, "bvh4", device="cpu")
    rays = jax_rays(j_make_camera((0, 18, 45), (0, 2, 0)),
                    JFilm(fov=jnp.float32(np.radians(45.0)), width=24,
                          height=24))
    return js, ts, rays, {}


@pytest.mark.parametrize("route", ["shade", "general"])
@pytest.mark.parametrize("depth", [0, 2, 5])
def test_slice_matches_jax(slice600, depth, route):
    js, ts, (o, d, pix, spp), refs = slice600
    if depth not in refs:
        refs[depth] = j_trace(js, jnp.asarray(o), jnp.asarray(d), SEED,
                              jnp.asarray(pix), jnp.asarray(spp), depth,
                              with_metrics=True, fast_shade=False)
    Lr, gr, mr = refs[depth]
    L, good, m = trace_paths(ts, torch.from_numpy(o), torch.from_numpy(d),
                             SEED, torch.from_numpy(pix),
                             torch.from_numpy(spp), depth, with_metrics=True,
                             general=route == "general")
    np.testing.assert_array_equal(good.numpy(), np.asarray(gr))
    assert int(m["rays"]) == int(mr["rays"])
    assert int(m["shadow_rays"]) == int(mr["shadow_rays"])
    np.testing.assert_array_equal(m["bounce_live"].numpy(),
                                  np.asarray(mr["bounce_live"]))
    L, Lr = L.numpy(), np.asarray(Lr)
    keep = np.ones(L.shape[0], bool)
    keep[list(EXCUSED.get(depth, ()))] = False
    np.testing.assert_allclose(L[keep], Lr[keep], **BAR)
    np.testing.assert_allclose(L[~keep], Lr[~keep], **EXCUSED_BAR)
    assert depth == 0 or (L.mean() > 0.05 and int(m["shadow_rays"]) > 0)


def test_sphere_field_view_and_route():
    """The 2,000-sphere field takes the "shade" route from its default
    build, with bench_spheres.py's camera."""
    scene = sphere_field(2000, device="cpu")
    cam, film = sphere_field_view(2000, 16, device="cpu")
    assert scene.accel == "none" and scene.sph_bvh is not None
    assert production_fast_shade(scene, cam, film) == "shade"
    np.testing.assert_array_equal(
        cam.position.numpy(), np.float32([0, 40, 2.0 * 2000 ** 0.5 + 30]))
    L = render_sample(scene, cam, film,
                      torch.arange(256, dtype=torch.int32), 0, 0, 3)
    assert bool(torch.isfinite(L).all()) and float(L.mean()) > 0.0
