"""Spheres in the port's plain intersection (craytracer_tpu_torch/core/
solvers.py `solve_quadratic`, ops/intersect.py `sphere_ts`,
`_fill_sphere`, `intersect_scene`, `shadow_distance`) against the JAX
package (core/solvers.py:21, ops/intersect.py:61-99, :325-344, :518,
:685) on the same seeded rays: full spheres, clipped ones (phi 2.0 and
theta 0.5-2.5, as tests/test_pallas_shade.py:89-90, and a narrow band),
a rect in front of them (the group tie-break), random rays from inside
and outside, rays through the poles (|cos| near 1, the unclamped-acos
rejection) and escape lanes.

Bars: t and the quadratic's roots to rtol 1e-5 (XLA:CPU contracts the
multiply-adds of the quadratic and the hit point into FMAs, as in the
BVH4 traversal tests); group, prim and mat_id exact; point, normal, dpdu
and uv to 1e-4 (the Newton step and the normalization amplify those ulps
near grazing hits)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.core.solvers import solve_quadratic as j_solve
from craytracer_tpu.ops.intersect import intersect_scene as j_intersect
from craytracer_tpu.ops.intersect import shadow_distance as j_shadow
from craytracer_tpu.ops.intersect import sphere_ts as j_sphere_ts
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.core.solvers import solve_quadratic
from craytracer_tpu_torch.ops.intersect import (intersect_scene,
                                                shadow_distance, sphere_ts)
from craytracer_tpu_torch.scene.build import SceneBuilder

torch.set_num_threads(2)
SPHERES = [((0.0, 1.0, 0.0), 1.0, {}),
           ((2.5, 0.6, -0.5), 0.6, {"phi": 2.0, "min_theta": 0.5,
                                     "max_theta": 2.5}),
           ((-2.2, 0.8, 0.4), 0.8, {"phi": 1.0, "min_theta": 1.2,
                                     "max_theta": 1.9}),
           ((0.3, 2.6, 1.0), 0.35, {})]


def _build(b):
    b.add_matte("a", (0.5, 0.5, 0.5))
    b.add_matte("b", (0.2, 0.6, 0.2))
    for i, (c, r, clip) in enumerate(SPHERES):
        b.add_sphere(c, r, "ab"[i % 2], **clip)
    b.add_rect((-4, 0, 1.5), (8, 0, 0), (0, 3, 0), "b")
    b.add_rect((-4, -0.01, -4), (8, 0, 0), (0, 0, 8), "a")
    return b


@pytest.fixture(scope="module")
def scenes():
    return _build(JBuilder()).build(), _build(SceneBuilder()).build(
        device="cpu")


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(17)
    n = 4096
    o = rng.uniform(-4.0, 4.0, (n, 3))
    o[:, 1] = rng.uniform(-0.5, 4.0, n)
    # aim half of them at a sphere's surface
    tgt = np.array([s[0] for s in SPHERES])[rng.integers(0, 4, n)]
    d = np.where(rng.random((n, 1)) < 0.5, tgt - o, rng.normal(size=(n, 3)))
    # rays through the poles: from above or below a sphere, nearly axial
    pole = []
    for c, r, _ in SPHERES:
        for sgn in (1.0, -1.0):
            off = rng.normal(scale=1e-4, size=(64, 3))
            po = np.asarray(c) + np.array([0.0, sgn * 3.0 * r, 0.0]) + off
            pd = np.array([0.0, -sgn, 0.0]) + rng.normal(scale=1e-5,
                                                       size=(64, 3))
            pole.append((po, pd))
    o = np.concatenate([o] + [p for p, _ in pole])
    d = np.concatenate([d] + [q for _, q in pole])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[:32] = 3.0e18  # escape lanes
    d[:32] = (1.0, 0.0, 0.0)
    return o.astype(np.float32), d.astype(np.float32)


def test_solve_quadratic():
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 2.0, 8192).astype(np.float32)
    b = rng.uniform(-10, 10, 8192).astype(np.float32)
    c = rng.uniform(-10, 10, 8192).astype(np.float32)
    a[:64] = 0.0  # the linear lanes
    b[:8] = 0.0
    ok, t0, t1 = solve_quadratic(*(torch.from_numpy(x) for x in (a, b, c)))
    jok, jt0, jt1 = j_solve(*(jnp.asarray(x) for x in (a, b, c)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    for ours, ref in ((t0, jt0), (t1, jt1)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5)
    assert bool(ok.any()) and bool((~ok).any())


def test_sphere_ts(scenes, rays):
    js, ts = scenes
    o, d = rays
    ours = sphere_ts(torch.from_numpy(o), torch.from_numpy(d), ts.spheres)
    ref = np.asarray(j_sphere_ts(jnp.asarray(o), jnp.asarray(d), js.spheres))
    hit = ref < 3e38
    np.testing.assert_array_equal(ours.numpy() < 3e38, hit)
    np.testing.assert_allclose(ours.numpy()[hit], ref[hit], rtol=1e-5)
    assert hit[:, 1:3].any() and (~hit[:, 1:3]).any()


def test_intersect_scene_hit_fields(scenes, rays):
    js, ts = scenes
    o, d = rays
    ours = intersect_scene(ts, torch.from_numpy(o), torch.from_numpy(d))
    ref = j_intersect(js, jnp.asarray(o), jnp.asarray(d))
    for key in ("group", "prim", "mat_id"):
        np.testing.assert_array_equal(getattr(ours, key).numpy(),
                                      np.asarray(getattr(ref, key)),
                                      err_msg=key)
    np.testing.assert_allclose(ours.t.numpy(), np.asarray(ref.t), rtol=1e-5)
    for key in ("point", "normal", "dpdu", "uv"):
        np.testing.assert_allclose(getattr(ours, key).numpy(),
                                   np.asarray(getattr(ref, key)), rtol=1e-4,
                                   atol=1e-4, err_msg=key)
    groups = ours.group.numpy()
    assert (groups == 0).sum() > 1000 and (groups == 2).any()
    assert (groups == -1).any()
    # every sphere is hit, the clipped ones through their window
    assert set(ours.prim.numpy()[groups == 0]) == {0, 1, 2, 3}


def test_shadow_distance_with_spheres(scenes, rays):
    js, ts = scenes
    o, d = rays
    ours = shadow_distance(ts, torch.from_numpy(o), torch.from_numpy(d))
    ref = np.asarray(j_shadow(js, jnp.asarray(o), jnp.asarray(d)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5)
    assert (ref < 3e38).any() and (ref >= 3e38).any()
