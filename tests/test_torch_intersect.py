"""Brute-force intersection (craytracer_tpu_torch/ops/intersect.py) against
the JAX package's intersect_scene and shadow_distance on parity_cornell:
camera rays and seeded random rays. hit_mask and mat_id must be exact;
t, point, normal and dpdu agree to 1e-5."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.ops.intersect import intersect_scene as j_intersect
from craytracer_tpu.ops.intersect import shadow_distance as j_shadow
from craytracer_tpu_torch.camera import Film, generate_rays
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.ops.intersect import intersect_scene, shadow_distance
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "parity_cornell.txt")


@pytest.fixture(scope="module")
def scenes():
    js, _, _ = j_load(CORNELL)
    ts, tc, tf = load_scene_file(CORNELL, device="cpu")
    return js, ts, tc, tf


def _camera_rays(tc, tf, size=48):
    film = Film(fov=tf.fov, width=size, height=size)
    pix = torch.arange(size * size, dtype=torch.int32)
    return generate_rays(tc, film, pix, stratified_jitter(1, pix, 2))


def _random_rays(seed, n=20_000):
    r = np.random.default_rng(seed)
    # origins inside and around the unit box, directions uniform
    o = r.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    o[:, 2] = -o[:, 2]
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _rays(kind, tc, tf):
    return _camera_rays(tc, tf) if kind == "camera" else _random_rays(
        int(kind[-1]))


@pytest.mark.parametrize("kind", ["camera", "random0", "random1"])
def test_intersect_scene_matches_jax(scenes, kind):
    js, ts, tc, tf = scenes
    o, d = _rays(kind, tc, tf)
    ref = j_intersect(js, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
    hit = intersect_scene(ts, o, d)
    np.testing.assert_array_equal(hit.hit_mask.numpy(),
                                  np.asarray(ref.hit_mask))
    np.testing.assert_array_equal(hit.mat_id.numpy(), np.asarray(ref.mat_id))
    np.testing.assert_array_equal(hit.group.numpy(), np.asarray(ref.group))
    np.testing.assert_array_equal(hit.prim.numpy(), np.asarray(ref.prim))
    m = hit.hit_mask.numpy()
    assert m.mean() > 0.3  # the rays really hit the box
    for name in ("point", "normal", "dpdu"):
        np.testing.assert_allclose(getattr(hit, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(hit.t.numpy()[m], np.asarray(ref.t)[m],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["camera", "random2"])
def test_shadow_distance_matches_jax(scenes, kind):
    js, ts, tc, tf = scenes
    o, d = _rays(kind, tc, tf)
    ref = np.asarray(j_shadow(js, jnp.asarray(o.numpy()),
                              jnp.asarray(d.numpy())))
    got = shadow_distance(ts, o, d).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
