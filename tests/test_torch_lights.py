"""The general route's light sampling (craytracer_tpu_torch/lights/
lights.py) against the JAX package's lights/lights.py, and the delta
lights' tables (scene/build.py `add_point_light` and
`add_directional_light`, io/scenefile.py's POINT_LIGHT and
DIRECTIONAL_LIGHT blocks) against the JAX builder's and parser's.

`sample_one_light` runs on 4,096 seeded lanes (hit points in the scene's
box, shading normals uniform on the sphere with their Duff frames, pick
and sample uniforms) over tables of each light type alone (rect, sphere,
disk, a constant env, point with and without 1/d^2 falloff,
directional), all of them together, and the 17-light table of
tests/torch_general_scenes.py. Bars: `valid` equal on every lane; wi,
li, distance and pdf within rtol 1e-5 (atol 1e-6) where valid, the
bar of tests/test_torch_bsdf.py. The tables are compared bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.core import math as jvm
from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.lights import lights as jl
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.interop import numpy_leaves
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.lights import lights as tl
from craytracer_tpu_torch.scene.build import SceneBuilder

import torch_general_scenes as general_scenes

torch.set_num_threads(2)
N = 4096
TOL = dict(rtol=1e-5, atol=1e-6)


def _base(b):
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_rect((-3, 0, -3), (6, 0, 0), (0, 0, 6), "w")
    b.add_sphere((0.0, 0.5, 0.0), 0.5, "w")


def _rect(b):
    b.add_emissive("l", (1.0, 0.8, 0.6), 9.0)
    b.add_rect((-0.7, 2.5, -0.5), (1.4, 0, 0), (0, 0.2, 1.0), "l")


def _sphere(b):
    b.add_emissive("l", (0.6, 0.8, 1.0), 7.0)
    b.add_sphere((1.2, 2.0, 0.3), 0.4, "l")


def _disk(b):
    b.add_emissive("l", (1.0, 0.9, 0.5), 5.0)
    b.add_disk((-1.0, 2.2, 0.5), (0.3, -1.0, 0.2), 0.6, "l")


def _env(b):
    b.set_env_light("constant", (0.4, 0.5, 0.7), 0.8)


def _point(b):
    b.add_point_light((0.4, 2.6, 1.1), (1.0, 0.9, 0.8), 6.0)
    b.add_point_light((-1.5, 1.2, 2.0), (0.3, 0.6, 1.0), 0.5,
                      dist_atten=False)


def _directional(b):
    b.add_directional_light((0.2, 1.0, -0.4), (1.0, 0.95, 0.9), 2.0)


LIGHTS = {"rect": [_rect], "sphere": [_sphere], "disk": [_disk],
          "env": [_env], "point": [_point], "directional": [_directional],
          "all": [_rect, _sphere, _disk, _env, _point, _directional]}


def _scenes(name):
    jb, tb = JBuilder(), SceneBuilder()
    for b in (jb, tb):
        if name == "17 lights":
            general_scenes.many_lights(b)
            continue
        _base(b)
        for add in LIGHTS[name]:
            add(b)
    return jb.build(), tb.build(device="cpu")


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(4242)
    n = rng.normal(size=(N, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return dict(point=rng.uniform([-3, 0, -3], [3, 2, 3],
                                  (N, 3)).astype(np.float32),
                normal=n.astype(np.float32),
                u_pick=rng.random(N).astype(np.float32),
                u2=rng.random((N, 2)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", [*LIGHTS, "17 lights"])
def test_sample_one_light_matches_jax(lanes, name):
    js, ts = _scenes(name)
    n = lanes["normal"]
    jt, jb_, _ = jvm.orthonormal_basis(jnp.asarray(n))
    ref = jl.sample_one_light(js, jnp.asarray(lanes["u_pick"]),
                              jnp.asarray(lanes["u2"]),
                              jnp.asarray(lanes["point"]), jnp.asarray(n),
                              jt, jb_)
    tt, tb_, _ = vm.orthonormal_basis(_t(n))
    ours = tl.sample_one_light(ts, _t(lanes["u_pick"]), _t(lanes["u2"]),
                               _t(lanes["point"]), _t(n), tt, tb_)
    valid = ours.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    assert valid.mean() > 0.1
    for f in ("wi", "li", "distance", "pdf"):
        np.testing.assert_allclose(getattr(ours, f).numpy()[valid],
                                   np.asarray(getattr(ref, f))[valid],
                                   err_msg=f, **TOL)


@pytest.mark.parametrize("kind", [0, 1])
def test_env_radiance(lanes, kind):
    js, ts = _scenes("env")
    if kind == 0:
        js, ts = _scenes("rect")
    assert ts.env.kind == js.env.kind == kind
    d = lanes["normal"]
    np.testing.assert_array_equal(
        tl.env_radiance(ts.env, ts.textures, _t(d)).numpy(),
        np.asarray(jl.env_radiance(js.env, js.textures, jnp.asarray(d))))


def _assert_tables_equal(ts, js):
    for group in ("lights", "materials", "env"):
        ours, ref = numpy_leaves(getattr(ts, group)), numpy_leaves(
            getattr(js, group))
        for k, v in ours.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, np.asarray(ref[k]),
                                              f"{group}.{k}")
    assert ts.light_types_present == tuple(js.light_types_present)


def test_builder_delta_light_tables_match_jax():
    js, ts = _scenes("all")
    _assert_tables_equal(ts, js)


SCENE = """FOV 40
CAMERA_POS 0 2 6
LOOK_POINT 0 0.5 0
MATERIAL MATTE
NAME w
COLOR 0.7 0.7 0.7
END
MATERIAL EMISSIVE
NAME lamp
COLOR 1 0.9 0.8
INTENSITY 4
END
END_MATERIALS
OBJECT RECTANGLE
POINT -3 0 -3
WIDTH 6 0 0
HEIGHT 0 0 6
MATERIAL w
OBJECT DISK
CENTER 0 2 0
NORMAL 0 -1 0
RADIUS 0.5
MATERIAL lamp
POINT_LIGHT
POINT 0.5 2.5 1
COLOR 1 0.9 0.7
INTENSITY 3
POINT_LIGHT
POINT -1 1 2
INTENSITY 0.5
DIST_ATTEN no
DIRECTIONAL_LIGHT
DIRECTION 0.3 1 0.2
COLOR BLUE
INTENSITY 1.5
DIRECTIONAL_LIGHT
"""


def test_parser_delta_light_tables_match_jax(tmp_path):
    p = tmp_path / "delta.txt"
    p.write_text(SCENE)
    ts, _, _ = load_scene_file(str(p), device="cpu")
    js, _, _ = j_load(str(p))
    assert ts.lights.light_type.tolist() == [2, 6, 6, 5, 5]
    _assert_tables_equal(ts, js)
