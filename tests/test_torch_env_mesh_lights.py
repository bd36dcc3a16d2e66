"""Texture env lights and mesh lights in the port's builder and light
sampler (craytracer_tpu_torch/scene/build.py, lights/lights.py) against
the JAX package's: the env texel distribution (flat_cdf, flat_pdf) bit
for bit on the fullscene HDR sky and on a map with negative texels; the
mesh-light tables and the light power CDF under the reference and the
principled power; `sample_light_index` on 4,096 seeded lanes for the
texture env by texel importance and by the cosine hemisphere and for
mesh lights (the test_mis.py quad and an icosphere lamp): `valid` equal,
wi, li, distance and pdf within 2e-5 where valid; and the quad's CDF
boundary cases of tests/test_mis.py:112-138, where the port picks the
same triangle as the CDF's first entry >= u on every case and its
samples equal JAX's to 2e-5; and interop.scene_from_numpy carrying a JAX
scene's texel pool, mesh lights and env tables."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.core import math as jvm
from craytracer_tpu.io.teximage import load_texture_image as j_tex
from craytracer_tpu.lights import lights as jl
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.interop import numpy_leaves, scene_from_numpy
from craytracer_tpu_torch.io.teximage import load_texture_image as t_tex
from craytracer_tpu_torch.lights import lights as tl
from craytracer_tpu_torch.scene import types as T
from craytracer_tpu_torch.scene.build import SceneBuilder
from craytracer_tpu_torch.scene.city import icosphere

import torch_textured_scenes as tex_scenes

torch.set_num_threads(2)
N = 4096
TOL = dict(rtol=2e-5, atol=2e-5)
NEG = (np.random.default_rng(9).standard_normal((7, 13, 3)) * 3).astype(
    np.float32)


def _env(b, load, importance, kind):
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_rect((-3, 0, -3), (6, 0, 0), (0, 0, 6), "w")
    img = (load(os.path.join(tex_scenes.SCENES, "fullscene_env.exr"))
           if kind == "sky" else NEG)
    tid = b.add_texture(kind, img)
    b.set_env_light("texture", intensity=1.5, tex_id=tid,
                    rotate_y_angle=-0.76, importance=importance)


def _ico_lamp(b):
    v, f = icosphere(2)
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_emissive("lamp", (1.0, 0.8, 0.6), 9.0)
    b.add_rect((-3, 0, -3), (6, 0, 0), (0, 0, 6), "w")
    b.add_mesh(v * 0.6 + np.array([0.3, 2.5, -0.2]), f, "lamp")


def _mixed(b):
    """A rect, a sphere, a mesh, a point light and a texture env."""
    _ico_lamp(b)
    b.add_emissive("l2", (0.6, 0.8, 1.0), 7.0)
    b.add_rect((-0.7, 2.5, -0.5), (1.4, 0, 0), (0, 0, 1.0), "l2")
    b.add_sphere((1.2, 2.0, 0.3), 0.4, "l2")
    b.add_point_light((0.4, 2.6, 1.1), (1.0, 0.9, 0.8), 6.0)
    b.set_env_light("texture", intensity=0.7,
                    tex_id=b.add_texture("neg", NEG), rotate_y_angle=-0.76)


def _both(fn, power="reference", **kw):
    jb, tb = JBuilder(), SceneBuilder()
    if "kind" in kw:
        fn(jb, j_tex, **kw)
        fn(tb, t_tex, **kw)
    else:
        fn(jb)
        fn(tb)
    return jb.build(light_power=power), tb.build(light_power=power,
                                                 device="cpu")


@pytest.mark.parametrize("kind", ["sky", "negative texels"])
def test_env_cdf_bit_equal(kind):
    js, ts = _both(_env, importance=True, kind=kind)
    assert (ts.env.imp_h, ts.env.imp_w) == (js.env.imp_h, js.env.imp_w)
    assert ts.env.kind == js.env.kind == 2
    for f in ("flat_cdf", "flat_pdf", "transform", "world_radius", "tex_id"):
        ours, ref = getattr(ts.env, f).numpy(), np.asarray(getattr(js.env, f))
        assert ours.dtype == ref.dtype, f
        np.testing.assert_array_equal(ours, ref, f)
    assert ts.env.flat_pdf.min() >= 0.0


@pytest.mark.parametrize("power", ["reference", "principled"])
@pytest.mark.parametrize("scene", ["quad", "quad and rect", "mixed"])
def test_light_tables_bit_equal(power, scene):
    fn = {"quad": tex_scenes.quad_lamp,
          "quad and rect": tex_scenes.quad_lamp_and_rect,
          "mixed": _mixed}[scene]
    js, ts = _both(fn, power)
    for group in ("lights", "mesh_lights"):
        for f, ref in vars(getattr(js, group)).items():
            if isinstance(ref, jnp.ndarray):
                ours = getattr(getattr(ts, group), f).numpy()
                assert ours.dtype == np.asarray(ref).dtype, (group, f)
                np.testing.assert_array_equal(ours, np.asarray(ref),
                                              f"{group}.{f}")
    assert ts.light_types_present == js.light_types_present
    mesh = ts.lights.light_type.numpy() == T.LIGHT_MESH
    if power == "reference" and not mesh.all():
        assert (ts.lights.power.numpy()[mesh] == 0.0).all()
    else:
        assert (ts.lights.power.numpy()[mesh] > 0.0).all()


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(77)
    n = rng.normal(size=(N, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return dict(point=rng.uniform([-3, 0, -3], [3, 2, 3],
                                  (N, 3)).astype(np.float32),
                normal=n.astype(np.float32),
                u2=rng.random((N, 2)).astype(np.float32))


def _sample(js, ts, row, point, normal, u2):
    n = point.shape[0]
    idx = np.full(n, row, np.int32)
    jt, jb_, _ = jvm.orthonormal_basis(jnp.asarray(normal))
    ref = jl.sample_light_index(js, jnp.asarray(idx), jnp.asarray(u2),
                                jnp.asarray(point), jnp.asarray(normal),
                                jt, jb_)
    tt, tb_, _ = vm.orthonormal_basis(torch.from_numpy(normal))
    ours = tl.sample_light_index(ts, torch.from_numpy(idx).long(),
                                 torch.from_numpy(u2),
                                 torch.from_numpy(point),
                                 torch.from_numpy(normal), tt, tb_)
    return ours, ref


def _check(ours, ref, min_valid=0.1):
    valid = ours.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref.valid))
    assert valid.mean() > min_valid
    for f in ("wi", "li", "distance", "pdf"):
        np.testing.assert_allclose(getattr(ours, f).numpy()[valid],
                                   np.asarray(getattr(ref, f))[valid],
                                   err_msg=f, **TOL)


@pytest.mark.parametrize("importance", [True, False])
@pytest.mark.parametrize("kind", ["sky", "negative texels"])
def test_env_samples_match_jax(lanes, importance, kind):
    js, ts = _both(_env, importance=importance, kind=kind)
    row = ts.lights.light_type.tolist().index(T.LIGHT_ENV)
    ours, ref = _sample(js, ts, row, lanes["point"], lanes["normal"],
                        lanes["u2"])
    _check(ours, ref)


@pytest.mark.parametrize("scene", ["quad", "icosphere"])
def test_mesh_samples_match_jax(lanes, scene):
    fn = tex_scenes.quad_lamp if scene == "quad" else _ico_lamp
    js, ts = _both(fn, "principled")
    row = ts.lights.light_type.tolist().index(T.LIGHT_MESH)
    point = lanes["point"] * np.float32(0.5)  # under the lamps
    ours, ref = _sample(js, ts, row, point, lanes["normal"], lanes["u2"])
    _check(ours, ref)


def test_mesh_cdf_boundaries():
    """tests/test_mis.py:112-138's u at 0, just either side of the
    quad's 0.5 boundary, near 1 and at 1: the triangle whose CDF entry is
    the first >= u, every sample valid on the quad, equal to JAX's."""
    js, ts = _both(tex_scenes.quad_lamp, "principled")
    row = ts.lights.light_type.tolist().index(T.LIGHT_MESH)
    u2 = np.array([[0.0, 0.5], [0.49, 0.5], [0.5, 0.5], [0.51, 0.5],
                   [0.999, 0.5], [1.0, 0.5]], np.float32)
    n = u2.shape[0]
    point = np.zeros((n, 3), np.float32)
    normal = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (n, 1))
    ours, ref = _sample(js, ts, row, point, normal, u2)
    assert ours.valid.all() and bool(np.asarray(ref.valid).all())
    _check(ours, ref, min_valid=0.99)
    pts = (ours.wi * ours.distance[:, None]).numpy()
    np.testing.assert_allclose(pts[:, 1], 8.0, atol=1e-3)
    # triangle 0 spans x >= z (corners (-2,-2), (2,-2), (2,2)), 1 the rest
    cdf = ts.mesh_lights.cdf.numpy()
    want = np.searchsorted(cdf, u2[:, 0], side="left").clip(0, 1)
    got = np.where(pts[:, 0] >= pts[:, 2] - 1e-4, 0, 1)
    np.testing.assert_array_equal(got, want)


def test_interop_carries_slice_e_tables():
    """interop.scene_from_numpy rebuilds a JAX scene's texel pool, mesh
    lights and env tables (flat_cdf, flat_pdf, importance, imp_h, imp_w)
    into the port's Scene equal to the port's own build."""
    jb, tb = JBuilder(), SceneBuilder()
    for b, load in ((jb, j_tex), (tb, t_tex)):
        _env(b, load, importance=True, kind="sky")
        b.add_emissive("lamp", (1.0, 0.8, 0.6), 9.0)
        b.add_mesh([(0, 3, 0), (1, 3, 0), (0, 3, 1)], [(0, 2, 1)], "lamp")
    js = jb.build(light_power="principled")
    ts = tb.build(light_power="principled", device="cpu")
    carried = scene_from_numpy(numpy_leaves(js), device="cpu")
    for group in ("textures", "mesh_lights", "lights"):
        for f, ref in vars(getattr(ts, group)).items():
            np.testing.assert_array_equal(
                getattr(getattr(carried, group), f).numpy(), ref.numpy(), f)
    for f in ("flat_cdf", "flat_pdf", "transform", "tex_id"):
        np.testing.assert_array_equal(getattr(carried.env, f).numpy(),
                                      getattr(ts.env, f).numpy(), f)
    assert (carried.env.kind, carried.env.importance, carried.env.imp_h,
            carried.env.imp_w) == (2, 1, 128, 256)
    assert carried.light_types_present == ts.light_types_present
