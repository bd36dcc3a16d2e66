"""The general route on slice-E scenes (textures, normal maps, texture
env lights, mesh lights): the port's `trace_paths` through
`_general_step` against the JAX package's XLA
`trace_paths(fast_shade=False)` at depth 0, 2 and 5, with the bars of
tests/torch_general_check.py (`good`, rays and shadow rays exact, L
within 2e-5). The scenes: scenes/parity_textured.txt with and without
CRAY_TEX_FLOAT_DIV255 (a checker on a rect and a smooth quad mesh, an
EXR texture env), a normal-mapped textured floor, the fullscene HDR sky
as a texture env with IMPORTANCE under the reference estimator and
without it under the physical one (the Renderer's importance default
turns it on, in both packages), the quad mesh light of tests/test_mis.py
under the principled and the reference light power (beside a rect lamp,
so its reference power is 0), and the fullscene of
craytracer_tpu_torch/scene/fullscene.py at 4 spheres (77,312 triangles,
bvh4, MATERIAL FROM_MTL) with its PNG textures, normal map and HDR env.
"""

import contextlib
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.camera import Film as JFilm
from craytracer_tpu.camera import make_camera as j_make_camera
from craytracer_tpu.integrator.render import RenderConfig as JConfig
from craytracer_tpu.integrator.render import Renderer as JRenderer
from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.io.teximage import load_texture_image as j_tex
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.camera import Film
from craytracer_tpu_torch.integrator.gate import production_fast_shade
from craytracer_tpu_torch.integrator.render import RenderConfig, Renderer
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.io.teximage import load_texture_image as t_tex
from craytracer_tpu_torch.scene import types as T
from craytracer_tpu_torch.scene.build import SceneBuilder
from craytracer_tpu_torch.scene.fullscene import write_obj
from torch_general_check import SIZE, check_general, jax_rays
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401

import torch_textured_scenes as tex_scenes

torch.set_num_threads(2)
pytestmark = SAH_WARNING_IS_ERROR
SCENES = tex_scenes.SCENES
NAMES = ["parity_textured", "parity_textured_div255", "normal_floor",
         "env_importance_reference", "env_default_physical",
         "quad_lamp_principled", "quad_lamp_reference", "fullscene_4"]
# lanes where JAX's fori program and its unrolled step differ by more
# than the bar (tests/torch_general_check.py)
EXCUSED = {}


@contextlib.contextmanager
def _div255(on):
    old = os.environ.get("CRAY_TEX_FLOAT_DIV255")
    os.environ["CRAY_TEX_FLOAT_DIV255"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["CRAY_TEX_FLOAT_DIV255"]
        else:
            os.environ["CRAY_TEX_FLOAT_DIV255"] = old


def _fullscene_dir(tmp):
    """The 4-sphere fullscene beside copies of the tracked scene file,
    MTL, PNGs and EXR."""
    for f in os.listdir(SCENES):
        if f.startswith("fullscene") and f.endswith((".txt", ".mtl", ".png",
                                                     ".exr")):
            shutil.copy(os.path.join(SCENES, f), tmp)
    write_obj(os.path.join(tmp, "fullscene.obj"), spheres=4)
    return os.path.join(tmp, "fullscene.txt")


def _from_file(path, div255=False):
    with _div255(div255):
        js, jc, jf = j_load(path)
        ts, _, _ = load_scene_file(path, device="cpu")
    return js, ts, jc, jf


def _from_builders(fn, *, load=False, power="reference", **kw):
    jb, tb = JBuilder(), SceneBuilder()
    args = (j_tex,) if load else ()
    eye, look, fov = fn(jb, *args, **kw)
    fn(tb, *((t_tex,) if load else ()), **kw)
    js = jb.build(light_power=power)
    ts = tb.build(light_power=power, device="cpu")
    return js, ts, j_make_camera(eye, look), JFilm(
        fov=jnp.float32(fov), width=SIZE, height=SIZE)


def _build(name, tmp):
    if name.startswith("parity_textured"):
        return _from_file(os.path.join(SCENES, "parity_textured.txt"),
                          div255=name.endswith("div255"))
    if name == "normal_floor":
        return _from_builders(tex_scenes.normal_floor, load=True)
    if name == "env_importance_reference":
        return _from_builders(tex_scenes.env_spheres, load=True,
                              importance=True)
    if name == "env_default_physical":
        js, ts, jc, jf = _from_builders(tex_scenes.env_spheres, load=True,
                                        importance=False)
        assert ts.env.importance == js.env.importance == 0
        film = Film(fov=torch.tensor(float(jf.fov)), width=1, height=1)
        # the reference estimator keeps what the scene says
        assert Renderer(ts, None, film, RenderConfig()).scene.env.importance \
            == 0
        js = JRenderer(js, jc, jf, JConfig(estimator="physical")).scene
        ts = Renderer(ts, None, film,
                      RenderConfig(estimator="physical")).scene
        assert ts.env.importance == js.env.importance == 1
        return js, ts, jc, jf
    if name == "quad_lamp_principled":
        return _from_builders(tex_scenes.quad_lamp, power="principled")
    if name == "quad_lamp_reference":
        return _from_builders(tex_scenes.quad_lamp_and_rect)
    assert name == "fullscene_4"
    return _from_file(_fullscene_dir(tmp))


@pytest.fixture(scope="module")
def built():
    return {}


@pytest.mark.parametrize("depth", [0, 2, 5])
@pytest.mark.parametrize("name", NAMES)
def test_textured_pass_matches_jax(built, tmp_path_factory, name, depth):
    if name not in built:
        js, ts, jc, jf = _build(name, tmp_path_factory.mktemp(name))
        # the quad's mesh light has power 0 beside the rect lamp in the
        # reference power mode, so the gate keeps that scene on K1
        assert production_fast_shade(ts) == (
            "bounce" if name == "quad_lamp_reference" else "general")
        built[name] = (js, ts, jax_rays(jc, jf))
    js, ts, rays = built[name]
    L, m = check_general(js, ts, rays, depth, EXCUSED.get((name, depth), ()))
    assert np.isfinite(L).all()
    assert depth == 0 or (L.mean() > 1e-3 and int(m["shadow_rays"]) > 0)


def test_scene_features(built, tmp_path_factory):
    """What each scene holds: textures and a normal map, the texture env
    and its CDF, the mesh light's row and power under both modes."""
    js, ts, jc, jf = _build("normal_floor", None)
    assert ts.textures.width.tolist() == [512, 512]
    assert (ts.materials.normal_tex >= 0).sum() == 1
    js, ts, jc, jf = _build("env_importance_reference", None)
    assert ts.env.kind == 2 and ts.env.importance == 1
    assert (ts.env.imp_h, ts.env.imp_w) == (128, 256)
    assert ts.light_types_present == (T.LIGHT_ENV,)
    for name, power in (("quad_lamp_principled", 1.0),
                        ("quad_lamp_reference", 0.0)):
        js, ts, jc, jf = _build(name, None)
        row = ts.lights.light_type.tolist().index(T.LIGHT_MESH)
        assert float(ts.lights.power[row]) == power
        assert ts.mesh_lights.surface_area.tolist() == [16.0]
