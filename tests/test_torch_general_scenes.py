"""The general route on scenes no kernel shades, built through both
packages' builders from tests/torch_general_scenes.py: disk lights,
point and directional lights, 17 lights, 65 materials, and the
anisotropic and Trowbridge-Reitz microfacets of `make_anisotropic` (the
JAX scene's alphay / distrib replaced, the port's carried over by
interop.scene_from_numpy) on spheres and on a 320-triangle bvh4 mesh
(scenes/icosphere_small.obj) under a disk light and a constant env
light. The port's `trace_paths` through `_general_step` against the JAX
XLA `trace_paths(fast_shade=False)` at depth 0, 2 and 5, with the bars
of tests/torch_general_check.py. Measured: every lane within the bars
but for the excused lanes, where JAX's fori program and its unrolled
step differ by up to 2.9e-4; the port agrees with the unrolled step to
7.3e-6 there."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.camera import Film as JFilm
from craytracer_tpu.camera import make_camera as j_make_camera
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.integrator.gate import production_fast_shade
from craytracer_tpu_torch.interop import numpy_leaves, scene_from_numpy
from craytracer_tpu_torch.io.objloader import load_obj
from craytracer_tpu_torch.scene.build import SceneBuilder
from torch_general_check import SIZE, check_general, jax_rays
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401

import torch_general_scenes as general_scenes

torch.set_num_threads(2)
pytestmark = SAH_WARNING_IS_ERROR
OBJ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes", "icosphere_small.obj")
NAMES = [*general_scenes.SCENES, "mesh_env_disk"]
EXCUSED = {("many_materials", 5): (225, 828, 899),
           ("aniso_spheres", 5): (301, 948)}


def _build(name):
    jb, tb = JBuilder(), SceneBuilder()
    if name == "mesh_env_disk":
        shapes = [(s.positions, s.indices) for s in load_obj(OBJ)[0]]
        eye, look, fov, _ = general_scenes.mesh_env_disk(jb, shapes)
        general_scenes.mesh_env_disk(tb, shapes)
    else:
        eye, look, fov, _ = general_scenes.SCENES[name](jb)
        general_scenes.SCENES[name](tb)
    js, ts = jb.build(), tb.build(device="cpu")
    if name in ("aniso_spheres", "mesh_env_disk"):
        leaves = general_scenes.make_anisotropic(numpy_leaves(js))
        ts = scene_from_numpy(leaves, device="cpu")
        m = leaves["materials"]
        js = js.replace(materials=js.materials.replace(
            alphay=jnp.asarray(m["alphay"]), distrib=jnp.asarray(m["distrib"])))
        assert not ts.microfacet_iso_beckmann
    return js, ts, j_make_camera(eye, look), JFilm(
        fov=jnp.float32(fov), width=SIZE, height=SIZE)


@pytest.fixture(scope="module")
def built():
    return {}


@pytest.mark.parametrize("depth", [0, 2, 5])
@pytest.mark.parametrize("name", NAMES)
def test_general_pass_matches_jax(built, name, depth):
    if name not in built:
        js, ts, jc, jf = _build(name)
        assert production_fast_shade(ts) == "general"
        built[name] = (js, ts, jax_rays(jc, jf))
    js, ts, rays = built[name]
    L, m = check_general(js, ts, rays, depth, EXCUSED.get((name, depth), ()))
    assert depth == 0 or (L.mean() > 0.01 and int(m["shadow_rays"]) > 0)
    assert np.isfinite(L).all()
