"""Scenes with spheres and every material type through both packages'
parsers and builders: scenes/parity_mix.txt (matte, Oren-Nayar, plastic,
mirror and gold spheres, a rect lamp), a scene file with GLASS,
TRANSPARENT, the legacy REFLECTIVE, a clipped sphere and an emissive
sphere (a sphere area light), and a scene naming a mesh file that does
not exist (both parsers skip it). Every Scene leaf is equal (dtype, shape,
bits): the material columns (ks, sigma, on_a/on_b, ior, cf, eta/k,
alphax/alphay, distrib), the sphere table with its clip window, the light
rows and power CDF, the env light; so are the static fields and the
interop carry-over of the JAX scene. The gate's routes and feature
masks are checked too."""

import os

import numpy as np
import pytest
import torch

from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu_torch.integrator.gate import (F_GLASS, F_METAL, F_MIRROR,
                                                  F_OREN, F_PLASTIC,
                                                  F_SPHERE_LIGHT,
                                                  F_TRANSPARENT,
                                                  production_fast_shade,
                                                  shade_features)
from craytracer_tpu_torch.interop import numpy_leaves, scene_from_numpy
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.scene import types as T
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401

pytestmark = SAH_WARNING_IS_ERROR
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIX = os.path.join(REPO, "scenes", "parity_mix.txt")
GROUPS = ["spheres", "planes", "rects", "disks", "triangles", "instanced",
          "materials", "lights", "mesh_lights", "env", "textures"]

GLASS_SCENE = """FOV 40
CAMERA_POS 0 1 5
LOOK_POINT 0 0.5 0
MATERIAL MATTE
NAME floor
COLOR GREY
END
MATERIAL GLASS
NAME glass
ROUGHNESS 0.05
END
MATERIAL TRANSPARENT
NAME thin
IOR_IN 1.33
IOR_OUT 1.0
CF_IN 0.9 0.95 1
END
MATERIAL REFLECTIVE
NAME legacy
DIFF_COLOR 0.6 0.2 0.1
DIFF_CONSTANT 0.8
SPEC_COLOR WHITE
SPEC_CONSTANT 0.3
END
MATERIAL METAL
NAME copper
TYPE COPPER
ROUGHNESS 0.2
END
MATERIAL EMISSIVE
NAME bulb
COLOR 1 0.9 0.7
INTENSITY 30
END
END_MATERIALS
OBJECT RECTANGLE
POINT -4 0 -4
WIDTH 8 0 0
HEIGHT 0 0 8
MATERIAL floor
OBJECT SPHERE
RADIUS 0.7
CENTER -1 0.7 0
MATERIAL glass
OBJECT SPHERE
RADIUS 0.5
CENTER 1 0.5 0.3
MATERIAL thin
OBJECT SPHERE
RADIUS 0.4
CENTER 0 0.4 1.2
PHI 2.0
MIN_THETA 0.5
MAX_THETA 2.5
MATERIAL legacy
OBJECT SPHERE
RADIUS 0.3
CENTER 0.5 0.3 -1.5
MATERIAL copper
OBJECT SPHERE
RADIUS 0.4
CENTER 0 3 0
MATERIAL bulb
"""

MISSING_MESH = """OBJECT MESH
FILE_NAME no_such_mesh.obj
MATERIAL grey
MATERIAL MATTE
NAME grey
COLOR GREY
END
MATERIAL EMISSIVE
NAME lamp
END
OBJECT RECTANGLE
POINT -1 2 -1
WIDTH 2 0 0
HEIGHT 0 0 2
MATERIAL lamp
OBJECT RECTANGLE
POINT -1 0 -1
WIDTH 2 0 0
HEIGHT 0 0 2
MATERIAL grey
OBJECT SPHERE
RADIUS 0.5
CENTER 0 0.5 0
MATERIAL grey
"""


def _assert_tree_equal(ours, ref, path=""):
    if isinstance(ref, dict):
        for k, v in ref.items():
            _assert_tree_equal(ours[k], v, f"{path}.{k}")
    elif isinstance(ref, np.ndarray):
        assert ours.dtype == ref.dtype, (path, ours.dtype, ref.dtype)
        assert ours.shape == ref.shape, (path, ours.shape, ref.shape)
        np.testing.assert_array_equal(ours, ref, err_msg=path)
    else:
        assert ours == ref, (path, ours, ref)


@pytest.fixture(scope="module", params=["parity_mix", "glass", "missing"])
def both(request, tmp_path_factory):
    if request.param == "parity_mix":
        path = MIX
    else:
        path = tmp_path_factory.mktemp("scenes") / f"{request.param}.txt"
        path.write_text(GLASS_SCENE if request.param == "glass"
                        else MISSING_MESH)
        path = str(path)
    return request.param, j_load(path), load_scene_file(path, device="cpu")


def test_scene_leaves_equal(both):
    _, (js, jc, jf), (ts, tc, tf) = both
    for group in GROUPS:
        _assert_tree_equal(numpy_leaves(getattr(ts, group)),
                           numpy_leaves(getattr(js, group)), group)
    for name in ("accel", "mat_types_present", "light_types_present",
                 "matte_lambertian"):
        assert getattr(ts, name) == getattr(js, name), name
    assert js.sph_bvh is None and js.tri_bvh is None
    _assert_tree_equal(numpy_leaves(tc), numpy_leaves(jc))
    _assert_tree_equal(numpy_leaves(tf), numpy_leaves(jf))
    carried = scene_from_numpy(numpy_leaves(js), device="cpu")
    _assert_tree_equal(numpy_leaves(carried), numpy_leaves(ts))


def test_routes_and_feature_masks(both):
    name, _, (ts, tc, tf) = both
    assert ts.microfacet_iso_beckmann and ts.sphere_clips_in_domain
    assert production_fast_shade(ts, tc, tf) == "bounce"
    want = {"parity_mix": F_MIRROR | F_OREN | F_PLASTIC | F_METAL,
            "glass": F_GLASS | F_TRANSPARENT | F_PLASTIC | F_METAL
            | F_SPHERE_LIGHT,
            "missing": 0}[name]
    assert shade_features(ts) == want
    if name == "glass":
        li = ts.lights
        assert li.light_type.tolist() == [T.LIGHT_AREA_SPHERE]
        assert li.radius.tolist() == [pytest.approx(0.4)]


def test_parity_mix_materials():
    """The parity_mix rows as the reference builds them: plastic and metal
    keep the raw roughness as alpha, gold's eta/k preset, Oren-Nayar
    sigma 20."""
    ts, _, _ = load_scene_file(MIX, device="cpu")
    m = ts.materials
    by_type = {int(t): i for i, t in enumerate(m.mat_type.tolist())}
    pl, mt = by_type[T.MAT_PLASTIC], by_type[T.MAT_METAL]
    assert m.alphax[pl].item() == pytest.approx(0.08)
    assert m.alphax[mt].item() == pytest.approx(0.15)
    assert torch.equal(m.alphax, m.alphay)
    assert m.eta[mt].tolist() == pytest.approx([0.14282006, 0.37414363,
                                                1.43944442])
    assert (m.on_b > 0).sum().item() == 1
    assert ts.spheres.mat_id.shape[0] == 4 and ts.rects.mat_id.shape[0] == 3


def test_sphere_clip_outside_the_kernel_domain_takes_shade():
    """PHI 6.283 spells a full sphere in the parser's grammar; the
    kernel's cosine-space window is exact only for phi <= pi, so such a
    scene leaves K1 for the per-bounce route (pallas_shade.py:1541-1553)."""
    from craytracer_tpu_torch.scene.build import SceneBuilder

    _, tc, tf = load_scene_file(MIX, device="cpu")
    b = SceneBuilder()
    b.add_matte("w")
    b.add_emissive("lamp")
    b.add_sphere((0, 0, 0), 1.0, "w", phi=6.283)
    b.add_rect((-1, 3, -1), (2, 0, 0), (0, 0, 2), "lamp")
    scene = b.build(device="cpu")
    assert not scene.sphere_clips_in_domain
    assert production_fast_shade(scene, tc, tf) == "shade"
