"""Mesh scenes through both packages' parsers and builders:
scenes/parity_mesh.txt (icosphere_small.obj, 320 triangles) and
scenes/parity_mesh_mid.txt (16 icospheres, 20,480 triangles), flat and
smooth. Every triangle leaf, light, material and static field is equal,
the BVH4 fat table is bit-equal with the same stack bound, triangle
count and leaf size, and the interop carry-over of the JAX scene equals
the port's own parse. Also the port's refusals, a missing mesh file
(skipped by both parsers), and the entry points running on the card
unless asked for the CPU."""

import os

import numpy as np
import pytest
import torch

from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu_torch.interop import numpy_leaves, scene_from_numpy
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.scene.build import SceneBuilder
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401

torch.set_num_threads(2)
pytestmark = SAH_WARNING_IS_ERROR
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
GROUPS = ["rects", "triangles", "materials", "lights", "mesh_lights", "env",
          "textures", "spheres"]


def _smooth_copy(tmp_path, name):
    """The scene with SMOOTH yes and the OBJ path made absolute."""
    text = open(os.path.join(SCENES, f"{name}.txt")).read()
    obj = "icosphere_small.obj" if name == "parity_mesh" else \
        "parity_mesh_mid.obj"
    text = text.replace("SMOOTH no", "SMOOTH yes").replace(
        f"FILE_NAME {obj}", f"FILE_NAME {os.path.join(SCENES, obj)}")
    p = tmp_path / f"{name}_smooth.txt"
    p.write_text(text)
    return str(p)


@pytest.fixture(scope="module", params=["parity_mesh", "parity_mesh_mid",
                                        "parity_mesh_smooth",
                                        "parity_mesh_mid_smooth"])
def both(request, tmp_path_factory):
    """Both packages' parse; the smooth variants take the OBJ's vertex
    normals (icosphere_small.obj) or compute them (parity_mesh_mid.obj has
    none)."""
    name = request.param
    if name.endswith("_smooth"):
        path = _smooth_copy(tmp_path_factory.mktemp("smooth"),
                            name[:-len("_smooth")])
    else:
        path = os.path.join(SCENES, f"{name}.txt")
    return j_load(path), load_scene_file(path, device="cpu")


def _assert_tree_equal(ours, ref, path=""):
    if isinstance(ref, dict):
        for k, v in ref.items():
            if k in ("tri_shadow", "tri_parts", "tri_cam", "sph_bvh"):
                assert v is None, f"{path}.{k}"
                continue
            _assert_tree_equal(ours[k], v, f"{path}.{k}")
    elif isinstance(ref, np.ndarray):
        assert ours.dtype == ref.dtype, (path, ours.dtype, ref.dtype)
        assert ours.shape == ref.shape, (path, ours.shape, ref.shape)
        np.testing.assert_array_equal(ours, ref, err_msg=path)
    else:
        assert ours == ref, (path, ours, ref)


@pytest.mark.parametrize("group", GROUPS)
def test_mesh_scene_leaves_equal(both, group):
    (js, _, _), (ts, _, _) = both
    _assert_tree_equal(numpy_leaves(getattr(ts, group)),
                       numpy_leaves(getattr(js, group)), group)


def test_bvh4_table_bit_equal(both):
    (js, _, _), (ts, _, _) = both
    assert js.accel == ts.accel == "bvh4"
    _assert_tree_equal(numpy_leaves(ts.tri_bvh), numpy_leaves(js.tri_bvh),
                       "tri_bvh")
    assert ts.tri_bvh.fat.shape[1] == 128 and ts.tri_bvh.leaf_size == 2
    assert ts.tri_bvh.n_tris == ts.triangles.mat_id.shape[0]


def test_mesh_statics_and_interop(both):
    (js, _, _), (ts, _, _) = both
    for name in ("mat_types_present", "light_types_present",
                 "matte_lambertian"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.smooth_triangles == bool(np.asarray(js.triangles.smooth).any())
    carried = scene_from_numpy(numpy_leaves(js))
    _assert_tree_equal(numpy_leaves(carried), numpy_leaves(ts))


def test_missing_mesh_file_raises(tmp_path):
    """A mesh file that cannot be found no longer raises: the port skips
    the object, as the JAX parser does (scenefile.py:323-324), and both
    build a scene without it."""
    p = tmp_path / "scene.txt"
    p.write_text("OBJECT MESH\nFILE_NAME no_such_mesh.obj\nMATERIAL m\n"
                 "OBJECT RECTANGLE\nPOINT 0 0 0\nMATERIAL m\n")
    ts, _, _ = load_scene_file(str(p), device="cpu")
    js, _, _ = j_load(str(p))
    assert ts.triangles.mat_id.shape[0] == js.triangles.mat_id.shape[0] == 0
    assert ts.rects.mat_id.shape[0] == js.rects.mat_id.shape[0] == 1


def test_mesh_refusals():
    b = SceneBuilder()
    b.add_emissive("lamp")
    with pytest.raises(NotImplementedError, match="slice E"):
        b.add_triangles_array(np.zeros((1, 3)), np.eye(3)[:1],
                              np.eye(3)[1:2], "lamp")
    b.add_matte("m")
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), "m")
    with pytest.raises(NotImplementedError, match="slice I"):
        b.build(accel="grid", device="cpu")


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """Without a card, load_scene_file, SceneBuilder.build and the CLI
    raise unless asked for the CPU."""
    from craytracer_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cornell = os.path.join(SCENES, "parity_cornell.txt")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_scene_file(cornell)
    b = SceneBuilder()
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), "__default__")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        b.build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([cornell, "--spp", "1", "--size", "8", "-o",
              str(tmp_path / "x.ppm")])
    assert b.build(device="cpu").device.type == "cpu"
