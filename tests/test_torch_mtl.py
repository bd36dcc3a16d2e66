"""MTL materials and the fullscene: the port's `load_mtl` against the JAX
package's on scenes/fullscene.mtl and on a library with every key;
`_mtl_material_name` binding each material to the same table row as
JAX (type and every column); the OBJ of craytracer_tpu_torch/scene/
fullscene.py byte-equal to what scenes/make_fullscene.py writes for 4
spheres; and that 4-sphere fullscene (MATERIAL FROM_MTL, PNG textures
and normal map, an HDR env with IMPORTANCE, two lamp mesh lights, a
bvh4 table) loaded by both scene parsers into equal tensors."""

import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest

from craytracer_tpu.io import objloader as jobj
from craytracer_tpu.io import scenefile as jsf
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.interop import numpy_leaves
from craytracer_tpu_torch.io import objloader as tobj
from craytracer_tpu_torch.io import scenefile as tsf
from craytracer_tpu_torch.scene.build import SceneBuilder
from craytracer_tpu_torch.scene.fullscene import obj_text
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401

pytestmark = SAH_WARNING_IS_ERROR
SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes")
EVERY_KEY = """# every key and branch
newmtl lamp
Ka 0.1 0.1 0.1
Kd 0 0 0
Ke 14 12 9
newmtl glass7
Ks 0.9 0.9 0.9
Ni 1.45
Ns 40
illum 7
newmtl thin
d 0.5
Ni 1.2
newmtl chromium
Ks 0.8 0.8 0.8
Ns 200
newmtl mirror5
Ks 0.7 0.6 0.5
illum 5
newmtl mirror3
illum 3
newmtl shiny
Kd 0.2 0.4 0.6
Ks 0.3 0.3 0.3
Ns 50
map_Kd fullscene_noise.png
newmtl bumpy
Kd 0.6 0.5 0.4
Ks 0.01 0.01 0.01
map_Kd fullscene_checker.png
bump -bm 1 fullscene_normal.png
newmtl missing_tex
map_Kd no_such.png
"""


def _fields(m):
    return dataclasses.astuple(m)


@pytest.fixture
def every_key(tmp_path):
    p = tmp_path / "every.mtl"
    p.write_text(EVERY_KEY)
    for f in ("fullscene_noise.png", "fullscene_checker.png",
              "fullscene_normal.png"):
        shutil.copy(os.path.join(SCENES, f), tmp_path)
    return str(p)


@pytest.mark.parametrize("which", ["fullscene", "every key"])
def test_load_mtl_matches_jax(every_key, which):
    path = (os.path.join(SCENES, "fullscene.mtl") if which == "fullscene"
            else every_key)
    ours, ref = tobj.load_mtl(path), jobj.load_mtl(path)
    assert list(ours) == list(ref)
    for name in ref:
        assert _fields(ours[name]) == _fields(ref[name]), name


def test_mtl_material_binding_matches_jax(every_key):
    base = os.path.dirname(every_key)
    for path in (os.path.join(SCENES, "fullscene.mtl"), every_key):
        jb, tb = JBuilder(), SceneBuilder()
        jm, tm = jobj.load_mtl(path), tobj.load_mtl(path)
        for name in jm:
            jn = jsf._mtl_material_name(jb, jm[name], base, [base])
            tn = tsf._mtl_material_name(tb, tm[name], base, [base])
            assert jn == tn == "mtl:" + name
            # a second binding reuses the row
            assert tsf._mtl_material_name(tb, tm[name], base, [base]) == tn
        jb.add_rect((0, 0, 0), (1, 0, 0), (0, 0, 1), "__default__")
        tb.add_rect((0, 0, 0), (1, 0, 0), (0, 0, 1), "__default__")
        js, ts = jb.build(), tb.build(device="cpu")
        for field, ref in numpy_leaves(js.materials).items():
            np.testing.assert_array_equal(
                getattr(ts.materials, field).numpy(), ref, field)
        for field, ref in numpy_leaves(js.textures).items():
            np.testing.assert_array_equal(
                getattr(ts.textures, field).numpy(), ref, field)


def test_fullscene_obj_matches_make_fullscene(tmp_path, monkeypatch):
    sys.path.insert(0, SCENES)
    try:
        import make_fullscene
    finally:
        sys.path.remove(SCENES)
    monkeypatch.setattr(make_fullscene, "HERE", str(tmp_path))
    monkeypatch.setattr(sys, "argv", ["make_fullscene.py", "--spheres", "4"])
    make_fullscene.main()
    assert (tmp_path / "fullscene.obj").read_text() == obj_text(4)


def _cmp(ours, ref, path="scene"):
    if isinstance(ref, dict):
        for k, v in ref.items():
            if k not in ("tri_shadow", "tri_cam", "sph_bvh"):
                _cmp(ours[k], v, f"{path}.{k}")
    elif isinstance(ref, tuple):
        assert len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _cmp(a, b, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, path
        np.testing.assert_array_equal(ours, ref, path)
    else:
        assert ours == ref, path


def test_fullscene_scene_matches_jax(tmp_path):
    for f in os.listdir(SCENES):
        if f.startswith("fullscene") and f.endswith((".txt", ".mtl", ".png",
                                                     ".exr")):
            shutil.copy(os.path.join(SCENES, f), tmp_path)
    (tmp_path / "fullscene.obj").write_text(obj_text(4))
    path = str(tmp_path / "fullscene.txt")
    js, _, _ = jsf.load_scene_file(path)
    ts, _, _ = tsf.load_scene_file(path, device="cpu")
    assert ts.triangles.mat_id.shape[0] == 77312
    assert ts.accel == "bvh4" and ts.tri_parts is None
    assert ts.env.kind == 2 and ts.env.importance == 1
    assert ts.mesh_lights.surface_area.shape[0] == 2  # lamp0, lamp1
    _cmp(numpy_leaves(ts), numpy_leaves(js))
