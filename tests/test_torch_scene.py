"""scenes/parity_cornell.txt through both packages' parsers and builders:
every Scene leaf equal (dtype, shape, bits), the interop carry-over equal
to the port's own parse, the camera and film equal, and generate_rays
agreeing to 1e-6. Also the port's refusals of what the slice does not
cover."""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.camera import generate_rays as j_generate_rays
from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.sampling.multijitter import stratified_jitter as j_strat
from craytracer_tpu_torch.camera import Film, generate_rays
from craytracer_tpu_torch.integrator.pass_kernel import (
    fused_pass, fused_pass_reference, production_fast_shade)
from craytracer_tpu_torch.integrator.wavefront import render_sample
from craytracer_tpu_torch.interop import (camera_from_numpy, film_from_numpy,
                                          numpy_leaves, scene_from_numpy)
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter
from craytracer_tpu_torch.scene import types as T

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "parity_cornell.txt")


@pytest.fixture(scope="module")
def both():
    return j_load(CORNELL), load_scene_file(CORNELL, device="cpu")


def _assert_tree_equal(ours, ref, path=""):
    if isinstance(ref, dict):
        for k, v in ref.items():
            if k in ("tri_bvh", "tri_shadow", "tri_parts", "tri_cam",
                     "sph_bvh"):
                assert v is None, f"{path}.{k}"
                continue
            _assert_tree_equal(ours[k], v, f"{path}.{k}")
    elif isinstance(ref, np.ndarray):
        assert ours.dtype == ref.dtype, (path, ours.dtype, ref.dtype)
        assert ours.shape == ref.shape, (path, ours.shape, ref.shape)
        np.testing.assert_array_equal(ours, ref, err_msg=path)
    else:
        assert ours == ref, (path, ours, ref)


GROUPS = ["spheres", "planes", "rects", "disks", "triangles", "instanced",
          "materials", "lights", "mesh_lights", "env", "textures"]


@pytest.mark.parametrize("group", GROUPS)
def test_scene_leaves_equal(both, group):
    (js, _, _), (ts, _, _) = both
    _assert_tree_equal(numpy_leaves(getattr(ts, group)),
                       numpy_leaves(getattr(js, group)), group)


def test_scene_statics_equal(both):
    (js, _, _), (ts, _, _) = both
    assert ts.accel == js.accel == "none"  # 20 tris resolve 'auto' to none
    assert ts.mat_types_present == js.mat_types_present
    assert ts.light_types_present == js.light_types_present
    assert ts.matte_lambertian == js.matte_lambertian is True
    assert ts.rects.mat_id.shape[0] == 8 and ts.triangles.mat_id.shape[0] == 20


def test_interop_scene_equals_port_parse(both):
    (js, jc, jf), (ts, tc, tf) = both
    carried = scene_from_numpy(numpy_leaves(js))
    _assert_tree_equal(numpy_leaves(carried), numpy_leaves(ts))
    _assert_tree_equal(numpy_leaves(camera_from_numpy(numpy_leaves(jc))),
                       numpy_leaves(tc))
    _assert_tree_equal(numpy_leaves(film_from_numpy(numpy_leaves(jf))),
                       numpy_leaves(tf))


def test_camera_and_film_equal(both):
    (_, jc, jf), (_, tc, tf) = both
    _assert_tree_equal(numpy_leaves(tc), numpy_leaves(jc))
    _assert_tree_equal(numpy_leaves(tf), numpy_leaves(jf))


@pytest.mark.parametrize("size", [24, 37])
def test_generate_rays_agree(both, size):
    (_, jc, jf), (_, tc, tf) = both
    jf = jf.replace(width=size, height=size + 3)
    tf = Film(fov=tf.fov, width=size, height=size + 3)
    n = jf.num_pixels
    pix = np.tile(np.arange(n, dtype=np.int32), 2)
    spp = np.repeat(np.arange(2, dtype=np.int32), n) + 4
    jo, jd = j_generate_rays(jc, jf, jnp.asarray(pix),
                             j_strat(3, jnp.asarray(pix), jnp.asarray(spp)))
    to, td = generate_rays(tc, tf, torch.from_numpy(pix),
                           stratified_jitter(3, torch.from_numpy(pix),
                                             torch.from_numpy(spp)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


# a sphere is refused only where the JAX builder would index it with a
# sphere BVH4 (256 or more with an accelerator), a mirror only with a
# texture; planes, disks, boxes and tori are refused outright
UNPORTED = {
    "sphere": "OBJECT SPHERE\nRADIUS 0.1\nCENTER 0 0 0\nMATERIAL m\n"
              * 256,
    "mirror": "MATERIAL MIRROR\nNAME m\nTEXTURE x.png\nEND\n",
    "plane": "OBJECT PLANE\nPOINT 0 0 0\nNORMAL 0 1 0\nMATERIAL m\n",
    "disk": "OBJECT DISK\nCENTER 0 0 0\nNORMAL 0 1 0\nRADIUS 1\n"
            "MATERIAL m\n",
    "box": "OBJECT BOX\nLENGTH 1\nHEIGHT 1\nWIDTH 1\nMATERIAL m\n",
    "torus": "OBJECT TORUS\nSWEPT_RADIUS 1\nTUBE_RADIUS 0.2\nMATERIAL m\n",
    "mesh": "OBJECT MESH\nFILE x.obj\nMATERIAL FROM_MTL\n",
    "texture env": "ENV_LIGHT\nTYPE TEXTURE\nCOLOR x.exr\nINTENSITY 1\n",
}


@pytest.mark.parametrize("feature", sorted(UNPORTED))
def test_unported_features_raise(tmp_path, feature):
    p = tmp_path / "scene.txt"
    p.write_text(UNPORTED[feature])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_scene_file(str(p), device="cpu")


def test_gate_admits_cornell_and_refuses_the_rest(both):
    _, (ts, tc, tf) = both
    assert production_fast_shade(ts, tc, tf) == "bounce"
    # depth 31 leaves K1's 32-bit alive bitmask: the per-bounce route
    assert production_fast_shade(ts, tc, tf, max_depth=31) == "shade"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        production_fast_shade(ts, tc, tf, estimator="mis")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        production_fast_shade(ts, dataclasses.replace(tc, camera_type=1), tf)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        production_fast_shade(_with_plane(ts), tc, tf)


def _with_plane(scene):
    """The scene plus one plane: planes wait for the next K1/K2 gate
    item."""
    return dataclasses.replace(scene, planes=T.Planes(
        point=torch.zeros((1, 3)), normal=torch.tensor([[0.0, 1.0, 0.0]]),
        mat_id=torch.zeros(1, dtype=torch.int32)))


ENTRIES = ["render_sample", "fused_pass", "fused_pass_reference"]


@pytest.mark.parametrize("entry,refused", [
    ("render_sample", "estimator"),
    *[(e, r) for e in ENTRIES for r in ("thin-lens", "plane", "depth")]])
def test_every_entry_refuses_outside_the_gate(both, entry, refused):
    """Each entry point asks the gate (integrator/gate.py) before it traces
    anything: a refused scene raises and never reaches the plain tracer.
    Depth 31 is outside K1's gate only: K1's entries refuse it, while
    render_sample traces it per bounce (the "shade" route)."""
    _, (ts, tc, tf) = both
    depth, est = 2, "reference"
    if (entry, refused) == ("render_sample", "depth"):
        pix = torch.arange(16, dtype=torch.int32)
        out = render_sample(ts, tc, tf, pix, 0, 0, 31, est)
        assert out.shape == (16, 3) and bool(torch.isfinite(out).all())
        return
    if refused == "estimator":
        est = "mis"
    elif refused == "thin-lens":
        tc = dataclasses.replace(tc, camera_type=1)
    elif refused == "plane":
        ts = _with_plane(ts)
    else:
        depth = 31
    pix = torch.arange(16, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if entry == "render_sample":
            render_sample(ts, tc, tf, pix, 0, 0, depth, est)
        else:
            fn = fused_pass if entry == "fused_pass" else fused_pass_reference
            fn(ts, tc, tf, pix, 0, 0, depth)
