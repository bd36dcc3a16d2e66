"""scenes/parity_cornell.txt through both packages' parsers and builders:
every Scene leaf equal (dtype, shape, bits), the interop carry-over equal
to the port's own parse, the camera and film equal, and generate_rays
agreeing to 1e-6, for the pinhole and the thin-lens camera. Also the
port's refusals of what it does not cover yet."""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.camera import generate_rays as j_generate_rays
from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.sampling import uniforms as j_uniforms
from craytracer_tpu.sampling.multijitter import stratified_jitter as j_strat
from craytracer_tpu_torch.camera import THINLENS, Film, generate_rays
from craytracer_tpu_torch.integrator.pass_kernel import (
    fused_pass, fused_pass_reference, production_fast_shade)
from craytracer_tpu_torch.integrator.wavefront import (camera_rays,
                                                      render_sample)
from craytracer_tpu_torch.interop import (camera_from_numpy, film_from_numpy,
                                          numpy_leaves, scene_from_numpy)
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter
from craytracer_tpu_torch.scene import types as T
from craytracer_tpu_torch.scene.build import SceneBuilder

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


@pytest.mark.parametrize("size", [24, 37])
def test_thinlens_rays_agree(both, size):
    """Thin-lens rays with the lens samples render_sample takes
    (CAMERA_BOUNCE dims 2-3): the port's camera_rays against JAX's
    generate_rays(..., lens_u)."""
    (_, jc, jf), (_, tc, tf) = both
    jc, tc = jc.replace(camera_type=1), _thin(tc)
    jf = jf.replace(width=size, height=size + 3)
    tf = Film(fov=tf.fov, width=size, height=size + 3)
    n = jf.num_pixels
    pix = np.tile(np.arange(n, dtype=np.int32), 2)
    spp = np.repeat(np.arange(2, dtype=np.int32), n) + 4
    jp, js_ = jnp.asarray(pix), jnp.asarray(spp)
    jo, jd = j_generate_rays(jc, jf, jp, j_strat(3, jp, js_),
                             j_uniforms(3, jp, js_, 0x7FFF, 2, 2))
    tp, ts_ = torch.from_numpy(pix), torch.from_numpy(spp)
    to, td = camera_rays(tc, tf, tp, 3, ts_, stratified_jitter(3, tp, ts_))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    assert np.abs(np.asarray(jo) - np.asarray(jc.position)).max() > 0.01


# 256 or more spheres with an accelerator get the sphere BVH4, as in the
# JAX builder, and take the "shade" route beside a rect lamp
SHADE = {
    "sphere": "OBJECT SPHERE\nRADIUS 0.1\nCENTER 0 0 0\nMATERIAL m\n"
              * 256 + "MATERIAL EMISSIVE\nNAME lamp\nINTENSITY 5\nEND\n"
              "OBJECT RECTANGLE\nPOINT 0 2 0\nWIDTH 1 0 0\nHEIGHT 0 0 1\n"
              "MATERIAL lamp\n",
}
# disk, point and directional lights take the general route
# (tests/test_torch_general.py holds it against the JAX package); so do
# the slice-E blocks, whose missing files are dropped as the JAX parser
# drops them (a texture id of -1, a white constant env, no mesh)
GENERAL = {
    "mirror": "MATERIAL MIRROR\nNAME m\nTEXTURE x.png\nEND\n",
    "textured matte": "MATERIAL MATTE\nNAME m\nTEXTURE x.png\nEND\n",
    "mesh": "OBJECT MESH\nFILE x.obj\nMATERIAL FROM_MTL\n",
    "texture env": "ENV_LIGHT\nTYPE TEXTURE\nCOLOR x.exr\nINTENSITY 1\n",
    "disk light": "MATERIAL EMISSIVE\nNAME lamp\nINTENSITY 5\nEND\n"
                  "OBJECT DISK\nCENTER 0 1 0\nNORMAL 0 -1 0\nRADIUS 1\n"
                  "MATERIAL lamp\n",
    "point light": "POINT_LIGHT\nPOINT 0 2 0\nINTENSITY 3\n",
    "directional light": "DIRECTIONAL_LIGHT\nDIRECTION 0 1 0\n",
}


@pytest.mark.parametrize("feature", sorted(SHADE) + sorted(GENERAL))
def test_unported_features_raise(tmp_path, feature):
    """What the general route renders gets "general"; 256 spheres get
    the sphere BVH4 and "shade"."""
    p = tmp_path / "scene.txt"
    p.write_text({**SHADE, **GENERAL}[feature])
    scene, camera, film = load_scene_file(str(p), device="cpu")
    route = "general" if feature in GENERAL else "shade"
    assert production_fast_shade(scene, camera, film) == route
    assert (scene.sph_bvh is not None) == (feature in SHADE)


def test_gate_admits_cornell_and_refuses_the_rest(both):
    _, (ts, tc, tf) = both
    assert production_fast_shade(ts, tc, tf) == "bounce"
    # depth 31 leaves K1's 32-bit alive bitmask: the per-bounce route
    assert production_fast_shade(ts, tc, tf, max_depth=31) == "shade"
    # a plane and a thin-lens camera stay in K1's gate
    assert production_fast_shade(_with_plane(ts), _thin(tc), tf) == "bounce"
    # the MIS estimator runs on the general step only
    assert production_fast_shade(ts, tc, tf, estimator="mis") == "general"
    with pytest.raises(NotImplementedError, match="PINHOLE and THINLENS"):
        production_fast_shade(ts, dataclasses.replace(tc, camera_type=2), tf)
    # no kernel shades an anisotropic microfacet
    assert production_fast_shade(_anisotropic(ts), tc, tf) == "general"


def _thin(camera):
    return dataclasses.replace(camera, camera_type=THINLENS)


def _with_plane(scene):
    """The scene plus one ground plane, a row of K1's table."""
    return dataclasses.replace(scene, planes=T.Planes(
        point=torch.zeros((1, 3)), normal=torch.tensor([[0.0, 1.0, 0.0]]),
        mat_id=torch.zeros(1, dtype=torch.int32)))


def _anisotropic(_scene):
    """A small scene with an anisotropic metal, which the JAX package
    renders on XLA only, so the port takes the general route."""
    b = SceneBuilder()
    b.add_metal("gold", "GOLD", 0.1)
    b.add_rect((0, 0, 0), (1, 0, 0), (0, 0, 1), "gold")
    b.add_emissive("lamp", (1, 1, 1), 4.0)
    b.add_rect((0, 1, 0), (1, 0, 0), (0, 0, 1), "lamp")
    aniso = b.build(device="cpu")
    m = aniso.materials
    return dataclasses.replace(aniso, materials=dataclasses.replace(
        m, alphay=m.alphax * 2.0), microfacet_iso_beckmann=False)


ENTRIES = ["render_sample", "fused_pass", "fused_pass_reference"]


@pytest.mark.parametrize("entry,refused", [
    ("render_sample", "estimator"),
    *[(e, r) for e in ENTRIES for r in ("camera", "anisotropic", "depth")]])
def test_every_entry_refuses_outside_the_gate(both, entry, refused):
    """Each entry point asks the gate (integrator/gate.py) before it traces
    anything: a refused scene raises and never reaches the plain tracer.
    Depth 31, an anisotropic metal and the MIS estimator are outside K1's
    gate only: K1's entries refuse them, while render_sample traces them
    per bounce (the "shade" and "general" routes)."""
    _, (ts, tc, tf) = both
    depth, est = 2, "reference"
    if entry == "render_sample" and refused != "camera":
        pix = torch.arange(16, dtype=torch.int32)
        if refused == "depth":
            out = render_sample(ts, tc, tf, pix, 0, 0, 31, est)
        elif refused == "estimator":
            out = render_sample(ts, tc, tf, pix, 0, 0, 2, "mis")
        else:
            out = render_sample(_anisotropic(ts), tc, tf, pix, 0, 0, 2, est)
        assert out.shape == (16, 3) and bool(torch.isfinite(out).all())
        return
    if refused == "camera":
        tc = dataclasses.replace(tc, camera_type=2)
    elif refused == "anisotropic":
        ts = _anisotropic(ts)
    else:
        depth = 31
    pix = torch.arange(16, dtype=torch.int32)
    match = "PINHOLE and THINLENS" if refused == "camera" else "ROADMAP"
    with pytest.raises(NotImplementedError, match=match):
        if entry == "render_sample":
            render_sample(ts, tc, tf, pix, 0, 0, depth, est)
        else:
            fn = fused_pass if entry == "fused_pass" else fused_pass_reference
            fn(ts, tc, tf, pix, 0, 0, depth)
