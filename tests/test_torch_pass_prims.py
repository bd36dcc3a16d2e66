"""Whole passes over planes, disks, instanced boxes and a thin-lens
camera, K1's new scenes: the port against the JAX package's XLA
`trace_paths` on the same pixels, at 24x24, depth 0, 2 and 5.

The plane/disk and the instanced-box scenes of
tests/test_pallas_shade.py :320-334 and :391-402 (torch_prim_scenes.py)
and scenes/parity_cornell.txt with a thin-lens camera (lens_radius 0.2,
focal_length 3.0) go through `fused_pass_reference`, K1's plain version,
with its own raygen (the plain CAMERA_BOUNCE jitter and, for the thin
lens, the lens samples of dims 2-3); JAX generates the rays with
`generate_rays(..., lens_u)` and traces them. Bar, as
test_torch_pass_mix.py: L within 5e-5, good, rays, shadow rays and the
live histogram exact (measured: every lane equal, max |dL| 7.7e-6).
parity_prims, the "shade" route's scene, is held the same way in
test_torch_parity_prims.py."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.camera import Film as JFilm
from craytracer_tpu.camera import generate_rays as j_generate_rays
from craytracer_tpu.camera import make_camera as j_make_camera
from craytracer_tpu.integrator.wavefront import trace_paths as j_trace
from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.sampling import uniforms as j_uniforms
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.camera import Film, make_camera
from craytracer_tpu_torch.integrator.gate import production_fast_shade
from craytracer_tpu_torch.integrator.pass_kernel import fused_pass_reference
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.scene.build import SceneBuilder

import torch_prim_scenes as prim_scenes

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SEED, SPP = 24, 0, 3


def _scenes(name):
    """(JAX scene, camera, film; port scene, camera, film) at SIZE."""
    if name in prim_scenes.SCENES:
        jb, tb = JBuilder(), SceneBuilder()
        eye, look, fov, _ = prim_scenes.SCENES[name](jb)
        prim_scenes.SCENES[name](tb)
        return (jb.build(), j_make_camera(eye, look),
                JFilm(fov=jnp.float32(fov), width=SIZE, height=SIZE),
                tb.build(device="cpu"), make_camera(eye, look),
                Film(fov=torch.tensor(fov), width=SIZE, height=SIZE))
    path = os.path.join(REPO, "scenes", "parity_cornell.txt"
                        if name == "thinlens_cornell" else "parity_prims.txt")
    js, jc, jf = j_load(path)
    ts, tc, tf = load_scene_file(path, device="cpu")
    if name == "thinlens_cornell":
        jc, tc = prim_scenes.thinlens(jc), prim_scenes.thinlens(tc)
    return (js, jc, jf.replace(width=SIZE, height=SIZE), ts, tc,
            Film(fov=tf.fov, width=SIZE, height=SIZE))


def _jax_pass(js, jc, jf, depth):
    pix = jnp.arange(SIZE * SIZE, dtype=jnp.int32)
    o, d = j_generate_rays(jc, jf, pix,
                           j_uniforms(SEED, pix, SPP, 0x7FFF, 2, 0),
                           j_uniforms(SEED, pix, SPP, 0x7FFF, 2, 2))
    L, good, m = j_trace(js, o, d, SEED, pix, SPP, depth, with_metrics=True)
    return o, d, (np.asarray(L), np.asarray(good),
                  {k: np.asarray(v) for k, v in m.items()})


@pytest.mark.parametrize("depth", [0, 2, 5])
@pytest.mark.parametrize("name", ["plane_disk", "aabox", "thinlens_cornell"])
def test_bounce_scene_pass_matches_xla(name, depth):
    js, jc, jf, ts, tc, tf = _scenes(name)
    assert production_fast_shade(ts, tc, tf) == "bounce"
    _, _, (Lr, goodr, mr) = _jax_pass(js, jc, jf, depth)
    pix = torch.arange(SIZE * SIZE, dtype=torch.int32)
    L, good, m = fused_pass_reference(ts, tc, tf, pix, SPP, SEED, depth,
                                      raygen="plain")
    np.testing.assert_allclose(L.numpy(), Lr, rtol=5e-5, atol=5e-5)
    np.testing.assert_array_equal(good.numpy(), goodr)
    for key in ("rays", "shadow_rays", "bounce_live"):
        np.testing.assert_array_equal(m[key].numpy(), mr[key], err_msg=key)
    assert depth == 0 or Lr.mean() > 0.05
