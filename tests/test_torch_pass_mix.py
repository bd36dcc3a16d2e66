"""Whole passes over spheres and every material type: the port's plain
`trace_paths` (craytracer_tpu_torch/integrator/wavefront.py, K1's and the
"shade" route's plain version) against the JAX package's XLA
`trace_paths` on the same camera rays, at 32x32 with the depths of the
JAX package's own fused-path tests, on its four sphere scenes
(tests/test_pallas_shade.py :79-91 mirror and clipped sphere, :136-142
sphere light, :212-226 Oren-Nayar / plastic / mirror / metal, :259-267
glass / transparent; built here through both packages' builders from
torch_sphere_scenes.py) and on scenes/parity_mix.txt at depth 5.

Bar, as those tests: L within 5e-5 (rtol and atol), good, rays and
shadow rays exact. Measured at these settings: every lane's good equal,
max |dL| 2.3e-5 (glass), counters identical. A Fresnel or lobe pick
(r_extra <= Fr, u >= 0.5) an ulp apart between XLA:CPU and torch could
send one lane down another path; none did here, so no lane is
excused."""

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
from craytracer_tpu_torch.integrator.wavefront import trace_paths
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.scene.build import SceneBuilder

import torch_sphere_scenes as sphere_scenes

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIX = os.path.join(REPO, "scenes", "parity_mix.txt")
SIZE = 32


def _scenes(name):
    """(JAX scene, port scene, JAX camera, JAX film, depth)."""
    if name == "parity_mix":
        js, jc, jf = j_load(MIX)
        ts, _, _ = load_scene_file(MIX, device="cpu")
        return js, ts, jc, jf.replace(width=SIZE, height=SIZE), 5
    jb, tb = JBuilder(), SceneBuilder()
    eye, look, fov, depth = sphere_scenes.SCENES[name](jb)
    sphere_scenes.SCENES[name](tb)
    return (jb.build(), tb.build(device="cpu"), j_make_camera(eye, look),
            JFilm(fov=jnp.float32(fov), width=SIZE, height=SIZE), depth)


@pytest.mark.parametrize("name", [*sphere_scenes.SCENES, "parity_mix"])
def test_plain_pass_matches_xla(name):
    js, ts, jc, jf, depth = _scenes(name)
    pix = jnp.arange(SIZE * SIZE, dtype=jnp.int32)
    o, d = j_generate_rays(jc, jf, pix, j_uniforms(0, pix, 0, 0x7FFF, 2, 0))
    Lr, goodr, mr = j_trace(js, o, d, 0, pix, 0, depth, with_metrics=True)
    L, good, m = trace_paths(ts, torch.tensor(np.asarray(o)),
                             torch.tensor(np.asarray(d)), 0,
                             torch.tensor(np.asarray(pix)), 0, depth,
                             with_metrics=True)
    Lr = np.asarray(Lr)
    np.testing.assert_allclose(L.numpy(), Lr, rtol=5e-5, atol=5e-5)
    np.testing.assert_array_equal(good.numpy(), np.asarray(goodr))
    assert int(m["rays"]) == int(mr["rays"])
    assert int(m["shadow_rays"]) == int(mr["shadow_rays"])
    np.testing.assert_array_equal(m["bounce_live"].numpy(),
                                  np.asarray(mr["bounce_live"]))
    assert Lr.mean() > 0.05 and int(mr["shadow_rays"]) > 0
