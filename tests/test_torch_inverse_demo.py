"""The albedo-recovery demo (craytracer_tpu_torch/examples/inverse_demo.py)
against the JAX package's (examples/inverse_demo.py, its scene and
InverseRenderer rebuilt here as its main builds them): the same scene
rows, target and starting guess, then the first 3 steps of both
InverseRenderers at 16x16 (physical estimator, depth 3, Adam at 0.04,
the clip to [0.02, 1]): every step's loss and gradient norm and both
albedo rows within slice G's bar for material leaves, rtol 1e-5. Then
the demo's command line on the CPU: 2 steps, the PNG written.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.camera import Film as JFilm
from craytracer_tpu.camera import make_camera as j_make_camera
from craytracer_tpu.integrator.wavefront import render_sample as j_render
from craytracer_tpu.inverse import InverseConfig as JConfig
from craytracer_tpu.inverse import InverseRenderer as JInverse
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.examples import inverse_demo as demo
from craytracer_tpu_torch.io.teximage import read_png

torch.set_num_threads(2)
SIZE, STEPS = 16, 3
MATERIAL = 1e-5  # slice G's rtol for material leaves


def _j_build(back_albedo, sphere_albedo):
    """examples/inverse_demo.py's `build`, on the JAX builder."""
    b = JBuilder()
    b.add_matte("floor", (0.73, 0.73, 0.73))
    i_back = b.add_matte("back", tuple(back_albedo))
    i_ball = b.add_matte("ball", tuple(sphere_albedo))
    b.add_emissive("light", (1.0, 0.95, 0.85), 18.0)
    b.add_rect((-3, 0, -3), (6, 0, 0), (0, 0, 6), "floor")
    b.add_rect((-3, 0, -2), (6, 0, 0), (0, 3.5, 0), "back")
    b.add_sphere((0.0, 0.8, 0.3), 0.7, "ball")
    b.add_rect((-1, 3.2, -1), (2, 0, 0), (0, 0, 2), "light")
    return b.build(), i_back, i_ball


@pytest.fixture(scope="module")
def jax_demo():
    """The JAX demo's target and its InverseRenderer's first steps."""
    scene_t, i_back, i_ball = _j_build(demo.TARGET_BACK, demo.TARGET_BALL)
    scene_0, _, _ = _j_build(demo.GUESS, demo.GUESS)
    cam = j_make_camera(demo.EYE, demo.LOOK)
    film = JFilm(fov=jnp.float32(np.radians(demo.FOV_DEG)), width=SIZE,
                 height=SIZE)
    ids = jnp.arange(film.num_pixels, dtype=jnp.int32)
    target = sum(j_render(scene_t, cam, film, ids, 7, s, 3,
                          estimator="physical") for s in range(4)) / 4
    params0 = (scene_0.materials.color[i_back],
               scene_0.materials.color[i_ball])

    def apply_fn(scene, p):
        back, ball = p
        col = scene.materials.color.at[i_back].set(back).at[i_ball].set(ball)
        return scene.replace(materials=scene.materials.replace(color=col))

    def clip_fn(p):
        return tuple(jnp.clip(x, 0.02, 1.0) for x in p)

    inv = JInverse(scene_0, cam, film, target, params0, apply_fn,
                   JConfig(learning_rate=0.04, max_depth=3), seed=7,
                   clip_fn=clip_fn)
    steps = []
    for _ in range(STEPS):
        rec = inv.step()
        steps.append((rec, [np.asarray(x) for x in inv.params]))
    return (i_back, i_ball), np.asarray(target), steps


def test_demo_scene_and_target_match_jax(jax_demo):
    rows, target, _ = jax_demo
    d = demo.demo(SIZE, device="cpu")
    assert d["rows"] == rows
    assert d["config"].estimator == "physical" and d["config"].max_depth == 3
    np.testing.assert_allclose(d["target"].numpy(), target, rtol=MATERIAL,
                               atol=1e-7)
    for p in d["params0"]:
        np.testing.assert_array_equal(p.numpy(), np.float32(demo.GUESS))


def test_demo_first_steps_match_jax(jax_demo):
    """3 steps of the port's demo InverseRenderer against the JAX demo's:
    loss, gradient norm, both albedo rows."""
    _, target, steps = jax_demo
    d = demo.demo(SIZE, device="cpu")
    d["target"] = torch.from_numpy(np.array(target))
    inv = demo.renderer(d)
    for k, (jrec, jparams) in enumerate(steps):
        rec = inv.step()
        np.testing.assert_allclose(rec, jrec, rtol=MATERIAL,
                                   err_msg=f"step {k + 1}")
        for got, want in zip(inv.params, jparams):
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       rtol=MATERIAL, atol=1e-7,
                                       err_msg=f"step {k + 1}")
    assert inv.updates == STEPS and inv.nan_steps == 0


def test_demo_command_line(tmp_path, capsys):
    out = tmp_path / "panel.png"
    inv = demo.main(["--device", "cpu", "--steps", "2", "--size", "8",
                     "--out", str(out)])
    img = read_png(str(out))
    assert img.shape == (8 * 4, 8 * 3 * 4, 3) and img.max() > 0
    text = capsys.readouterr().out
    assert "recovered back wall" in text and "recovered sphere" in text
    assert len(inv.history) == 2 and all(np.isfinite(h[0])
                                         for h in inv.history)
