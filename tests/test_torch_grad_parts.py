"""Gradients through the parts route: the inverse mesh demo's scene
(craytracer_tpu_torch/examples/inverse_mesh_demo.py: a 320-triangle
bvh4 icosphere in gold on a 64x64 textured floor under a rect lamp) with
its bvh4 table cut into parts, the port's part budget monkeypatched
(never the JAX package's), against `jax.grad` of the same loss on the
JAX package's uncut scene.

The port takes its gradient with the search on the parts route
(`render_sample(kernels=True)`: on CPU tensors the wrappers' plain
versions, the part sort and the per-part walks with the carried hit, the
shadow any hit per part), detached as on the whole table. The loss: the
MSE of one 16x16 pass (physical estimator, depth 2) against a seeded
image, with
respect to the floor's texels, the ball's roughness (alphax and alphay),
the lamp's intensity, the camera position and an offset added to every
vertex. Bars (slice G's): 1e-5 for the material, light and texel leaves
(texels within 1e-5 of the largest), 1e-4 for camera and geometry. Every
bounce's hit group, triangle id and t through the parts equal the uncut
search's, bit for bit, and so do the loss and every gradient.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.camera import make_camera as j_make_camera
from craytracer_tpu.integrator.wavefront import render_sample as j_render
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.accel import bvh4_parts
from craytracer_tpu_torch.camera import make_camera
from craytracer_tpu_torch.examples import inverse_mesh_demo as demo
from craytracer_tpu_torch.integrator import wavefront as wf
from craytracer_tpu_torch.scene import types as T
from test_torch_grad import GEOMETRY, MATERIAL, _film
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401

torch.set_num_threads(2)
pytestmark = SAH_WARNING_IS_ERROR
SIZE, DEPTH, SEED = 16, 2, 7
P0 = {"alpha": 0.6, "intensity": 8.0}
NAMES = ("alpha", "intensity", "offset", "position", "texels")


def _target():
    return np.random.default_rng(5).uniform(
        0.0, 0.6, (SIZE * SIZE, 3)).astype(np.float32)


def _graft(s, cam, p, mid, t0, stack):
    """The scene and camera with the leaves of `p` in place, out of place
    (JAX's .at[].set or the port's torch.where / torch.cat)."""
    m, lt, tr, tx = s.materials, s.lights, s.triangles, s.textures
    if stack is jnp:
        texels = jax.lax.dynamic_update_slice(tx.texels, p["texels"],
                                              (t0, 0))
        alphax = m.alphax.at[mid].set(p["alpha"])
        alphay = m.alphay.at[mid].set(p["alpha"])
        intensity = lt.intensity.at[0].set(p["intensity"])
    else:
        n = p["texels"].shape[0]
        texels = torch.cat([tx.texels[:t0], p["texels"], tx.texels[t0 + n:]])
        row = torch.arange(m.alphax.shape[0])
        alphax = torch.where(row == mid, p["alpha"], m.alphax)
        alphay = torch.where(row == mid, p["alpha"], m.alphay)
        intensity = torch.where(torch.arange(lt.intensity.shape[0]) == 0,
                                p["intensity"], lt.intensity)
    off = p["offset"]
    s = dataclasses.replace(
        s, materials=dataclasses.replace(m, alphax=alphax, alphay=alphay),
        lights=dataclasses.replace(lt, intensity=intensity),
        triangles=dataclasses.replace(tr, v0=tr.v0 + off, v1=tr.v1 + off,
                                      v2=tr.v2 + off),
        textures=dataclasses.replace(tx, texels=texels))
    return s, dataclasses.replace(cam, position=p["position"])


@pytest.fixture(scope="module")
def jax_grads(jax_native):  # noqa: F811
    """The JAX demo scene, uncut, and jax.grad of the loss at the
    starting guess."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes"))
    from make_fixtures import icosphere as j_icosphere

    b = JBuilder()
    tid = b.add_texture("floor_tex", demo.checker(64))
    b.add_matte("floor", (1.0, 1.0, 1.0), diffuse_tex=tid)
    mid = b.add_metal("ball", preset="GOLD", roughness=0.2)
    b.add_emissive("lamp", (1.0, 0.95, 0.85), 8.0)
    b.add_rect((-5, 0, -5), (10, 0, 0), (0, 0, 10), "floor")
    v, f = j_icosphere(2)
    c = np.array([0, 1.6, 0])
    b.add_triangles_array(1.5 * v[f[:, 0]] + c, 1.5 * v[f[:, 1]] + c,
                          1.5 * v[f[:, 2]] + c, "ball")
    b.add_rect((-1.5, 7, -1.5), (3, 0, 0), (0, 0, 3), "lamp")
    js = b.build(accel="bvh4")
    jc = j_make_camera(demo.EYE, demo.LOOK)
    jf, _ = _film(SIZE, demo.FOV_DEG)
    ids = jnp.arange(SIZE * SIZE, dtype=jnp.int32)
    t0 = int(np.asarray(js.textures.offset)[0])
    target = jnp.asarray(_target())

    def loss(p):
        s, cam = _graft(js, jc, p, mid, t0, jnp)
        img = j_render(s, cam, jf, ids, SEED, 0, DEPTH, estimator="physical")
        return jnp.mean((img - target) ** 2)

    p0 = {"texels": jnp.full((64 * 64, 3), demo.TEXEL0, jnp.float32),
          "alpha": jnp.float32(P0["alpha"]),
          "intensity": jnp.float32(P0["intensity"]),
          "position": jnp.asarray(jc.position),
          "offset": jnp.zeros(3, jnp.float32)}
    val, g = jax.jit(jax.value_and_grad(loss))(p0)
    return mid, float(val), {k: np.asarray(v) for k, v in g.items()}


def _port_grad(scene, mid, kernels, monkeypatch):
    """(loss, {name: gradient}, [(group, prim, t) per bounce]) of the
    port's loss, the hits recorded as the trace takes them."""
    cam = make_camera(demo.EYE, demo.LOOK, device="cpu")
    _, film = _film(SIZE, demo.FOV_DEG)
    p = {"texels": torch.full((64 * 64, 3), demo.TEXEL0),
         "alpha": torch.tensor(P0["alpha"]),
         "intensity": torch.tensor(P0["intensity"]),
         "position": cam.position.clone(), "offset": torch.zeros(3)}
    for x in p.values():
        x.requires_grad_(True)
    hits, closest = [], wf._closest_hit

    def record(*a, **k):
        hit = closest(*a, **k)
        hits.append((hit.group.clone(), hit.prim.clone(),
                     hit.t.detach().clone()))
        return hit

    monkeypatch.setattr(wf, "_closest_hit", record)
    s, c = _graft(scene, cam, p, mid, int(scene.textures.offset[0]), torch)
    img = wf.render_sample(s, c, film, torch.arange(SIZE * SIZE,
                                                    dtype=torch.int32),
                           SEED, 0, DEPTH, estimator="physical",
                           kernels=kernels)
    diff = img - torch.from_numpy(_target())
    loss = torch.mean(diff * diff)
    grads = torch.autograd.grad(loss, [p[k] for k in NAMES])
    monkeypatch.undo()
    return loss.detach(), dict(zip(NAMES, grads)), hits


@pytest.fixture(scope="module")
def scenes():
    """The port's demo scene uncut, and cut into parts under a budget of
    a third of its table."""
    whole, mid = demo.build(demo.checker(64), device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(bvh4_parts, "PART_BUDGET_BYTES",
               whole.tri_bvh.fat.numel() * 4 // 3)
    try:
        cut, mid_cut = demo.build(demo.checker(64), device="cpu")
    finally:
        mp.undo()
    assert mid_cut == mid
    return whole, cut, mid


@pytest.fixture(scope="module")
def port_grads(scenes):
    """The port's loss, gradients and hits through the parts route and
    through the uncut plain search."""
    whole, cut, mid = scenes
    mp = pytest.MonkeyPatch()
    try:
        return (_port_grad(cut, mid, True, mp),
                _port_grad(whole, mid, False, mp))
    finally:
        mp.undo()


def test_parts_route_hits_equal_uncut(scenes, port_grads):
    """At least 3 parts; every bounce's hit group, triangle id and t
    through the parts bit-equal with the uncut search's; the loss and
    every gradient too."""
    whole, cut, _ = scenes
    assert whole.tri_parts is None and len(cut.tri_parts) >= 3
    assert torch.equal(cut.tri_bvh.fat, whole.tri_bvh.fat)
    (loss, g, hits), (loss_w, g_w, hits_w) = port_grads
    assert len(hits) == len(hits_w) == DEPTH + 1
    for (ga, pa, ta), (gb, pb, tb) in zip(hits, hits_w):
        assert torch.equal(ga, gb) and torch.equal(pa, pb)
        assert torch.equal(ta, tb)
    assert int((hits[0][0] == T.GROUP_TRIANGLE).sum()) > 0
    assert torch.equal(loss, loss_w)
    for k in NAMES:
        assert torch.equal(g[k], g_w[k]), k


@pytest.mark.parametrize("name", NAMES)
def test_parts_route_grad_matches_jax(scenes, port_grads, jax_grads, name):
    """The gradient through the parts route against jax.grad on the uncut
    JAX scene: the loss and material, light and texel leaves at 1e-5,
    camera and geometry at 1e-4."""
    (loss, g, _), _ = port_grads
    jmid, jloss, gj = jax_grads
    assert jmid == scenes[2]
    np.testing.assert_allclose(float(loss), jloss, rtol=MATERIAL)
    got, want = g[name].numpy(), gj[name]
    rtol = GEOMETRY if name in ("offset", "position") else MATERIAL
    assert np.isfinite(got).all() and np.abs(got).max() > 0.0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())
