"""Gradients through the port on scenes tests/test_grad.py does not
cover, against `jax.grad` of the JAX package on the same inputs (carried
by craytracer_tpu_torch.interop), with tests/test_torch_grad.py's bars:

- a sphere centre and the camera position with an instanced AABOX in the
  scene: finite, as JAX's are, and JAX's to 1e-4 (the instanced fill
  picks the box face on detached values, the Newton step divides by a
  detached derivative);
- a 320-triangle bvh4 icosphere moved by an offset (its vertex columns),
  the search through the plain traversal, to 1e-4;
- the inverse mesh demo's scene (craytracer_tpu_torch/examples/
  inverse_mesh_demo.py, built by the port equal to the JAX demo's) at
  16x16 under MIS, the alpha and texel gradients of the MSE at the
  starting guess, to 1e-5 (texels within 1e-5 of the largest).

Each JAX gradient is computed once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.camera import make_camera as j_make_camera
from craytracer_tpu.integrator.wavefront import render_sample as j_render
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.integrator.wavefront import render_sample
from craytracer_tpu_torch.interop import (camera_from_numpy, numpy_leaves,
                                          scene_from_numpy, with_grad)
from test_torch_grad import (GEOMETRY, MATERIAL, _carry, _film, _j_loss,
                             _metal_scene, _set_row, _t_loss)
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401

torch.set_num_threads(2)
pytestmark = SAH_WARNING_IS_ERROR


@pytest.fixture(scope="module")
def boxed():
    """The metal scene with one instanced AABOX: the sphere centre's and
    the camera position's gradients."""
    js, _ = _metal_scene(JBuilder(), box=True)
    jc = j_make_camera((0.0, 15.0, 40.0), (0.0, 5.0, 0.0))
    jf, tf = _film(16, 45.0)
    ts, tc = _carry(js, jc)

    def loss(c, pos):
        s = js.replace(spheres=js.spheres.replace(
            center=js.spheres.center.at[0].set(c)))
        return _j_loss(s, jc.replace(position=pos), jf)

    gj = jax.jit(jax.grad(loss, argnums=(0, 1)))(js.spheres.center[0],
                                                  jc.position)
    return ts, tc, tf, [np.asarray(x) for x in gj]


def test_instanced_box_grads_finite_and_match_jax(boxed):
    """The instanced fill picks the box face on detached values and the
    Newton step's derivative is detached: no 0 * inf cotangent, so the
    gradients are finite and JAX's to 1e-4."""
    ts, tc, tf, gj = boxed
    assert ts.instanced.kind.shape[0] == 1
    c = ts.spheres.center[0].clone().requires_grad_(True)
    cam, (pos,) = with_grad(tc, "position")
    s = dataclasses.replace(ts, spheres=dataclasses.replace(
        ts.spheres, center=_set_row(ts.spheres.center, 0, c)))
    gc, gp = torch.autograd.grad(_t_loss(s, cam, tf), [c, pos])
    for g, want in ((gc, gj[0]), (gp, gj[1])):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), want, rtol=GEOMETRY,
                                   atol=GEOMETRY * np.abs(want).max())


@pytest.fixture(scope="module")
def mesh_offset(jax_native):
    """A 320-triangle bvh4 icosphere on a floor: the gradient of the mean
    image with respect to an offset added to every vertex."""
    from craytracer_tpu_torch.scene.city import icosphere

    b = JBuilder()
    b.add_matte("floor", (0.6, 0.6, 0.6))
    b.add_matte("ball", (0.7, 0.3, 0.2))
    b.add_emissive("lamp", (1.0, 1.0, 1.0), 10.0)
    b.add_rect((-8, 0, -8), (16, 0, 0), (0, 0, 16), "floor")
    v, f = icosphere(2)
    c = np.array([0, 1.6, 0])
    b.add_triangles_array(1.5 * v[f[:, 0]] + c, 1.5 * v[f[:, 1]] + c,
                          1.5 * v[f[:, 2]] + c, "ball")
    b.add_rect((-1.5, 7, -1.5), (3, 0, 0), (0, 0, 3), "lamp")
    js = b.build(accel="bvh4")
    jc = j_make_camera((0.0, 5.0, 9.0), (0.0, 1.5, 0.0))
    jf, tf = _film(16, 40.0)
    ts, tc = _carry(js, jc)

    def loss(off):
        t = js.triangles
        s = js.replace(triangles=t.replace(v0=t.v0 + off, v1=t.v1 + off,
                                           v2=t.v2 + off))
        return _j_loss(s, jc, jf)

    return ts, tc, tf, np.asarray(jax.jit(jax.grad(loss))(
        jnp.zeros(3, jnp.float32)))


def test_bvh4_mesh_vertex_grad_matches_jax(mesh_offset):
    """Vertices of a bvh4 mesh: the search walks the (detached) table with
    the plain traversal, the triangle fill re-derives t, uv and the
    barycentrics from the vertex columns."""
    ts, tc, tf, gj = mesh_offset
    assert ts.accel == "bvh4" and ts.tri_bvh is not None
    off = torch.zeros(3, requires_grad=True)
    t = ts.triangles
    s = dataclasses.replace(ts, triangles=dataclasses.replace(
        t, v0=t.v0 + off, v1=t.v1 + off, v2=t.v2 + off))
    (g,) = torch.autograd.grad(_t_loss(s, tc, tf), [off])
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0.0
    np.testing.assert_allclose(g.numpy(), gj, rtol=GEOMETRY,
                               atol=GEOMETRY * np.abs(gj).max())


@pytest.fixture
def flush_denormals():
    """XLA:CPU flushes denormals; the MIS NEE's grazing microfacet terms
    underflow (tests/test_torch_mis.py)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def demo_scene(jax_native):
    """The inverse mesh demo's scene (examples/inverse_mesh_demo.py) at
    16x16, MIS, depth 2, 2 spp: the JAX gradients of the MSE against the
    true scene's render, with respect to alpha and the 64x64 texels at
    the starting guess."""
    import os
    import sys

    from craytracer_tpu_torch.examples import inverse_mesh_demo as demo

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes"))
    from make_fixtures import icosphere as j_icosphere

    tex = demo.checker(64)
    b = JBuilder()
    tid = b.add_texture("floor_tex", tex)
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
    jf, tf = _film(16, demo.FOV_DEG)
    ids = jnp.arange(256, dtype=jnp.int32)
    t0 = int(np.asarray(js.textures.offset)[0])

    def graft(p):
        tx = jax.lax.dynamic_update_slice(js.textures.texels, p["texels"],
                                          (t0, 0))
        m = js.materials
        return js.replace(materials=m.replace(
            alphax=m.alphax.at[mid].set(p["alpha"]),
            alphay=m.alphay.at[mid].set(p["alpha"])),
            textures=js.textures.replace(texels=tx))

    def img(s, spp0):
        return sum(j_render(s, jc, jf, ids, 7, spp0 + k, 2, estimator="mis")
                   for k in range(2)) / 2

    target = jax.jit(lambda p: img(graft(p), 10))(
        {"texels": jnp.asarray(tex.reshape(-1, 3)),
         "alpha": jnp.float32(0.35)})
    p0 = {"texels": jnp.full((64 * 64, 3), 0.4, jnp.float32),
          "alpha": jnp.float32(0.6)}
    gj = jax.jit(jax.grad(lambda p: jnp.mean(
        (img(graft(p), 0) - target) ** 2)))(p0)
    return js, jc, tf, mid, np.asarray(target), gj


def test_demo_scene_grads_match_jax(demo_scene, flush_denormals):
    """The port's demo builder makes the JAX demo's scene (every tensor
    equal), and the port's alpha and texel gradients under MIS equal
    JAX's: alpha at rtol 1e-5, every texel within 1e-5 of the largest."""
    from craytracer_tpu_torch.examples import inverse_mesh_demo as demo

    js, jc, tf, mid, target, gj = demo_scene
    ts, tmid = demo.build(demo.checker(64), device="cpu")
    assert tmid == mid
    carried = scene_from_numpy(numpy_leaves(js))
    for f in dataclasses.fields(carried):
        a, b = getattr(carried, f.name), getattr(ts, f.name)
        if dataclasses.is_dataclass(a):
            for g in dataclasses.fields(a):
                x, y = getattr(a, g.name), getattr(b, g.name)
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x, y), (f.name, g.name)
    tc = camera_from_numpy(numpy_leaves(jc))
    apply_fn = demo.grafter(ts, mid)
    p = {"texels": torch.full((64 * 64, 3), 0.4, requires_grad=True),
         "alpha": torch.tensor(0.6, requires_grad=True)}
    ids = torch.arange(256, dtype=torch.int32)
    s = apply_fn(ts, p)
    img = sum(render_sample(s, tc, tf, ids, 7, k, 2, estimator="mis")
              for k in range(2)) / 2
    diff = img - torch.from_numpy(np.array(target))
    torch.mean(diff * diff).backward()
    ga, gt = float(p["alpha"].grad), p["texels"].grad.numpy()
    want_t = np.asarray(gj["texels"])
    assert np.isfinite(ga) and np.isfinite(gt).all() and ga != 0.0
    assert (gt != 0).any()
    np.testing.assert_allclose(ga, float(gj["alpha"]), rtol=MATERIAL)
    np.testing.assert_allclose(gt, want_t, rtol=MATERIAL,
                               atol=MATERIAL * np.abs(want_t).max())
