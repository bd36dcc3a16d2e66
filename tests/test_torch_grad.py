"""Gradients through the port (craytracer_tpu_torch: render_sample under
autograd takes the general step, its search detached, the fills
differentiable) against `jax.grad` of the JAX package on the same inputs,
carried by craytracer_tpu_torch.interop, and against the port's own
central differences.

The counterparts of tests/test_grad.py (all but test_multichip_dryrun):
albedo, lights.intensity, light colour, camera position, look point
(make_camera_torch against make_camera_jax), texel, metal roughness and
remat. Bars: rtol 1e-5 against jax.grad for material, light and texel
gradients; 1e-4 for camera and geometry gradients, where XLA:CPU's
multiply-add contraction into FMAs moves the hit distances (ROADMAP's
documented deviations); the central differences at test_grad.py's own
rtol.

Cases tests/test_grad.py lacks: a sphere centre and the camera position
with an instanced AABOX in the scene (finite, as JAX's are); a bvh4 mesh
moved by an offset, the search through the plain traversal; the inverse
mesh demo's scene at 16x16 under MIS for alpha and every texel; the tie
points of core/math.py against jax.grad of the JAX helpers; a gradient
on a scene K1 would take, which takes the general route and raises
nothing; the field of view's gradient on a scene K1 or the "shade" route
would take; remat against no remat and against JAX.

Each JAX gradient is computed once per module (a module-scoped fixture
per case).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.camera import Film as JFilm
from craytracer_tpu.camera import make_camera as j_make_camera
from craytracer_tpu.camera import make_camera_jax
from craytracer_tpu.integrator.wavefront import render_sample as j_render
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.camera import Film, make_camera_torch
from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.integrator.gate import production_fast_shade
from craytracer_tpu_torch.integrator.wavefront import (camera_rays,
                                                       render_sample,
                                                       trace_paths)
from craytracer_tpu_torch.interop import (camera_from_numpy, numpy_leaves,
                                          scene_from_numpy, with_grad)
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter

torch.set_num_threads(2)
MATERIAL = 1e-5  # rtol against jax.grad: material, light, texel
GEOMETRY = 1e-4  # rtol against jax.grad: camera and geometry
SEED = 3


def _film(size, deg):
    return (JFilm(fov=jnp.float32(np.deg2rad(deg)), width=size,
                  height=size),
            Film(fov=torch.tensor(np.float32(np.deg2rad(deg))), width=size,
                 height=size))


def _carry(js, jc):
    return (scene_from_numpy(numpy_leaves(js), device="cpu"),
            camera_from_numpy(numpy_leaves(jc), device="cpu"))


def _j_loss(scene, camera, film, depth=2, estimator="physical"):
    ids = jnp.arange(film.width * film.height, dtype=jnp.int32)
    return jnp.mean(j_render(scene, camera, film, ids, SEED, 0, depth,
                             estimator=estimator))


def _t_loss(scene, camera, film, depth=2, estimator="physical"):
    ids = torch.arange(film.num_pixels, dtype=torch.int32)
    return render_sample(scene, camera, film, ids, SEED, 0, depth,
                         estimator=estimator).mean()


def _set_row(t, i, v):
    """t with row i set to v, out of place (.at[i].set)."""
    return torch.index_put(t, (torch.tensor([i]),), v.reshape(
        (1,) + t.shape[1:]))


def _grad_fd(f, x0, eps):
    """(autograd df/dx at x0, central difference) of the port's f."""
    x = torch.tensor(np.float32(x0), requires_grad=True)
    (g,) = torch.autograd.grad(f(x), [x])
    with torch.no_grad():
        fd = (f(torch.tensor(np.float32(x0 + eps)))
              - f(torch.tensor(np.float32(x0 - eps)))) / (2 * eps)
    return float(g), float(fd)


# -- the counterparts of tests/test_grad.py ---------------------------------

def _simple_scene(b, textured=False):
    if textured:
        tex = np.linspace(0.2, 0.8, 4 * 4 * 3,
                          dtype=np.float32).reshape(4, 4, 3)
        b.add_matte("floor", (1.0, 1.0, 1.0),
                    diffuse_tex=b.add_texture("checker", tex))
    else:
        b.add_matte("floor", (0.5, 0.5, 0.5))
    b.add_emissive("light", (1.0, 1.0, 1.0), 30.0)
    b.add_rect((-50, 0, -50), (100, 0, 0), (0, 0, 100), "floor")
    b.add_rect((-5, 40, -5), (10, 0, 0), (0, 0, 10), "light")
    return b.build()


@pytest.fixture(scope="module")
def simple():
    js = _simple_scene(JBuilder())
    jc = j_make_camera((0.0, 20.0, 60.0), (0.0, 5.0, 0.0))
    jf, tf = _film(16, 45.0)
    ts, tc = _carry(js, jc)
    return js, jc, jf, ts, tc, tf


def _albedo(s, a, stack):
    m = s.materials
    return dataclasses.replace(s, materials=dataclasses.replace(
        m, color=(m.color.at[1].set(jnp.stack([a, a, a])) if stack is jnp
                  else _set_row(m.color, 1, torch.stack([a, a, a])))))


def _intensity(s, i, stack):
    ll = s.lights
    return dataclasses.replace(s, lights=dataclasses.replace(
        ll, intensity=(ll.intensity.at[0].set(i) if stack is jnp
                       else _set_row(ll.intensity, 0, i))))


def _light_r(s, r, stack):
    ll = s.lights
    if stack is jnp:
        color = ll.color.at[0, 0].set(r)
    else:
        color = _set_row(ll.color, 0, torch.cat([r[None], ll.color[0, 1:]]))
    return dataclasses.replace(s, lights=dataclasses.replace(ll,
                                                             color=color))


# name -> (graft, x0, eps, FD rtol, FD atol, sign of the gradient)
SIMPLE = {"albedo": (_albedo, 0.5, 1e-2, 2e-2, 0.0, 1.0),
          "intensity": (_intensity, 30.0, 0.5, 2e-2, 0.0, 1.0),
          "light_color": (_light_r, 1.0, 1e-2, 2e-2, 0.0, 1.0)}


@pytest.fixture(scope="module")
def simple_jax(simple):
    js, jc, jf, _, _, _ = simple
    out = {}
    for name, (graft, x0, *_) in SIMPLE.items():
        out[name] = float(jax.jit(jax.grad(lambda x, g=graft: _j_loss(
            g(js, x, jnp), jc, jf)))(jnp.float32(x0)))
    return out


@pytest.mark.parametrize("name", list(SIMPLE))
def test_simple_grad_matches_jax_and_fd(simple, simple_jax, name):
    """Albedo, lights.intensity (NEE reads the light table's snapshot of
    the emission), lights.color: jax.grad at rtol 1e-5, the port's
    central difference at test_grad.py's rtol, and the sign."""
    _, _, _, ts, tc, tf = simple
    graft, x0, eps, rtol, atol, sign = SIMPLE[name]
    g, fd = _grad_fd(lambda x: _t_loss(graft(ts, x, torch), tc, tf), x0,
                     eps)
    np.testing.assert_allclose(g, simple_jax[name], rtol=MATERIAL)
    np.testing.assert_allclose(g, fd, rtol=rtol, atol=atol)
    assert g * sign > 0.0


@pytest.fixture(scope="module")
def plane_point():
    """test_grad.py's boundary-free camera scene: an infinite plane under
    a point light, 8x8, depth 1."""
    b = JBuilder()
    b.add_matte("floor", (0.8, 0.8, 0.8))
    b.add_plane((0, 0, 0), (0, 1, 0), "floor")
    b.add_point_light((0, 8, 0), (1, 1, 1), intensity=60.0, dist_atten=True)
    js = b.build()
    jc = j_make_camera((2.0, 6.0, 14.0), (0.0, 0.0, 0.0))
    jf, tf = _film(8, 35.0)
    ts, tc = _carry(js, jc)
    return js, jc, jf, ts, tc, tf


@pytest.fixture(scope="module")
def camera_jax(plane_point):
    js, jc, jf, _, _, _ = plane_point

    def pos_x(x):
        cam = jc.replace(position=jnp.stack([x, jnp.float32(6.0),
                                             jnp.float32(14.0)]))
        return _j_loss(js, cam, jf, depth=1)

    def look_x(lx):
        cam = make_camera_jax((2.0, 6.0, 14.0), jnp.stack(
            [lx, jnp.float32(0.0), jnp.float32(0.0)]))
        return _j_loss(js, cam, jf, depth=1)

    return {"position": float(jax.jit(jax.grad(pos_x))(jnp.float32(2.0))),
            "look": float(jax.jit(jax.grad(look_x))(jnp.float32(0.5)))}


def test_camera_position_grad_matches_jax_and_fd(plane_point, camera_jax):
    """d(loss)/d(camera x) with the lookAt basis held: jax.grad at 1e-4,
    the central difference (eps 0.1) at rtol 0.15, nonzero."""
    _, _, _, ts, tc, tf = plane_point

    def f(x):
        pos = torch.stack([x, torch.tensor(6.0), torch.tensor(14.0)])
        return _t_loss(ts, dataclasses.replace(tc, position=pos), tf,
                       depth=1)

    g, fd = _grad_fd(f, 2.0, 0.1)
    np.testing.assert_allclose(g, camera_jax["position"], rtol=GEOMETRY)
    np.testing.assert_allclose(g, fd, rtol=0.15)
    assert abs(g) > 1e-6


def test_look_point_grad_matches_jax_and_fd(plane_point, camera_jax):
    """make_camera_torch: the gradient flows through the lookAt basis;
    the camera's leaves equal make_camera_jax's, the gradient jax.grad's
    at 1e-4, the central difference (eps 0.05) at rtol 0.2."""
    _, _, _, ts, _, tf = plane_point
    look = (0.5, 0.0, 0.0)
    jcam = make_camera_jax((2.0, 6.0, 14.0), look)
    tcam = make_camera_torch((2.0, 6.0, 14.0), look)
    for f in ("position", "x_axis", "y_axis", "z_axis", "focal_dist",
              "focal_length", "lens_radius"):
        np.testing.assert_allclose(getattr(tcam, f).numpy(),
                                   np.asarray(getattr(jcam, f)), rtol=1e-6,
                                   atol=1e-7)

    def f(lx):
        cam = make_camera_torch((2.0, 6.0, 14.0), torch.stack(
            [lx, torch.tensor(0.0), torch.tensor(0.0)]))
        return _t_loss(ts, cam, tf, depth=1)

    g, fd = _grad_fd(f, 0.5, 0.05)
    np.testing.assert_allclose(g, camera_jax["look"], rtol=GEOMETRY)
    np.testing.assert_allclose(g, fd, rtol=0.2)
    assert abs(g) > 1e-6


@pytest.fixture(scope="module")
def textured():
    js = _simple_scene(JBuilder(), textured=True)
    jc = j_make_camera((0.0, 20.0, 60.0), (0.0, 5.0, 0.0))
    jf, tf = _film(16, 45.0)
    ts, tc = _carry(js, jc)

    def j_graft(v):
        tx = js.textures.texels.at[5, 1].set(v)
        return js.replace(textures=js.textures.replace(texels=tx))

    gj = float(jax.jit(jax.grad(lambda v: _j_loss(j_graft(v), jc, jf)))(
        jnp.float32(0.5)))
    return ts, tc, tf, gj


def test_texel_grad_matches_jax_and_fd(textured):
    """One texel channel through the nearest-lookup gather."""
    ts, tc, tf, gj = textured

    def f(v):
        tx = ts.textures.texels
        row = torch.cat([tx[5, :1], v[None], tx[5, 2:]])
        s = dataclasses.replace(ts, textures=dataclasses.replace(
            ts.textures, texels=_set_row(tx, 5, row)))
        return _t_loss(s, tc, tf)

    g, fd = _grad_fd(f, 0.5, 1e-2)
    np.testing.assert_allclose(g, gj, rtol=MATERIAL)
    np.testing.assert_allclose(g, fd, rtol=2e-2)
    assert g > 0.0


def _metal_scene(b, box=False):
    mid = b.add_metal("m", preset="GOLD", roughness=0.25)
    b.add_matte("w", (0.5, 0.5, 0.5))
    b.add_emissive("light", (1.0, 1.0, 1.0), 30.0)
    b.add_rect((-50, 0, -50), (100, 0, 0), (0, 0, 100), "w")
    b.add_sphere((0.0, 6.0, 0.0), 6.0, "m")
    if box:
        b.add_box(6.0, 6.0, 6.0, "w", location=(12.0, 3.0, 0.0))
    b.add_rect((-5, 40, -5), (10, 0, 0), (0, 0, 10), "light")
    return b.build(), mid


@pytest.fixture(scope="module")
def metal():
    js, mid = _metal_scene(JBuilder())
    jc = j_make_camera((0.0, 15.0, 40.0), (0.0, 5.0, 0.0))
    jf, tf = _film(16, 45.0)
    ts, tc = _carry(js, jc)

    def j_graft(a):
        m = js.materials
        return js.replace(materials=m.replace(alphax=m.alphax.at[mid].set(a),
                                              alphay=m.alphay.at[mid].set(a)))

    a0 = float(js.materials.alphax[mid])
    gj = float(jax.jit(jax.grad(lambda a: _j_loss(j_graft(a), jc, jf)))(
        jnp.float32(a0)))
    return ts, tc, tf, mid, a0, gj


def test_metal_roughness_grad_matches_jax_and_fd(metal):
    """d(loss)/d(alpha) through the metal lobe's D, G and sample."""
    ts, tc, tf, mid, a0, gj = metal

    def f(a):
        m = ts.materials
        row = torch.arange(m.alphax.shape[0]) == mid
        s = dataclasses.replace(ts, materials=dataclasses.replace(
            m, alphax=torch.where(row, a, m.alphax),
            alphay=torch.where(row, a, m.alphay)))
        return _t_loss(s, tc, tf)

    g, fd = _grad_fd(f, a0, 1e-3)
    assert np.isfinite(g)
    np.testing.assert_allclose(g, gj, rtol=MATERIAL)
    np.testing.assert_allclose(g, fd, rtol=5e-2, atol=1e-4)


@pytest.fixture(scope="module")
def remat_case(simple):
    """test_grad.py's remat case: trace_paths on stratified camera rays,
    the albedo gradient of mean(L), JAX's without remat."""
    from craytracer_tpu.camera import generate_rays as j_rays
    from craytracer_tpu.integrator.wavefront import CAMERA_BOUNCE
    from craytracer_tpu.integrator.wavefront import trace_paths as j_trace
    from craytracer_tpu.sampling import uniforms as j_uniforms

    js, jc, jf, ts, tc, tf = simple
    ids = jnp.arange(256, dtype=jnp.int32)
    o, d = j_rays(jc, jf, ids, j_uniforms(SEED, ids, 0, CAMERA_BOUNCE, 2, 0))

    def loss(a, remat):
        L, _ = j_trace(_albedo(js, a, jnp), o, d, SEED, ids, 0, 2,
                       remat=remat)
        return jnp.mean(L)

    g = {r: float(jax.jit(jax.grad(lambda a, r=r: loss(a, r)))(
        jnp.float32(0.5))) for r in (False, True)}
    return ts, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d)), g


def test_remat_grad_matches(remat_case):
    """trace_paths(remat=True) checkpoints each bounce: the gradient
    equals the stored one (rtol 1e-5, test_grad.py's) and JAX's."""
    ts, o, d, gj = remat_case
    np.testing.assert_allclose(gj[False], gj[True], rtol=1e-5)
    ids = torch.arange(256, dtype=torch.int32)
    g = {}
    for remat in (False, True):
        a = torch.tensor(0.5, requires_grad=True)
        L, _ = trace_paths(_albedo(ts, a, torch), o, d, SEED, ids, 0, 2,
                           remat=remat)
        (g[remat],) = torch.autograd.grad(L.mean(), [a])
    np.testing.assert_allclose(float(g[True]), float(g[False]), rtol=1e-5)
    np.testing.assert_allclose(float(g[False]), gj[False], rtol=MATERIAL)


# -- cases test_grad.py lacks (more in tests/test_torch_grad_scenes.py) -----

def _tie_inputs(name):
    """Local directions on the bounds of the shading-frame trig (cos =
    +-1, sin = 0), the zero vector, and ordinary directions; for
    cartesian_to_spherical, y on its clip bounds, and no direction on
    atan2's singular axis (x = z = 0), where jax.grad is NaN and torch's
    0."""
    w = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0],
                  [0.0, 1.0, 0.0], [0.6, 0.0, 0.8], [0.0, 0.6, 0.8],
                  [0.0, 0.0, 0.0], [0.3, -0.4, 0.5]], np.float32)
    if name == "cartesian_to_spherical":
        w = w[(w[:, 0] != 0) | (w[:, 2] != 0)]
        edge = np.float32(1.0 - 1e-6)
        w = np.concatenate([w, np.array([[0.3, edge, 0.2],
                                         [0.3, -edge, -0.2]], np.float32)])
    return w


TIES = ("length", "normalize", "sin2_theta", "sin_theta", "tan2_theta",
        "cos_phi", "sin_phi", "cartesian_to_spherical")


@pytest.mark.parametrize("name", TIES)
def test_math_tie_grads_match_jax(name):
    """core/math.py's bounds split a tie's gradient as jnp.maximum and
    jnp.clip do (half to each side), where torch.clamp passes all of it:
    the gradient of the sum of each helper's outputs at bound-hitting
    inputs equals jax.grad's."""
    from craytracer_tpu.core import math as jm

    w = _tie_inputs(name)

    def jf(x):
        out = getattr(jm, name)(x)
        return sum(jnp.sum(o) for o in (out if isinstance(out, tuple)
                                        else (out,)))

    x = torch.from_numpy(w).requires_grad_(True)
    out = getattr(vm, name)(x)
    tot = sum(o.sum() for o in (out if isinstance(out, tuple) else (out,)))
    (g,) = torch.autograd.grad(tot, [x])
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jf)(
        jnp.asarray(w))), rtol=1e-6, atol=1e-6)


def test_math_bounds_split_ties():
    """maximum / minimum / clip at their bounds pass half the gradient;
    their values are torch.clamp's."""
    x = torch.tensor([0.0, 1.0, -1.0, 0.5, 2.0], requires_grad=True)
    parts = (vm.maximum(x, 0.0), vm.minimum(x, 1.0), vm.clip(x, -1.0, 1.0))
    want = (torch.clamp(x, min=0.0), torch.clamp(x, max=1.0),
            torch.clamp(x, -1.0, 1.0))
    for p, c in zip(parts, want):
        assert torch.equal(p, c)
    g = [torch.autograd.grad(p.sum(), [x])[0].tolist() for p in parts]
    assert g == [[0.5, 1.0, 0.0, 1.0, 1.0], [1.0, 0.5, 1.0, 1.0, 0.0],
                 [1.0, 0.5, 0.5, 1.0, 0.0]]


def test_grad_on_k1_scene_takes_general_route(simple):
    """A scene K1 takes whole: under autograd with a material that
    requires grad the gate answers "general" and render_sample raises
    nothing; without grad it keeps "bounce", and the two passes agree to
    the bar between the routes (2e-5)."""
    _, _, _, ts, tc, tf = simple
    assert production_fast_shade(ts, tc, tf) == "bounce"
    a = torch.tensor(0.5, requires_grad=True)
    s = _albedo(ts, a, torch)
    assert production_fast_shade(s, tc, tf) == "general"
    with torch.no_grad():
        assert production_fast_shade(s, tc, tf) == "bounce"
        plain = render_sample(s, tc, tf, torch.arange(256, dtype=torch.int32),
                              SEED, 0, 2)
    img = render_sample(s, tc, tf, torch.arange(256, dtype=torch.int32),
                        SEED, 0, 2)
    (g,) = torch.autograd.grad(img.mean(), [a])
    assert torch.isfinite(g) and float(g) > 0.0
    np.testing.assert_allclose(img.detach().numpy(), plain.numpy(),
                               rtol=2e-5, atol=2e-5)
    cam, _ = with_grad(tc, "position")
    assert production_fast_shade(ts, cam, tf) == "general"


@pytest.fixture(scope="module")
def fov_cases():
    """{route: (scene, camera, jax.grad of the loss w.r.t. the fov)} for a
    scene K1 takes whole ("bounce") and one the per-bounce kernel route
    takes ("shade": an open cylinder leaves K1's gate)."""
    out = {}
    for route in ("bounce", "shade"):
        b = JBuilder()
        b.add_matte("floor", (0.5, 0.5, 0.5))
        b.add_matte("can", (0.7, 0.4, 0.3))
        b.add_emissive("light", (1.0, 1.0, 1.0), 30.0)
        b.add_rect((-50, 0, -50), (100, 0, 0), (0, 0, 100), "floor")
        b.add_rect((-5, 40, -5), (10, 0, 0), (0, 0, 10), "light")
        if route == "shade":
            b.add_open_cylinder(360.0, "can", location=(0.0, 5.0, 0.0),
                                scale=(6.0, 6.0, 6.0))
        js = b.build()
        jc = j_make_camera((0.0, 20.0, 60.0), (0.0, 5.0, 0.0))

        def loss(fov):
            return _j_loss(js, jc, JFilm(fov=fov, width=16, height=16))

        gj = float(jax.jit(jax.grad(loss))(jnp.float32(np.deg2rad(45.0))))
        out[route] = _carry(js, jc) + (gj,)
    return out


@pytest.mark.parametrize("route", ["bounce", "shade"])
def test_fov_grad_takes_general_route(fov_cases, route):
    """d loss / d fov: with the film's fov requiring grad the gate answers
    "general" on a scene K1 or the "shade" route would take, so neither
    K1's nor K2's forward-only guard raises, and the gradient is JAX's to
    1e-4 (a camera gradient)."""
    ts, tc, gj = fov_cases[route]
    _, tf = _film(16, 45.0)
    assert production_fast_shade(ts, tc, tf) == route
    fov = tf.fov.clone().requires_grad_(True)
    film = dataclasses.replace(tf, fov=fov)
    assert production_fast_shade(ts, tc, film) == "general"
    (g,) = torch.autograd.grad(_t_loss(ts, tc, film), [fov])
    assert torch.isfinite(g) and float(g) != 0.0
    np.testing.assert_allclose(float(g), gj, rtol=GEOMETRY)


def test_camera_rays_carry_grad(simple):
    """trace_paths on origins and directions that require grad takes the
    general step (the "shade" route's K2 contract is forward-only)."""
    _, _, _, ts, tc, tf = simple
    cam, (pos,) = with_grad(tc, "position")
    ids = torch.arange(256, dtype=torch.int32)
    o, d = camera_rays(cam, tf, ids, SEED, 0, stratified_jitter(SEED, ids, 0))
    L, _ = trace_paths(ts, o, d, SEED, ids, 0, 2, fast_shade="shade")
    (g,) = torch.autograd.grad(L.mean(), [pos])
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0.0
