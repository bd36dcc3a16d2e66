"""The MIS estimator (craytracer_tpu_torch/integrator/wavefront.py
`_general_step(mis=True)`, lights/lights.py `light_pdf_for_hit` and
`env_pdf`) against the JAX package's, and the route gate's mesh-light
rule.

- Whole passes: the port's `trace_paths(..., mis=True)` against the JAX
  `trace_paths(..., mis=True)` at 24x24 x 2 spp, depth 0, 2 and 5, on
  scenes/parity_mix.txt, the glossy scene of tests/test_mis.py (a rough
  SILVER floor under a 1 x 1 lamp), the quad mesh light of
  tests/test_mis.py:76-104 in the principled power mode (its only light)
  and spheres under the fullscene HDR sky sampled by texel importance,
  with the bars of tests/torch_general_check.py; on the EXCUSED lanes
  JAX's fori program and its bounce step run one by one differ past the
  bar, and the port is held to the latter. Both sides run with denormals
  flushed to zero: XLA:CPU flushes them, and the MIS NEE evaluates
  microfacet lobes whose grazing terms underflow (f ~ 1e-39 on about 1%
  of the glossy scene's lanes, which would fire a shadow ray and count a
  good path in the port only).
- The counterparts of tests/test_light_pdf.py (a light's own samples
  have the density `light_pdf_for_hit` gives them, per light type; its
  quadrature mass; none on a rect lamp's back) through the port, with
  the port's densities also held to JAX's on the same inputs (2e-5), and
  `env_pdf` against JAX's for a texture env with and without texel
  importance and a constant env (rtol and atol 2e-5: the cosine form
  takes wi back through the env rotation by a matrix product, whose
  rounding moves a near-horizon cosine by about 1e-8).
- The counterparts of tests/test_mis.py's five tests through the port's
  `render_sample` (the spp of a test traced as one batch of lanes, the
  same counter-RNG stream as pass after pass).
- The gate: the quad mesh light beside a rect lamp in the reference
  power mode (the mesh light at power 0) takes K1's route, as the JAX
  gate decides (CRAYTRACER_PALLAS_SHADE=1 lets it answer on the CPU),
  and its pass equals the JAX XLA one at the bars; in the principled
  mode it takes "general"; "mis" takes "general" on a K1 scene.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.camera import Film as JFilm
from craytracer_tpu.camera import make_camera as j_make_camera
from craytracer_tpu.integrator.pallas_shade import \
    production_fast_shade as j_production_fast_shade
from craytracer_tpu.integrator.wavefront import trace_paths as j_trace
from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.io.teximage import load_texture_image as j_tex
from craytracer_tpu.lights import lights as jl
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.camera import Film, make_camera
from craytracer_tpu_torch.integrator.gate import production_fast_shade
from craytracer_tpu_torch.integrator.wavefront import (render_sample,
                                                       trace_paths)
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.io.teximage import load_texture_image as t_tex
from craytracer_tpu_torch.lights import lights as tl
from craytracer_tpu_torch.scene import types as T
from craytracer_tpu_torch.scene.build import SceneBuilder
from torch_general_check import BAR, SEED, SIZE, check_general, jax_rays
from torch_jax_native import jax_native  # noqa: F401

import torch_textured_scenes as tex_scenes

torch.set_num_threads(2)
SCENES = tex_scenes.SCENES
NAMES = ["parity_mix", "glossy", "quad_lamp", "env_importance"]
# lanes where JAX's fori program and its bounce step run one by one
# differ by more than the bar (tests/torch_general_check.py)
EXCUSED = {("parity_mix", 2): (812,), ("parity_mix", 5): (401, 812),
           ("env_importance", 2): (205,), ("env_importance", 5): (205,)}


@pytest.fixture(autouse=True, scope="module")
def flush_denormals():
    """torch's CPU ops flush denormals to zero in this module, as XLA:CPU
    does (the module docstring)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _builders(fn, *, load=False, power="reference", **kw):
    """(JAX scene, port scene, JAX camera, JAX film) from one call
    sequence."""
    jb, tb = JBuilder(), SceneBuilder()
    eye, look, fov = fn(jb, *((j_tex,) if load else ()), **kw)
    fn(tb, *((t_tex,) if load else ()), **kw)
    return (jb.build(light_power=power),
            tb.build(light_power=power, device="cpu"),
            j_make_camera(eye, look),
            JFilm(fov=jnp.float32(fov), width=SIZE, height=SIZE))


def _build(name):
    if name == "parity_mix":
        path = os.path.join(SCENES, "parity_mix.txt")
        js, jc, jf = j_load(path)
        return js, load_scene_file(path, device="cpu")[0], jc, jf
    if name == "glossy":
        return _builders(tex_scenes.glossy_lamp)
    if name == "quad_lamp":
        return _builders(tex_scenes.quad_lamp, power="principled")
    return _builders(tex_scenes.env_spheres, load=True, importance=True)


@pytest.fixture(scope="module")
def built():
    return {}


@pytest.mark.parametrize("depth", [0, 2, 5])
@pytest.mark.parametrize("name", NAMES)
def test_mis_pass_matches_jax(built, name, depth):
    if name not in built:
        js, ts, jc, jf = _build(name)
        assert production_fast_shade(ts, estimator="mis") == "general"
        built[name] = (js, ts, jax_rays(jc, jf))
    js, ts, rays = built[name]
    L, m = check_general(js, ts, rays, depth, EXCUSED.get((name, depth), ()),
                         mis=True)
    assert np.isfinite(L).all()
    assert depth == 0 or (L.mean() > 0.01 and int(m["shadow_rays"]) > 0)


# ---- tests/test_light_pdf.py


def _pdf_scene(builder, kind, **kw):
    """tests/test_light_pdf.py:29-41: a floor and one lamp of `kind`."""
    b = builder()
    b.add_matte("floor", (0.6, 0.6, 0.6))
    b.add_emissive("lamp", (1.0, 1.0, 1.0), 10.0)
    b.add_rect((-30, -0.5, -30), (60, 0, 0), (0, 0, 60), "floor")
    if kind == "rect":
        b.add_rect((-1.0, 8.0, -1.0), (2.0, 0, 0), (0, 0, 2.0), "lamp")
    elif kind == "sphere":
        b.add_sphere((0.0, 5.0, 0.0), 0.5, "lamp")
    else:
        b.add_disk((0.0, 6.0, 0.0), (0, -1, 0), 1.0, "lamp")
    return b.build(**kw)


def _both_pdfs(js, ts, hit_point, prev_point, wi):
    """(port, JAX) light_pdf_for_hit for the scene's one light row."""
    n = hit_point.shape[0]
    grp, prm = (np.full(n, int(ts.lights.src_group[0]), np.int32),
                np.full(n, int(ts.lights.src_prim[0]), np.int32))
    args = (grp, prm, hit_point, prev_point, wi)
    ours = tl.light_pdf_for_hit(ts, *(torch.from_numpy(a) for a in args))
    ref = jl.light_pdf_for_hit(js, *(jnp.asarray(a) for a in args))
    return ours.numpy(), np.asarray(ref)


def _frames(n):
    f32 = np.float32
    return (np.tile(f32([[0.0, 1.0, 0.0]]), (n, 1)),
            np.tile(f32([[1.0, 0.0, 0.0]]), (n, 1)),
            np.tile(f32([[0.0, 0.0, 1.0]]), (n, 1)))


@pytest.mark.parametrize("kind", ["rect", "sphere", "disk"])
def test_sample_pdf_matches_mis_pdf(kind):
    """sample_one_light's pdf equals light_pdf_for_hit re-evaluated at the
    sampled point, lane for lane (tests/test_light_pdf.py:51-84)."""
    js = _pdf_scene(JBuilder, kind)
    ts = _pdf_scene(SceneBuilder, kind, device="cpu")
    n = 4096
    rng = np.random.default_rng(7)
    p = np.tile(np.float32([[0.4, 0.0, 0.2]]), (n, 1))
    normal, ft, fb = (torch.from_numpy(a) for a in _frames(n))
    u_pick = torch.from_numpy(rng.random(n, np.float32))
    u2 = torch.from_numpy(rng.random((n, 2), np.float32))
    ls = tl.sample_one_light(ts, u_pick, u2, torch.from_numpy(p), normal,
                             ft, fb)
    hit_point = (torch.from_numpy(p) + ls.wi * ls.distance[:, None]).numpy()
    ours, ref = _both_pdfs(js, ts, hit_point, p, ls.wi.numpy())
    np.testing.assert_allclose(ours, ref, rtol=2e-5, atol=1e-12)
    valid = ls.valid.numpy()
    assert valid.mean() > 0.5
    a, b = ls.pdf.numpy()[valid], ours[valid]
    if kind == "sphere":
        # near the silhouette cos_local -> 0 amplifies the f32 error of the
        # recomputed surface normal (the JAX test's bars)
        assert (b > 0).all()
        rel = np.abs(a - b) / np.maximum(a, 1e-9)
        assert np.quantile(rel, 0.95) < 2e-2 and np.median(rel) < 2e-3
    else:
        np.testing.assert_allclose(b, a, rtol=2e-3)


def _cone_dirs(axis, cos_max, m, seed):
    """tests/test_light_pdf.py:87-103: jittered-grid uniform directions in
    the cone about `axis`, and their constant density."""
    g = int(np.sqrt(m))
    rng = np.random.default_rng(seed)
    i, j = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    u1 = ((i + rng.random((g, g))) / g).reshape(-1)
    u2 = ((j + rng.random((g, g))) / g).reshape(-1)
    mu = 1.0 - u1 * (1.0 - cos_max)
    phi = 2.0 * np.pi * u2
    s = np.sqrt(np.maximum(1.0 - mu * mu, 0.0))
    axis = axis / np.linalg.norm(axis)
    h = (np.array([1.0, 0.0, 0.0]) if abs(axis[0]) < 0.9
         else np.array([0.0, 1.0, 0.0]))
    t = np.cross(axis, h)
    t /= np.linalg.norm(t)
    bt = np.cross(axis, t)
    d = ((s * np.cos(phi))[:, None] * t + (s * np.sin(phi))[:, None] * bt
         + mu[:, None] * axis)
    return d, 1.0 / (2.0 * np.pi * (1.0 - cos_max))


@pytest.mark.parametrize("kind", ["rect", "sphere", "disk"])
def test_pdf_quadrature_mass(kind):
    """The density integrated over the directions that reach the light
    (independent numpy intersections) gives each type's mass: 1 for rect
    and disk, (1 - r^2/d^2) / (2 pi) for the reference's sphere density
    (tests/test_light_pdf.py:106-162)."""
    js = _pdf_scene(JBuilder, kind)
    ts = _pdf_scene(SceneBuilder, kind, device="cpu")
    p = np.array([0.4, 0.0, 0.2])
    lights = ts.lights
    p0, v1, v2 = (x[0].double().numpy() for x in (lights.p0, lights.v1,
                                                   lights.v2))
    ln, radius = lights.normal[0].double().numpy(), float(lights.radius[0])
    if kind == "rect":
        center, extent = p0 + 0.5 * v1 + 0.5 * v2, 0.5 * np.linalg.norm(
            v1 + v2)
    else:
        center, extent = p0, radius
    axis = center - p
    d_c = np.linalg.norm(axis)
    dirs, pdf_dir = _cone_dirs(axis, np.cos(np.arctan2(extent * 1.6, d_c)),
                               384 * 384, seed=3)
    if kind == "sphere":
        oc = p - center
        bq = dirs @ oc
        disc = bq * bq - (oc @ oc - radius * radius)
        t = -bq - np.sqrt(np.maximum(disc, 0.0))
        hit = (disc > 0) & (t > 0)
        expected = (1.0 - (radius / d_c) ** 2) / (2.0 * np.pi)
    else:
        denom = dirs @ ln
        t = ((p0 - p) @ ln) / np.where(np.abs(denom) > 1e-12, denom, 1e-12)
        x = p[None] + t[:, None] * dirs
        if kind == "rect":
            s1 = ((x - p0) @ v1) / (v1 @ v1)
            s2 = ((x - p0) @ v2) / (v2 @ v2)
            hit = (t > 0) & (s1 >= 0) & (s1 <= 1) & (s2 >= 0) & (s2 <= 1)
        else:
            hit = (t > 0) & (np.linalg.norm(x - p0, axis=-1) <= radius)
        expected = 1.0
    x = p[None] + t[:, None] * dirs
    m = dirs.shape[0]
    f32 = np.float32
    ours, ref = _both_pdfs(js, ts, x.astype(f32),
                           np.tile(p.astype(f32)[None], (m, 1)),
                           dirs.astype(f32))
    np.testing.assert_allclose(ours[hit], ref[hit], rtol=2e-5)
    mass = float(np.where(hit, ours, 0.0).mean() / pdf_dir)
    assert mass == pytest.approx(expected, rel=2e-2), (kind, mass, expected)


def test_backside_rect_zero_density():
    """A BSDF hit on the back of a one-sided lamp sees no light-strategy
    density (tests/test_light_pdf.py:165-176)."""
    js = _pdf_scene(JBuilder, "rect")
    ts = _pdf_scene(SceneBuilder, "rect", device="cpu")
    f32 = np.float32
    ours, ref = _both_pdfs(js, ts, f32([[0.2, 8.0, 0.1]]),
                           f32([[0.2, 12.0, 0.1]]), f32([[0.0, -1.0, 0.0]]))
    assert ours[0] == ref[0] == 0.0


@pytest.mark.parametrize("env", ["importance", "cosine", "constant"])
def test_env_pdf_matches_jax(env):
    """env_pdf for 4,096 seeded escape directions and shading normals."""
    def fn(b, load=None):
        b.add_matte("floor", (0.6, 0.6, 0.6))
        b.add_rect((-5, 0, -5), (10, 0, 0), (0, 0, 10), "floor")
        if env == "constant":
            b.set_env_light("constant", (0.9, 0.8, 0.7), 0.7)
        else:
            tid = b.add_texture("sky", load(os.path.join(
                SCENES, "fullscene_env.exr")))
            b.set_env_light("texture", intensity=1.5, tex_id=tid,
                            rotate_y_angle=-0.76,
                            importance=env == "importance")
        return (0, 2, 6), (0, 0, 0), 0.8

    js, ts, _, _ = _builders(fn, load=env != "constant")
    rng = np.random.default_rng(5)
    wi, nrm = (rng.standard_normal((2, 4096, 3))).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    ours = tl.env_pdf(ts, torch.from_numpy(wi), torch.from_numpy(nrm))
    ref = jl.env_pdf(js, jnp.asarray(wi), jnp.asarray(nrm))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **BAR)
    assert (ours.numpy() > 0).mean() > 0.3


# ---- tests/test_mis.py


def _view(size, eye=(0, 4, 14), look=(0, 0, 0)):
    return make_camera(eye, look), Film(
        fov=torch.tensor(math.radians(40.0)), width=size, height=size)


def _passes(scene, cam, film, estimator, n_spp, seed=11, depth=3):
    """[n_spp, pixels, 3]: render_sample at spp 0..n_spp-1, as one batch
    of lanes."""
    n = film.width * film.height
    ids = torch.arange(n, dtype=torch.int32).repeat(n_spp)
    spp = torch.arange(n_spp, dtype=torch.int32).repeat_interleave(n)
    out = render_sample(scene, cam, film, ids, seed, spp, depth, estimator)
    return out.reshape(n_spp, n, 3).numpy()


def _glossy_scene(light_size):
    b = SceneBuilder()
    tex_scenes.glossy_lamp(b, light_size)
    return b.build(device="cpu")


def test_mis_unbiased_vs_physical():
    """tests/test_mis.py:40-58: the MIS and physical image means agree
    within the combined MC error, on the 4 x 4 lamp."""
    scene = _glossy_scene(4.0)
    cam, film = _view(12)
    mis = _passes(scene, cam, film, "mis", 96)
    phys = _passes(scene, cam, film, "physical", 96)
    assert np.isfinite(mis).all() and np.isfinite(phys).all()
    np.testing.assert_allclose(mis.mean(axis=0).mean(),
                               phys.mean(axis=0).mean(), rtol=0.12)


def test_mis_reduces_variance():
    """tests/test_mis.py:61-68: lower per-pixel variance than the physical
    estimator on the 1 x 1 lamp."""
    scene = _glossy_scene(1.0)
    cam, film = _view(12)
    v_mis = _passes(scene, cam, film, "mis", 64).var(axis=0).mean()
    v_phys = _passes(scene, cam, film, "physical", 64).var(axis=0).mean()
    assert v_mis < v_phys * 0.9, (v_mis, v_phys)


def test_mesh_light_nee_principled():
    """tests/test_mis.py:71-109: under the principled power a quad mesh
    light lights the floor about as strongly as the same rect light."""
    def build(use_mesh):
        b = SceneBuilder()
        b.add_matte("floor", (0.7, 0.7, 0.7))
        b.add_emissive("lamp", (1, 1, 1), 30.0)
        b.add_rect((-20, 0, -20), (40, 0, 0), (0, 0, 40), "floor")
        if use_mesh:
            b.add_mesh(positions=[(-2, 8, -2), (2, 8, -2), (2, 8, 2),
                                  (-2, 8, 2)],
                       indices=[(0, 1, 2), (0, 2, 3)], mat="lamp")
        else:
            b.add_rect((-2, 8, -2), (4, 0, 0), (0, 0, 4), "lamp")
        return b.build(light_power="principled", device="cpu")

    cam, film = _view(10)
    m_mesh = _passes(build(True), cam, film, "physical", 24, 5, 2).mean()
    m_rect = _passes(build(False), cam, film, "physical", 24, 5, 2).mean()
    assert m_mesh > 0.005
    np.testing.assert_allclose(m_mesh, m_rect, rtol=0.25)


def test_mesh_light_cdf_boundaries():
    """tests/test_mis.py:112-138: the mesh light's samples at CDF
    boundaries land on the quad, and equal JAX's."""
    def quad(b):
        b.add_matte("f", (0.5, 0.5, 0.5))
        b.add_emissive("lamp", (1, 1, 1), 5.0)
        b.add_rect((-20, 0, -20), (40, 0, 0), (0, 0, 40), "f")
        b.add_mesh(positions=[(-2, 8, -2), (2, 8, -2), (2, 8, 2),
                              (-2, 8, 2)],
                   indices=[(0, 1, 2), (0, 2, 3)], mat="lamp")
        return (0, 4, 14), (0, 0, 0), 0.7

    js, ts, _, _ = _builders(quad, power="principled")
    row = ts.lights.light_type.tolist().index(T.LIGHT_MESH)
    n = 5
    idx = np.full(n, row, np.int32)
    hp = np.zeros((n, 3), np.float32)
    nrm = np.tile(np.float32([[0.0, 1.0, 0.0]]), (n, 1))
    u2 = np.float32([[0.0, 0.5], [0.49, 0.5], [0.51, 0.5], [0.999, 0.5],
                     [1.0, 0.5]])
    args = (idx, u2, hp, nrm, nrm, nrm)
    ls = tl.sample_light_index(ts, *(torch.from_numpy(a) for a in args))
    ref = jl.sample_light_index(js, *(jnp.asarray(a) for a in args))
    assert bool(ls.valid.all())
    pts = hp + ls.wi.numpy() * ls.distance.numpy()[:, None]
    np.testing.assert_allclose(pts[:, 1], 8.0, atol=1e-3)
    assert (np.abs(pts[:, 0]) <= 2.001).all()
    assert (np.abs(pts[:, 2]) <= 2.001).all()
    for f in ("wi", "distance", "pdf"):
        np.testing.assert_allclose(getattr(ls, f).numpy(),
                                   np.asarray(getattr(ref, f)), **BAR)


def test_mis_backface_emission_keeps_full_weight():
    """tests/test_mis.py:141-165: BSDF hits on the back of a lamp facing
    up keep weight 1, so MIS and physical agree where only BSDF sampling
    sees the emission."""
    b = SceneBuilder()
    b.add_matte("w", (0.6, 0.6, 0.6))
    b.add_emissive("l", (1, 1, 1), 6.0)
    b.add_rect((-8, 0, -8), (16, 0, 0), (0, 0, 16), "w")
    b.add_rect((-1, 4, -1), (2, 0, 0), (0, 0, 2), "l")
    scene = b.build(device="cpu")
    cam, film = _view(10, eye=(0, 2, 9), look=(0, 1, 0))
    mis = _passes(scene, cam, film, "mis", 192).mean()
    phys = _passes(scene, cam, film, "physical", 192).mean()
    assert phys > 1e-3
    np.testing.assert_allclose(mis, phys, rtol=0.15)


# ---- the gate


def test_mesh_light_at_power_zero_takes_k1(monkeypatch):
    """The quad mesh light beside a rect lamp: at reference power the
    mesh row has power 0 and both gates answer "bounce"; the pass there
    equals JAX's at the bars. At principled power the row is picked:
    "general", and JAX's gate answers False (its XLA step)."""
    monkeypatch.setenv("CRAYTRACER_PALLAS_SHADE", "1")
    js, ts, jc, jf = _builders(tex_scenes.quad_lamp_and_rect)
    row = ts.lights.light_type.tolist().index(T.LIGHT_MESH)
    assert float(ts.lights.power[row]) == 0.0
    cam, film = _view(SIZE, eye=(0, 4, 14))
    assert production_fast_shade(ts, cam, film) == "bounce"
    assert j_production_fast_shade(js, jc, jf) == "bounce"
    o, d, pix, spp = jax_rays(jc, jf)
    ref = j_trace(js, jnp.asarray(o), jnp.asarray(d), SEED, jnp.asarray(pix),
                  jnp.asarray(spp), 5, with_metrics=True, fast_shade=False)
    L, good, m = trace_paths(ts, torch.from_numpy(o), torch.from_numpy(d),
                             SEED, torch.from_numpy(pix),
                             torch.from_numpy(spp), 5, with_metrics=True)
    np.testing.assert_array_equal(good.numpy(), np.asarray(ref[1]))
    assert int(m["shadow_rays"]) == int(ref[2]["shadow_rays"]) > 0
    np.testing.assert_array_equal(m["bounce_live"].numpy(),
                                  np.asarray(ref[2]["bounce_live"]))
    np.testing.assert_allclose(L.numpy(), np.asarray(ref[0]), **BAR)

    jp, tp, jc, jf = _builders(tex_scenes.quad_lamp_and_rect,
                               power="principled")
    assert production_fast_shade(tp, cam, film) == "general"
    assert j_production_fast_shade(jp, jc, jf) is False


def test_mis_takes_general_on_a_k1_scene():
    ts, tc, tf = load_scene_file(os.path.join(SCENES, "parity_cornell.txt"),
                                 device="cpu")
    assert production_fast_shade(ts, tc, tf) == "bounce"
    assert production_fast_shade(ts, tc, tf, estimator="mis") == "general"
    with pytest.raises(ValueError, match="reference, physical, mis"):
        production_fast_shade(ts, tc, tf, estimator="bdpt")
