"""The general route on every accelerator against the JAX package: each
of bvh, bvh4q, grid, binned and hybrid built by both packages for a scene
no kernel shades, then `trace_paths` through `_general_step` on the same
camera rays (16x16 x 1 spp, depth 5) against the JAX XLA
`trace_paths(fast_shade=False)`.

The scene here: tests/torch_general_scenes.py `mesh_env_disk` on
scenes/parity_mesh_mid.obj (20,480 triangles in a gold metal that
`make_anisotropic` turns anisotropic Trowbridge-Reitz, a disk light, a
rect lamp, a constant env light); tests/test_torch_accel_general_textured.py
runs scenes/parity_textured.txt through the same check. Every
accelerator traces under the physical estimator (plain L, `mis=False`),
bvh also under MIS (hybrid in the textured file).

Bars: `good`, the ray and shadow-ray counts and the per-bounce live
histogram exact, L within 2e-5 (rtol and atol) on every lane. binned's
matmul form may name the other triangle of a shared edge
(tests/test_torch_accel.py's bar); no lane is excused: measured, every
lane of every case within the bars.

Each JAX program is compiled once, with the scene as its argument, in a
thread (XLA compiles outside the GIL) while the next case is built,
lowered and traced by the port.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.camera import Film as JFilm
from craytracer_tpu.camera import make_camera as j_make_camera
from craytracer_tpu.integrator.wavefront import trace_paths as j_trace
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.integrator.gate import production_fast_shade
from craytracer_tpu_torch.integrator.wavefront import trace_paths
from craytracer_tpu_torch.interop import numpy_leaves, scene_from_numpy
from craytracer_tpu_torch.io.objloader import load_obj
from craytracer_tpu_torch.scene.build import SceneBuilder
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401
from torch_slice_f import SCENES, SEED, jax_rays, load_both, t

import torch_general_scenes as general_scenes

torch.set_num_threads(2)
pytestmark = SAH_WARNING_IS_ERROR
SIZE, DEPTH = 16, 5
BAR = dict(rtol=2e-5, atol=2e-5)
ACCELS = ("bvh", "bvh4q", "grid", "binned", "hybrid")
CASES = ([("mesh_env_disk", accel, False) for accel in ACCELS]
         + [("mesh_env_disk", "bvh", True)])


def _mesh_env_disk(accel):
    """Both packages' mesh_env_disk built with `accel`, the microfacet
    rows made anisotropic in both; the JAX camera and film."""
    shapes = [(s.positions, s.indices) for s in load_obj(
        os.path.join(SCENES, "parity_mesh_mid.obj"))[0]]
    jb, tb = JBuilder(), SceneBuilder()
    eye, look, fov, _ = general_scenes.mesh_env_disk(jb, shapes)
    general_scenes.mesh_env_disk(tb, shapes)
    leaves = general_scenes.make_anisotropic(numpy_leaves(
        tb.build(accel=accel, device="cpu")))
    ts = scene_from_numpy(leaves, device="cpu")
    m = leaves["materials"]
    js = jb.build(accel=accel)
    js = js.replace(materials=js.materials.replace(
        alphay=jnp.asarray(m["alphay"]), distrib=jnp.asarray(m["distrib"])))
    assert not ts.microfacet_iso_beckmann
    return js, ts, j_make_camera(eye, look), JFilm(
        fov=jnp.float32(fov), width=SIZE, height=SIZE)


def _scenes(name, accel):
    if name == "mesh_env_disk":
        return _mesh_env_disk(accel)
    (js, jc, jf), (ts, _, _) = load_both(name, SIZE, accel=accel)
    return js, ts, jc, jf


def traced(cases):
    """Per case: the port's and the JAX (L, good, metrics) and the port
    scene. Each JAX program's compile runs in a thread while this one
    builds, lowers and traces the next case."""
    built, jobs = {}, {}
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        for name, accel, mis in cases:
            if (name, accel) not in built:
                js, ts, jc, jf = _scenes(name, accel)
                built[name, accel] = (js, ts, jax_rays(jc, jf, 1))
            js, ts, (o, d, pix, spp) = built[name, accel]

            def fn(scene, o, d, pix, spp, mis=mis):
                return j_trace(scene, o, d, SEED, pix, spp, DEPTH,
                               with_metrics=True, fast_shade=False, mis=mis)

            args = (js, *(jnp.asarray(x) for x in (o, d, pix, spp)))
            lowered = jax.jit(fn).lower(*args)
            jobs[name, accel, mis] = (ex.submit(lowered.compile), args,
                                      trace_paths(ts, t(o), t(d), SEED,
                                                  t(pix), t(spp), DEPTH,
                                                  with_metrics=True,
                                                  general=True, mis=mis))
        out = {}
        for key, (fut, args, port) in jobs.items():
            L, good, m = fut.result()(*args)
            out[key] = (port, (np.asarray(L), np.asarray(good),
                               {k: np.asarray(v) for k, v in m.items()}),
                        built[key[:2]][1])
    return out


def case_ids(cases):
    return [f"{n}-{a}-{'mis' if m else 'physical'}" for n, a, m in cases]


def check(ref, accel):
    """The port's trace against JAX's at the module docstring's bars."""
    (L, good, m), (Lr, goodr, mr), ts = ref
    assert ts.accel == accel and ts.tri_bvh is not None
    assert (ts.tri_shadow is not None) == (accel == "hybrid")
    assert production_fast_shade(ts) == "general"
    np.testing.assert_array_equal(good.numpy(), goodr)
    assert int(m["rays"]) == int(mr["rays"])
    assert int(m["shadow_rays"]) == int(mr["shadow_rays"])
    np.testing.assert_array_equal(m["bounce_live"].numpy(),
                                  mr["bounce_live"])
    np.testing.assert_allclose(L.numpy(), Lr, **BAR)
    assert int(mr["shadow_rays"]) > 0 and float(Lr.mean()) > 0.01
    assert np.isfinite(L.numpy()).all()


@pytest.fixture(scope="module")
def refs(jax_native):  # noqa: F811
    return traced(CASES)


@pytest.mark.parametrize("name,accel,mis", CASES, ids=case_ids(CASES))
def test_general_route_on_accel_matches_jax(refs, name, accel, mis):
    check(refs[name, accel, mis], accel)
