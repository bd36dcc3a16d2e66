"""WHITTED and RAYCAST (craytracer_tpu_torch/integrator/whitted.py)
against the JAX package's `trace_whitted` / `trace_raycast` on the same
camera rays, L within 2e-5 (rtol and atol) on every lane: RAYCAST on
parity_mix (mirror and metal spheres, plastic, Oren-Nayar, a rect lamp),
WHITTED on the bvh4 parity_mesh, and both on a built scene with a mirror
and a glass sphere, a point and a directional light beside the rect
lamp. Then `render_sample`'s
trace_type dispatch against the JAX render_sample, the gate's answer for
the other trace types, and the refusal of an unknown one."""

import jax.numpy as jnp
import numpy as np
import pytest

from craytracer_tpu.integrator.wavefront import render_sample as j_render
from craytracer_tpu.integrator.whitted import trace_raycast as j_raycast
from craytracer_tpu.integrator.whitted import trace_whitted as j_whitted
from craytracer_tpu_torch.integrator.gate import production_fast_shade
from craytracer_tpu_torch.integrator.wavefront import render_sample
from craytracer_tpu_torch.integrator.whitted import (trace_raycast,
                                                     trace_whitted)
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401
from torch_slice_f import SEED, build_both, jax_rays, load_both, t

pytestmark = SAH_WARNING_IS_ERROR
BAR = dict(rtol=2e-5, atol=2e-5)


def _lights_scene(b):
    b.add_matte("floor", (0.6, 0.6, 0.6))
    b.add_mirror("mir", (0.9, 0.9, 0.9))
    b.add_glass("glass")
    b.add_emissive("lamp", (1, 1, 1), 10.0)
    b.add_rect((-20, 0, -20), (40, 0, 0), (0, 0, 40), "floor")
    b.add_rect((-2, 12, -2), (4, 0, 0), (0, 0, 4), "lamp")
    b.add_sphere((-1.2, 1.0, 0), 1.0, "mir")
    b.add_sphere((1.2, 1.0, 0.5), 0.8, "glass")
    b.add_point_light((3, 6, 3), (1, 0.8, 0.6), 40.0)
    b.add_directional_light((0.3, -1, -0.2), (0.5, 0.5, 0.6), 1.5)


@pytest.fixture(scope="module")
def cases():
    from craytracer_tpu.camera import Film as JFilm
    from craytracer_tpu.camera import make_camera as j_cam

    out = {}
    for name in ("parity_mix", "parity_mesh"):
        (js, jc, jf), (ts, _, _) = load_both(name, 16)
        out[name] = (js, ts, jax_rays(jc, jf, 1))
    js, ts = build_both(_lights_scene)
    jf = JFilm(fov=jnp.float32(np.radians(40.0)), width=16, height=16)
    out["lights"] = (js, ts, jax_rays(j_cam((0, 3, 8), (0, 1, 0)), jf, 1))
    return out


@pytest.mark.parametrize("name,mode", [("parity_mix", "RAYCAST"),
                                       ("parity_mesh", "WHITTED"),
                                       ("lights", "RAYCAST"),
                                       ("lights", "WHITTED")])
def test_whitted_and_raycast_match_jax(cases, name, mode):
    """RAYCAST (one bounce, which WHITTED at depth 0 equals) and WHITTED
    at depth 3."""
    js, ts, (o, d, pix, spp) = cases[name]
    args = (SEED, jnp.asarray(pix), jnp.asarray(spp))
    if mode == "RAYCAST":
        ref = j_raycast(js, jnp.asarray(o), jnp.asarray(d), *args)
        got = trace_raycast(ts, t(o), t(d), SEED, t(pix), t(spp))
    else:
        ref = j_whitted(js, jnp.asarray(o), jnp.asarray(d), *args, 3)
        got = trace_whitted(ts, t(o), t(d), SEED, t(pix), t(spp), 3)
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(ref), **BAR)
    assert np.isfinite(got).all() and got.mean() > 1e-3


def test_render_sample_dispatches_trace_types():
    (js, jc, jf), (ts, tc, tf) = load_both("parity_cornell", 12)
    n = 12 * 12
    pix = np.arange(n, dtype=np.int32)
    spp = np.full(n, 5, np.int32)
    ref = np.asarray(j_render(js, jc, jf, jnp.asarray(pix), SEED,
                              jnp.asarray(spp), 3, trace_type="WHITTED"))
    for trace_type in ("WHITTED", "RAYCAST"):
        assert production_fast_shade(ts, tc, tf, max_depth=3,
                                     trace_type=trace_type) == "general"
    got = render_sample(ts, tc, tf, t(pix), SEED, t(spp), 3,
                        trace_type="WHITTED").numpy()
    np.testing.assert_allclose(got, ref, **BAR)
    with pytest.raises(ValueError, match="trace_type"):
        render_sample(ts, tc, tf, t(pix), SEED, t(spp), 3,
                      trace_type="AO")
