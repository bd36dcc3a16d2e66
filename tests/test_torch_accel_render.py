"""The accelerators on the render path against the JAX package:
`trace_paths` on scenes/parity_mesh_mid.txt (20,480 triangles) at 16x16
x 1 spp, depth 5, with each of bvh, bvh4q, grid, binned and hybrid built
by both packages, the same camera rays on both sides: the port's plain
route and its "shade" route on the CPU (the wrappers' plain versions)
against the JAX XLA trace_paths, L within 2e-5 (rtol and atol), good,
the ray and shadow-ray counts and the live histogram exact, on every
lane (measured: every lane, max |dL| below 1e-6; no lane is excused).

Then hybrid's shadow any hit on its own (binned over `tri_shadow`
behind the ray_key sort: verdicts equal to JAX's `shadow_distance`,
and K4's wrapper never called), WHITTED and the first-hit AOVs on
accel="bvh" (the bars of test_torch_trace_modes.py and
test_torch_aov.py), and the gate: Cornell's 20 triangles with
accel="bvh" take "shade", not K1, as JAX's gate sends a scene with a
tri_bvh (pallas_shade.py:1555-1559)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.integrator.aov import render_aovs as j_aovs
from craytracer_tpu.integrator.pallas_shade import \
    fast_shade_mode as j_fast_shade_mode
from craytracer_tpu.integrator.wavefront import trace_paths as j_trace
from craytracer_tpu.integrator.whitted import trace_whitted as j_whitted
from craytracer_tpu.ops.intersect import shadow_distance as j_shadow
from craytracer_tpu_torch.accel import bvh4_kernel
from craytracer_tpu_torch.integrator.aov import AOV_NAMES, render_aovs
from craytracer_tpu_torch.integrator.gate import production_fast_shade
from craytracer_tpu_torch.integrator.wavefront import trace_paths
from craytracer_tpu_torch.integrator.whitted import trace_whitted
from craytracer_tpu_torch.ops.intersect import shadow_distance
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401
from torch_slice_f import SEED, jax_rays, load_both, t

torch.set_num_threads(2)
pytestmark = SAH_WARNING_IS_ERROR
DEPTH = 5
BAR = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("accel", ["bvh", "bvh4q", "grid", "binned",
                                   "hybrid"])
def test_mesh_mid_trace_paths_matches_jax(accel):
    (js, jc, jf), (ts, _, _) = load_both("parity_mesh_mid", 16, accel=accel)
    assert ts.accel == accel and ts.tri_bvh is not None
    assert (ts.tri_shadow is not None) == (accel == "hybrid")
    o, d, pix, spp = jax_rays(jc, jf, 1)
    Lr, goodr, mr = j_trace(js, jnp.asarray(o), jnp.asarray(d), SEED,
                            jnp.asarray(pix), jnp.asarray(spp), DEPTH,
                            with_metrics=True)
    args = (ts, t(o), t(d), SEED, t(pix), t(spp), DEPTH)
    plain = trace_paths(*args, with_metrics=True)
    route = trace_paths(*args, with_metrics=True, fast_shade="shade")
    L, good, m = plain
    np.testing.assert_allclose(L.numpy(), np.asarray(Lr), **BAR)
    np.testing.assert_array_equal(good.numpy(), np.asarray(goodr))
    for k in ("rays", "shadow_rays", "bounce_live"):
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(mr[k]))
    assert int(mr["shadow_rays"]) > 0 and float(np.asarray(Lr).sum()) > 0
    assert torch.equal(route[0], L) and torch.equal(route[1], good)


def test_hybrid_shadow_any_hit(monkeypatch):
    """hybrid's shadow rays go through binned_any_hit over tri_shadow,
    never K4: shadow rays from the camera rays' first hits toward the
    lamp, verdicts equal to the JAX shadow_distance on every lane."""
    from craytracer_tpu_torch.ops.intersect import intersect_scene

    (js, jc, jf), (ts, _, _) = load_both("parity_mesh_mid", 16,
                                         accel="hybrid")
    o, d, _, _ = jax_rays(jc, jf, 1)
    hit = intersect_scene(ts, t(o), t(d))
    keep = (hit.t < 1e30).numpy()
    p = (hit.point + 1e-3 * hit.normal)[torch.from_numpy(keep)]
    rng = np.random.default_rng(3)
    target = torch.from_numpy(rng.uniform(-1.0, 1.0, (p.shape[0], 3))
                              .astype(np.float32) * 2.0
                              + np.float32([0.0, 9.0, 0.0]))
    to = target - p
    md = torch.linalg.norm(to, dim=1)
    sd = to / md[:, None]

    def no_k4(*a, **k):
        raise AssertionError("hybrid launched K4")

    monkeypatch.setattr(bvh4_kernel, "bvh4_any_hit_kernel", no_k4)
    got = shadow_distance(ts, p, sd, md, kernels=True).numpy()
    ref = np.asarray(j_shadow(js, jnp.asarray(p.numpy()),
                              jnp.asarray(sd.numpy()),
                              jnp.asarray(md.numpy())))
    occluded = ref < md.numpy()
    np.testing.assert_array_equal(got < md.numpy(), occluded)
    assert 0 < occluded.sum() < occluded.size


def test_whitted_on_bvh_matches_jax():
    (js, jc, jf), (ts, _, _) = load_both("parity_mesh_mid", 16, accel="bvh")
    o, d, pix, spp = jax_rays(jc, jf, 1)
    ref = j_whitted(js, jnp.asarray(o), jnp.asarray(d), SEED,
                    jnp.asarray(pix), jnp.asarray(spp), 3)
    got = trace_whitted(ts, t(o), t(d), SEED, t(pix), t(spp), 3).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), **BAR)
    assert np.isfinite(got).all() and got.mean() > 1e-3


def test_aovs_on_bvh_match_jax():
    (js, jc, jf), (ts, tc, tf) = load_both("parity_mesh_mid", 16, 12,
                                           accel="bvh")
    ref = {k: np.asarray(v) for k, v in j_aovs(js, jc, jf).items()}
    got = {k: v.numpy() for k, v in render_aovs(ts, tc, tf).items()}
    for k in AOV_NAMES:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5)
    assert got["depth"].any()


def test_cornell_with_bvh_routes_to_shade():
    (js, _, _), (ts, tc, tf) = load_both("parity_cornell", 8, accel="bvh")
    assert ts.tri_bvh is not None and ts.triangles.mat_id.shape[0] == 20
    assert production_fast_shade(ts, tc, tf) == "shade"
    assert j_fast_shade_mode(js) == "shade"
    _, (tn, tcn, tfn) = load_both("parity_cornell", 8)
    assert tn.accel == "none" and production_fast_shade(tn, tcn, tfn) == \
        "bounce"


@pytest.mark.parametrize("accel", ["bvh", "bvh4q", "grid", "binned",
                                   "hybrid"])
def test_scene_from_numpy_carries_every_table(accel):
    """interop.scene_from_numpy carries the JAX scene's table of each
    accelerator and hybrid's tri_shadow, equal to the port's own build;
    a JAX tri_cam is refused as not ported as such."""
    from craytracer_tpu_torch.interop import numpy_leaves, scene_from_numpy
    from test_torch_accel import assert_tables_equal

    (js, _, _), (ts, _, _) = load_both("parity_mesh", 8, accel=accel)
    leaves = numpy_leaves(js)
    got = scene_from_numpy(leaves, device="cpu")
    assert got.accel == accel and type(got.tri_bvh) is type(ts.tri_bvh)
    assert_tables_equal(js.tri_bvh, got.tri_bvh)
    assert_tables_equal(got.tri_bvh, ts.tri_bvh)
    if accel == "hybrid":
        assert_tables_equal(js.tri_shadow, got.tri_shadow)
        assert_tables_equal(got.tri_shadow, ts.tri_shadow)
    else:
        assert got.tri_shadow is None
    leaves["tri_cam"] = leaves["tri_shadow"] or leaves["tri_bvh"]
    with pytest.raises(NotImplementedError,
                       match=r"not ported as such \(ROADMAP\)"):
        scene_from_numpy(leaves, device="cpu")
