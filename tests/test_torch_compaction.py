"""Stream compaction (craytracer_tpu_torch/integrator/wavefront.py
`_trace(compact_at=B)`, the JAX `trace_paths(compact_at=B)`,
wavefront.py:499-560, with the auto policy of `render_sample` :639-650).

- The port's `trace_paths(compact_at=2)` against the JAX one on the same
  camera rays with a per-lane spp (16x16 at 2 spp), at depth 16, on
  parity_mesh_mid (20,480 triangles, bvh4; the "shade" route's plain
  version against JAX's XLA step) and on parity_cornell (the "shade"
  step, K1's plain version). `good` and the live histogram exact, L within
  2e-5 (rtol and atol).
- `render_sample` on parity_mesh_mid at depth 16 under the reference,
  physical and MIS estimators (the general step), where both packages'
  policy compacts at bounce 2, against the JAX render_sample, L within
  2e-5.
- The port compacted against the port dense: L, good, every lane's ray
  and shadow-ray counts and the histogram bit-equal, with the second half
  run and skipped; a per-lane spp with two spp per pixel, as a batched
  render gives it.
- A gradient through a compacted general step (d mean L / d a material
  color) equal to the dense one."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.integrator.wavefront import render_sample as j_render
from craytracer_tpu.integrator.wavefront import trace_paths as j_trace
from craytracer_tpu_torch.integrator import wavefront as wf
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401
from torch_slice_f import SEED, jax_rays, load_both, t

torch.set_num_threads(2)
pytestmark = SAH_WARNING_IS_ERROR
BAR = dict(rtol=2e-5, atol=2e-5)
DEPTH = 16


@pytest.fixture(scope="module")
def mesh():
    (js, jc, jf), (ts, tc, tf) = load_both("parity_mesh_mid", 16)
    return js, ts, jc, jf, tc, tf, jax_rays(jc, jf, 2)


@pytest.mark.parametrize("name", ["parity_mesh_mid", "parity_cornell"])
def test_compacted_trace_matches_jax(mesh, name, mis=False):
    if name == "parity_mesh_mid":
        js, ts, *_, (o, d, pix, spp) = mesh
    else:
        (js, jc, jf), (ts, _, _) = load_both(name, 16)
        o, d, pix, spp = jax_rays(jc, jf, 2)
    ref = j_trace(js, jnp.asarray(o), jnp.asarray(d), SEED,
                  jnp.asarray(pix), jnp.asarray(spp), DEPTH,
                  with_metrics=True, mis=mis, compact_at=2)
    before = wf.COMPACTION.traces
    L, good, m = wf.trace_paths(ts, t(o), t(d), SEED, t(pix), t(spp), DEPTH,
                                with_metrics=True, mis=mis, compact_at=2)
    assert wf.COMPACTION.traces == before + 1 and "compact_hi" in m
    np.testing.assert_array_equal(good.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(m["bounce_live"].numpy(),
                                  np.asarray(ref[2]["bounce_live"]))
    assert int(m["rays"]) == int(ref[2]["rays"])
    assert int(m["shadow_rays"]) == int(ref[2]["shadow_rays"])
    np.testing.assert_allclose(L.numpy(), np.asarray(ref[0]), **BAR)


@pytest.mark.parametrize("estimator", ["reference", "physical", "mis"])
def test_render_sample_auto_compaction_matches_jax(mesh, estimator):
    js, ts, jc, jf, tc, tf, (_, _, pix, spp) = mesh
    assert wf.compact_policy(ts, DEPTH) == 2 and wf.compact_policy(ts, 7) == 0
    ref = np.asarray(j_render(js, jc, jf, jnp.asarray(pix), SEED,
                              jnp.asarray(spp), DEPTH, estimator=estimator))
    before = wf.COMPACTION.traces
    got = wf.render_sample(ts, tc, tf, t(pix), SEED, t(spp), DEPTH,
                           estimator=estimator).numpy()
    assert wf.COMPACTION.traces == before + 1
    np.testing.assert_allclose(got, ref, **BAR)


def _assert_same(a, b):
    (L, good, m), (L2, good2, m2) = a, b
    assert torch.equal(L, L2) and torch.equal(good, good2)
    for k in ("lane_rays", "lane_shadow_rays", "bounce_live"):
        assert torch.equal(m[k], m2[k]), k


@pytest.mark.parametrize("general", [False, True])
def test_compacted_equals_dense_bit_for_bit(mesh, general):
    _, ts, *_, (o, d, pix, spp) = mesh
    args = (ts, t(o), t(d), SEED, t(pix), t(spp))
    hi = set()
    for depth, at in ((DEPTH, 2), (6, 4), (4, 1)):
        dense = wf.trace_paths(*args, depth, with_metrics=True,
                               general=general)
        comp = wf.trace_paths(*args, depth, with_metrics=True,
                              general=general, compact_at=at)
        _assert_same(comp, dense)
        hi.add(comp[2]["compact_hi"])
    # after bounce 0 more than half the lanes live: the second half runs;
    # deeper, it is skipped
    assert hi == {False, True}
    # a scalar spp, and a compaction past the depth (dense)
    _assert_same(wf.trace_paths(*args[:5], 5, 6, with_metrics=True,
                                compact_at=2),
                 wf.trace_paths(*args[:5], 5, 6, with_metrics=True))


def test_gradient_through_a_compacted_general_step(mesh):
    _, ts, *_, (o, d, pix, spp) = mesh
    grads = []
    for at in (0, 2):
        color = ts.materials.color.clone().requires_grad_(True)
        scene = dataclasses.replace(
            ts, materials=dataclasses.replace(ts.materials, color=color))
        L, _ = wf.trace_paths(scene, t(o), t(d), SEED, t(pix), t(spp), 5,
                              compact_at=at)
        L.mean().backward()
        grads.append(color.grad)
    assert grads[0].abs().sum() > 0
    assert torch.equal(grads[0], grads[1])
