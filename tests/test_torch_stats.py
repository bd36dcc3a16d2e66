"""Intersect diagnostics (craytracer_tpu_torch/utils/stats.py) and the
pass metrics (utils/metrics.py) against the JAX package's: the
brute-force test counts exact on parity_cornell (and on parity_mesh
built without an accelerator), the BVH4 pops equal lane for lane on the
bvh4 parity_mesh (so mean, p99, max and the slot tests are equal), the
printout identical; and `collect` on the port's metrics dict against JAX
`collect` on the JAX trace's."""

import jax.numpy as jnp
import numpy as np
import pytest

from craytracer_tpu.accel.bvh4 import bvh4_closest_hit_stats as j_pops
from craytracer_tpu.integrator.wavefront import trace_paths as j_trace
from craytracer_tpu.utils.metrics import collect as j_collect
from craytracer_tpu.utils.stats import format_stats as j_format
from craytracer_tpu.utils.stats import intersect_stats as j_stats
from craytracer_tpu_torch.accel.bvh4 import bvh4_closest_hit_stats
from craytracer_tpu_torch.integrator.wavefront import trace_paths
from craytracer_tpu_torch.utils.metrics import collect
from craytracer_tpu_torch.utils.stats import format_stats, intersect_stats
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401
from torch_slice_f import SEED, jax_rays, load_both, t

pytestmark = SAH_WARNING_IS_ERROR


@pytest.mark.parametrize("name,accel", [("parity_cornell", "auto"),
                                        ("parity_mesh", "none"),
                                        ("parity_mesh", "bvh4")])
def test_intersect_stats_match_jax(name, accel):
    (js, jc, jf), (ts, _, _) = load_both(name, 20, accel=accel)
    o, d, _, _ = jax_rays(jc, jf, 1)
    ref = j_stats(js, jnp.asarray(o), jnp.asarray(d))
    got = intersect_stats(ts, t(o), t(d))
    assert got == ref
    assert format_stats(got) == j_format(ref)
    if ts.accel == "bvh4":
        pops = bvh4_closest_hit_stats(ts.tri_bvh, t(o), t(d))[2].numpy()
        np.testing.assert_array_equal(
            pops, np.asarray(j_pops(js.tri_bvh, jnp.asarray(o),
                                    jnp.asarray(d))[2]))
        assert got["bvh4"]["pops_max"] > 0


def test_collect_matches_jax():
    (js, jc, jf), (ts, _, _) = load_both("parity_cornell", 12)
    o, d, pix, spp = jax_rays(jc, jf, 2)
    ref = j_trace(js, jnp.asarray(o), jnp.asarray(d), SEED,
                  jnp.asarray(pix), jnp.asarray(spp), 3, with_metrics=True)
    L, _, m = trace_paths(ts, t(o), t(d), SEED, t(pix), t(spp), 3,
                          with_metrics=True)
    L[5, 1] = float("nan")
    Lr = np.array(ref[0])
    Lr[5, 1] = np.nan
    got, want = collect(m, L, 0.25), j_collect(ref[2], Lr, 0.25)
    assert (got.rays, got.shadow_rays, got.nan_pixels) == (
        want.rays, want.shadow_rays, want.nan_pixels) and got.nan_pixels == 1
    np.testing.assert_array_equal(got.bounce_live, want.bounce_live)
    assert got.rays_per_sec == want.rays_per_sec > 0
    np.testing.assert_array_equal(got.occupancy, want.occupancy)
    assert got.summary() == want.summary()
