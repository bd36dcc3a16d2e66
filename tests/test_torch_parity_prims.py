"""scenes/parity_prims.txt (an instanced torus and box, a disk, rects),
the scene of the "shade" route's new groups, through the port on the
CPU, against the JAX package and the reference binary's golden.

- Whole passes: the port's plain `trace_paths` (the torch-op intersection
  of every group, the plain shade, the plain shadow distance per bounce)
  against JAX's XLA `trace_paths` on JAX's 24x24 camera rays, depth 0, 2
  and 5. XLA:CPU contracts the torus quartic's multiply-adds, which moves
  a grazing lane's t by up to ~3e-4 (test_torch_prims.py) and can send it
  down another path, so the bar is: >= 99% of lanes with equal good and
  L within 5e-5; rays, shadow rays and each bounce's live count apart by
  at most 0.5% of the rays, exact at depth 0 (measured: 99.65% of lanes;
  2 rays and 1 shadow ray apart in 1,476 and 831 at depth 5). Against
  JAX's trace_paths with jit disabled (op by op, no contraction) the
  counters agree exactly.
- The golden: the Renderer at 128x128 @ 64 spp, depth 5, spp_batch 16
  (four passes of 262,144 lanes) against tests/goldens/golden_prims.is by
  tone-mapped 8x8 block means with the thresholds of
  tests/test_reference_parity.py:149-154."""

import os

import numpy as np
import pytest
import torch

from craytracer_tpu_torch.integrator.gate import production_fast_shade
from craytracer_tpu_torch.integrator.wavefront import trace_paths

from test_torch_pass_prims import SEED, SIZE, SPP, _jax_pass, _scenes
from test_torch_render import REPO, _render_against_golden

GOLDEN_PRIMS = os.path.join(REPO, "tests", "goldens", "golden_prims.is")


@pytest.mark.parametrize("depth", [0, 2, 5])
def test_parity_prims_shade_route_matches_xla(depth):
    js, jc, jf, ts, tc, tf = _scenes("parity_prims")
    assert production_fast_shade(ts, tc, tf) == "shade"
    o, d, (Lr, goodr, mr) = _jax_pass(js, jc, jf, depth)
    L, good, m = trace_paths(ts, torch.tensor(np.asarray(o)),
                             torch.tensor(np.asarray(d)), SEED,
                             torch.arange(SIZE * SIZE, dtype=torch.int32),
                             SPP, depth, with_metrics=True)
    L, good = L.numpy(), good.numpy()
    agree = (good == goodr) & (np.abs(L - Lr) <= 5e-5 + 5e-5 * np.abs(Lr)
                               ).all(axis=1)
    assert agree.mean() >= 0.99
    rays = int(mr["rays"])
    for key in ("rays", "shadow_rays", "bounce_live"):
        a, b = m[key].numpy(), mr[key]
        if depth == 0:
            np.testing.assert_array_equal(a, b, err_msg=key)
        assert (np.abs(a - b) <= 5e-3 * rays).all(), key
    assert depth == 0 or (Lr.mean() > 0.05 and int(mr["shadow_rays"]) > 0)


def test_renderer_matches_golden_prims():
    _render_against_golden(os.path.join(REPO, "scenes", "parity_prims.txt"),
                           GOLDEN_PRIMS)
