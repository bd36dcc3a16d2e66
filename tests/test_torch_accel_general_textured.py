"""The general route on every accelerator against the JAX package on
scenes/parity_textured.txt (a checker on a rect, a smooth-normal quad
mesh, an EXR texture env): each of bvh, bvh4q, grid, binned and hybrid
built by both packages' scene-file loaders, `trace_paths` through
`_general_step` at 16x16 x 1 spp, depth 5, under the physical estimator,
hybrid also under MIS, against the JAX XLA
`trace_paths(fast_shade=False)` with tests/test_torch_accel_general.py's
check and bars (measured: every lane within them; none excused).
"""

import pytest
import torch

from test_torch_accel_general import ACCELS, case_ids, check, traced
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401

torch.set_num_threads(2)
pytestmark = SAH_WARNING_IS_ERROR
CASES = ([("parity_textured", accel, False) for accel in ACCELS]
         + [("parity_textured", "hybrid", True)])


@pytest.fixture(scope="module")
def refs(jax_native):  # noqa: F811
    return traced(CASES)


@pytest.mark.parametrize("name,accel,mis", CASES, ids=case_ids(CASES))
def test_general_route_on_accel_matches_jax(refs, name, accel, mis):
    check(refs[name, accel, mis], accel)
