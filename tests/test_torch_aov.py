"""First-hit AOVs (craytracer_tpu_torch/integrator/aov.py `render_aovs`)
against the JAX package's `render_aovs` on parity_cornell, parity_mix and
the bvh4 parity_mesh at 24x20: every buffer within 1e-5 (rtol and atol),
and the miss masks (all-zero rows) exact."""

import numpy as np
import pytest

from craytracer_tpu.integrator.aov import AOV_NAMES as J_NAMES
from craytracer_tpu.integrator.aov import render_aovs as j_aovs
from craytracer_tpu_torch.integrator.aov import AOV_NAMES, render_aovs
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401
from torch_slice_f import load_both

pytestmark = SAH_WARNING_IS_ERROR


@pytest.mark.parametrize("name", ["parity_cornell", "parity_mix",
                                  "parity_mesh"])
def test_aovs_match_jax(name):
    (js, jc, jf), (ts, tc, tf) = load_both(name, 24, 20)
    ref = {k: np.asarray(v) for k, v in j_aovs(js, jc, jf).items()}
    got = {k: v.numpy() for k, v in render_aovs(ts, tc, tf).items()}
    assert AOV_NAMES == J_NAMES and set(got) == set(AOV_NAMES)
    miss = ~ref["depth"].any(axis=1)
    assert 0 < miss.sum() < miss.size or name != "parity_mesh"
    for k in AOV_NAMES:
        assert got[k].shape == (24 * 20, 3) and got[k].dtype == np.float32
        np.testing.assert_array_equal(~got[k].any(axis=1) & miss, miss)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5)
