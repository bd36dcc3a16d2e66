"""The table samplers (craytracer_tpu_torch/sampling/tables.py and
multijitter.py `multijittered_table`) against the JAX package's: the
regular, multijittered and Hammersley tables bit-equal (both are numpy,
from `default_rng(seed)`), `make_sample_table`'s points equal, and
`table_sample` exact on the same pixels, spp (an int or per lane) and
dimension; a JAX table carried over by interop.py equal to the port's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.sampling import tables as jt
from craytracer_tpu.sampling.multijitter import multijittered_table as j_mj
from craytracer_tpu_torch.interop import (numpy_leaves,
                                          sample_table_from_numpy)
from craytracer_tpu_torch.sampling import tables as tt
from craytracer_tpu_torch.sampling.multijitter import (
    multijittered_table as t_mj)


@pytest.mark.parametrize("num_samples,num_sets,seed",
                         [(16, 5, 0), (64, 3, 7), (1, 83, 2)])
def test_tables_bit_equal(num_samples, num_sets, seed):
    pairs = [(jt.regular_table(num_samples, num_sets),
              tt.regular_table(num_samples, num_sets)),
             (j_mj(num_samples, num_sets, seed),
              t_mj(num_samples, num_sets, seed)),
             (jt.hammersley_table(num_samples, num_sets, seed),
              tt.hammersley_table(num_samples, num_sets, seed))]
    for ref, got in pairs:
        assert got.dtype == ref.dtype == np.float32
        assert got.shape == (num_sets, num_samples, 2)
        assert np.array_equal(got, ref)
    with pytest.raises(ValueError):
        t_mj(15, 2)


@pytest.mark.parametrize("kind", tt.KINDS)
def test_table_sample_exact(kind):
    jtab = jt.make_sample_table(kind, 16, 7, seed=3)
    ttab = tt.make_sample_table(kind, 16, 7, seed=3, device="cpu")
    assert ttab.kind == kind and (ttab.num_sets, ttab.num_samples) == (7, 16)
    assert np.array_equal(ttab.points.numpy(), np.asarray(jtab.points))
    carried = sample_table_from_numpy(numpy_leaves(jtab), device="cpu")
    assert carried.kind == kind and torch.equal(carried.points, ttab.points)
    pix = np.arange(0, 4000, 3, dtype=np.int32)
    spp = (np.arange(pix.shape[0], dtype=np.int32) * 7) % 40
    for seed, s, dim in ((0, 5, 0), (11, 21, 0), (0xFFFFFFF0, 3, 2)):
        ref = jt.table_sample(jtab, seed, jnp.asarray(pix), s, dim)
        got = tt.table_sample(ttab, seed, torch.from_numpy(pix), s, dim)
        assert np.array_equal(got.numpy(), np.asarray(ref))
    ref = jt.table_sample(jtab, 5, jnp.asarray(pix), jnp.asarray(spp), 0)
    got = tt.table_sample(ttab, 5, torch.from_numpy(pix),
                          torch.from_numpy(spp), 0)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        tt.make_sample_table("sobol", 16, device="cpu")
