"""P1's plain version (craytracer_tpu_torch/profiling/pop_probe.py
`pop_probe`) against the JAX probe's kernel body.

profiling/ablate_pallas_pop.py `make_kernel(mode, pops, m)` is wrapped
here in a `pl.pallas_call(..., interpret=True)` with the BlockSpecs of
its `run` (:160-175) at a packet of 32 lanes, the port's packet (a warp).
Inputs: the fat table of an icosphere(2) scaled by 3 (built by the port;
real boxes, child ids and triangles) and 96 rays (three packets) from a
camera-like bundle aimed at it, 64 pops of the LCG stack.

Bars: per lane t = best_t + acc. In the modes whose t is integer
arithmetic on the stack and the table (empty, rowload, cols, colsdir,
box) t is equal on every lane; in mt and full, whose best_t comes from
Moller-Trumbore, within rtol 1e-5 (XLA's CPU backend contracts
multiply-adds into FMAs; the port rounds each operation, as the CUDA
kernel does with --fmad=false). The wrapper takes the plain version for
CPU tensors.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from craytracer_tpu_torch.accel.bvh4 import build_bvh4
from craytracer_tpu_torch.profiling.pop_probe import (MODES, PACKET,
                                                      lcg_nodes, pop_probe,
                                                      pop_probe_kernel)
from craytracer_tpu_torch.scene.city import icosphere

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "profiling"))
from ablate_pallas_pop import make_kernel  # noqa: E402

POPS = 64


def _jax_probe(fat, o, d, mode, pops):
    """ablate_pallas_pop.py's `run` at a block of PACKET lanes, interpreted."""
    blocks = o.shape[0] // PACKET
    return pl.pallas_call(
        make_kernel(mode, pops, fat.shape[0]),
        grid=(blocks,),
        in_specs=[
            pl.BlockSpec((3, PACKET), lambda i: (0, i)),
            pl.BlockSpec((3, PACKET), lambda i: (0, i)),
            pl.BlockSpec(fat.shape, lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((1, PACKET), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((1, blocks * PACKET), jnp.float32),
        scratch_shapes=[pltpu.SMEM((8192,), jnp.int32)],
        interpret=True,
    )(o.T, d.T, fat)[0]


@pytest.fixture(scope="module")
def inputs():
    v, f = icosphere(2)
    bvh = build_bvh4(*(v[f[:, k]] * 3 for k in range(3)))
    rng = np.random.default_rng(1)
    n = 3 * PACKET
    o = np.tile([[0.0, 0.5, 8.0]], (n, 1)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] -= 1.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return bvh.fat, torch.from_numpy(o), torch.from_numpy(d)


def test_lcg_stack_matches_int32_arithmetic():
    m = 91
    i = np.arange(5000, dtype=np.int32)
    with np.errstate(over="ignore"):
        ref = (i * np.int32(1103515245) + np.int32(12345)) % np.int32(m)
    assert lcg_nodes(5000, m) == ref.tolist()
    assert min(lcg_nodes(5000, m)) >= 0


@pytest.mark.parametrize("mode", MODES)
def test_pop_probe_matches_jax_body(inputs, mode):
    fat, o, d = inputs
    t, sink = pop_probe(fat, o, d, mode, POPS)
    t_k, sink_k = pop_probe_kernel(fat, o, d, mode, POPS)
    assert torch.equal(t, t_k) and torch.equal(sink, sink_k)
    ref = np.asarray(_jax_probe(jnp.asarray(fat.numpy()),
                                jnp.asarray(o.numpy()),
                                jnp.asarray(d.numpy()), mode, POPS))
    if mode in ("mt", "full"):
        np.testing.assert_allclose(t.numpy(), ref, rtol=1e-5)
        assert (ref < 1e30).sum() > 8  # triangles were hit
    else:
        np.testing.assert_array_equal(t.numpy(), ref)
    if mode in ("box", "full"):
        assert (sink != 0).all()
    else:
        assert (sink == 0).all()
