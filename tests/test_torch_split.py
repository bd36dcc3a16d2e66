"""K5's plain version against the JAX package's split-table kernel.

The port's K5 wrapper (craytracer_tpu_torch/accel/bvh4_split_kernel.py
`bvh4_closest_hit_split_kernel`) takes accel/bvh4.py
`bvh4_closest_hit_init` for CPU tensors: the closest hit from a carried
best hit, or from TMAX / -1 without one. It is held against
`pallas_bvh4_closest_hit_hbm` in interpret mode, without and with
`with_init`, as tests/test_pallas_kernel.py:140-175 holds that kernel to
the XLA walk: an icosphere(2) scaled by 3 and a camera-like bundle of 500
rays, half the lanes carrying a hit at half their closest t under id
7777; and on every part of tests/test_torch_parts.py's 16-icosphere
table cut at a fifth of its bytes, with the best hit of the parts before
it carried. The fat table is the port's, handed to JAX as a BVH4Arrays of
the same rows.

Bars: triangle ids equal on >= 99.9% of lanes and t within rtol 1e-5
where they agree (tests/test_torch_bvh4.py's bar: XLA's CPU backend
contracts multiply-adds into FMAs); where a carried hit is kept, t and id
are the carried ones exactly. The topology table is the fat rows' first
32 columns.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.accel.pallas_bvh4 import pallas_bvh4_closest_hit_hbm
from craytracer_tpu_torch.accel import bvh4_parts as tp
from craytracer_tpu_torch.accel.bvh4 import build_bvh4, bvh4_closest_hit
from craytracer_tpu_torch.accel.bvh4_split_kernel import (
    bvh4_closest_hit_split_kernel, split_topology)
from craytracer_tpu_torch.constants import TMAX
from craytracer_tpu_torch.scene.city import icosphere

import test_torch_parts as parts_case
from test_torch_parts import _jax_bvh

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ico():
    """tests/test_pallas_kernel.py:140-160: icosphere(2) x 3, the bundle."""
    v, f = icosphere(2)
    bvh = build_bvh4(*(v[f[:, k]] * 3 for k in range(3)))
    rng = np.random.default_rng(1)
    n = 500
    o = np.tile([[0.0, 0.5, 8.0]], (n, 1)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] -= 1.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return bvh, torch.from_numpy(o), torch.from_numpy(d)


def _carried(t_ref):
    n = t_ref.shape[0]
    even = torch.arange(n) % 2 == 0
    t0 = torch.where(even & (t_ref < TMAX), t_ref * 0.5,
                     torch.full_like(t_ref, TMAX))
    return t0, torch.where(t0 < TMAX, 7777, -1).to(torch.int32)


def _check(t, tri, jt, jtri, t0=None, tri0=None):
    jt, jtri = np.asarray(jt), np.asarray(jtri)
    same = tri.numpy() == jtri
    assert same.mean() >= 0.999
    hit = same & (jt < TMAX)
    assert hit.sum() > 15
    np.testing.assert_allclose(t.numpy()[hit], jt[hit], rtol=1e-5)
    if t0 is not None:
        kept = (tri == 7777).numpy()
        assert kept.any()
        np.testing.assert_array_equal(t.numpy()[kept], t0.numpy()[kept])


def test_topology_is_the_fat_rows_boxes_and_children(ico):
    bvh = ico[0]
    topo = split_topology(bvh)
    assert topo.shape == (bvh.fat.shape[0], 32) and topo.is_contiguous()
    assert torch.equal(topo, bvh.fat[:, :32])


@pytest.mark.parametrize("with_init", [False, True])
def test_split_plain_matches_jax_hbm(ico, with_init):
    bvh, o, d = ico
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    if not with_init:
        t, tri = bvh4_closest_hit_split_kernel(bvh, o, d)
        assert torch.equal(t, bvh4_closest_hit(bvh, o, d)[0])
        _check(t, tri, *pallas_bvh4_closest_hit_hbm(_jax_bvh(bvh), jo, jd,
                                                     interpret=True))
        return
    t0, tri0 = _carried(bvh4_closest_hit(bvh, o, d)[0])
    t, tri = bvh4_closest_hit_split_kernel(bvh, o, d, t0, tri0)
    out = pallas_bvh4_closest_hit_hbm(
        _jax_bvh(bvh), jo, jd, jnp.asarray(t0.numpy()),
        jnp.asarray(tri0.numpy()), interpret=True, with_init=True)
    _check(t, tri, *out, t0, tri0)


def test_split_plain_matches_jax_hbm_on_parts():
    ours = parts_case._mesh()
    parts = tp.partition_bvh4(ours, ours.fat.numel() * 4 // 5)
    assert len(parts) > 2
    rng = np.random.default_rng(4)
    o = rng.uniform(-12, 12, (700, 3)).astype(np.float32)
    d = rng.normal(0, 5, (700, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    t, tri = _carried(bvh4_closest_hit(ours, o, d)[0])
    for p in parts:
        jt, jtri = pallas_bvh4_closest_hit_hbm(
            _jax_bvh(p), jo, jd, jnp.asarray(t.numpy()),
            jnp.asarray(tri.numpy()), interpret=True, with_init=True)
        t, tri = bvh4_closest_hit_split_kernel(p, o, d, t, tri)
        _check(t, tri, jt, jtri)
