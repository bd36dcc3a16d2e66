"""K6's plain version against the JAX package's brute-force triangle kernel.

`pack_triangles` (craytracer_tpu_torch/ops/tri_kernel.py) must equal
craytracer_tpu/ops/pallas_tri.py `pack_triangles` bit for bit, and the
plain `triangle_closest` (which the K6 wrapper takes for CPU tensors) is
held against `pallas_triangle_closest` in interpret mode, as
tests/test_pallas_kernel.py:8-23 holds that kernel to the XLA
`triangle_ts`: 300 random triangles and 700 random rays (seed 0), the
same triangles with a block of 40 repeated (exact-t ties, which both
sides give to the lower index), and scenes/parity_mesh.txt's 320
triangles against its 24x24 camera rays.

Bars: idx equal on every lane; t within rtol 1e-5 where a triangle was
hit (XLA's CPU backend contracts multiply-adds into FMAs; the port
rounds each operation, as K6 does with --fmad=false), TMAX on the
misses.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.ops.pallas_tri import (pack_triangles as j_pack,
                                           pallas_triangle_closest)
from craytracer_tpu_torch.camera import Film, generate_rays
from craytracer_tpu_torch.constants import TMAX
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.ops.tri_kernel import (pack_triangles,
                                                 triangle_closest,
                                                 triangle_closest_kernel)
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(REPO, "scenes", "parity_mesh.txt")


def _random(ties: bool):
    rng = np.random.default_rng(0)
    base = rng.uniform(-10, 10, (300, 3))
    v = [base + rng.normal(0, 1, (300, 3)) for _ in range(3)]
    o = rng.uniform(-15, 15, (700, 3)).astype(np.float32)
    d = rng.normal(size=(700, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    if ties:
        v = [np.concatenate([x, x[100:140]]) for x in v]
    return v, o, d


def _mesh():
    scene, cam, film = load_scene_file(MESH, device="cpu")
    tr = scene.triangles
    v = [x.numpy() for x in (tr.v0, tr.v1, tr.v2)]
    film = Film(fov=film.fov, width=24, height=24)
    pix = torch.arange(film.num_pixels, dtype=torch.int32)
    o, d = generate_rays(cam, film, pix, stratified_jitter(5, pix, 0))
    return v, o.numpy(), d.numpy()


@pytest.mark.parametrize("case", ["random", "ties", "parity_mesh"])
def test_triangle_closest_matches_jax(case):
    v, o, d = _mesh() if case == "parity_mesh" else _random(case == "ties")
    soa = pack_triangles(*v)
    np.testing.assert_array_equal(soa.numpy(), np.asarray(j_pack(*v)))
    assert soa.shape[1] % 128 == 0
    t, idx = triangle_closest(torch.from_numpy(o), torch.from_numpy(d), soa)
    t_k, idx_k = triangle_closest_kernel(torch.from_numpy(o),
                                         torch.from_numpy(d), soa)
    assert torch.equal(t, t_k) and torch.equal(idx, idx_k)
    jt, jidx = pallas_triangle_closest(jnp.asarray(o), jnp.asarray(d),
                                       j_pack(*v), interpret=True)
    jt, jidx = np.asarray(jt), np.asarray(jidx)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    hit = jidx >= 0
    assert hit.sum() > 30 and (~hit).sum() > 30
    np.testing.assert_allclose(t.numpy()[hit], jt[hit], rtol=1e-5)
    assert (t.numpy()[~hit] == TMAX).all()
    if case == "ties":  # the repeated block never wins: lower index first
        assert not (idx.numpy() >= 300).any() and (
            (idx.numpy() >= 100) & (idx.numpy() < 140)).any()
