"""The port's texel addressing and lookups against the JAX package's
(craytracer_tpu_torch/bsdf/texture.py vs craytracer_tpu/bsdf/texture.py)
on the same seeded numpy inputs: uv covering negatives, values past 1,
exact texel halves (round half down), the poles (v = 0 and 1, where row
0 takes both slivers) and ids of -1 and past the table.
`nearest_texel_xy` is exact (integers), `tex_lookup_nearest` bit-equal,
`tex_lookup_bilinear` within 1e-6 (XLA may contract its multiply-adds)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.bsdf import texture as jt
from craytracer_tpu.scene.types import TexturePack as JPack
from craytracer_tpu_torch.bsdf import texture as tt
from craytracer_tpu_torch.scene.types import TexturePack

SIZES = [(4, 8), (5, 3), (16, 16), (1, 1)]  # (h, w)


def _pack():
    rng = np.random.default_rng(0)
    texels = [rng.random((h * w, 3)).astype(np.float32) for h, w in SIZES]
    off = np.cumsum([0] + [h * w for h, w in SIZES[:-1]]).astype(np.int32)
    arrs = (np.concatenate(texels), off,
            np.array([w for _, w in SIZES], np.int32),
            np.array([h for h, _ in SIZES], np.int32))
    return (JPack(*map(jnp.asarray, arrs)),
            TexturePack(*map(torch.from_numpy, arrs)))


def _uv(n=4096):
    rng = np.random.default_rng(1)
    uv = rng.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    special = np.array([0.0, 1.0, -1.0, 0.5, 1.5, 2.0, -0.5, 1e-7,
                        1 - 1e-7, 0.125, 0.0625, 0.375, 0.2, 0.1, 0.9],
                       np.float32)
    grid = np.stack(np.meshgrid(special, special), -1).reshape(-1, 2)
    # exact halves of every size: (k + 0.5) / w
    halves = np.concatenate([np.stack([(np.arange(w) + 0.5) / w,
                                       (np.arange(w) % h + 0.5) / h], -1)
                             for h, w in SIZES]).astype(np.float32)
    return np.concatenate([uv, grid, halves])


def test_nearest_texel_xy_exact():
    uv = _uv()
    for h, w in SIZES:
        jw, jh = jnp.full(uv.shape[0], w, jnp.int32), jnp.full(
            uv.shape[0], h, jnp.int32)
        jx, jy = jt.nearest_texel_xy(jw, jh, jnp.asarray(uv[:, 0]),
                                     jnp.asarray(uv[:, 1]))
        tx, ty = tt.nearest_texel_xy(torch.full((uv.shape[0],), w,
                                                dtype=torch.int32),
                                     torch.full((uv.shape[0],), h,
                                                dtype=torch.int32),
                                     torch.from_numpy(uv[:, 0]),
                                     torch.from_numpy(uv[:, 1]))
        assert tx.dtype == ty.dtype == torch.int32
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        assert (tx.numpy() >= 0).all() and (tx.numpy() < w).all()
        assert (ty.numpy() >= 0).all() and (ty.numpy() < h).all()


def test_row_zero_owns_both_poles():
    w = h = torch.tensor([8], dtype=torch.int32)
    for v in (0.0, 1e-3, 1.0, 1 - 1e-3):
        _, y = tt.nearest_texel_xy(w, h, torch.tensor([0.3]),
                                   torch.tensor([v]))
        assert int(y) == 0, v


@pytest.mark.parametrize("lookup", ["tex_lookup_nearest",
                                    "tex_lookup_bilinear"])
def test_lookups_match_jax(lookup):
    jpack, tpack = _pack()
    uv = _uv()
    rng = np.random.default_rng(2)
    tid = rng.integers(-1, len(SIZES) + 1, uv.shape[0]).astype(np.int32)
    ref = np.asarray(getattr(jt, lookup)(jpack, jnp.asarray(tid),
                                         jnp.asarray(uv)))
    ours = getattr(tt, lookup)(tpack, torch.from_numpy(tid),
                               torch.from_numpy(uv)).numpy()
    if lookup == "tex_lookup_nearest":
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
