"""The port's counter RNG (craytracer_tpu_torch/sampling) against the JAX
package's, bit for bit: hash_u32, uniforms (including the CAMERA_BOUNCE
= 0x7FFF counter and per-lane spp) and stratified_jitter on 100k lanes
made from a numpy seed."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.sampling import rng as jrng
from craytracer_tpu.sampling.multijitter import stratified_jitter as j_strat
from craytracer_tpu_torch.sampling import rng as trng
from craytracer_tpu_torch.sampling.mappings import (map_to_disk_polar,
                                                    map_to_hemisphere_cosine)
from craytracer_tpu_torch.sampling.multijitter import (CAMERA_BOUNCE,
                                                       stratified_jitter)

torch.set_num_threads(2)
N = 100_000


def _lanes(seed):
    r = np.random.default_rng(seed)
    pix = r.integers(0, 1 << 24, N, dtype=np.int64).astype(np.int32)
    spp = r.integers(0, 4096, N, dtype=np.int64).astype(np.int32)
    return pix, spp


@pytest.mark.parametrize("lo,hi", [(0, 1 << 16), (0, 1 << 32),
                                   ((1 << 32) - 4096, 1 << 32)])
def test_hash_u32_bit_exact(lo, hi):
    x = np.random.default_rng(1).integers(lo, hi, N, dtype=np.uint64)
    ref = np.asarray(jrng.hash_u32(jnp.asarray(x.astype(np.uint32))))
    got = trng.hash_u32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("seed,bounce", [(0, 0), (7, 3), (123456, 30),
                                         (3, CAMERA_BOUNCE)])
@pytest.mark.parametrize("per_lane", [False, True])
def test_uniforms_bit_exact(seed, bounce, per_lane):
    pix, spp = _lanes(seed)
    spp_arg = spp if per_lane else 5
    ref = np.asarray(jrng.uniforms(seed, jnp.asarray(pix), jnp.asarray(spp_arg),
                                   bounce, 9, 0))
    got = trng.uniforms(seed, torch.from_numpy(pix),
                        torch.from_numpy(spp) if per_lane else 5,
                        bounce, 9, 0).numpy()
    assert got.dtype == np.float32 and got.shape == (N, 9)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 3, 99])
@pytest.mark.parametrize("per_lane", [False, True])
def test_stratified_jitter_bit_exact(seed, per_lane):
    pix, spp = _lanes(seed + 10)
    spp_j = jnp.asarray(spp) if per_lane else 17
    spp_t = torch.from_numpy(spp) if per_lane else 17
    ref = np.asarray(j_strat(seed, jnp.asarray(pix), spp_j))
    got = stratified_jitter(seed, torch.from_numpy(pix), spp_t).numpy()
    np.testing.assert_array_equal(got, ref)


def test_warps_match_jax():
    """The polar disk and cosine hemisphere warps: same formulas, so x and
    y agree to an f32 ulp (sin/cos come from different libraries). The
    hemisphere's z = sqrt(1 - x^2 - y^2) magnifies that ulp near the rim
    (dz = -(x dx + y dy) / z), hence 2e-5 on z."""
    from craytracer_tpu.sampling import mappings as jm

    u = np.random.default_rng(5).random((N, 2), dtype=np.float32)
    ref = np.asarray(jm.map_to_disk_polar(jnp.asarray(u)))
    got = map_to_disk_polar(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    ref = np.asarray(jm.map_to_hemisphere_cosine(jnp.asarray(u)))
    got = map_to_hemisphere_cosine(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=0, atol=2e-5)
