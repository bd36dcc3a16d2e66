"""Multijittered sample tables and the stratified film jitter
(counterpart of craytracer_tpu/sampling/multijitter.py:
`multijittered_table` :23, `stratified_jitter` :46).

`multijittered_table` is the reference's table generator
(genMultijitteredSamples, sampling.cpp:260-352) in numpy, drawn from
`numpy.random.default_rng(seed)` as the JAX package draws it, so the two
packages' tables are bit-equal; sampling/tables.py walks it.

Sample s of pixel p lands in stratum (s + rot(p)) mod strata^2 of a
strata x strata grid, jittered inside the stratum by the counter RNG's
camera dimensions 0 and 1.
"""

from __future__ import annotations

import numpy as np
import torch

from craytracer_tpu_torch.sampling.rng import (MASK32, as_u32, hash_u32,
                                               uniforms)

CAMERA_BOUNCE = 0x7FFF  # bounce counter reserved for camera dims


def multijittered_table(num_samples: int, num_sets: int,
                        seed: int = 0) -> np.ndarray:
    """[num_sets, num_samples, 2] f32 multijittered points: stratified on
    the n x n grid and on the n^2 1-D strata of each axis (the canonical
    construction, with its row and column shuffles)."""
    n = int(np.sqrt(num_samples))
    if n * n != num_samples:
        raise ValueError("num_samples must be a perfect square")
    rng = np.random.default_rng(seed)
    out = np.empty((num_sets, num_samples, 2), np.float32)
    for s in range(num_sets):
        pts = np.empty((n, n, 2), np.float64)
        for i in range(n):
            for j in range(n):
                pts[i, j, 0] = (i + (j + rng.random()) / n) / n
                pts[i, j, 1] = (j + (i + rng.random()) / n) / n
        # x sub-offsets permute within each row, y within each column
        for i in range(n):
            pts[i, rng.permutation(n), 0] = pts[i, :, 0].copy()
        for j in range(n):
            pts[rng.permutation(n), j, 1] = pts[:, j, 1].copy()
        out[s] = pts.reshape(num_samples, 2)
    return out


def stratified_jitter(seed: int, pixel_ids, spp_index, strata: int = 4):
    """[N, 2] float32 film jitter for sample `spp_index` (int or [N])."""
    pixel_ids = torch.as_tensor(pixel_ids)
    k2 = strata * strata
    u = uniforms(seed, pixel_ids, spp_index, CAMERA_BOUNCE, 2, 0)
    rot = hash_u32(as_u32(pixel_ids) ^ ((int(seed) * 977) & MASK32)) % k2
    spp = as_u32(torch.as_tensor(spp_index, device=pixel_ids.device))
    stratum = ((spp + rot) & MASK32) % k2
    sx = (stratum % strata).to(torch.float32)
    sy = (stratum // strata).to(torch.float32)
    inv = 1.0 / strata
    return torch.stack([(sx + u[:, 0]) * inv, (sy + u[:, 1]) * inv], dim=-1)
