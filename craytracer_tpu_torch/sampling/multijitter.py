"""Stratified film jitter (counterpart of
craytracer_tpu/sampling/multijitter.py:46 `stratified_jitter`).

Sample s of pixel p lands in stratum (s + rot(p)) mod strata^2 of a
strata x strata grid, jittered inside the stratum by the counter RNG's
camera dimensions 0 and 1.
"""

from __future__ import annotations

import torch

from craytracer_tpu_torch.sampling.rng import (MASK32, as_u32, hash_u32,
                                               uniforms)

CAMERA_BOUNCE = 0x7FFF  # bounce counter reserved for camera dims


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
