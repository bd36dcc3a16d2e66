"""Counter-based stateless RNG (counterpart of
craytracer_tpu/sampling/rng.py: `hash_u32` :27, `_combine` :38,
`uniforms` :48).

Every uniform is a hash of (seed, pixel, spp, bounce, dim), so the port
reproduces the JAX package's bit stream exactly. torch has no unsigned
32-bit shift on the CPU, so the words ride in int64 tensors holding
values in [0, 2^32): each multiply is split into two 16-bit halves so no
intermediate leaves int64's range, and the result is masked back to 32
bits. The CUDA kernel computes the same words in native uint32_t.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9  # 2^32 / phi, Weyl increment
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def _mul32(x, m: int):
    """(x * m) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant m."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def as_u32(x) -> torch.Tensor:
    """Integer tensor -> int64 tensor of its 32-bit two's-complement word
    (what `.astype(jnp.uint32)` gives in the JAX package)."""
    return torch.as_tensor(x).to(torch.int64) & MASK32


def hash_u32(x):
    """Murmur3 fmix32 finalizer over uint32 words held in int64."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def lane_key(seed: int, pixel_id, spp_index, bounce: int):
    """The per-(lane, bounce) word before the dimension round
    (_combine minus its last hash): hash(hash(hash(pix) ^ hash(spp)) ^
    (seed + GOLDEN * bounce))."""
    h = hash_u32(pixel_id)
    h = hash_u32(h ^ hash_u32(spp_index))
    return hash_u32(h ^ ((int(seed) + GOLDEN * int(bounce)) & MASK32))


def uniforms(seed: int, pixel_id, spp_index, bounce: int, n_dims: int,
             dim0: int = 0):
    """[N, n_dims] float32 uniforms in [0, 1) for lanes `pixel_id`.

    `spp_index` is an int or a per-lane [N] tensor (spp-batched dispatch);
    `dim0` offsets the dimension counter so call sites stay disjoint."""
    pixel_id = torch.as_tensor(pixel_id)
    spp = torch.as_tensor(spp_index, device=pixel_id.device)
    if spp.dim() == pixel_id.dim() and spp.dim() > 0:
        spp = spp[..., None]
    h = lane_key(seed, pixel_id[..., None], spp, bounce)
    dims = torch.arange(dim0, dim0 + n_dims, dtype=torch.int64,
                        device=pixel_id.device)
    bits = hash_u32((h + GOLDEN * dims) & MASK32)
    # top 24 bits -> a uniform exactly representable in f32
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
