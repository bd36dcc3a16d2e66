"""Ray reordering for traversal coherence (counterpart of
craytracer_tpu/ops/raysort.py: `morton3` :39, `ray_key` :45,
`sorted_traversal` :80).

K3 and K4 run one ray per thread, so a warp costs its slowest lane's
node visits, and the lanes of a warp diverge where their walks differ.
Secondary rays arrive shuffled; sorting them by a key of quantized origin
(Morton order inside the batch's own box of real origins) and direction
octant puts rays that walk alike into the same warps. The sort is a pure
permutation: results scatter back to the caller's ray order.
"""

from __future__ import annotations

import torch

POS_BITS = 6  # origin cells per axis: 2^6 (raysort.py's default)


def _part1by2(x):
    """Spread the low 10 bits of x so consecutive bits land 3 apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def ray_key(o, d):
    """Coherence key per ray (int64): the Morton code of the origin
    quantized to 2^POS_BITS cells per axis inside the box of real origins,
    then the direction octant as the low 3 bits. Escape rays (|o| >=
    1e17, retired lanes) do not stretch the box and land in the top
    cell."""
    real = (torch.abs(o) < 1.0e17).all(dim=1, keepdim=True)
    lo = torch.where(real, o, torch.inf).amin(dim=0)
    hi = torch.where(real, o, -torch.inf).amax(dim=0)
    lo = torch.where(torch.isfinite(lo), lo, 0.0)
    hi = torch.where(torch.isfinite(hi), hi, 1.0)
    scale = (1 << POS_BITS) / torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp(((torch.minimum(torch.maximum(o, lo), hi) - lo) * scale)
                    .to(torch.int64), 0, (1 << POS_BITS) - 1)
    code = (_part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1)
            | (_part1by2(q[:, 2]) << 2))
    octant = ((d[:, 0] < 0).to(torch.int64)
              | ((d[:, 1] < 0).to(torch.int64) << 1)
              | ((d[:, 2] < 0).to(torch.int64) << 2))
    return (code << 3) | octant


def sorted_traversal(traverse_fn, o, d, *per_ray):
    """traverse_fn(o, d, *per_ray) run on the rays in ray_key order; its
    [N] result (or tuple of them) scattered back to the caller's order."""
    perm = torch.argsort(ray_key(o, d), stable=True)
    out = traverse_fn(*(x[perm].contiguous() for x in (o, d) + per_ray))

    def unsort(x):
        y = torch.empty_like(x)
        y[perm] = x
        return y

    return (tuple(unsort(x) for x in out) if isinstance(out, tuple)
            else unsort(out))
