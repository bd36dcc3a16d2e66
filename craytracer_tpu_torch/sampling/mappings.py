"""Sample-space warps (counterpart of craytracer_tpu/sampling/mappings.py:
`map_to_disk_polar` :17, `map_to_hemisphere_cosine` :38)."""

from __future__ import annotations

import torch

from craytracer_tpu_torch.constants import TWO_PI
from craytracer_tpu_torch.core import math as vm


def map_to_disk_polar(u):
    """[..., 2] uniforms -> [..., 2] points on the unit disk (polar warp)."""
    phi = TWO_PI * u[..., 0]
    r = torch.sqrt(u[..., 1])
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def map_to_hemisphere_cosine(u):
    """[..., 2] uniforms -> [..., 3] cosine-weighted local directions."""
    d = map_to_disk_polar(u)
    z = torch.sqrt(vm.maximum(1.0 - d[..., 0] * d[..., 0]
                              - d[..., 1] * d[..., 1], 1e-12))
    return torch.cat([d, z[..., None]], dim=-1)
