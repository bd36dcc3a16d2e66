"""Batched slab test (counterpart of craytracer_tpu/core/aabb.py
`ray_aabb` :13). Boxes are (mins [..., 3], maxs [..., 3]); rays are
(origin [..., 3], inv_dir [..., 3]); an axis-parallel ray's infinite
inv_dir works the IEEE way."""

from __future__ import annotations

import math

import torch


def ray_aabb(origin, inv_dir, box_min, box_max, t_min=0.0, t_max=math.inf):
    """(hit, t_near, t_far), broadcast across leading dims."""
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    t_near = torch.clamp(torch.minimum(t0, t1).amax(dim=-1), min=t_min)
    t_far = torch.clamp(torch.maximum(t0, t1).amin(dim=-1), max=t_max)
    return t_near <= t_far, t_near, t_far
