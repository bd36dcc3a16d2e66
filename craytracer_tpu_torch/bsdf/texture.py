"""Texture lookups over the packed texel pool (the port's counterpart of
craytracer_tpu/bsdf/texture.py: `_ref_wrap` :17, `nearest_texel_xy` :24,
`tex_lookup_nearest` :39, `tex_lookup_bilinear` :50).

The reference samples the nearest texel with its own wrap (getTexColor,
texture.cpp:27-86): negative coordinates are reflected, coordinates past
1 fold back as 1 - frac, v is flipped, x and y round half down and wrap
modulo the size, so row 0 owns a sliver of both poles. The bilinear
lookup is the JAX package's smooth variant on the same grid. A texture
id of -1 reads texture 0 (the caller masks it), and an id past the table
reads its last texture, as take_rows clips it (ops/gather.py:76).
"""

from __future__ import annotations

import torch

from craytracer_tpu_torch.scene.types import TexturePack


def _ref_wrap(x):
    """getTexColor's coordinate wrap (texture.cpp:29-40)."""
    x = torch.abs(x)
    return torch.where(x > 1.0, 1.0 - (x - torch.floor(x)), x)


def nearest_texel_xy(w, h, u, v):
    """The texel (x, y) getTexColor reads for (u, v) on a w x h image,
    as int32 tensors."""
    uf = _ref_wrap(u) * w.to(u.dtype)
    vf = (1.0 - _ref_wrap(v)) * h.to(v.dtype)
    xi = torch.floor(uf)
    xi = torch.where(uf - xi > 0.5, xi + 1.0, xi).to(torch.int32) % w
    yi = torch.floor(vf)
    yi = torch.where(vf - yi > 0.5, yi + 1.0, yi).to(torch.int32) % h
    return xi, yi


def _descriptors(pack: TexturePack, tex_id):
    tid = torch.clamp(tex_id.to(torch.int64), 0, pack.width.shape[0] - 1)
    return pack.width[tid], pack.height[tid], pack.offset[tid]


def tex_lookup_nearest(pack: TexturePack, tex_id, uv):
    """[N] texture ids and [N, 2] uv -> [N, 3] texels."""
    w, h, off = _descriptors(pack, tex_id)
    x, y = nearest_texel_xy(w, h, uv[..., 0], uv[..., 1])
    return pack.texels[(off + y * w + x).to(torch.int64)]


def tex_lookup_bilinear(pack: TexturePack, tex_id, uv):
    """Bilinear interpolation with texel centres at the integer
    coordinates of the nearest lookup's wrapped, flipped grid, clamped at
    the edges."""
    w, h, off = _descriptors(pack, tex_id)
    u = _ref_wrap(uv[..., 0]) * w.to(uv.dtype)
    v = (1.0 - _ref_wrap(uv[..., 1])) * h.to(uv.dtype)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]

    def fetch(xi, yi):
        xi = torch.minimum(torch.clamp(xi.to(torch.int32), min=0), w - 1)
        yi = torch.minimum(torch.clamp(yi.to(torch.int32), min=0), h - 1)
        return pack.texels[(off + yi * w + xi).to(torch.int64)]

    return (fetch(x0, y0) * (1 - fx) * (1 - fy)
            + fetch(x0 + 1, y0) * fx * (1 - fy)
            + fetch(x0, y0 + 1) * (1 - fx) * fy
            + fetch(x0 + 1, y0 + 1) * fx * fy)
