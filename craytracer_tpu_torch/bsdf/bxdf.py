"""Vectorized BSDF evaluation/sampling over hit queues (counterpart of
craytracer_tpu/bsdf/bxdf.py, MATTE (Lambertian) and EMISSIVE only:
`gather_params` :69, `_oren_nayar_f(lambertian_only=True)` :122,
`bsdf_f_direct` :276, `bsdf_sample` :385; the slice reads no BSDF pdf, so
`_cos_hemisphere_pdf` :146 comes with the plastic and MIS items).

Directions are in the local shading frame (z = shading normal), except
where the reference quirk feeds world vectors (bsdf_f_direct; constant
for Lambertian). EMISSIVE has no lobes: f = 0, pdf = 0. The other five
material types and the Oren-Nayar trig are K1's next gate items.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from craytracer_tpu_torch.constants import INV_PI
from craytracer_tpu_torch.sampling.mappings import map_to_hemisphere_cosine
from craytracer_tpu_torch.scene import types as T


@dataclass(frozen=True)
class MatParams:
    """Per-hit material parameters gathered from the table ([N, ...])."""

    mat_type: torch.Tensor
    color: torch.Tensor
    on_a: torch.Tensor
    on_b: torch.Tensor
    intensity: torch.Tensor
    color_raw: torch.Tensor  # emissive radiance uses the raw table color


def gather_params(materials: T.Materials, mat_id) -> MatParams:
    """Row lookup of the material table (no textures in the slice)."""
    idx = mat_id.to(torch.int64)
    color = materials.color[idx]
    return MatParams(mat_type=materials.mat_type[idx], color=color,
                     on_a=materials.on_a[idx], on_b=materials.on_b[idx],
                     intensity=materials.intensity[idx], color_raw=color)


def _oren_nayar_f(color, a):
    """OrenNayar_f at sigma = 0: exactly Lambertian, color * a / pi."""
    return color * (a * INV_PI)[..., None]


def bsdf_f_direct(mp: MatParams):
    """BSDF_f with SPECULAR|GLOSSY excluded (the NEE evaluation): MATTE's
    Lambertian lobe, zero for EMISSIVE. Direction-independent, so the
    reference's world-vector quirk has nothing to act on."""
    f = _oren_nayar_f(mp.color, mp.on_a)
    return torch.where((mp.mat_type == T.MAT_MATTE)[..., None], f,
                       torch.zeros_like(f))


def bsdf_sample(u, mp: MatParams):
    """BSDF_sample_f for the hit queue: MATTE cosine-hemisphere sample
    (OrenNayar_sample_f, reflection.cpp:550-562). `u` is [N, 3] (the third
    column is the fresnel-branch rand, unused by these lobes).

    Returns (f[N,3], wi[N,3], pdf[N], is_specular[N], is_glossy[N])."""
    wi_matte = map_to_hemisphere_cosine(u[:, :2])
    pdf_matte = torch.abs(wi_matte[:, 2]) * INV_PI
    f_matte = _oren_nayar_f(mp.color, mp.on_a)
    m = mp.mat_type == T.MAT_MATTE
    up = torch.zeros_like(wi_matte)
    up[:, 2] = 1.0
    f = torch.where(m[:, None], f_matte, torch.zeros_like(f_matte))
    wi = torch.where(m[:, None], wi_matte, up)
    pdf = torch.where(m, pdf_matte, torch.zeros_like(pdf_matte))
    false_n = torch.zeros_like(m)
    return f, wi, pdf, false_n, false_n
