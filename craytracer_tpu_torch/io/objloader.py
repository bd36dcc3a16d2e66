"""Wavefront OBJ loader (counterpart of craytracer_tpu/io/objloader.py:
`load_obj` :86 through the native scan and `_assemble_native` :104,
`compute_vertex_normals` :205).

Groups split on g/usemtl/o, faces are fan-triangulated by the C++ scanner
(native.py), and each group's (v, vt, vn) corner triples are deduplicated
with np.unique, as in the JAX package. Material libraries are not read:
`MATERIAL FROM_MTL` waits for ROADMAP slice E, and the scene parser
refuses it before a mesh is loaded.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from craytracer_tpu_torch.native import load_obj_native


@dataclass
class OBJShape:
    positions: np.ndarray  # [V, 3] f32
    normals: Optional[np.ndarray]  # [V, 3] f32
    texcoords: Optional[np.ndarray]  # [V, 2] f32
    indices: np.ndarray  # [F, 3] int32


def load_obj(path: str) -> list[OBJShape]:
    """The OBJ file's shapes, one per group, with deduplicated vertices."""
    positions, texcoords, normals, corners, groups = load_obj_native(path)
    shapes = []
    for begin, end in groups:
        tri = corners[begin:end].astype(np.int64)
        if tri.shape[0] == 0:
            continue
        has_vt = texcoords is not None and bool((tri[:, :, 1] >= 0).any())
        has_vn = normals is not None and bool((tri[:, :, 2] >= 0).any())
        v_idx = np.maximum(tri[:, :, 0], 0)
        zero = np.zeros_like(v_idx)
        key = np.stack([v_idx,
                        np.maximum(tri[:, :, 1], 0) if has_vt else zero,
                        np.maximum(tri[:, :, 2], 0) if has_vn else zero],
                       axis=-1).reshape(-1, 3)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        shapes.append(OBJShape(
            positions=positions[uniq[:, 0]],
            normals=normals[uniq[:, 2]] if has_vn else None,
            texcoords=texcoords[uniq[:, 1]] if has_vt else None,
            indices=inv.reshape(-1, 3).astype(np.int32)))
    return shapes


def compute_vertex_normals(positions: np.ndarray,
                           indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (calcTriangleNormals,
    buildscene.h:28-99)."""
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # length ~ 2 * area: area weighting
    normals = np.zeros_like(positions)
    for k in range(3):
        np.add.at(normals, indices[:, k], fn)
    lens = np.linalg.norm(normals, axis=-1, keepdims=True)
    return (normals / np.where(lens > 0, lens, 1.0)).astype(np.float32)
