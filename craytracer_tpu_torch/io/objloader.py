"""Wavefront OBJ and MTL loader (counterpart of
craytracer_tpu/io/objloader.py: `OBJMaterial` :30, `load_mtl` :43,
`load_obj` :86 through the native scan and `_assemble_native` :104,
`compute_vertex_normals` :205).

Groups split on g/usemtl/o, faces are fan-triangulated by the C++ scanner
(native.py), and each group's (v, vt, vn) corner triples are deduplicated
with np.unique, as in the JAX package. Each shape keeps its group name and
its usemtl material name; the material library the file names (mtllib,
looked up beside the OBJ) is read by `load_mtl`: Ka/Kd/Ks/Ke, Ns, Ni, d,
illum, map_Kd and map_bump/bump.
"""

from __future__ import annotations

import os
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
    name: str = ""
    mat_name: str = ""


@dataclass
class OBJMaterial:
    name: str = ""
    ka: tuple = (0.0, 0.0, 0.0)
    kd: tuple = (0.5, 0.5, 0.5)
    ks: tuple = (0.0, 0.0, 0.0)
    ke: tuple = (0.0, 0.0, 0.0)
    ns: float = 0.0
    ni: float = 1.0
    d: float = 1.0
    illum: int = 2
    map_kd: str = ""
    map_bump: str = ""


def load_mtl(path: str) -> dict[str, OBJMaterial]:
    """The materials of an MTL file by name ({} when it does not exist)."""
    mats: dict[str, OBJMaterial] = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path, errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                cur = OBJMaterial(name=parts[1] if len(parts) > 1 else "")
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif key in ("Ka", "Kd", "Ks", "Ke") and len(parts) >= 4:
                setattr(cur, key.lower(), tuple(float(x) for x in parts[1:4]))
            elif key == "Ns":
                cur.ns = float(parts[1])
            elif key == "Ni":
                cur.ni = float(parts[1])
            elif key == "d":
                cur.d = float(parts[1])
            elif key == "illum":
                cur.illum = int(parts[1])
            elif key == "map_Kd":
                cur.map_kd = parts[-1]
            elif key in ("map_bump", "bump"):
                cur.map_bump = parts[-1]
    return mats


def load_obj(path: str):
    """(the OBJ file's shapes, one per group, with deduplicated vertices;
    its mtllib's materials by name)."""
    positions, texcoords, normals, corners, groups, mtllib = \
        load_obj_native(path)
    shapes = []
    for begin, end, name, mat in groups:
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
            indices=inv.reshape(-1, 3).astype(np.int32),
            name=name, mat_name=mat))
    base_dir = os.path.dirname(os.path.abspath(path))
    return shapes, (load_mtl(os.path.join(base_dir, mtllib)) if mtllib
                    else {})


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
