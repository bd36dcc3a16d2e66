"""Parameter carry-over from the JAX package: numpy leaves -> port objects.

The JAX package's Scene / Camera / Film are dataclasses; `numpy_leaves`
flattens one into nested mappings of numpy arrays (`np.asarray` on every
leaf, static fields as plain values), and the `*_from_numpy` functions
rebuild the port's dataclasses from such mappings, so both packages
compute on identical data. This module imports neither JAX nor the JAX
package: it only reads dataclass fields.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from craytracer_tpu_torch.camera import Camera, Film
from craytracer_tpu_torch.scene import types as T

_GROUPS = {
    "spheres": T.Spheres, "planes": T.Planes, "rects": T.Rects,
    "disks": T.Disks, "triangles": T.Triangles, "instanced": T.Instanced,
    "materials": T.Materials, "lights": T.Lights,
    "mesh_lights": T.MeshLights, "textures": T.TexturePack,
}
_STATIC = ("accel", "mat_types_present", "light_types_present",
           "matte_lambertian")


def numpy_leaves(obj):
    """Any (nested) dataclass -> nested dict: array leaves through
    np.asarray, tuples element by element, None and Python
    scalars/strings kept as they are."""
    if dataclasses.is_dataclass(obj):
        return {f.name: numpy_leaves(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return tuple(numpy_leaves(x) for x in obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return np.asarray(obj)


def _tensor(x, device):
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _build(cls, leaves: Mapping, device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = leaves.get(f.name)
        kw[f.name] = (_tensor(v, device) if isinstance(v, np.ndarray)
                      else v)
    return cls(**kw)


def scene_from_numpy(leaves: Mapping, device="cpu") -> T.Scene:
    """`leaves` maps each Scene group name to a mapping of its fields
    (numpy arrays) plus the static fields. The bvh4 table `tri_bvh` (fat
    rows, n_tris, leaf_size, stack_size) and its parts `tri_parts` are
    carried; a scene holding any other accel table is refused (ROADMAP
    queue 1, slice I)."""
    for name in ("tri_shadow", "tri_cam", "sph_bvh"):
        if leaves.get(name) is not None:
            raise NotImplementedError(
                f"scene carries {name}; that accelerator is not ported "
                "(ROADMAP queue 1, slice I)")
    kw = {name: _build(cls, leaves[name], device)
          for name, cls in _GROUPS.items()}
    kw["env"] = _build(T.EnvLight, leaves["env"], device)
    if leaves.get("tri_bvh") is not None:
        kw["tri_bvh"] = _build(T.BVH4Arrays, leaves["tri_bvh"], device)
    if leaves.get("tri_parts") is not None:
        kw["tri_parts"] = tuple(_build(T.BVH4Arrays, p, device)
                                for p in leaves["tri_parts"])
    for name in _STATIC:
        kw[name] = leaves[name]
    kw["mat_types_present"] = tuple(kw["mat_types_present"])
    kw["light_types_present"] = tuple(kw["light_types_present"])
    kw["smooth_triangles"] = bool(np.asarray(
        leaves["triangles"]["smooth"]).any())
    m, s = leaves["materials"], leaves["spheres"]
    kw["microfacet_iso_beckmann"] = T.microfacet_iso_beckmann(
        m["mat_type"], m["alphax"], m["alphay"], m["distrib"])
    kw["sphere_clips_in_domain"] = T.sphere_clips_in_domain(
        s["phi"], s["min_theta"], s["max_theta"])
    kw["instanced_aabox_only"] = T.instanced_aabox_only(
        leaves["instanced"]["kind"])
    return T.Scene(**kw)


def camera_from_numpy(leaves: Mapping, device="cpu") -> Camera:
    return _build(Camera, leaves, device)


def film_from_numpy(leaves: Mapping, device="cpu") -> Film:
    return _build(Film, leaves, device)
