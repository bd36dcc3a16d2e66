"""ctypes binding to the native runtime, native/craynative.cpp (the port's
own copy of craytracer_tpu/native.py: `load_obj_native` :95,
`build_bvh_native` :140, `build_bvh4_fat_native` :211).

The C++ source sits outside both packages and is shared as it is. The port
builds it with g++ at first use into craytracer_tpu_torch/_build/, keyed
by a hash of the source and the flags (the same flags as native/Makefile,
so the tree matches the JAX package's build bit for bit), and never writes
into native/. There is no numpy fallback: where the JAX package quietly
builds a median-split tree without the library (accel/bvh4.py:229-239),
the port raises, so a scene always gets the SAH tree. The sphere BVH4
(accel/bvh4_sphere.py) takes the binary tree itself, in the median split
the JAX sphere build asks for (accel/bvh4.py:135 `collapse4` calls
`build_bvh_native` with its default split).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent
SOURCE = _ROOT / "native" / "craynative.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
_NAME_STRIDE = 256
_SPLIT_MEDIAN = 0  # crn_build_bvh's split modes: object median,
_SPLIT_SAH = 1  # exact-sweep SAH

_LIB = None


def _build() -> Path:
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found: the native scene runtime "
                           f"({SOURCE}) needs g++ to build")
    if not SOURCE.exists():
        raise RuntimeError(f"native runtime source missing: {SOURCE}")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    so = BUILD_DIR / f"libcraynative_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{so.name}.{os.getpid()}"
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed:\n{res.stderr}")
        os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded native library (built on first use)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(_build()))
    c = ctypes
    fp, ip, i64p = (c.POINTER(c.c_float), c.POINTER(c.c_int32),
                    c.POINTER(c.c_int64))
    lib.crn_load_obj.restype = c.c_void_p
    lib.crn_load_obj.argtypes = [c.c_char_p]
    lib.crn_obj_counts.restype = c.c_int64
    lib.crn_obj_counts.argtypes = [c.c_void_p] + [i64p] * 5
    lib.crn_obj_copy.restype = c.c_int64
    lib.crn_obj_copy.argtypes = [c.c_void_p, fp, fp, fp, ip, ip, c.c_char_p,
                                 c.c_char_p, c.c_char_p, c.c_int64]
    lib.crn_obj_free.argtypes = [c.c_void_p]
    lib.crn_build_bvh.restype = c.c_void_p
    lib.crn_build_bvh.argtypes = [fp] * 3 + [c.c_int64, c.c_int32, c.c_int32]
    lib.crn_bvh_counts.restype = c.c_int64
    lib.crn_bvh_counts.argtypes = [c.c_void_p, i64p, i64p]
    lib.crn_bvh_copy.restype = c.c_int64
    lib.crn_bvh_copy.argtypes = [c.c_void_p, fp, fp] + [ip] * 5
    lib.crn_bvh_free.argtypes = [c.c_void_p]
    lib.crn_bvh4_collapse.restype = c.c_int64
    lib.crn_bvh4_collapse.argtypes = [c.c_void_p, i64p]
    lib.crn_bvh4_fat.restype = c.c_int64
    lib.crn_bvh4_fat.argtypes = [c.c_void_p] + [fp] * 3 + [c.c_int32, fp]
    _LIB = lib
    return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def load_obj_native(path: str):
    """OBJ scan: (positions, texcoords | None, normals | None,
    corners [T, 3 corners, (v, vt, vn)], groups, mtllib), groups being
    (face_begin, face_end, group name, usemtl name) in triangle units and
    mtllib the file's material library name ("" when it names none)."""
    lib = library()
    h = lib.crn_load_obj(str(path).encode())
    if not h:
        raise OSError(f"cannot read OBJ file {path}")
    try:
        n = [ctypes.c_int64() for _ in range(5)]
        lib.crn_obj_counts(h, *[ctypes.byref(x) for x in n])
        n_pos, n_tex, n_nrm, n_corners, n_groups = (x.value for x in n)
        pos = np.empty((max(n_pos, 1), 3), np.float32)
        tex = np.empty((max(n_tex, 1), 2), np.float32)
        nrm = np.empty((max(n_nrm, 1), 3), np.float32)
        corners = np.empty((max(n_corners, 1), 3), np.int32)
        ranges = np.empty((max(n_groups, 1), 2), np.int32)
        names = ctypes.create_string_buffer(_NAME_STRIDE * max(n_groups, 1))
        mats = ctypes.create_string_buffer(_NAME_STRIDE * max(n_groups, 1))
        mtllib = ctypes.create_string_buffer(_NAME_STRIDE)
        lib.crn_obj_copy(h, _fptr(pos), _fptr(tex), _fptr(nrm),
                         _iptr(corners), _iptr(ranges), names, mats, mtllib,
                         _NAME_STRIDE)
        def name(buf, i):
            return buf.raw[i * _NAME_STRIDE:(i + 1) * _NAME_STRIDE].split(
                b"\0")[0].decode("latin-1")

        # ranges count corners; three corners make a triangle
        groups = [(int(b) // 3, int(e) // 3, name(names, i), name(mats, i))
                  for i, (b, e) in enumerate(ranges[:n_groups])]
        return (pos[:n_pos], tex[:n_tex] if n_tex else None,
                nrm[:n_nrm] if n_nrm else None,
                corners[:n_corners].reshape(-1, 3, 3), groups,
                mtllib.value.decode("latin-1"))
    finally:
        lib.crn_obj_free(h)


def build_bvh_native(v0, v1, v2, leaf_size: int):
    """Median-split binary BVH over [T, 3] corner triples, each cast to
    f32 (the builder reads only their min, max and centroid): (node_min [M, 3],
    node_max [M, 3] f32, right, axis, first, count [M] int32, order [T]
    int32), nodes in depth-first order, a leaf's count > 0."""
    lib = library()
    v0, v1, v2 = (np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2))
    h = lib.crn_build_bvh(_fptr(v0), _fptr(v1), _fptr(v2), v0.shape[0],
                          leaf_size, _SPLIT_MEDIAN)
    if not h:
        raise RuntimeError("native BVH build failed")
    try:
        n_nodes, n_order = ctypes.c_int64(), ctypes.c_int64()
        lib.crn_bvh_counts(h, ctypes.byref(n_nodes), ctypes.byref(n_order))
        m, t = n_nodes.value, n_order.value
        node_min = np.empty((m, 3), np.float32)
        node_max = np.empty((m, 3), np.float32)
        right, axis, first, count = (np.empty(m, np.int32) for _ in range(4))
        order = np.empty(max(t, 1), np.int32)
        lib.crn_bvh_copy(h, _fptr(node_min), _fptr(node_max), _iptr(right),
                         _iptr(axis), _iptr(first), _iptr(count),
                         _iptr(order))
        return node_min, node_max, right, axis, first, count, order[:t]
    finally:
        lib.crn_bvh_free(h)


def build_bvh4_fat_native(v0, v1, v2, leaf_size: int):
    """4-wide fat rows [M, 28 + 4 * leaf_size * 10] f32: SAH binary build
    (crn_build_bvh), BFS grandchild collapse (crn_bvh4_collapse) and row
    assembly (crn_bvh4_fat), all in C++."""
    lib = library()
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    h = lib.crn_build_bvh(_fptr(v0), _fptr(v1), _fptr(v2), v0.shape[0],
                          leaf_size, _SPLIT_SAH)
    if not h:
        raise RuntimeError("native BVH build failed")
    try:
        m = ctypes.c_int64()
        if lib.crn_bvh4_collapse(h, ctypes.byref(m)) != 0 or m.value <= 0:
            raise RuntimeError("native BVH4 collapse failed")
        fat = np.empty((m.value, 28 + 4 * leaf_size * 10), np.float32)
        if lib.crn_bvh4_fat(h, _fptr(v0), _fptr(v1), _fptr(v2), leaf_size,
                            _fptr(fat)) != m.value:
            raise RuntimeError("native BVH4 row assembly failed")
        return fat
    finally:
        lib.crn_bvh_free(h)
