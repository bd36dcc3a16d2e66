"""Batched vector math on `[..., 3]` tensors.

Counterpart of craytracer_tpu/core/math.py, restricted to the ops the
port's torch code uses (the shading math lives in
integrator/shade_kernel.py, formula for formula with the kernels). Each
function keeps the JAX expression tree (same operand order, same
epsilons) so the two packages round alike: `dot` :16, `cross` :30,
`normalize` :55, `orthonormal_basis` :86, `_safe` :199, and the
host-side `euler_to_mat3` :246 for mesh and instance placement.
"""

from __future__ import annotations

import numpy as np
import torch


def dot(a, b, keepdims: bool = False):
    r = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return r[..., None] if keepdims else r


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def normalize(a, eps: float = 1e-20):
    """Safe normalize: `a/|a|`, or zeros for (near-)zero vectors."""
    n2 = dot(a, a, keepdims=True)
    inv = torch.where(n2 > eps, 1.0 / torch.sqrt(torch.clamp(n2, min=eps)),
                      torch.zeros_like(n2))
    return a * inv


def orthonormal_basis(n):
    """The branchless (t, b, n) frame of unit normals (Duff et al.), the
    tangent that plane, disk and instanced fills give as dpdu."""
    s = torch.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    t = torch.stack([1.0 + s[..., 0] * n[..., 0] * n[..., 0] * a[..., 0],
                     s[..., 0] * b[..., 0], -s[..., 0] * n[..., 0]], dim=-1)
    bt = torch.stack([b[..., 0], s[..., 0] + n[..., 1] * n[..., 1] * a[..., 0],
                      -n[..., 1]], dim=-1)
    return t, bt, n


def _safe(x, eps: float = 1e-12):
    """Divide-guard: replace ~0 with +-eps, keeping sign."""
    return torch.where(torch.abs(x) < eps,
                       torch.where(x < 0, -eps, eps).to(x.dtype), x)


def euler_to_mat3(angles) -> np.ndarray:
    """Euler XYZ -> f32 rotation matrix (eulerAngToMat4, util/mat.h),
    composed Rz(z) @ Ry(y) @ Rx(x) like the reference; host-side numpy."""
    x, y, z = [float(a) for a in angles]
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (rz @ ry @ rx).astype(np.float32)
