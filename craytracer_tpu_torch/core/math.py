"""Batched vector math on `[..., 3]` tensors.

Counterpart of craytracer_tpu/core/math.py, restricted to the ops the
Cornell slice uses. Each function keeps the JAX expression tree (same
operand order, same epsilons) so the two packages round alike:
`dot` :16, `cross` :30, `max3` :34, `length` :45, `normalize` :55,
`orthonormal_basis` :86, `make_shading_frame` :110, `to_world` :128,
`_safe` :199.
"""

from __future__ import annotations

import torch


def dot(a, b, keepdims: bool = False):
    r = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return r[..., None] if keepdims else r


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def max3(a, keepdims: bool = False):
    r = torch.maximum(torch.maximum(a[..., 0], a[..., 1]), a[..., 2])
    return r[..., None] if keepdims else r


def length(a, keepdims: bool = False):
    return torch.sqrt(torch.clamp(dot(a, a, keepdims=keepdims), min=1e-20))


def normalize(a, eps: float = 1e-20):
    """Safe normalize: `a/|a|`, or zeros for (near-)zero vectors."""
    n2 = dot(a, a, keepdims=True)
    inv = torch.where(n2 > eps, 1.0 / torch.sqrt(torch.clamp(n2, min=eps)),
                      torch.zeros_like(n2))
    return a * inv


def orthonormal_basis(n):
    """Duff et al. branchless (t, b, n) frame from unit normals."""
    n0, n1, n2 = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(n2 >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n2)
    b = n0 * n1 * a
    t = torch.stack([1.0 + s * n0 * n0 * a, s * b, -s * n0], dim=-1)
    bt = torch.stack([b, s + n1 * n1 * a, -n1], dim=-1)
    return t, bt, n


def make_shading_frame(normal, dpdu):
    """Gram-Schmidt dpdu against the normal (computeLocalBasis), with the
    Duff basis as fallback for a degenerate tangent."""
    t = dpdu - dot(normal, dpdu, keepdims=True) * normal
    t_len2 = dot(t, t, keepdims=True)
    ft, _, _ = orthonormal_basis(normal)
    t = torch.where(t_len2 > 1e-12, normalize(t), ft)
    b = normalize(cross(normal, t))
    return t, b, normal


def to_world(v, t, b, n):
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def _safe(x, eps: float = 1e-12):
    """Divide-guard: replace ~0 with +-eps, keeping sign."""
    return torch.where(torch.abs(x) < eps,
                       torch.where(x < 0, -eps, eps).to(x.dtype), x)
