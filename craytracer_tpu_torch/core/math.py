"""Batched vector math on `[..., 3]` tensors.

Counterpart of craytracer_tpu/core/math.py, restricted to the ops the
port's torch code uses (the "shade" route's math lives in
integrator/shade_kernel.py, formula for formula with the kernels; the
general route's in bsdf/bxdf.py and lights/lights.py calls these). Each
function keeps the JAX expression tree (same operand order, same
epsilons) so the two packages round alike: `dot` :16, `cross` :30,
`max3` :34, `length` :44, `length_sq` :50, `normalize` :55, `reflect`
:62, `refract` :68, `orthonormal_basis` :86, `make_shading_frame` :110,
`to_local` :123, `to_world` :128, the shading-frame trig :137-196,
`_safe` :199, `spherical_direction` :214, `cartesian_to_spherical`
:219, `spherical_to_uv` :232, `rotate_y` :239, and the host-side
`euler_to_mat3` :246 for mesh and instance placement. Integer powers
are products, as XLA lowers `x ** 2`.

Bounds against a constant go through `maximum`, `minimum` and `clip`,
the counterparts of `jnp.maximum`, `jnp.minimum` and `jnp.clip`: where
the value equals the bound they pass half the gradient, as JAX does,
where `torch.clamp` passes all of it. The values are `torch.clamp`'s.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from craytracer_tpu_torch.constants import INV_PI, PI, TWO_PI


_CONSTS: dict = {}


def _const(c: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor holding c, in `like`'s dtype and on its device,
    made once per (c, dtype, device)."""
    key = (c, like.dtype, like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(c, dtype=like.dtype,
                                        device=like.device)
    return t


def maximum(x, c: float):
    """jnp.maximum(x, c) for a constant c: a tie passes half the
    gradient."""
    return torch.maximum(x, _const(c, x))


def minimum(x, c: float):
    """jnp.minimum(x, c) for a constant c: a tie passes half the
    gradient."""
    return torch.minimum(x, _const(c, x))


def clip(x, lo: float, hi: float):
    """jnp.clip(x, lo, hi): minimum(maximum(x, lo), hi)."""
    return minimum(maximum(x, lo), hi)


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
    return torch.sqrt(maximum(dot(a, a, keepdims=keepdims), 1e-20))


def length_sq(a, keepdims: bool = False):
    return dot(a, a, keepdims=keepdims)


def normalize(a, eps: float = 1e-20):
    """Safe normalize: `a/|a|`, or zeros for (near-)zero vectors."""
    n2 = dot(a, a, keepdims=True)
    inv = torch.where(n2 > eps, 1.0 / torch.sqrt(maximum(n2, eps)),
                      torch.zeros_like(n2))
    return a * inv


def reflect(wo, n):
    """Mirror `wo` about `n` (util/ray.cpp reflect)."""
    return 2.0 * dot(wo, n, keepdims=True) * n - wo


def refract(wi, n, eta):
    """PBRT refraction (reflection.cpp:26-49): `wi` points away from the
    surface, `n` is on its side, `eta` = incident / transmitted IOR.
    Returns (ok, wt)."""
    cos_theta_i = dot(n, wi, keepdims=True)
    sin2_theta_i = maximum(1.0 - cos_theta_i * cos_theta_i, 0.0)
    if eta.dim() < n.dim():
        eta = eta[..., None]
    sin2_theta_t = eta * eta * sin2_theta_i
    ok = (sin2_theta_t < 1.0)[..., 0]
    cos_theta_t = torch.sqrt(maximum(1.0 - sin2_theta_t, 1e-12))
    return ok, -eta * wi + (eta * cos_theta_i - cos_theta_t) * n


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


def make_shading_frame(normal, dpdu):
    """Gram-Schmidt dpdu against the normal (computeLocalBasis,
    trace.h:132-146), the Duff tangent where dpdu is degenerate."""
    t = dpdu - dot(normal, dpdu, keepdims=True) * normal
    t_len2 = dot(t, t, keepdims=True)
    ft, _, _ = orthonormal_basis(normal)
    t = torch.where(t_len2 > 1e-12, normalize(t), ft)
    return t, normalize(cross(normal, t)), normal


def to_local(v, t, b, n):
    """World -> shading-local: (v.t, v.b, v.n)."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_world(v, t, b, n):
    """Shading-local -> world (orthoNormalTransform, util/math.h:55)."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


# Shading-frame trig on local directions (z = normal), util/math.h:13-40.

def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def sin2_theta(w):
    return maximum(1.0 - cos2_theta(w), 0.0)


def sin_theta(w):
    return torch.sqrt(maximum(sin2_theta(w), 1e-16))


def tan_theta(w):
    c = cos_theta(w)
    c = torch.where(torch.abs(c) < 1e-3,
                    torch.where(c < 0, -1e-3, 1e-3).to(c.dtype), c)
    return sin_theta(w) / c


def tan2_theta(w):
    return sin2_theta(w) / maximum(cos2_theta(w), 1e-6)


def cos_phi(w):
    s = sin_theta(w)
    return torch.where(s < 1e-6, 1.0,
                       clip(w[..., 0] / _safe(s), -1.0, 1.0))


def sin_phi(w):
    s = sin_theta(w)
    return torch.where(s < 1e-6, 0.0,
                       clip(w[..., 1] / _safe(s), -1.0, 1.0))


def cos2_phi(w):
    c = cos_phi(w)
    return c * c


def sin2_phi(w):
    s = sin_phi(w)
    return s * s


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


def spherical_direction(sin_t, cos_t, phi):
    """Local direction from spherical angles (z up)."""
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


def cartesian_to_spherical(d):
    """Direction -> (theta, phi) (cartesianToSpherical, util/math.h:95-101;
    math.py:219): theta = acos(y) with y clipped 1e-6 inside [-1, 1],
    phi = atan2(z, x) + pi."""
    theta = torch.arccos(clip(d[..., 1], -1.0 + 1e-6, 1.0 - 1e-6))
    phi = torch.atan2(d[..., 2], d[..., 0]) + PI
    return theta, phi


def spherical_to_uv(theta, phi):
    """sphericalToUV (util/math.h:103-107; math.py:232): u = phi / 2pi,
    v = 1 - theta / pi."""
    return phi * (1.0 / TWO_PI), 1.0 - theta * INV_PI


def rotate_y(angle: float) -> torch.Tensor:
    """f32 rotation about y (mat3_rotate_y, util/mat.h; math.py:239), the
    cosine and sine of the f32 angle rounded to f32."""
    a = float(np.float32(angle))
    c, s = float(np.float32(math.cos(a))), float(np.float32(math.sin(a)))
    return torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                        dtype=torch.float32)


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
