"""Branchless polynomial root solvers for batched ray-primitive tests
(counterpart of craytracer_tpu/core/solvers.py: `solve_quadratic` :21,
`cubic_one_root` :48, `solve_quartic` :78).

Every lane runs the same op sequence; lanes without a root carry TMAX.
The quartic is Ferrari's method through the resolvent cubic in f32,
then Newton steps on the original quartic. Each function keeps the JAX
expression tree; torch has no cbrt, so the cube root is the signed
power |x|^(1/3), whose ulps the Newton polish absorbs.
"""

from __future__ import annotations

import torch

from craytracer_tpu_torch.constants import TMAX


def solve_quadratic(a, b, c):
    """Roots of a x^2 + b x + c. Returns (has_roots, t0, t1) with t0 <= t1,
    through the stable form q = -(b + sign(b) sqrt(disc)) / 2; lanes
    without real roots carry TMAX, a == 0 lanes the linear root -c/b."""
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * (b + torch.where(b >= 0.0, sq, -sq))
    safe_a = torch.where(a == 0.0, 1.0, a)
    safe_q = torch.where(q == 0.0, 1.0, q)
    r0 = q / safe_a
    r1 = c / safe_q
    lin = a == 0.0
    bl = torch.where(b == 0.0, 1.0, b)
    r_lin = -c / bl
    r0 = torch.where(lin, r_lin, r0)
    r1 = torch.where(lin, r_lin, r1)
    t0 = torch.where(ok, torch.minimum(r0, r1), TMAX)
    t1 = torch.where(ok, torch.maximum(r0, r1), TMAX)
    return ok, t0, t1


def _cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def cubic_one_root(a, b, c, d):
    """One real root of a x^3 + b x^2 + c x + d (a != 0): Cardano where
    the discriminant is >= 0, else the trigonometric root k = 0. It only
    seeds Ferrari's quartic, whose roots are polished."""
    inv_a = 1.0 / torch.where(a == 0.0, 1.0, a)
    B = b * inv_a
    C = c * inv_a
    D = d * inv_a
    p = C - B * B / 3.0
    q = 2.0 * B * B * B / 27.0 - B * C / 3.0 + D
    disc = (q * q) / 4.0 + (p * p * p) / 27.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    y_card = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)
    pm = torch.clamp(p, max=-1e-12)
    m = 2.0 * torch.sqrt(-pm / 3.0)
    arg = torch.clamp(3.0 * q / (pm * m), -1.0, 1.0)
    y_trig = m * torch.cos(torch.acos(arg) / 3.0)
    y = torch.where(disc >= 0.0, y_card, y_trig)
    return y - B / 3.0


def solve_quartic(b, c, d, e, newton_iters: int = 2):
    """Real roots of x^4 + b x^3 + c x^2 + d x + e. Returns (roots [..., 4],
    valid [..., 4]); invalid entries hold TMAX. `newton_iters` Newton
    steps polish each valid root on the original quartic."""
    b2 = b * b
    p = c - 3.0 * b2 / 8.0
    q = d - b * c / 2.0 + b2 * b / 8.0
    r = e - b * d / 4.0 + b2 * c / 16.0 - 3.0 * b2 * b2 / 256.0

    # resolvent cubic m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0
    m = cubic_one_root(torch.ones_like(p), p, p * p / 4.0 - r, -q * q / 8.0)
    m = torch.clamp(m, min=0.0)

    # biquadratic lanes (q ~ 0): y^2 = (-p +- sqrt(p^2 - 4r)) / 2
    biquad = torch.abs(q) < 1e-12
    sq_bq = torch.sqrt(torch.clamp(p * p - 4.0 * r, min=0.0))
    y2a = (-p + sq_bq) / 2.0
    y2b = (-p - sq_bq) / 2.0

    sqrt2m = torch.sqrt(torch.clamp(2.0 * m, min=0.0))
    safe_s = torch.where(sqrt2m == 0.0, 1.0, sqrt2m)
    qa_c = p / 2.0 + m - q / (2.0 * safe_s)
    qb_c = p / 2.0 + m + q / (2.0 * safe_s)
    ok1, r0, r1 = solve_quadratic(torch.ones_like(p), sqrt2m, qa_c)
    ok2, r2, r3 = solve_quadratic(torch.ones_like(p), -sqrt2m, qb_c)

    okb1 = biquad & (y2a >= 0.0)
    okb2 = biquad & (y2b >= 0.0)
    sb1 = torch.sqrt(torch.clamp(y2a, min=0.0))
    sb2 = torch.sqrt(torch.clamp(y2b, min=0.0))
    r0 = torch.where(biquad, torch.where(okb1, sb1, TMAX), r0)
    r1 = torch.where(biquad, torch.where(okb1, -sb1, TMAX), r1)
    r2 = torch.where(biquad, torch.where(okb2, sb2, TMAX), r2)
    r3 = torch.where(biquad, torch.where(okb2, -sb2, TMAX), r3)
    ok1 = torch.where(biquad, okb1, ok1)
    ok2 = torch.where(biquad, okb2, ok2)

    roots = torch.stack([r0, r1, r2, r3], dim=-1)
    valid = torch.stack([ok1, ok1, ok2, ok2], dim=-1)
    roots = roots - b[..., None] / 4.0
    roots = torch.where(valid, roots, TMAX)

    bb, cc, dd, ee = (x[..., None] for x in (b, c, d, e))
    for _ in range(newton_iters):
        x = roots
        f = (((x + bb) * x + cc) * x + dd) * x + ee
        fp = ((4.0 * x + 3.0 * bb) * x + 2.0 * cc) * x + dd
        step = f / torch.where(torch.abs(fp) < 1e-12, 1e-12, fp)
        roots = torch.where(valid & (roots < TMAX), x - step, roots)
    return roots, valid
