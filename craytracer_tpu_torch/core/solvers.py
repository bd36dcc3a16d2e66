"""Branchless root solver for batched ray-sphere tests (counterpart of
craytracer_tpu/core/solvers.py `solve_quadratic` :21; the cubic and
quartic solvers wait for the torus, ROADMAP queue 1, slice D)."""

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
