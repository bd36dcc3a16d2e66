"""The field of random spheres, the many-spheres scene (counterpart of
bench_spheres.py:18-40 `build_scene` and its camera and film :64-66).

`n_spheres` matte spheres on a 3-unit grid, each jittered by up to 0.8
in x and z, lifted by 0.6-3.1 and of radius 0.4-0.9, drawn from one
seeded generator (seed 7) in bench_spheres.py's order, over a 400 x 400
matte ground rect, lit by a 20 x 20 emissive rect at height 80; the
camera looks down from a distance that grows with the grid. From 256
spheres on, `build` indexes them with the sphere BVH4
(accel/bvh4_sphere.py), and the scene takes the "shade" route: the
sphere traversal in torch ops, then K2 once per bounce. At 10,000
spheres it is bench_spheres.py's default.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from craytracer_tpu_torch.camera import Film, make_camera
from craytracer_tpu_torch.scene import types as T
from craytracer_tpu_torch.scene.build import SceneBuilder


def sphere_field(n_spheres: int, device=None):
    """The field built (accel="auto") on `device`, the card unless the
    caller asks for another."""
    rng = np.random.default_rng(7)
    b = SceneBuilder()
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_emissive("l", (1, 1, 1), 40.0)
    b.add_rect((-200, 0, -200), (400, 0, 0), (0, 0, 400), "w")
    b.add_rect((-10, 80, -10), (20, 0, 0), (0, 0, 20), "l")
    side = int(np.ceil(n_spheres ** 0.5))
    n = 0
    for i in range(side):
        for j in range(side):
            if n >= n_spheres:
                break
            c = (i * 3.0 - 1.5 * side + rng.uniform(-0.8, 0.8),
                 0.6 + rng.random() * 2.5,
                 j * 3.0 - 1.5 * side + rng.uniform(-0.8, 0.8))
            b.add_sphere(c, 0.4 + rng.random() * 0.5, "w")
            n += 1
    return b.build(device=device)


def sphere_field_view(n_spheres: int, size: int, device=None):
    """bench_spheres.py's camera and a size x size film for a field of
    `n_spheres`, on `device` (the card unless the caller asks for
    another)."""
    device = T.resolve_device(device)
    cam = make_camera((0, 40, 2.0 * n_spheres ** 0.5 + 30), (0, 1, 0),
                      device=device)
    film = Film(fov=torch.tensor(math.radians(50.0), device=device),
                width=size, height=size)
    return cam, film
