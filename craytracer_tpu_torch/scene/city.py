"""The procedural city of icospheres, the large-mesh scene (counterpart of
bench_mesh.py:18-53 `build_scene`, its camera :258-259, and the
icosphere of scenes/make_fixtures.py:10).

icosphere(3) copies (1,280 triangles each) on a 6-unit grid, each lifted
by 1-3 and scaled by 0.8-1.8 from one seeded generator (seed 0), over a
400 x 400 ground rect, lit by a 20 x 20 emissive rect at height 80; the
camera looks down from a distance that grows with the grid. At 327,680
triangles it is bench_mesh.py's default; at 7,000,000 (6,999,040) the
San-Miguel-scale scene the partitioned BVH4 (accel/bvh4_parts.py) was
built for.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from craytracer_tpu_torch.camera import Film, make_camera
from craytracer_tpu_torch.scene import types as T
from craytracer_tpu_torch.scene.build import SceneBuilder

TRIS_PER_SPHERE = 1280


def icosphere(subdivisions: int = 3):
    """Unit icosphere: (verts [V, 3] f64, faces [F, 3] int64)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    for _ in range(subdivisions):
        edge_mid = {}
        vlist = verts.tolist()

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (np.asarray(vlist[a]) + np.asarray(vlist[b])) / 2.0
                m /= np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m.tolist())
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return verts, faces


def city_triangles(target_tris: int):
    """The city's triangle corners (v0, v1, v2), each [T, 3] f64, T the
    largest multiple of 1,280 not above `target_tris` (at least one
    sphere)."""
    v, f = icosphere(3)
    count = max(1, target_tris // f.shape[0])
    grid = int(np.ceil(np.sqrt(count)))
    rng = np.random.default_rng(0)
    corners = ([], [], [])
    n = 0
    for i in range(grid):
        for j in range(grid):
            if n >= count:
                break
            c = np.array([i * 6.0 - 3 * grid, 1.0 + rng.random() * 2,
                          j * 6.0 - 3 * grid])
            w = v * (0.8 + rng.random()) + c
            for k in range(3):
                corners[k].append(w[f[:, k]])
            n += 1
    return tuple(np.concatenate(c) for c in corners)


def city_builder(target_tris: int) -> SceneBuilder:
    """A SceneBuilder holding the city: materials, ground, lamp, and the
    spheres as one triangle array."""
    b = SceneBuilder()
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_emissive("l", (1, 1, 1), 40.0)
    b.add_rect((-200, 0, -200), (400, 0, 0), (0, 0, 400), "w")
    b.add_rect((-10, 80, -10), (20, 0, 0), (0, 0, 20), "l")
    b.add_triangles_array(*city_triangles(target_tris), "w")
    return b


def city_scene(target_tris: int, accel: str = "auto", device=None):
    """The city built with `accel` on `device`: a picklable way for a rank
    process to make it itself (parallel/dryrun.py's case "scene")."""
    return city_builder(target_tris).build(accel=accel, device=device)


def city_view(n_tris: int, size: int, device=None):
    """bench_mesh.py's camera and a size x size film for a city of
    `n_tris` triangles, on `device` (the card unless the caller asks for
    another)."""
    device = T.resolve_device(device)
    cam = make_camera((0, 40, 3.2 * (n_tris / TRIS_PER_SPHERE) ** 0.5 + 40),
                      (0, 2, 0), device=device)
    film = Film(fov=torch.tensor(math.radians(50.0), device=device),
                width=size, height=size)
    return cam, film
