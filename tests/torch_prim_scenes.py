"""Test scenes of planes, disks, instanced shapes and a thin-lens camera,
written as builder calls: the JAX package's fused-path scenes
(tests/test_pallas_shade.py :320-334 planes and disks, :391-402
instanced boxes, :358-376 thin lens) and a scene of every instanced kind
for the intersection tests. The port's tests and chip_smoke.py build
them.

Each scene function takes a SceneBuilder (the port's, or any object with
the same methods, so one call sequence can build both packages' scenes)
and returns the view the JAX tests render it with: (camera position,
look point, fov in radians, depth).
"""

from __future__ import annotations

import dataclasses

# the JAX camera defaults a thin-lens render of parity_cornell takes
# (camera.py make_camera: focal_length 3.0, lens_radius 0.2)
THINLENS = 1


def plane_disk(b):
    """Two planes, a disk facing the camera and one whose stored normal
    faces away (the flip leg), a mirror ball, a triangle, a rect lamp."""
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_matte("g", (0.2, 0.6, 0.2))
    b.add_matte("b", (0.2, 0.3, 0.7))
    b.add_mirror("m", (0.9, 0.9, 0.9))
    b.add_emissive("lamp", (1.0, 0.9, 0.8), 18.0)
    b.add_plane((0, 0, 0), (0, 1, 0), "w")
    b.add_plane((0, 0, -4), (0, 0, 1), "g")
    b.add_disk((-1.2, 1.0, -1.0), (0.3, 0.2, 1.0), 0.8, "b")
    b.add_disk((1.4, 0.9, -0.5), (0, 0, -1), 0.6, "g")
    b.add_sphere((0.2, 0.7, 0.6), 0.7, "m")
    b.add_triangle((-0.5, 0.0, 1.8), (0.6, 0.0, 1.6), (0.0, 1.1, 1.7), "b")
    b.add_rect((-1, 3.2, -1), (2, 0, 0), (0, 0, 2), "lamp")
    return (0, 1.8, 5.5), (0, 0.9, 0), 0.85, 4


def aabox(b):
    """A ground plane, a rotated box, a rotated and scaled box, a mirror
    ball and a rect lamp."""
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_matte("r", (0.6, 0.15, 0.1))
    b.add_mirror("m", (0.9, 0.9, 0.9))
    b.add_emissive("lamp", (1.0, 0.9, 0.8), 18.0)
    b.add_plane((0, 0, 0), (0, 1, 0), "w")
    b.add_box(1.2, 0.8, 0.9, "r", location=(-1.1, 0.4, 0.2),
              orientation=(0, 30, 0))
    b.add_box(0.6, 1.6, 0.6, "w", location=(0.9, 0.8, -0.6),
              scale=(1.0, 1.0, 1.3), orientation=(10, -20, 5))
    b.add_sphere((0.1, 0.45, 1.4), 0.45, "m")
    b.add_rect((-1, 3.0, -1), (2, 0, 0), (0, 0, 2), "lamp")
    return (0, 1.6, 5.0), (0, 0.7, 0), 0.85, 4


def every_instance(b):
    """Every instanced kind, rotated and scaled: a box, open cylinders
    with each normal rule, a solid cylinder (a tube and two INST_DISK
    caps), a clipped torus; a plane and a disk beside them."""
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_matte("r", (0.6, 0.15, 0.1))
    b.add_emissive("lamp", (1.0, 0.9, 0.8), 18.0)
    b.add_plane((0, -1.5, 0), (0.1, 1, 0), "w")
    b.add_disk((2.2, 0.4, -1.0), (-0.5, 0.2, 1.0), 0.7, "r")
    b.add_box(1.0, 0.7, 0.8, "r", location=(-1.8, 0.2, 0.3),
              scale=(1.2, 0.9, 1.1), orientation=(0.3, 0.5, -0.2))
    for i, nt in enumerate((0, 1, 2)):
        b.add_open_cylinder(2.5, "w", location=(-0.6 + 1.2 * i, 1.6, -0.8),
                            scale=(0.4, 0.5, 0.4),
                            orientation=(0.2 * i, 0.4, 0.1), normal_type=nt)
    b.add_solid_cylinder("r", location=(0.4, -0.4, 0.6),
                         scale=(0.5, 0.6, 0.5), orientation=(0.6, 0.0, 0.3))
    b.add_torus(0.6, 0.2, 2.5, "w", location=(1.6, -0.5, 0.8),
                scale=(1.0, 1.2, 1.0), orientation=(0.9, 0.3, 0.0))
    b.add_rect((-1, 3.0, -1), (2, 0, 0), (0, 0, 2), "lamp")
    return (0, 1.2, 6.0), (0, 0.2, 0), 0.9, 4


SCENES = {"plane_disk": plane_disk, "aabox": aabox}


class MatteOnly:
    """A SceneBuilder whose mirrors are matte, so the scene takes K1's
    matte-only core, and which leaves the planes out if `planes` is
    False."""

    def __init__(self, b, planes=True):
        self._b, self._planes = b, planes

    def __getattr__(self, name):
        return getattr(self._b, name)

    def add_mirror(self, name, color):
        self._b.add_matte(name, color)

    def add_plane(self, *args, **kwargs):
        if self._planes:
            self._b.add_plane(*args, **kwargs)


# matte-only scenes with planes and disks, planes and boxes, or boxes
# alone: with Cornell (neither) they reach every K1 instantiation
MATTE_SCENES = {"plane_disk_matte": (plane_disk, True),
                "aabox_matte": (aabox, True), "boxes_matte": (aabox, False)}


def build_matte(name, b):
    """Builds MATTE_SCENES[name] into `b`; returns its view."""
    scene, planes = MATTE_SCENES[name]
    return scene(MatteOnly(b, planes))


def thinlens(camera):
    """`camera` with the thin-lens type (its focal_length and lens_radius
    as made, the JAX defaults 3.0 and 0.2)."""
    return dataclasses.replace(camera, camera_type=THINLENS)
