"""Slice-E test scenes (textures, normal maps, texture env lights, mesh
lights) and the glossy MIS scene of tests/test_mis.py, which both
packages' builders make from one call sequence; the port's tests and
chip_smoke.py build them.

Each scene function takes a SceneBuilder (the port's, or the JAX
package's: they share these methods) and, where it needs an image, that
package's `load_texture_image`, and returns the view to render it with:
(camera position, look point, fov in radians). Images are the tracked
ones under scenes/.
"""

from __future__ import annotations

import math
import os

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes")


def _image(load, name):
    img = load(os.path.join(SCENES, name))
    assert img is not None, name
    return img


def glossy_lamp(b, light_size=1.0):
    """tests/test_mis.py:13-27: a rough SILVER floor under a small bright
    lamp of constant power (400 / light_size^2)."""
    b.add_metal("floor", preset="SILVER", roughness=0.25)
    b.add_matte("wall", (0.4, 0.4, 0.4))
    b.add_emissive("lamp", (1, 1, 1), 400.0 / (light_size * light_size))
    b.add_rect((-20, 0, -20), (40, 0, 0), (0, 0, 40), "floor")
    b.add_rect((-light_size / 2, 8, -light_size / 2), (light_size, 0, 0),
               (0, 0, light_size), "lamp")
    return (0, 4, 14), (0, 0, 0), math.radians(40.0)


def quad_lamp(b):
    """tests/test_mis.py:76-104: a 40 x 40 matte floor under a 4 x 4
    emissive two-triangle quad mesh at y = 8, wound to face down (a mesh
    light, the only light)."""
    b.add_matte("floor", (0.7, 0.7, 0.7))
    b.add_emissive("lamp", (1, 1, 1), 30.0)
    b.add_rect((-20, 0, -20), (40, 0, 0), (0, 0, 40), "floor")
    b.add_mesh(positions=[(-2, 8, -2), (2, 8, -2), (2, 8, 2), (-2, 8, 2)],
               indices=[(0, 1, 2), (0, 2, 3)], mat="lamp")
    return (0, 4, 14), (0, 0, 0), math.radians(40.0)


def quad_lamp_and_rect(b):
    """The quad lamp beside a small rect lamp: under the reference power
    mode the mesh light's power is 0 and the rect lamp takes every NEE
    sample (alone, the quad would get the uniform fallback, power 1)."""
    view = quad_lamp(b)
    b.add_emissive("rect_lamp", (1.0, 0.9, 0.8), 40.0)
    b.add_rect((4, 6, -1), (2, 0, 0), (0, 0, 2), "rect_lamp")
    return view


def normal_floor(b, load):
    """A checker-textured, normal-mapped matte floor (the fullscene
    floor's PNGs, uv over the rect), a textured plastic ball and a plain
    matte ball under a rect lamp."""
    checker = b.add_texture("fullscene_checker.png",
                            _image(load, "fullscene_checker.png"))
    normal = b.add_texture("fullscene_normal.png",
                           _image(load, "fullscene_normal.png"))
    b.add_matte("floor", (0.5, 0.5, 0.5), diffuse_tex=checker,
                normal_tex=normal)
    b.add_plastic("ball", (0.3, 0.3, 0.3), (0.4, 0.4, 0.4), 0.1,
                  diffuse_tex=checker)
    b.add_matte("grey", (0.6, 0.6, 0.6))
    b.add_emissive("lamp", (1.0, 0.95, 0.9), 25.0)
    b.add_rect((-4, 0, -4), (8, 0, 0), (0, 0, 8), "floor")
    b.add_sphere((-0.8, 0.7, 0.0), 0.7, "ball")
    b.add_sphere((1.2, 0.5, 0.8), 0.5, "grey")
    b.add_rect((-0.75, 4, -0.75), (1.5, 0, 0), (0, 0, 1.5), "lamp")
    return (0, 2.5, 5.5), (0, 0.3, 0), math.radians(45.0)


def env_spheres(b, load, importance):
    """Matte, plastic and gold balls on a matte floor under the fullscene
    HDR sky (a texture env through the reference's rot-y(-0.76), its
    only light), sampled by texel importance when `importance`."""
    env = b.add_texture("fullscene_env.exr", _image(load,
                                                    "fullscene_env.exr"))
    b.add_matte("floor", (0.6, 0.6, 0.6))
    b.add_matte("rough", (0.7, 0.4, 0.3), sigma=15.0)
    b.add_plastic("plastic", (0.1, 0.3, 0.7), (0.4, 0.4, 0.4), 0.1)
    b.add_metal("gold", "GOLD", 0.1)
    b.add_rect((-5, 0, -5), (10, 0, 0), (0, 0, 10), "floor")
    b.add_sphere((-1.4, 0.8, 0.0), 0.8, "rough")
    b.add_sphere((0.4, 0.7, 0.3), 0.7, "plastic")
    b.add_sphere((1.8, 0.5, 1.0), 0.5, "gold")
    b.set_env_light("texture", intensity=1.0, tex_id=env,
                    rotate_y_angle=-0.76, importance=importance)
    return (0, 2.0, 6.0), (0, 0.6, 0), math.radians(45.0)
