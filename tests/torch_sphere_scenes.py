"""Test scenes of spheres and every material type, written as builder
calls: the JAX package's fused-path scenes (tests/test_pallas_shade.py
:79-91 mirror and clipped sphere, :136-142 sphere light, :212-226
Oren-Nayar / plastic / mirror / metal, :259-267 glass / transparent).
The port's tests and chip_smoke.py build them.

Each function takes a SceneBuilder (the port's, or any object with the
same methods, so one call sequence can build both packages' scenes) and
returns the view the JAX tests render it with: (camera position, look
point, fov in radians, depth).
"""

from __future__ import annotations


def mirror_spheres(b):
    """MIRROR ball, matte balls and a clipped sphere (phi 2.0, theta
    0.5-2.5) on a floor and a back wall, one rect lamp."""
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_matte("r", (0.6, 0.1, 0.1))
    b.add_mirror("m", (0.9, 0.9, 0.9))
    b.add_emissive("lamp", (1.0, 0.9, 0.8), 20.0)
    b.add_rect((-4, 0, -4), (8, 0, 0), (0, 0, 8), "w")
    b.add_rect((-4, 0, -4), (8, 0, 0), (0, 4, 0), "r")
    b.add_sphere((0.8, 1.0, 0.5), 1.0, "m")
    b.add_sphere((-1.4, 0.7, -0.5), 0.7, "w")
    b.add_sphere((0.0, 0.4, 1.8), 0.4, "r", phi=2.0, min_theta=0.5,
                 max_theta=2.5)
    b.add_rect((-1, 3.5, -1), (2, 0, 0), (0, 0, 2), "lamp")
    return (0, 2.2, 6.0), (0, 1.0, 0), 0.8, 4


def sphere_light(b):
    """A matte ball lit by an emissive sphere (a sphere area light)."""
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_emissive("lamp", (1.0, 0.9, 0.7), 25.0)
    b.add_rect((-4, 0, -4), (8, 0, 0), (0, 0, 8), "w")
    b.add_sphere((-1.0, 0.8, 0.0), 0.8, "w")
    b.add_sphere((1.5, 2.5, 0.5), 0.5, "lamp")
    return (0, 2.0, 5.5), (0, 0.8, 0), 0.8, 4


def glossy_spheres(b):
    """Oren-Nayar (sigma 20), plastic, mirror and gold balls: the
    parity_mix material family."""
    b.add_matte("grey", (0.73, 0.73, 0.73))
    b.add_matte("rough_blue", (0.2, 0.3, 0.7), sigma=20.0)
    b.add_plastic("red_plastic", kd=(0.6, 0.05, 0.05), ks=(0.4, 0.4, 0.4),
                  roughness=0.08)
    b.add_mirror("chrome", (0.9, 0.9, 0.9))
    b.add_metal("gold", "GOLD", 0.1)
    b.add_emissive("lamp", (1.0, 0.95, 0.85), 14.0)
    b.add_rect((-6, 0, -6), (12, 0, 0), (0, 0, 12), "grey")
    b.add_sphere((-2.2, 0.8, 0.0), 0.8, "rough_blue")
    b.add_sphere((-0.7, 0.8, 0.8), 0.8, "red_plastic")
    b.add_sphere((0.9, 0.8, -0.3), 0.8, "chrome")
    b.add_sphere((2.4, 0.8, 0.6), 0.8, "gold")
    b.add_rect((-1.5, 4, -1.5), (3, 0, 0), (0, 0, 3), "lamp")
    return (0, 2.0, 6.5), (0, 0.8, 0), 0.8, 4


def glass_spheres(b):
    """A rough GLASS ball (roughness 0.05) and a thin TRANSPARENT one."""
    b.add_matte("grey", (0.7, 0.7, 0.7))
    b.add_glass("glass", ior_in=1.5, ior_out=1.0, roughness=0.05)
    b.add_transparent("thin", ior_in=1.5, ior_out=1.0)
    b.add_emissive("lamp", (1.0, 0.95, 0.85), 16.0)
    b.add_rect((-6, 0, -6), (12, 0, 0), (0, 0, 12), "grey")
    b.add_sphere((-1.0, 0.9, 0.0), 0.9, "glass")
    b.add_sphere((1.3, 0.7, 0.6), 0.7, "thin")
    b.add_rect((-1.5, 4, -1.5), (3, 0, 0), (0, 0, 3), "lamp")
    return (0, 2.0, 6.0), (0, 0.8, 0), 0.8, 5


SCENES = {"mirror_spheres": mirror_spheres, "sphere_light": sphere_light,
          "glossy_spheres": glossy_spheres, "glass_spheres": glass_spheres}
