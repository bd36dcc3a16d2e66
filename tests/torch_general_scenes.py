"""Test scenes that the port renders through the "general" route
(integrator/gate.py): disk, point and directional lights, a constant env
light, 17 lights, 65 materials and anisotropic or Trowbridge-Reitz
microfacets, none of which K1 or K2 shades. The port's tests and
chip_smoke.py build them.

Each scene function takes a SceneBuilder (the port's, or any object with
the same methods, so one call sequence can build both packages' scenes)
and returns the view to render it with: (camera position, look point,
fov in radians, depth). The builders' grammar has no anisotropic or
Trowbridge-Reitz material, so `make_anisotropic` rewrites the microfacet
rows of a scene's numpy leaves (interop.numpy_leaves), which
interop.scene_from_numpy then carries into the port.
"""

from __future__ import annotations

import numpy as np

from craytracer_tpu_torch.scene import types as T


def _room(b):
    """A floor and a back wall."""
    b.add_matte("floor", (0.7, 0.7, 0.7))
    b.add_matte("wall", (0.5, 0.55, 0.6))
    b.add_rect((-5, 0, -5), (10, 0, 0), (0, 0, 10), "floor")
    b.add_rect((-5, 0, -3), (10, 0, 0), (0, 5, 0), "wall")


def disk_light(b):
    """Lambertian, Oren-Nayar and plastic balls under two disk lights,
    one facing down and one tilted toward the wall."""
    _room(b)
    b.add_matte("rough", (0.7, 0.3, 0.2), sigma=20.0)
    b.add_plastic("plastic", (0.1, 0.3, 0.7), (0.4, 0.4, 0.4), 0.1)
    b.add_emissive("lamp", (1.0, 0.9, 0.8), 12.0)
    b.add_emissive("lamp2", (0.6, 0.8, 1.0), 6.0)
    b.add_sphere((-1.3, 0.8, 0.0), 0.8, "rough")
    b.add_sphere((0.9, 0.7, 0.4), 0.7, "plastic")
    b.add_sphere((0.0, 0.4, 1.6), 0.4, "wall")
    b.add_disk((0.0, 3.6, 0.0), (0, -1, 0), 0.9, "lamp")
    b.add_disk((2.5, 2.0, 1.5), (-0.5, -0.3, -1.0), 0.5, "lamp2")
    return (0, 2.0, 6.0), (0, 0.8, 0), 0.8, 5


def delta_lights(b):
    """Oren-Nayar, plastic and metal balls lit by a point light with 1/d^2
    falloff, one without, and a directional light (the JAX grammar's
    POINT_LIGHT and DIRECTIONAL_LIGHT)."""
    _room(b)
    b.add_matte("rough", (0.6, 0.6, 0.3), sigma=30.0)
    b.add_plastic("plastic", (0.7, 0.2, 0.2), (0.5, 0.5, 0.5), 0.08)
    b.add_metal("gold", "GOLD", 0.1)
    b.add_sphere((-1.4, 0.8, 0.0), 0.8, "rough")
    b.add_sphere((0.4, 0.7, 0.3), 0.7, "plastic")
    b.add_sphere((1.8, 0.5, 1.0), 0.5, "gold")
    b.add_point_light((0.5, 3.5, 2.0), (1.0, 0.95, 0.9), 14.0)
    b.add_point_light((-2.5, 2.0, 2.5), (0.5, 0.7, 1.0), 0.6,
                      dist_atten=False)
    b.add_directional_light((0.3, 1.0, 0.6), (1.0, 0.9, 0.7), 1.5)
    return (0, 2.0, 6.0), (0, 0.8, 0), 0.8, 5


def many_lights(b):
    """17 lights (past K1/K2's 16): nine rects, five spheres and three
    disks of different colors around a matte and a plastic ball."""
    _room(b)
    b.add_plastic("plastic", (0.3, 0.5, 0.2), (0.5, 0.5, 0.5), 0.15)
    b.add_sphere((-0.8, 0.8, 0.0), 0.8, "floor")
    b.add_sphere((1.0, 0.6, 0.5), 0.6, "plastic")
    for i in range(17):
        a = 2.0 * np.pi * i / 17
        c = (0.5 + 0.5 * np.cos(a), 0.5 + 0.5 * np.sin(a), 0.6)
        b.add_emissive(f"l{i}", c, 4.0 + i)
        p = (3.0 * np.cos(a), 3.2 + 0.3 * np.sin(3 * a), 3.0 * np.sin(a))
        if i < 9:
            b.add_rect(p, (0.6, 0, 0), (0, 0, 0.6), f"l{i}")
        elif i < 14:
            b.add_sphere(p, 0.25, f"l{i}")
        else:
            b.add_disk(p, (0, -1, 0), 0.35, f"l{i}")
    return (0, 2.5, 6.5), (0, 0.8, 0), 0.9, 5


def many_materials(b):
    """65 materials (past K1/K2's 64, the builder's default row counted)
    on a grid of 61 balls: every type in turn, Oren-Nayar sigmas and
    microfacet roughnesses varied."""
    _room(b)
    b.add_emissive("lamp", (1.0, 0.95, 0.9), 10.0)
    b.add_rect((-1.5, 4.0, -1.5), (3, 0, 0), (0, 0, 3), "lamp")
    for i in range(61):
        c = ((i * 37 % 100) / 100.0, (i * 59 % 100) / 100.0,
             (i * 83 % 100) / 100.0)
        kind = i % 6
        if kind == 0:
            b.add_matte(f"m{i}", c, sigma=float(i % 30))
        elif kind == 1:
            b.add_plastic(f"m{i}", c, (0.4, 0.4, 0.4), 0.05 + 0.01 * i)
        elif kind == 2:
            b.add_metal(f"m{i}", ("GOLD", "SILVER", "COPPER")[i % 3],
                        0.05 + 0.005 * i)
        elif kind == 3:
            b.add_glass(f"m{i}", 0.02 * (i % 5))
        elif kind == 4:
            b.add_mirror(f"m{i}", c)
        else:
            b.add_transparent(f"m{i}")
        b.add_sphere((-3.0 + 0.6 * (i % 10), 0.25, -2.0 + 0.6 * (i // 10)),
                     0.25, f"m{i}")
    return (0, 3.5, 5.5), (0, 0.3, -0.5), 0.9, 5


def aniso_spheres(b):
    """Two metals, a plastic and a glass ball for `make_anisotropic` to
    turn anisotropic or Trowbridge-Reitz, under a rect lamp and a
    constant env light."""
    _room(b)
    b.add_metal("gold", "GOLD", 0.08)
    b.add_metal("silver", "SILVER", 0.12)
    b.add_plastic("plastic", (0.2, 0.4, 0.6), (0.5, 0.5, 0.5), 0.1)
    b.add_glass("glass", 0.1)
    b.add_emissive("lamp", (1.0, 0.95, 0.9), 12.0)
    b.add_sphere((-2.0, 0.7, 0.0), 0.7, "gold")
    b.add_sphere((-0.4, 0.7, 0.5), 0.7, "silver")
    b.add_sphere((1.1, 0.6, 0.0), 0.6, "plastic")
    b.add_sphere((2.3, 0.5, 1.0), 0.5, "glass")
    b.add_rect((-1.5, 4.0, -1.5), (3, 0, 0), (0, 0, 3), "lamp")
    b.set_env_light("constant", (0.5, 0.6, 0.8), 0.4)
    return (0, 2.0, 6.0), (0, 0.6, 0), 0.8, 5


def mesh_env_disk(b, shapes):
    """parity_mesh_mid.txt's floor, mesh and lamp rect (its OBJ shapes:
    (positions, indices) pairs), the mesh in a metal that
    `make_anisotropic` turns anisotropic Trowbridge-Reitz, plus a disk
    light and a constant env light."""
    b.add_matte("floor", (0.72, 0.72, 0.72))
    b.add_metal("metal", "GOLD", 0.1)
    b.add_emissive("lamp", (1.0, 0.95, 0.85), 10.0)
    b.add_emissive("disk", (0.7, 0.8, 1.0), 8.0)
    b.add_rect((-12, 0, -12), (24, 0, 0), (0, 0, 24), "floor")
    for positions, indices in shapes:
        b.add_mesh(positions, indices, "metal")
    b.add_rect((-3.0, 7.0, -3.0), (6.0, 0, 0), (0, 0, 6.0), "lamp")
    b.add_disk((4.0, 3.0, 2.0), (-1.0, -0.6, -0.5), 1.0, "disk")
    b.set_env_light("constant", (0.6, 0.7, 0.9), 0.5)
    return (0, 4.5, 11.0), (0, 0.6, 0), np.radians(45.0), 5


# per microfacet material type, in row order: (alphay / alphax, distrib)
ANISO = {
    T.MAT_METAL: ((3.0, T.DIST_TROWBRIDGE_REITZ), (0.4, T.DIST_BECKMANN)),
    T.MAT_PLASTIC: ((1.0, T.DIST_TROWBRIDGE_REITZ),),
    T.MAT_GLASS: ((2.0, T.DIST_BECKMANN),),
}


def make_anisotropic(leaves):
    """Rewrite the microfacet rows of a scene's numpy leaves in place: the
    k-th row of each type in ANISO takes the k-th (mod) entry's alphay /
    alphax ratio and distribution. Returns `leaves`."""
    m = leaves["materials"]
    mat_type = np.asarray(m["mat_type"])
    alphay = np.array(m["alphax"], dtype=np.float32)
    distrib = np.array(m["distrib"], dtype=np.int32)
    for mt, forms in ANISO.items():
        for k, row in enumerate(np.flatnonzero(mat_type == mt)):
            ratio, dist = forms[k % len(forms)]
            alphay[row] = np.float32(alphay[row] * ratio)
            distrib[row] = dist
    m["alphay"], m["distrib"] = alphay, distrib
    return leaves


SCENES = {"disk_light": disk_light, "delta_lights": delta_lights,
          "many_lights": many_lights, "many_materials": many_materials,
          "aniso_spheres": aniso_spheres}
