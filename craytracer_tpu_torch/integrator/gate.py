"""The route gate: which scenes the port can render and through which
route (the port's counterpart of
craytracer_tpu/integrator/pallas_shade.py `production_fast_shade` :1490,
`fast_shade_mode` :1521 and `fast_shade_ok` :1566).

`production_fast_shade` returns one of three routes:

- "bounce": the whole pass is one K1 launch (integrator/pass_kernel.py);
- "shade": per bounce, the closest hit (through K3 for a bvh4 scene),
  K2's shading, then the shadow any hit (through K4 for a bvh4 scene)
  (integrator/wavefront.py);
- "general": per bounce, the same closest hit and shadow any hit around
  the torch-op shading of every lobe and light (the JAX XLA bounce step,
  integrator/wavefront.py `_general_step`), for the MIS estimator on
  every scene (the JAX package keeps MIS off its kernels, wavefront.py
  :439, :602), for a pass under autograd (`needs_grad`: a tensor of the
  scene, camera or film requires grad while autograd records; K1 and K2 are
  forward-only, and the JAX package differentiates its XLA step, the
  render_sample default fast_shade=False, wavefront.py:585) and for the
  scenes the JAX gate answers False: a material
  type or lobe form K2 lacks (anisotropic or Trowbridge-Reitz
  microfacets), textures or normal maps, a texture env light or texel
  importance, a light row that can be picked (power > 0) other than a
  rect or sphere area light (a constant env light with intensity > 0,
  disk, point, directional lights, and mesh lights but for one at power
  0 beside another light, which the power CDF never picks), no light or
  more than 16 lights, or more than 64 materials.

"bounce" and "shade" cover spheres, planes, rects, disks, triangles and
the instanced boxes, cylinders and tori, all seven material types (MATTE
with or without Oren-Nayar, MIRROR, PLASTIC, METAL, GLASS, TRANSPARENT,
EMISSIVE; the microfacet lobes isotropic Beckmann), rect and sphere area
lights, a constant or black env light without a light row, and pinhole
and thin-lens cameras. A scene leaves K1's gate for "shade" by its
geometry only: an instanced row that is not a box (a torus, an open
cylinder, a solid cylinder's caps: no kernel intersects them,
pallas_shade.py:1535-1540), more than 64 rows of spheres, planes, rects,
disks, triangles and boxes together, a bvh4 accelerator, a sphere BVH4,
smooth triangles, a sphere clip outside the domain where the kernel's
cosine-space window equals the atan2/acos one (pallas_shade.py
:1541-1557), or depth 31 and over. Other accelerators raise
NotImplementedError naming their ROADMAP item, an estimator other than
reference, physical and mis raises ValueError, and a camera type other
than PINHOLE and THINLENS, which neither package has, raises
NotImplementedError. The plain versions ask the same gate, so they cover
the same scenes. The gate reads only static fields and table shapes, so
asking costs no device sync.

`shade_features` is the scene's feature mask (pallas_shade.py:1793-1802):
which of the material and light branches the shading core needs. The
plain version skips the branches it lacks; K2 is built once per mask, and
K1 takes its matte-only core when it is 0 and its full core otherwise.
"""

from __future__ import annotations

import torch

from craytracer_tpu_torch.camera import PINHOLE, THINLENS
from craytracer_tpu_torch.scene import types as T

MAX_LIGHTS = 16
MAX_PRIMS = 64
MAX_MATS = 64
MAX_DEPTH = 30  # K1's alive-per-bounce bitmask is one 32-bit word
ESTIMATORS = ("reference", "physical", "mis")
TRACE_TYPES = ("PATHTRACE", "WHITTED", "RAYCAST")  # config.h trace_type

# the shading core's feature mask (the has_* flags of pallas_shade.py
# :1793-1802)
F_MIRROR, F_SPHERE_LIGHT, F_OREN, F_PLASTIC, F_METAL, F_GLASS, \
    F_TRANSPARENT = (1 << i for i in range(7))
F_ALL = (1 << 7) - 1
_MAT_FEATURE = ((T.MAT_MIRROR, F_MIRROR), (T.MAT_PLASTIC, F_PLASTIC),
                (T.MAT_METAL, F_METAL), (T.MAT_GLASS, F_GLASS),
                (T.MAT_TRANSPARENT, F_TRANSPARENT))
_MATERIALS = {T.MAT_MATTE, T.MAT_EMISSIVE, T.MAT_MIRROR, T.MAT_PLASTIC,
              T.MAT_METAL, T.MAT_GLASS, T.MAT_TRANSPARENT}


def shade_features(scene: T.Scene) -> int:
    """The branches of the shading core this scene needs, as F_* bits."""
    mats = scene.mat_types_present
    f = sum(bit for mt, bit in _MAT_FEATURE if mt in mats)
    if T.LIGHT_AREA_SPHERE in scene.light_types_present:
        f |= F_SPHERE_LIGHT
    if T.MAT_MATTE in mats and not scene.matte_lambertian:
        f |= F_OREN
    return f


def check_estimator(estimator: str):
    """Raise ValueError for an estimator other than the three of root
    render.py:31 (`--estimator`)."""
    if estimator not in ESTIMATORS:
        raise ValueError(f"estimator {estimator!r}: not one of "
                         f"{', '.join(ESTIMATORS)}")


def needs_grad(*objs) -> bool:
    """Autograd records and a tensor leaf of `objs` (scenes, cameras,
    tensors) requires grad: the pass must be differentiable, so it takes
    the general step, whose search alone is detached."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for obj in objs for t in T.tensor_leaves(obj))


def unported(scene: T.Scene):
    """What no route of the port renders yet, naming its ROADMAP item, or
    None."""
    if scene.accel not in ("none", "bvh4"):
        return f"accel={scene.accel!r} (ROADMAP queue 1, slice I)"
    return None


def kernels_shade(scene: T.Scene) -> bool:
    """K1 and K2 can shade this scene (fast_shade_ok, pallas_shade.py
    :1566-1610): no texture, no texture env or texel importance, and
    every light row that can be picked (power > 0) a rect or sphere area
    light. A row of power 0 (a mesh light in the reference power mode)
    spans a zero-width interval of the power CDF, which the kernels'
    side="right" count never lands in; past the last entry the clip can
    land on it, with pick probability 0, and the sample is discarded as
    invalid, in the kernels as in the JAX ones."""
    n_lights = scene.lights.light_type.shape[0]
    return (set(scene.mat_types_present) <= _MATERIALS
            and scene.textures.texels.shape[0] <= 1
            and scene.env.kind in (0, 1) and not scene.env.importance
            and scene.microfacet_iso_beckmann
            and 1 <= n_lights <= MAX_LIGHTS
            and set(scene.light_types_picked) <= {T.LIGHT_AREA_RECT,
                                                   T.LIGHT_AREA_SPHERE}
            and scene.materials.mat_type.shape[0] <= MAX_MATS)


_GEOMETRY = ("spheres", "planes", "rects", "disks", "triangles",
             "instanced")


def fast_shade_mode(scene: T.Scene, max_depth: int = 5) -> str:
    """"bounce" when K1 takes the whole pass, "shade" when the scene
    leaves K1's gate by geometry only (fast_shade_mode :1521-1563): the
    box table joins K1's rows only when every instanced row is a box, and
    a scene with a bvh4 or a sphere BVH4 table is never K1's."""
    n_rows = sum(getattr(scene, g).mat_id.shape[0] for g in _GEOMETRY)
    if (not scene.instanced_aabox_only or scene.tri_bvh is not None
            or scene.sph_bvh is not None
            or n_rows > MAX_PRIMS or scene.smooth_triangles
            or not scene.sphere_clips_in_domain or max_depth > MAX_DEPTH):
        return "shade"
    return "bounce"


def production_fast_shade(scene: T.Scene, camera=None, film=None,
                          estimator: str = "reference", max_depth: int = 5,
                          trace_type: str = "PATHTRACE"):
    """THE production decision (pallas_shade.py:1490): "bounce",
    "shade" or "general", or NotImplementedError naming the ROADMAP item
    that will cover the scene. It is static: table shapes, static fields
    and whether a tensor requires grad, never a caught exception. The
    port has no other route, so nothing is quietly traced another way.
    A `trace_type` other than PATHTRACE gets no kernel route
    (pallas_shade.py:1505): "general", and render_sample traces it
    through integrator/whitted.py, whose search takes K3 and K4 for a
    bvh4 mesh on the card."""
    check_estimator(estimator)
    if trace_type not in TRACE_TYPES:
        raise ValueError(f"trace_type {trace_type!r}: not one of "
                         f"{', '.join(TRACE_TYPES)}")
    if camera is not None and camera.camera_type not in (PINHOLE, THINLENS):
        raise NotImplementedError(
            f"camera type {camera.camera_type}: craytracer_tpu_torch, like "
            "the reference package, has only PINHOLE and THINLENS")
    reason = unported(scene)
    if reason is not None:
        raise NotImplementedError(
            f"craytracer_tpu_torch cannot render this yet: {reason}")
    if (estimator == "mis" or trace_type != "PATHTRACE"
            or needs_grad(scene, camera, film) or not kernels_shade(scene)):
        return "general"
    return fast_shade_mode(scene, max_depth)
