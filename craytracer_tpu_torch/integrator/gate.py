"""The K1 gate: which scenes the port can render (the port's restriction
of craytracer_tpu/integrator/pallas_shade.py `production_fast_shade`
:1490, `fast_shade_mode` :1521 and `fast_shade_ok` :1566 to what K1
covers).

Both K1 (integrator/pass_kernel.py) and its plain version, the torch-op
`trace_paths` (integrator/wavefront.py), cover exactly these scenes, so
both ask this module; neither imports the other for it. The gate reads
only static fields and table shapes, so asking costs no device sync.
"""

from __future__ import annotations

from craytracer_tpu_torch.camera import PINHOLE, THINLENS
from craytracer_tpu_torch.scene import types as T

MAX_LIGHTS = 16
MAX_PRIMS = 64
MAX_MATS = 64
MAX_DEPTH = 30  # the alive-per-bounce bitmask is one 32-bit word
ESTIMATORS = ("reference", "physical")

_K1_TODO = "ROADMAP queue 2, K1 remaining gate features"
_SLICE_C = "ROADMAP queue 1, slice C (per-bounce shading, K2)"


def _refuse(reason: str):
    raise NotImplementedError(
        f"craytracer_tpu_torch cannot render this yet: {reason}")


def check_estimator(estimator: str):
    """Raise NotImplementedError for an estimator the port lacks."""
    if estimator not in ESTIMATORS:
        _refuse(f"estimator {estimator!r} (ROADMAP queue 1, slice F)")


def fast_shade_refusal(scene: T.Scene):
    """Why K1 cannot run this scene, or None when it can. A light table
    holding any type but rect area lights is refused outright (the JAX
    gate looks at per-row powers; the port's builder emits a non-rect row
    only with nonzero power)."""
    mats = set(scene.mat_types_present)
    if not mats <= {T.MAT_MATTE, T.MAT_EMISSIVE}:
        return f"materials other than matte and emissive ({_K1_TODO})"
    if T.MAT_MATTE in mats and not scene.matte_lambertian:
        return f"Oren-Nayar matte with sigma != 0 ({_K1_TODO})"
    if scene.textures.texels.shape[0] > 1:
        return "textures (ROADMAP queue 1, slice E)"
    if scene.env.kind not in (0, 1) or scene.env.importance:
        return "texture env lights (ROADMAP queue 1, slice E)"
    n_lights = scene.lights.light_type.shape[0]
    if n_lights == 0 or n_lights > MAX_LIGHTS:
        return f"{n_lights} lights, outside K1's 1..{MAX_LIGHTS} ({_SLICE_C})"
    if not set(scene.light_types_present) <= {T.LIGHT_AREA_RECT}:
        return f"lights other than rect area lights ({_K1_TODO})"
    if scene.materials.mat_type.shape[0] > MAX_MATS:
        return f"more than {MAX_MATS} materials ({_SLICE_C})"
    for name in ("spheres", "planes", "disks", "instanced"):
        if getattr(scene, name).mat_id.shape[0]:
            return f"{name} ({_K1_TODO})"
    if scene.accel != "none":
        return "accelerated meshes (ROADMAP queue 1, slice B)"
    n_prims = scene.rects.mat_id.shape[0] + scene.triangles.mat_id.shape[0]
    if n_prims > MAX_PRIMS:
        return f"more than {MAX_PRIMS} primitives ({_SLICE_C})"
    return None


def production_fast_shade(scene: T.Scene, camera=None, film=None,
                          estimator: str = "reference", max_depth: int = 5):
    """THE production decision (pallas_shade.py:1490): returns "bounce"
    when the whole pass can run through K1, and otherwise raises
    NotImplementedError naming the ROADMAP item that will cover it. The
    port has no other route, so nothing is quietly traced another way."""
    check_estimator(estimator)
    if max_depth > MAX_DEPTH:
        _refuse(f"max_depth {max_depth} > {MAX_DEPTH} ({_SLICE_C})")
    if camera is not None and camera.camera_type != PINHOLE:
        kind = "thin-lens" if camera.camera_type == THINLENS else "unknown"
        _refuse(f"{kind} camera ({_K1_TODO})")
    reason = fast_shade_refusal(scene)
    if reason is not None:
        _refuse(reason)
    return "bounce"
