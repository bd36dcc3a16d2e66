"""First-hit AOVs (counterpart of craytracer_tpu/integrator/aov.py:
`AOV_NAMES` :15, `render_aovs` :18): normal, depth, albedo and uv
buffers from one deterministic pass of pixel-center camera rays, the
usual inputs of a denoiser, written as linear EXR by the command line's
--aov. On the card a bvh4 mesh's closest hit goes through K3
(`kernels`); the fills are the plain ones."""

from __future__ import annotations

import torch

from craytracer_tpu_torch.bsdf.bxdf import gather_params
from craytracer_tpu_torch.camera import generate_rays
from craytracer_tpu_torch.constants import TMAX
from craytracer_tpu_torch.ops.intersect import intersect_scene

AOV_NAMES = ("normal", "depth", "albedo", "uv")


@torch.no_grad()
def render_aovs(scene, camera, film, kernels=None):
    """dict of [num_pixels, 3] f32 AOVs: the shading normal (world), the
    hit distance t in every channel, the texture-resolved material color,
    and (u, v, 0); zero on a miss. `kernels` None takes K3 on the card,
    False the plain traversal."""
    dev = scene.device
    n = film.num_pixels
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    o, d = generate_rays(camera, film, ids,
                         torch.full((n, 2), 0.5, device=dev))
    hit = intersect_scene(scene, o, d, kernels=dev.type == "cuda"
                          and kernels is not False)
    ok = (~((hit.group < 0) | (hit.t >= TMAX)))[:, None]
    mp = gather_params(scene.materials, scene.textures, hit.mat_id, hit.uv,
                       lambertian_only=scene.matte_lambertian)
    zero = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    return {
        "normal": torch.where(ok, hit.normal, zero),
        "depth": torch.where(ok, hit.t[:, None].expand(n, 3), zero),
        "albedo": torch.where(ok, mp.color, zero),
        "uv": torch.where(ok, torch.cat([hit.uv, zero[:, :1]], dim=1), zero),
    }
