"""Progressive renderer (counterpart of
craytracer_tpu/integrator/render.py: `RenderConfig` :27, `Renderer` :119
with the env importance default :120-134, the Morton pixel order
:150-168, spp batching :98-116 and NaN substitution :241-255).

Each pass traces one sample per pixel for the whole image through
`render_sample` (one K1 launch on the card for a scene of at most 64
rows of spheres, planes, rects, disks, flat triangles and boxes; a K3,
K2 and K4 launch per bounce for a mesh scene; a K2 launch per bounce for
a scene with a torus or a cylinder; the general torch-op step per
bounce, with a K3 and K4 launch for a mesh, for a scene no kernel
shades: textures and normal maps, disk, point, directional and mesh
lights, a constant or texture env light, anisotropic or
Trowbridge-Reitz microfacets, more than 16 lights or 64 materials) and
accumulates into an f32 buffer on the scene's device. Under the
physical and MIS estimators a texture env with a texel CDF is sampled by
importance even where the scene did not ask (the JAX Renderer's
measured default: lower variance, and the cosine strategy carries the
reference's rotated-env pdf quirk, trace.h:307); the reference
estimator keeps what the scene says, since its L / good_paths ratio
depends on the strategy.
With `spp_batch` B > 1 one pass carries B samples per pixel (lanes = B *
pixels) with the same launches.
Pixels go out in Morton order, a pure reorder (the RNG keys off pixel
id) that keeps each warp's rays coherent. A NaN sample is replaced by the
running mean (main.cpp:127-136); the JAX Renderer's NaN-log retrace
waits for ROADMAP slice F.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from craytracer_tpu_torch.integrator.wavefront import render_sample
from craytracer_tpu_torch.utils.tonemap import tone_map


@dataclass
class RenderConfig:
    num_samples: int = 16
    max_depth: int = 5
    seed: int = 0
    # B spp per pass (one launch); replica r of pixel p traces spp index
    # s + r, the same counter-RNG stream the sequential loop would use
    spp_batch: int = 1
    estimator: str = "reference"


class Renderer:
    def __init__(self, scene, camera, film, config: RenderConfig):
        env = scene.env
        if (config.estimator in ("physical", "mis") and env.kind == 2
                and not env.importance and env.flat_cdf is not None):
            scene = dataclasses.replace(
                scene, env=dataclasses.replace(env, importance=1))
        self.scene = scene
        self.camera = camera
        self.film = film
        self.config = config
        self.device = scene.device
        self.accum = torch.zeros((film.num_pixels, 3), dtype=torch.float32,
                                 device=self.device)
        self.spp_done = 0
        self.passes = 0  # render_sample calls
        self.nan_count = 0

    def pixel_order(self) -> np.ndarray:
        """Morton dispatch order: dispatch position -> pixel id (int32)."""
        w, h = self.film.width, self.film.height
        n = self.film.num_pixels
        bits = max(int(np.ceil(np.log2(max(w, h, 2)))), 1)
        code = np.arange(1 << (2 * bits), dtype=np.int64)
        x = np.zeros_like(code)
        y = np.zeros_like(code)
        for b in range(bits):
            x |= ((code >> (2 * b)) & 1) << b
            y |= ((code >> (2 * b + 1)) & 1) << b
        pid = y * w + x
        return pid[(x < w) & (y < h)].astype(np.int32)[:n]

    @torch.no_grad()
    def render(self):
        cfg = self.config
        n = self.film.num_pixels
        dev = self.device
        perm = self.pixel_order()
        ids = torch.from_numpy(perm).to(dev)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n, dtype=np.int32)
        inv = torch.from_numpy(inv).to(dev).long()
        s = self.spp_done
        end = self.spp_done + cfg.num_samples
        B = max(1, cfg.spp_batch)
        while s < end:
            b = min(B, end - s)
            ids_b = ids.repeat(b)
            spp_lane = s + torch.arange(b, dtype=torch.int32,
                                        device=dev).repeat_interleave(n)
            vals = render_sample(self.scene, self.camera, self.film, ids_b,
                                 cfg.seed, spp_lane, cfg.max_depth,
                                 cfg.estimator)
            self.passes += 1
            # dispatch order -> pixel order
            vals = vals.reshape(b, n, 3)[:, inv]
            nan_px = torch.isnan(vals).any(dim=-1)
            mean_so_far = self.accum / max(s, 1)
            vals = torch.where(nan_px[..., None],
                               torch.nan_to_num(mean_so_far)[None], vals)
            self.nan_count += int(nan_px.sum())
            self.accum = self.accum + vals.sum(dim=0)
            s += b
        self.spp_done = end
        return self.image()

    def raw_mean(self) -> np.ndarray:
        spp = max(self.spp_done, 1)
        return (self.accum / spp).cpu().numpy().reshape(
            self.film.height, self.film.width, 3)

    def image(self) -> np.ndarray:
        """Tone-mapped [H, W, 3] image of the running mean."""
        spp = max(self.spp_done, 1)
        return tone_map(self.accum / spp).cpu().numpy().reshape(
            self.film.height, self.film.width, 3)
