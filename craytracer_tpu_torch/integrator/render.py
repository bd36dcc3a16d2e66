"""Progressive renderer (counterpart of
craytracer_tpu/integrator/render.py: `RenderConfig` :27-84, `Renderer`
:119 with the env importance default :120-134, `resume_from` :145, the
Morton pixel order :150-168, the auto spp batch :178-192, the tile loop
:225-240, NaN substitution :241-255, `_write_nan_log` :288-337, `_probe`
:339, `image` / `raw_mean` :416-427).

Each pass traces B samples per pixel (`spp_batch`) for the whole image,
or tile by tile (`tile_pixels`: each tile is its own render_sample call,
one K1 launch or one K3, K2 and K4 launch per bounce), through
`render_sample` (integrator/wavefront.py: K1 for a scene of at most 64
rows of spheres, planes, rects, disks, flat triangles and boxes, its
external-ray mode when a table `sampler` makes the camera rays; K3, K2
and K4 per bounce for a mesh scene, with the stream compacted after
bounce 2 on deep traces of large meshes; K2 per bounce for a scene with a
torus or a cylinder; the general torch-op step per bounce, with K3 and K4
for a mesh, for a scene no kernel shades; WHITTED and RAYCAST through
integrator/whitted.py) and accumulates into an f32 buffer on the scene's
device. Under the physical and MIS estimators a texture env with a texel
CDF is sampled by importance even where the scene did not ask (the JAX
Renderer's measured default: lower variance, and the cosine strategy
carries the reference's rotated-env pdf quirk, trace.h:307); the
reference estimator keeps what the scene says, since its L / good_paths
ratio depends on the strategy.

Replica r of pixel p in a pass traces spp index s + r, the counter-RNG
stream the sequential loop would use, and pixels go out in Morton order
(or raster, `ray_order`), a pure reorder: the RNG keys off (seed, pixel,
spp), so tiles, order, batching and a resume from a checkpoint
(io/imagestate.py, `resume_from`) all give the same samples. A NaN sample
is replaced by the running mean (main.cpp:127-136); before that, up to
`nan_log_max` of a pass's NaN samples are traced again, bounce by bounce,
by `trace_paths_logged` and their records appended to `nan_log_path` in
the JAX package's text format.

`spp_batch=0` resolves B by `auto_spp_batch`: the JAX package's rule with
the card in the TPU's place. Its 2M-lane target was measured on a TPU;
tuning it for the card by device time is ROADMAP queue 3 item 6.
The live views (preview PNG, ANSI, HTTP, interactive console) are
ROADMAP slice F, part 3.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from craytracer_tpu_torch.integrator.wavefront import (camera_rays,
                                                       film_jitter,
                                                       render_sample,
                                                       trace_paths_logged)
from craytracer_tpu_torch.utils.tonemap import tone_map

_LIVE = ("preview_path", "preview_every", "serve_port", "ansi_every",
         "interactive")


@dataclass
class RenderConfig:
    num_samples: int = 16
    max_depth: int = 5
    seed: int = 0
    tile_pixels: int = 0  # pixels per render_sample call; 0 = the image
    # B spp per pass (one launch); replica r of pixel p traces spp index
    # s + r, the same counter-RNG stream the sequential loop would use.
    # 0 = auto (`auto_spp_batch`)
    spp_batch: int = 1
    log_every: int = 0  # print progress every k passes (0 = silent)
    estimator: str = "reference"
    trace_type: str = "PATHTRACE"  # or WHITTED, RAYCAST
    # substitute the running mean for NaN samples and count them
    nan_recovery: bool = True
    # retrace NaN samples under the logging tracer and append their
    # per-bounce records here ("" disables; the reference writes
    # trace_log.txt in the working directory)
    nan_log_path: str = "trace_log.txt"
    nan_log_max: int = 8  # samples logged per pass
    sampler: object = None  # sampling.tables.SampleTable for the film jitter
    ray_order: str = "morton"  # or "raster"
    # the bounce after which the per-bounce routes compact the stream;
    # None = the JAX policy (wavefront.compact_policy), 0 = dense
    compact_at: int | None = None
    # the live views, not ported yet
    preview_path: str = ""
    preview_every: int = 0
    serve_port: int = 0
    ansi_every: int = 0
    interactive: bool = False

    def __post_init__(self):
        for name in _LIVE:
            if getattr(self, name):
                raise NotImplementedError(
                    f"RenderConfig.{name}: the live views are not ported to "
                    "craytracer_tpu_torch yet (ROADMAP slice F, part 3)")
        if self.ray_order not in ("morton", "raster"):
            raise ValueError(f"ray_order {self.ray_order!r}: morton or "
                             "raster")


def auto_spp_batch(device_type: str, accel: str, n_tris: int,
                   lanes: int) -> int:
    """spp_batch=0's B: on the card, for a scene whose at least 4,096
    triangles sit in an accelerator, enough spp per pass for about 2M
    lanes (`lanes` per spp: the tile's pixels), at most 16; else 1, and
    always 1 on the CPU, where the lane count is the cost. The JAX rule
    (render.py:178-192) with the card in the TPU's place; its 2M-lane
    target was measured on a TPU, and the card's own policy, by device
    time, is ROADMAP queue 3 item 6."""
    if device_type == "cuda" and accel != "none" and n_tris >= 4096:
        return max(1, min(16, 2_000_000 // max(lanes, 1)))
    return 1


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
        self.spp_done = 0  # updated when render() completes
        self._accum_passes = 0  # spp in accum, the running render's too
        self.passes = 0  # render_sample calls
        self.nan_count = 0
        self.spp_batch = self.resolve_spp_batch()

    def resolve_spp_batch(self) -> int:
        """The B each pass traces: `spp_batch`, or for 0 `auto_spp_batch`
        on this scene, device and tile."""
        cfg = self.config
        if cfg.spp_batch != 0:
            return max(1, cfg.spp_batch)
        n = self.film.num_pixels
        return auto_spp_batch(self.device.type, self.scene.accel,
                              self.scene.triangles.mat_id.shape[0],
                              min(cfg.tile_pixels or n, n))

    def resume_from(self, accum, spp: int):
        """Continue from a checkpoint's accumulator ([H*W, 3]) and spp
        (io/imagestate.py load_image_state)."""
        self.accum = torch.as_tensor(np.asarray(accum, np.float32)).reshape(
            -1, 3).to(self.device)
        self.spp_done = spp
        self._accum_passes = spp

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
        tile = cfg.tile_pixels or n
        if cfg.ray_order == "morton":
            perm = self.pixel_order()
            ids = torch.from_numpy(perm).to(dev)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(n, dtype=np.int32)
            inv = torch.from_numpy(inv).to(dev).long()
        else:
            ids = torch.arange(n, dtype=torch.int32, device=dev)
            inv = None
        start = time.time()
        s = self.spp_done
        end = self.spp_done + cfg.num_samples
        B = self.spp_batch
        while s < end:
            b = min(B, end - s)
            vals = []
            for t0 in range(0, n, tile):
                ids_t = ids[t0:t0 + tile]
                m = ids_t.shape[0]
                spp_lane = s + torch.arange(
                    b, dtype=torch.int32, device=dev).repeat_interleave(m)
                v = render_sample(self.scene, self.camera, self.film,
                                  ids_t.repeat(b), cfg.seed, spp_lane,
                                  cfg.max_depth, cfg.estimator,
                                  trace_type=cfg.trace_type,
                                  sampler=cfg.sampler,
                                  compact_at=cfg.compact_at)
                self.passes += 1
                vals.append(v.reshape(b, m, 3))
            vals = torch.cat(vals, dim=1)
            if inv is not None:
                vals = vals[:, inv]  # dispatch order -> pixel order
            if cfg.nan_recovery:
                nan_px = torch.isnan(vals).any(dim=-1)
                n_nan = int(nan_px.sum())
                if (n_nan and cfg.nan_log_path
                        and cfg.trace_type == "PATHTRACE"):
                    # retrace before substituting (main.cpp:127-136);
                    # columns are pixel ids
                    self._write_nan_log(nan_px.cpu().numpy(), s)
                mean_so_far = self.accum / max(self._accum_passes, 1)
                vals = torch.where(nan_px[..., None],
                                   torch.nan_to_num(mean_so_far)[None], vals)
                self.nan_count += n_nan
            self.accum = self.accum + vals.sum(dim=0)
            s += b
            self._accum_passes = s
            done = s - self.spp_done
            if cfg.log_every and done % cfg.log_every == 0:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                dt = time.time() - start
                nan_note = f" nan={self.nan_count}" if self.nan_count else ""
                print(f"pass {s}: {done / dt:.2f} passes/s{nan_note}")
        self.spp_done = end
        return self.image()

    def _write_nan_log(self, nan_px: np.ndarray, spp0: int):
        """Retrace NaN samples ([b, n] mask, pixel order) under the logging
        tracer and append their per-bounce records (SampleLog,
        trace.h:176-219): the counter RNG keys every decision off (seed,
        pixel, spp, bounce, dim), so the retrace replays the offending
        path."""
        cfg = self.config
        rows, cols = np.nonzero(nan_px)
        with open(cfg.nan_log_path, "a") as f:
            for r, p in list(zip(rows, cols))[:max(1, cfg.nan_log_max)]:
                spp = int(spp0 + r)
                pid = torch.tensor([int(p)], dtype=torch.int32,
                                   device=self.device)
                o, d = camera_rays(self.camera, self.film, pid, cfg.seed,
                                   spp, film_jitter(cfg.seed, pid, spp,
                                                    cfg.sampler))
                L, good, log = trace_paths_logged(
                    self.scene, o, d, cfg.seed, pid, spp, cfg.max_depth)
                log = {k: v.cpu().numpy() for k, v in log.items()}
                x, y = int(p) % self.film.width, int(p) // self.film.width
                f.write(f"NaN/Inf sample: pixel ({x},{y}) id {int(p)} "
                        f"spp {spp} seed {cfg.seed}\n")
                for bo in range(cfg.max_depth + 1):
                    be = log["beta"][bo, 0]
                    dc = log["direct_contrib"][bo, 0]
                    em = log["emissive_indirect_contrib"][bo, 0]
                    ev = log["env_indirect_contrib"][bo, 0]
                    f.write(
                        f"  bounce {bo}: alive={int(log['alive'][bo, 0])} "
                        f"t={float(log['t'][bo, 0]):.6g} "
                        f"beta=({be[0]:.6g} {be[1]:.6g} {be[2]:.6g}) "
                        f"direct=({dc[0]:.6g} {dc[1]:.6g} {dc[2]:.6g}) "
                        f"emit=({em[0]:.6g} {em[1]:.6g} {em[2]:.6g}) "
                        f"env=({ev[0]:.6g} {ev[1]:.6g} {ev[2]:.6g}) "
                        f"new_pdf={float(log['new_sample_pdf'][bo, 0]):.6g}"
                        "\n")
                Lr = L[0].cpu().numpy()
                f.write(f"  L=({Lr[0]:.6g} {Lr[1]:.6g} {Lr[2]:.6g}) "
                        f"good={int(good[0])}\n")

    def _probe(self, x: int, y: int, spp: int):
        """Print pixel (x, y)'s accumulator, mean and tone-mapped mean (the
        reference's click-to-probe, main.cpp:151-167)."""
        i = y * self.film.width + x
        acc = self.accum[i].cpu().numpy()
        mean = acc / max(spp, 1)
        tm = tone_map(torch.from_numpy(mean)[None]).numpy()[0]
        print(f"probe ({x},{y}) @ {spp} spp: accum={acc.tolist()} "
              f"mean={mean.tolist()} tonemapped={tm.tolist()}")

    def raw_mean(self) -> np.ndarray:
        spp = max(self._accum_passes, self.spp_done, 1)
        return (self.accum / spp).cpu().numpy().reshape(
            self.film.height, self.film.width, 3)

    def image(self) -> np.ndarray:
        """Tone-mapped [H, W, 3] image of the running mean."""
        spp = max(self._accum_passes, self.spp_done, 1)
        return tone_map(self.accum / spp).cpu().numpy().reshape(
            self.film.height, self.film.width, 3)
