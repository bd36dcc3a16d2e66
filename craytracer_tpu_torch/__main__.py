"""Command line: render a reference-grammar scene file (the port's
counterpart of the repo-root render.py, `main` :24-66 and :131-246).

    python -m craytracer_tpu_torch scenes/parity_mesh_mid.txt \\
        --spp 64 --depth 5 --size 512 --seed 0 --estimator reference \\
        -o mesh.ppm
    python -m craytracer_tpu_torch --config config.txt --size 640x480 \\
        --spp-batch 0 --stats --probe 10,20 --aov normal,depth -o out.exr
    python -m craytracer_tpu_torch --config config.txt -s out_state.npz \\
        --spp 8 -o out.exr

It runs on the CUDA card, and raises when there is none, unless asked for
the CPU (--device cpu). On the card every pass runs through the route the
gate picks (integrator/gate.py): K1 for scenes of at most 64 rows of
spheres, planes, rects, disks, flat triangles and boxes, such as
parity_cornell and parity_mix (on the camera rays of a --sampler table
through its external-ray mode); K3 -> K2 -> K4 per bounce for meshes,
the stream compacted after bounce 2 from depth 8 on a mesh of 4,096
triangles or more; K2 per bounce for scenes with a torus or a cylinder,
such as parity_prims; the general torch-op step per bounce, with K3 and
K4 for a mesh, for scenes no kernel shades, such as materials_scene,
parity_textured and fullscene, and for `--estimator mis`; a config's
trace_type WHITTED or RAYCAST through integrator/whitted.py (K3 and K4
for a mesh). On the CPU the plain PyTorch versions run instead.

Options beside the scene file (or a config.txt's scene_file, resolved
beside the config file; a positional scene file overrides it): --config,
the config.txt grammar (io/config.py: num_samples, max_depth,
trace_type, accel_struct, num_sample_sets); -s/--state, resume from a
checkpoint with its seed (a different explicit --seed is refused);
--size WxH or N; --tile, pixels per render_sample call; --spp-batch, 0
(the default) for auto (integrator/render.py auto_spp_batch);
--stats, the intersect-test counts and BVH4 pops of the camera rays;
--probe X,Y; --aov, first-hit AOVs written as <stem>_<aov>.exr;
--sampler, a table sampler for the film jitter; --accel auto, none or
bvh4 (the other accelerators are ROADMAP slice I; a config's GRID takes
bvh4 on the card, with a warning); `--thin-lens` swaps the scene file's
pinhole for a thin-lens camera (lens radius 0.2, in focus at 3.0). An
output ending in .exr gets the linear mean, anything else a tone-mapped
PPM; every render writes its checkpoint <stem>_state.npz. The interactive
console, the HTTP and ANSI live views and the caustic map are ROADMAP
slice F, part 3. Prints one summary line with the route, each kernel's
launches and the spp batch.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_ACCEL = {"GRID": "grid", "BVH": "bvh", "BVH4": "bvh4", "NONE": "none"}


def _parser():
    ap = argparse.ArgumentParser(prog="python -m craytracer_tpu_torch")
    ap.add_argument("scene", nargs="?", default=None,
                    help="reference-grammar scene file (else the config's)")
    ap.add_argument("--config", default=None,
                    help="config.txt (the reference's grammar)")
    ap.add_argument("-s", "--state", default=None,
                    help="resume from this image state (.npz)")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--size", default=None,
                    help="WxH, or N for N x N (default: the scene file's)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--estimator", default="reference",
                    choices=("reference", "physical", "mis"))
    ap.add_argument("--tile", type=int, default=0,
                    help="pixels per render_sample call (0 = the image)")
    ap.add_argument("--spp-batch", type=int, default=0,
                    help="spp per pass; 0 = auto (render.auto_spp_batch)")
    ap.add_argument("--stats", action="store_true",
                    help="print the intersect-test counts and BVH4 pops of "
                    "the camera rays after the render")
    ap.add_argument("--probe", default=None, metavar="X,Y",
                    help="print pixel (x, y)'s accumulated radiance")
    ap.add_argument("--aov", default=None,
                    help="comma list of first-hit AOVs (normal,depth,"
                    "albedo,uv) written as <output-stem>_<aov>.exr")
    ap.add_argument("--sampler", default=None,
                    choices=("rng", "regular", "multijittered",
                             "hammersley"),
                    help="film-jitter sampler: the counter RNG (default) or "
                    "a table of the config's num_samples x num_sample_sets")
    ap.add_argument("--accel", default=None,
                    choices=("auto", "none", "bvh", "bvh4", "bvh4q",
                             "binned", "hybrid", "grid"),
                    help="triangle accelerator (default: the config's, "
                    "else auto); only auto, none and bvh4 are ported")
    ap.add_argument("--thin-lens", action="store_true",
                    help="render through a thin lens (depth of field): "
                    "lens radius 0.2, in focus at 3.0, the camera's defaults")
    ap.add_argument("-o", "--output", default="out_torch.ppm")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def main(argv=None):
    import dataclasses

    import torch

    from craytracer_tpu_torch.accel import bvh4_kernel
    from craytracer_tpu_torch.camera import THINLENS, Film
    from craytracer_tpu_torch.integrator import pass_kernel, shade_kernel
    from craytracer_tpu_torch.integrator.gate import production_fast_shade
    from craytracer_tpu_torch.integrator.render import RenderConfig, Renderer
    from craytracer_tpu_torch.io.config import ConfigParams, parse_config
    from craytracer_tpu_torch.io.image import write_ppm
    from craytracer_tpu_torch.io.imagestate import (load_image_state,
                                                    save_image_state)
    from craytracer_tpu_torch.io.scenefile import load_scene_file

    args = _parser().parse_args(argv)
    cfg = ConfigParams() if args.config is None else parse_config(args.config)
    scene_file = args.scene
    if scene_file is None:
        if args.config is None:
            print("error: give a scene file or --config", file=sys.stderr)
            return 1
        scene_file = cfg.scene_file
        if not os.path.isabs(scene_file) and not os.path.exists(scene_file):
            scene_file = os.path.join(
                os.path.dirname(os.path.abspath(args.config)), scene_file)
    if not os.path.exists(scene_file):
        print(f"error: scene file not found: {scene_file}", file=sys.stderr)
        return 1
    on_card = torch.device(args.device).type == "cuda"
    accel = args.accel or (_ACCEL.get(cfg.accel_struct, "auto")
                           if args.config else "auto")
    if accel == "grid" and args.accel is None and on_card:
        # the reference ships accel_struct GRID (config.txt); the port has
        # no grid (ROADMAP slice I), and on the card a config's GRID takes
        # bvh4, as root render.py does on its accelerator (:99-110)
        print("config accel GRID is a CPU-era default; using bvh4 on the "
              "card (the port has no grid yet: ROADMAP slice I)",
              file=sys.stderr)
        accel = "bvh4"
    scene, camera, film = load_scene_file(scene_file, accel=accel,
                                          device=args.device)
    if args.size:
        w, _, h = args.size.lower().partition("x")
        film = Film(fov=film.fov, width=int(w), height=int(h or w))
    if args.thin_lens:
        camera = dataclasses.replace(camera, camera_type=THINLENS)
    trace_type = (cfg.trace_type if cfg.trace_type in
                  ("PATHTRACE", "WHITTED", "RAYCAST") else "PATHTRACE")
    rc = RenderConfig(
        num_samples=(args.spp if args.spp is not None
                     else max(cfg.num_samples, 1) if args.config else 16),
        max_depth=(args.depth if args.depth is not None
                   else max(cfg.max_depth, 1) if args.config else 5),
        seed=0 if args.seed is None else args.seed,
        tile_pixels=args.tile, spp_batch=max(0, args.spp_batch),
        estimator=args.estimator, trace_type=trace_type)
    if args.sampler and args.sampler != "rng":
        from craytracer_tpu_torch.sampling.tables import make_sample_table

        rc.sampler = make_sample_table(args.sampler, rc.num_samples,
                                       max(cfg.num_sample_sets, 1),
                                       seed=rc.seed, device=scene.device)
        print(f"sampler={args.sampler} ({rc.num_samples} samples x "
              f"{max(cfg.num_sample_sets, 1)} sets)")
    r = None
    if args.state and os.path.exists(
            args.state if args.state.endswith(".npz") else
            args.state + ".npz"):
        accum, spp_done, seed = load_image_state(args.state)
        # resume with the checkpoint's seed: another stream into the same
        # accumulator would break the bit-equal resume (render.py:158-175)
        if args.seed is not None and args.seed != seed:
            print(f"error: --seed {args.seed} differs from the checkpoint's "
                  f"seed {seed}; resume must continue the same stream",
                  file=sys.stderr)
            return 1
        rc = dataclasses.replace(rc, seed=seed)
        r = Renderer(scene, camera, film, rc)
        r.resume_from(accum, spp_done)
        print(f"resumed from {args.state}: {spp_done} spp done (seed {seed})")
    else:
        r = Renderer(scene, camera, film, rc)

    t0 = time.perf_counter()
    img = r.render()
    if on_card:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    if args.stats:
        from craytracer_tpu_torch.integrator.wavefront import camera_rays
        from craytracer_tpu_torch.sampling.rng import uniforms
        from craytracer_tpu_torch.utils.stats import (format_stats,
                                                      intersect_stats)

        ids = torch.arange(film.num_pixels, dtype=torch.int32,
                           device=scene.device)
        jit0 = uniforms(rc.seed, ids, torch.zeros_like(ids), 0, 2, 0)
        o0, d0 = camera_rays(camera, film, ids, rc.seed, 0, jit0)
        print(format_stats(intersect_stats(scene, o0, d0)))
    if args.probe:
        x, y = (int(v) for v in args.probe.split(","))
        acc = r.accum[y * film.width + x].cpu().numpy()
        mean = acc / max(r.spp_done, 1)
        print(f"probe ({x},{y}): accum={acc.tolist()} mean={mean.tolist()} "
              f"spp={r.spp_done}")
    stem = os.path.splitext(args.output)[0]
    if args.aov:
        from craytracer_tpu_torch.integrator.aov import AOV_NAMES, render_aovs
        from craytracer_tpu_torch.io.exr import write_exr

        aovs = render_aovs(scene, camera, film)
        for name in args.aov.split(","):
            if name not in AOV_NAMES:
                print(f"unknown AOV {name!r} (have {AOV_NAMES})",
                      file=sys.stderr)
                continue
            path = f"{stem}_{name}.exr"
            write_exr(path, aovs[name].cpu().numpy().reshape(
                film.height, film.width, 3))
            print(f"wrote {path}")
    if args.output.lower().endswith(".exr"):
        from craytracer_tpu_torch.io.exr import write_exr

        # the linear radiance mean, no tone map
        write_exr(args.output, r.accum.cpu().numpy().reshape(
            film.height, film.width, 3) / max(r.spp_done, 1))
    else:
        write_ppm(args.output, img)
    save_image_state(stem + "_state", r.accum, r.spp_done, rc.seed)
    launches = {"K1": pass_kernel.KERNEL, "K2": shade_kernel.KERNEL,
                "K3": bvh4_kernel.CLOSEST, "K4": bvh4_kernel.ANY,
                "K1 rays": pass_kernel.RAYS_KERNEL}
    ks = ", ".join(f"{k} {c.launches}" for k, c in launches.items())
    route = production_fast_shade(scene, camera, film, args.estimator,
                                  rc.max_depth, rc.trace_type)
    print(f"{film.width}x{film.height} {rc.num_samples} spp depth "
          f"{rc.max_depth} on {scene.device}, route {route}, trace "
          f"{rc.trace_type}, spp batch {r.spp_batch}: {dt:.3f} s, "
          f"{r.passes} passes, launches {ks}, {r.nan_count} NaN samples -> "
          f"{args.output} (state {stem}_state.npz, {r.spp_done} spp)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
