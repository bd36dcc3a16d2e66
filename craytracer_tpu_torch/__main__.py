"""Command line: render a reference-grammar scene file to a PPM (the
port's counterpart of the repo-root render.py, for the slice's options).

    python -m craytracer_tpu_torch scenes/parity_cornell.txt \\
        --spp 64 --depth 5 --size 512 --seed 0 --estimator reference \\
        -o cornell.ppm --device cuda

On a CUDA device every pass runs through the K1 kernel; on the CPU the
plain PyTorch version runs instead. Prints one summary line.
"""

from __future__ import annotations

import argparse
import time

import torch


def main(argv=None):
    from craytracer_tpu_torch.camera import Film
    from craytracer_tpu_torch.integrator.pass_kernel import KERNEL
    from craytracer_tpu_torch.integrator.render import RenderConfig, Renderer
    from craytracer_tpu_torch.io.image import write_ppm
    from craytracer_tpu_torch.io.scenefile import load_scene_file

    ap = argparse.ArgumentParser(prog="python -m craytracer_tpu_torch")
    ap.add_argument("scene", help="reference-grammar scene file")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--size", type=int, default=0,
                    help="square image size (0 = the scene file's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--estimator", default="reference",
                    choices=("reference", "physical"))
    ap.add_argument("--spp-batch", type=int, default=1)
    ap.add_argument("-o", "--output", default="out_torch.ppm")
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: cuda when available)")
    args = ap.parse_args(argv)

    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    scene, camera, film = load_scene_file(args.scene, device=device)
    if args.size:
        film = Film(fov=film.fov, width=args.size, height=args.size)
    r = Renderer(scene, camera, film,
                 RenderConfig(num_samples=args.spp, max_depth=args.depth,
                              seed=args.seed, spp_batch=args.spp_batch,
                              estimator=args.estimator))
    t0 = time.perf_counter()
    img = r.render()
    dt = time.perf_counter() - t0
    write_ppm(args.output, img)
    print(f"{film.width}x{film.height} {args.spp} spp depth {args.depth} on "
          f"{device}: {dt:.3f} s, {r.passes} passes, {KERNEL.launches} K1 "
          f"launches, {r.nan_count} NaN samples -> {args.output}")


if __name__ == "__main__":
    main()
