"""Command line: render a reference-grammar scene file to a PPM (the
port's counterpart of the repo-root render.py, for the slices' options).

    python -m craytracer_tpu_torch scenes/parity_mesh_mid.txt \\
        --spp 64 --depth 5 --size 512 --seed 0 --estimator reference \\
        -o mesh.ppm

It runs on the CUDA card, and raises when there is none, unless asked for
the CPU (--device cpu). On the card every pass runs through the route the
gate picks (integrator/gate.py): K1 for scenes of at most 64 rows of
spheres, planes, rects, disks, flat triangles and boxes, such as
parity_cornell and parity_mix; K3 -> K2 -> K4 per bounce for meshes; K2
per bounce for scenes with a torus or a cylinder, such as parity_prims;
the general torch-op step per bounce, with K3 and K4 for a mesh, for
scenes no kernel shades, such as materials_scene (a constant env light),
parity_textured and fullscene (textures, normal maps, a texture env
light, mesh lights, MTL materials) or one with disk, point or
directional lights. `--estimator mis` takes the general step on every
scene (K3 and K4 for a mesh). On the CPU the plain PyTorch versions run
instead. `--thin-lens` swaps the scene file's
pinhole for a thin-lens camera (make_camera's lens radius 0.2 and focal
length 3.0). Prints one summary line with the route and each kernel's
launches.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    from craytracer_tpu_torch.accel import bvh4_kernel
    import dataclasses

    from craytracer_tpu_torch.camera import THINLENS, Film
    from craytracer_tpu_torch.integrator import pass_kernel, shade_kernel
    from craytracer_tpu_torch.integrator.gate import production_fast_shade
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
                    choices=("reference", "physical", "mis"))
    ap.add_argument("--spp-batch", type=int, default=1)
    ap.add_argument("--thin-lens", action="store_true",
                    help="render through a thin lens (depth of field): "
                    "lens radius 0.2, in focus at 3.0, the camera's defaults")
    ap.add_argument("-o", "--output", default="out_torch.ppm")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    scene, camera, film = load_scene_file(args.scene, device=args.device)
    if args.size:
        film = Film(fov=film.fov, width=args.size, height=args.size)
    if args.thin_lens:
        camera = dataclasses.replace(camera, camera_type=THINLENS)
    r = Renderer(scene, camera, film,
                 RenderConfig(num_samples=args.spp, max_depth=args.depth,
                              seed=args.seed, spp_batch=args.spp_batch,
                              estimator=args.estimator))
    t0 = time.perf_counter()
    img = r.render()
    dt = time.perf_counter() - t0
    write_ppm(args.output, img)
    launches = {"K1": pass_kernel.KERNEL, "K2": shade_kernel.KERNEL,
                "K3": bvh4_kernel.CLOSEST, "K4": bvh4_kernel.ANY}
    ks = ", ".join(f"{k} {c.launches}" for k, c in launches.items())
    route = production_fast_shade(scene, camera, film, args.estimator,
                                  args.depth)
    print(f"{film.width}x{film.height} {args.spp} spp depth {args.depth} on "
          f"{scene.device}, route {route}: {dt:.3f} s, {r.passes} passes, "
          f"launches {ks}, "
          f"{r.nan_count} NaN samples -> {args.output}")


if __name__ == "__main__":
    main()
