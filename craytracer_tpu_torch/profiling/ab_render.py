"""Same-call A/B of render_sample between checkouts of the port.

    python -m craytracer_tpu_torch.profiling.ab_render ROOT [ROOT ...]
        [--scenes scenes/parity_mesh_mid.txt scenes/parity_prims.txt]
        [--size 512] [--passes 16] [--out FILE.json]

Each ROOT is a directory holding a `craytracer_tpu_torch/` package and
its `scenes/` and `native/` (an older checkout unpacked with `git
archive`, or `.` for this one). The roots are timed one after another,
each in a fresh process that imports the package from its root, so give
them in an interleaved order (parent, change, change, parent) to see the
machine's drift. A process loads each scene on the card, warms up with
one run (which builds the kernels), then times `passes` render_sample
calls at size x size, depth 5, one spp per pass in the Renderer's Morton
order, between CUDA events, median of 5: as `chip_smoke.py` times
parity_mesh_mid and parity_prims. It uses only API the port has had
since it rendered meshes (load_scene_file, Film, Renderer.pixel_order,
render_sample). Prints one JSON line per process, the card's name and
power limit, and per scene each root's ms/pass and the ratio of the
later roots' mean to the first root's. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

if __package__:
    from craytracer_tpu_torch.profiling import ab_roots
else:  # a child process, started by file path: a sibling import
    import ab_roots

_SCENES = ("scenes/parity_mesh_mid.txt", "scenes/parity_prims.txt")


def _one(root: str, scenes, size: int, passes: int) -> dict:
    """Time render_sample on each scene with the package under `root`."""
    root = ab_roots.import_root(root)
    import torch

    from craytracer_tpu_torch.camera import Film
    from craytracer_tpu_torch.integrator import wavefront as wf
    from craytracer_tpu_torch.integrator.render import RenderConfig, Renderer
    from craytracer_tpu_torch.io.scenefile import load_scene_file

    dev = torch.device("cuda")
    cfg = RenderConfig(num_samples=64, max_depth=5)
    out = {"root": root}
    for path in scenes:
        scn, cam, f0 = load_scene_file(os.path.join(root, path), device=dev)
        film = Film(fov=f0.fov, width=size, height=size)
        pix = torch.from_numpy(
            Renderer(scn, cam, film, cfg).pixel_order()).to(dev)

        def run():
            for s in range(passes):
                wf.render_sample(scn, cam, film, pix, cfg.seed, 3000 + s, 5)

        run()
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            stop.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(stop))
        out[path] = {"ms_per_pass": statistics.median(ts) / passes,
                     "runs_ms": ts}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--scenes", nargs="+", default=list(_SCENES))
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--passes", type=int, default=16)
    ap.add_argument("--out")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(_one(args.one, args.scenes, args.size,
                              args.passes)), flush=True)
        return 0
    if not args.roots:
        ap.error("give at least one ROOT")
    results = ab_roots.run_roots(__file__, args.roots, (
        "--size", str(args.size), "--passes", str(args.passes), "--scenes",
        *args.scenes))
    if results is None:
        return 1
    card = ab_roots.card()
    print(card)
    ab_roots.report("ab", card, results, [
        (f"{path} {args.size}x{args.size} depth 5, {args.passes} passes per "
         f"run, median of 5, ms/pass", lambda r, p=path: r[p]["ms_per_pass"],
         None) for path in args.scenes])
    ab_roots.write_out(args.out, card, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
