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
import subprocess
import sys

_SCENES = ("scenes/parity_mesh_mid.txt", "scenes/parity_prims.txt")


def _one(root: str, scenes, size: int, passes: int) -> dict:
    """Time render_sample on each scene with the package under `root`."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    import craytracer_tpu_torch
    from craytracer_tpu_torch.camera import Film
    from craytracer_tpu_torch.integrator import wavefront as wf
    from craytracer_tpu_torch.integrator.render import RenderConfig, Renderer
    from craytracer_tpu_torch.io.scenefile import load_scene_file

    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(craytracer_tpu_torch.__file__)))
    if pkg_root != root:
        raise RuntimeError(f"imported the package from {pkg_root}, not {root}")
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


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else "unknown card"


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
    results = []
    for root in map(os.path.abspath, args.roots):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root,
             "--size", str(args.size), "--passes", str(args.passes),
             "--scenes", *args.scenes], capture_output=True, text=True,
            cwd=root, timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            print(f"FAIL: {root} exited {proc.returncode}")
            return 1
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    card = _card()
    print(card)
    first = os.path.abspath(args.roots[0])
    for path in args.scenes:
        by_root = {}
        for r in results:
            by_root.setdefault(r["root"], []).append(r[path]["ms_per_pass"])
        means = {k: statistics.mean(v) for k, v in by_root.items()}
        print(f"[ab] {card}, {path} {args.size}x{args.size} depth 5, "
              f"{args.passes} passes per run, median of 5, ms/pass in run "
              f"order: " + ", ".join(
                  f"{os.path.basename(r['root']) or r['root']} "
                  f"{r[path]['ms_per_pass']:.4f}" for r in results)
              + "; each other root's mean / the first root's: "
              + ", ".join(f"{os.path.basename(k)} "
                          f"{means[k] / means[first]:.4f}"
                          for k in means if k != first), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "runs": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
