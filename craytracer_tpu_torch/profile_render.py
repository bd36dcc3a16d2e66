"""Where the time of a Renderer run goes on the card: a torch.profiler
pass over the port's Renderer.

    python -m craytracer_tpu_torch.profile_render [--scene FILE]
        [--size 512] [--spp 64] [--depth 5] [--spp-batch 1 16]
        [--out FILE.json]

For each spp batch it warms up with one full render (which also builds
the kernels), then profiles one more render of the same size and prints
its wall time, the device's busy time (the union of every device-side
event: kernels, copies and fills), each of the port's kernels' (K1-K4)
device time and launch count, and the device idle share 1 - busy / wall.
The profiler's own overhead is inside the wall time, so the idle share
it reports is an upper bound for an unprofiled run. The default scene is
scenes/parity_cornell.txt (K1); scenes/parity_mesh_mid.txt takes the
per-bounce K3 -> K2 -> K4 route. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

_SCENE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes", "parity_cornell.txt")
# the port's kernels by a piece of their (mangled) device function names
KERNELS = {"k1_pass": "k1_pass_kernel", "k2_shade": "k2_shade_kernel",
           "k3_bvh4_closest": "k3_closest_kernel",
           "k4_bvh4_any": "k4_any_kernel"}


def _busy_us(spans) -> float:
    """Length of the union of (start, end) intervals, in microseconds."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_render(scene, camera, film, spp: int, depth: int,
                   spp_batch: int) -> dict:
    """Profile one Renderer run (after a warm-up run) and return its
    breakdown: wall_ms, device_ms, per-kernel (ms, launches), passes,
    idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from craytracer_tpu_torch.integrator.render import RenderConfig, Renderer

    cfg = RenderConfig(num_samples=spp, max_depth=depth, spp_batch=spp_batch)
    Renderer(scene, camera, film, cfg).render()
    torch.cuda.synchronize()
    r = Renderer(scene, camera, film, cfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, fills): the CPU ops'
    # device times would count the same kernels again
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    device_ms = _busy_us((e.time_range.start, e.time_range.end)
                         for e in on_dev) / 1e3
    by_name: dict = {}
    for e in on_dev:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    kernels = {}
    for name, part in KERNELS.items():
        hits = [v for k, v in by_name.items() if part in k]
        kernels[name] = (sum(us for us, _ in hits) / 1e3,
                         sum(n for _, n in hits))
    return {"spp_batch": spp_batch, "passes": r.passes, "kernels": kernels,
            "wall_ms": wall_ms, "device_ms": device_ms,
            "idle": (1.0 - device_ms / wall_ms) if on_dev else None,
            "top_device": [(k, us / 1e3, n) for k, (us, n) in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])[:6]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m craytracer_tpu_torch.profile_render")
    ap.add_argument("--scene", default=_SCENE)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--spp-batch", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_render needs a CUDA card", file=sys.stderr)
        return 1

    from craytracer_tpu_torch.camera import Film
    from craytracer_tpu_torch.io.scenefile import load_scene_file

    scene, camera, film = load_scene_file(args.scene, device="cuda")
    film = Film(fov=film.fov, width=args.size, height=args.size)
    results = []
    for b in args.spp_batch:
        res = profile_render(scene, camera, film, args.spp, args.depth, b)
        results.append(res)
        idle = "not measured" if res["idle"] is None else f"{res['idle']:.4f}"
        ks = ", ".join(f"{k} {ms:.3f} ms over {n} launches"
                       for k, (ms, n) in res["kernels"].items() if n)
        print(f"[profile] {os.path.basename(args.scene)} {args.size}x"
              f"{args.size} {args.spp} spp depth {args.depth} spp_batch {b}: "
              f"{res['passes']} passes, wall {res['wall_ms']:.3f} ms, device "
              f"{res['device_ms']:.3f} ms ({ks}), idle share {idle}",
              flush=True)
        for key, ms, count in res["top_device"]:
            print(f"[profile]   {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    out = {"device": torch.cuda.get_device_name(0), "scene": args.scene,
           "size": args.size,
           "spp": args.spp, "depth": args.depth, "runs": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
