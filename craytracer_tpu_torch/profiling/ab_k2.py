"""Same-call A/B of K2 between checkouts of the port.

    python -m craytracer_tpu_torch.profiling.ab_k2 ROOT [ROOT ...]
        [--size 512] [--out FILE.json]

Each ROOT is a directory holding a `craytracer_tpu_torch/` package, its
`scenes/` and `tests/torch_sphere_scenes.py` (an older checkout unpacked
with `git archive`, or `.` for this one). First a fresh process of this
checkout makes the inputs once with the plain versions and saves them
under craytracer_tpu_torch/_build/: the hit records of the six bounces
of one plain SIZE x SIZE depth-5 pass (Morton lanes, spp 0) on
parity_mesh_mid and the 10,000-sphere field (matte scenes: K2's mask-0
core), and on parity_mix and glass_spheres (K2 with lobes).

Then each root, one after another, runs in a fresh process that imports
the package from its root, builds its own K2 and calls the public
`fused_shade` (whose signature every checkout of the port shares) on
those records, with the scene built by its own package:

- one call per bounce hashed (every output), so the summary says whether
  every root computes the same function bit for bit;
- device time per call: runs of the six calls between CUDA events, each
  run behind a device-side sleep long enough for the host to enqueue it,
  after a warm-up, median of 5 (the wrapper's own launches included);
- bare K2 per launch: the mean of the K2 kernel's device events in a
  torch.profiler trace of 5 runs (taken again, up to three times, if it
  lost any launch), and the device events (kernels, copies, fills) per
  call;
- wall time per call: the host clock around 20 runs, synchronised;
- ptxas' register and spill lines of each K2 build.

Give the roots interleaved (parent, change, change, parent) to see the
machine's drift. Prints one JSON line per process, the card's name and
power limit, and per scene and metric each root's value and the later
roots' mean over the first root's. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

if __package__:
    from craytracer_tpu_torch.profiling import ab_roots
else:  # a child process, started by file path: a sibling import
    import ab_roots

SEED, DEPTH, FIELD_SPHERES = 0, 5, 10_000
SCENES = ("parity_mesh_mid", "sphere_field", "parity_mix", "glass_spheres")
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's clock
WALL_RUNS = 20
HIT_FIELDS = ("t", "point", "normal", "dpdu", "mat_id")
KEYS = ("L_add", "shadow_o", "shadow_d", "dist_adj", "dist_adj_t",
        "contrib_cand", "new_o", "new_d", "new_beta", "good_inc",
        "want_shadow", "new_alive", "new_prev_sg")


def _inputs_path(root: str) -> str:
    return os.path.join(root, "craytracer_tpu_torch", "_build",
                        "ab_k2_inputs.pt")


def _scene(root: str, name: str, size: int, dev):
    """(scene, camera, film) of `name`, built by the package under
    `root`."""
    import torch

    from craytracer_tpu_torch.camera import Film, make_camera
    from craytracer_tpu_torch.io.scenefile import load_scene_file
    from craytracer_tpu_torch.scene.build import SceneBuilder

    if name == "sphere_field":
        from craytracer_tpu_torch.scene.sphere_field import (
            sphere_field, sphere_field_view)

        return (sphere_field(FIELD_SPHERES, device=dev),
                *sphere_field_view(FIELD_SPHERES, size, device=dev))
    if name == "glass_spheres":
        sys.path.insert(0, os.path.join(root, "tests"))
        import torch_sphere_scenes

        b = SceneBuilder()
        eye, look, fov, _ = torch_sphere_scenes.glass_spheres(b)
        return (b.build(device=dev), make_camera(eye, look, device=dev),
                Film(fov=torch.tensor(fov, device=dev), width=size,
                     height=size))
    scn, cam, f0 = load_scene_file(
        os.path.join(root, "scenes", f"{name}.txt"), device=dev)
    return scn, cam, Film(fov=f0.fov, width=size, height=size)


def _prepare(path: str, size: int) -> None:
    """Make the hit records with this checkout's plain versions."""
    import torch

    from craytracer_tpu_torch.camera import generate_rays
    from craytracer_tpu_torch.integrator import wavefront as wf
    from craytracer_tpu_torch.integrator.render import RenderConfig, Renderer
    from craytracer_tpu_torch.ops.intersect import intersect_scene
    from craytracer_tpu_torch.sampling.multijitter import stratified_jitter

    dev = torch.device("cuda")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = RenderConfig(num_samples=1, max_depth=DEPTH, estimator="reference")
    data = {}
    for name in SCENES:
        scn, cam, film = _scene(root, name, size, dev)
        ids = torch.from_numpy(Renderer(scn, cam, film, cfg).pixel_order()
                               ).to(dev)
        spp = torch.zeros_like(ids)
        o, d = generate_rays(cam, film, ids, stratified_jitter(SEED, ids, spp))
        state = wf._init_state(o, d, DEPTH, ids)
        recs = []
        for b in range(DEPTH + 1):
            hit = intersect_scene(scn, state[0], state[1])
            recs.append({"d": state[1], "beta": state[2], "alive": state[5],
                         "prev_sg": state[6], "pix": state[10], "spp": spp,
                         **{f: getattr(hit, f) for f in HIT_FIELDS}})
            recs[-1] = {k: v.contiguous().cpu() for k, v in recs[-1].items()}
            state = wf._bounce_step(scn, SEED, spp, DEPTH, b, state,
                                    kernels=False)
        data[name] = recs
        del scn, state
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(data, path)


def _ptxas(sk) -> list:
    """Register and spill lines of every K2 build this process loaded."""
    libs = (sk.variants().values() if hasattr(sk, "variants")
            else [sk.LIBRARY])
    return [f"{lib.source.name} {getattr(lib, 'name', '')}: {line.strip()}"
            for lib in libs for line in lib.ptxas_log.splitlines()
            if "registers" in line or "spill" in line]


def _one(root: str, path: str, size: int) -> dict:
    """Hash and time K2 through `fused_shade` with the package under
    `root`."""
    root = ab_roots.import_root(root)
    from types import SimpleNamespace

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from craytracer_tpu_torch.integrator import shade_kernel as sk

    dev = torch.device("cuda")
    data = torch.load(path)
    out = {"root": root}
    scenes = {name: _scene(root, name, size, dev)[0] for name in SCENES}
    if hasattr(sk, "library"):  # one K2 build per feature mask
        from craytracer_tpu_torch.integrator.gate import shade_features

        libs = [sk.library(shade_features(s)) for s in scenes.values()]
    else:
        libs = [sk.LIBRARY]
    for lib in libs:  # every nvcc started at once
        lib.start()
    for name, scn in scenes.items():
        calls = []
        for b, r in enumerate(data[name]):
            r = {k: v.to(dev) for k, v in r.items()}
            hit = SimpleNamespace(**{f: r[f] for f in HIT_FIELDS})
            calls.append((scn, r["d"], hit, r["beta"], r["alive"],
                          r["prev_sg"], r["pix"], r["spp"], SEED, b, DEPTH))

        def run():
            return [sk.fused_shade(*a) for a in calls]

        h = hashlib.sha256()
        for res in run():
            for k in KEYS:
                h.update(res[k].contiguous().cpu().numpy().tobytes())
        run()
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            run()
            stop.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(stop))
        for _ in range(3):  # a trace that lost events is taken again
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    run()
                torch.cuda.synchronize()
            on_dev = [e for e in prof.events()
                      if e.device_type == DeviceType.CUDA]
            k2 = [e.time_range.elapsed_us() for e in on_dev
                  if "k2_shade_kernel" in e.name]
            if len(k2) == 5 * len(calls):
                break
        t0 = time.perf_counter()
        for _ in range(WALL_RUNS):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        n_calls = len(calls)
        out[name] = {
            "hash": h.hexdigest()[:16],
            "device_ms_per_call": statistics.median(ts) / n_calls,
            "runs_ms": ts,
            "k2_ms": sum(k2) / max(len(k2), 1) / 1e3,
            "k2_launches": len(k2),
            "device_events_per_call": len(on_dev) / (5 * n_calls),
            "wall_ms_per_call": wall / (WALL_RUNS * n_calls)}
    out["ptxas"] = _ptxas(sk)
    return out


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*", metavar="ROOT")
    ap.add_argument("--size", type=int, default=512,
                    help="film width and height (default 512)")
    ap.add_argument("--out")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--prepare", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.size <= 0:
        ap.error("--size must be positive")
    if args.prepare:
        _prepare(args.inputs, args.size)
        return 0
    if args.one:
        print(json.dumps(_one(args.one, args.inputs, args.size)), flush=True)
        return 0
    if not args.roots:
        ap.error("give at least one ROOT")
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = _inputs_path(here)
    proc = subprocess.run(
        [sys.executable, "-m", "craytracer_tpu_torch.profiling.ab_k2",
         "--prepare", "--inputs", path, "--size", str(args.size)],
        capture_output=True, text=True, cwd=here, timeout=1800)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        print(f"FAIL: making the inputs exited {proc.returncode}")
        return 1
    results = ab_roots.run_roots(__file__, args.roots,
                                 ("--inputs", path, "--size", str(args.size)),
                                 timeout=1800)
    if results is None:
        return 1
    card = ab_roots.card()
    print(card)
    for r in results:
        for line in r["ptxas"]:
            print(f"[ab-k2] {os.path.relpath(r['root'])} ptxas {line}")
    cases = []
    for name in SCENES:
        head = f"{name} {args.size}x{args.size}, 6 bounces"
        cases += [
            (f"{head}, fused_shade device ms per call (events, median of 5)",
             lambda r, n=name: r[n]["device_ms_per_call"],
             lambda r, n=name: r[n]["hash"]),
            (f"{head}, bare K2 ms per launch (profiler)",
             lambda r, n=name: r[n]["k2_ms"], None),
            (f"{head}, device events per fused_shade call",
             lambda r, n=name: r[n]["device_events_per_call"], None),
            (f"{head}, fused_shade wall ms per call",
             lambda r, n=name: r[n]["wall_ms_per_call"], None)]
    same = ab_roots.report("ab-k2", card, results, cases)
    print(f"[ab-k2] every root's outputs bit-equal on every scene: {same}")
    ab_roots.write_out(args.out, card, results)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
