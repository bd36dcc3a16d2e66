"""Same-call A/B of bare K3, K3 `_init`, K4 and K5 between checkouts of the
port.

    python -m craytracer_tpu_torch.profiling.ab_bvh4 ROOT [ROOT ...]
        [--out FILE.json]

Each ROOT is a directory holding a `craytracer_tpu_torch/` package, its
`scenes/` and `native/` (an older checkout unpacked with `git archive`,
or `.` for this one). First a fresh process of this checkout makes the
inputs once, with the plain versions, and saves them under
craytracer_tpu_torch/_build/:

- parity_mesh_mid (20,480 triangles), one plain 512x512 depth-5 pass:
  the six bounces' rays for K3 and shadow rays with their max_dist for
  K4, ray_key-sorted as the route hands them over;
- the city of bench_mesh.py (327,680 triangles) at 256x256: the camera
  and bounce-1 rays for K3, ray_key-sorted;
- the 7M city (6,999,040 triangles, 17 parts) at
  512x512: the camera and bounce-1 rays in the route's order (ray_key
  sort, then the part sort) with, per part, the best hit the parts
  before it carry in, for K3 `_init` and K5 (each table's topology made
  before the timing); the same rays ray_key-sorted for K3 and K5 on the
  whole 1.05 GB table; the bounce-0 and bounce-1 shadow rays with, per
  part, the max_dist the route carries in (0 on lanes an earlier part
  occluded), for K4.

Then each root, one after another, runs in a fresh process that imports
the package from its root, builds its own kernels and launches them
through the wrappers (`bvh4_closest_hit_kernel`,
`bvh4_closest_hit_init_kernel`, `bvh4_any_hit_kernel`,
`bvh4_closest_hit_split_kernel`, whose signatures every checkout of the
port shares) on those inputs: one launch per case hashed (t and the
triangle ids), then each group of launches timed with CUDA events after
a warm-up, median of 5 runs. A run starts behind a
device-side sleep long enough for the host to enqueue the whole group,
so the events time the kernels and not the wrappers' host work. Give
the roots interleaved (parent, change, change, parent) to see the
machine's drift. Prints one JSON line per process, the card's name and
power limit, and per group each root's ms per launch and the later
roots' mean over the first root's, and whether every root's outputs are
bit-equal. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

if __package__:
    from craytracer_tpu_torch.profiling import ab_roots
else:  # a child process, started by file path: a sibling import
    import ab_roots

SEED, SPP = 0, 0
MESH_SIZE, CITY_SIZE, BIG_SIZE = 512, 256, 512
CITY_TRIS, BIG_TRIS = 327_680, 7_000_000
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's clock


def _inputs_path(root: str) -> str:
    return os.path.join(root, "craytracer_tpu_torch", "_build",
                        "ab_bvh4_inputs.pt")


def _prepare(path: str) -> None:
    """Make the inputs with this checkout's package and plain versions."""
    import torch

    from craytracer_tpu_torch.accel import bvh4_parts
    from craytracer_tpu_torch.accel.bvh4 import (bvh4_any_hit,
                                                 bvh4_closest_hit_init)
    from craytracer_tpu_torch.camera import Film, generate_rays
    from craytracer_tpu_torch.constants import TMAX
    from craytracer_tpu_torch.integrator import shade_kernel as sk
    from craytracer_tpu_torch.integrator import wavefront as wf
    from craytracer_tpu_torch.integrator.render import RenderConfig, Renderer
    from craytracer_tpu_torch.io.scenefile import load_scene_file
    from craytracer_tpu_torch.ops.intersect import intersect_scene
    from craytracer_tpu_torch.ops.raysort import ray_key
    from craytracer_tpu_torch.sampling.multijitter import stratified_jitter
    from craytracer_tpu_torch.scene.city import city_builder, city_view

    dev = torch.device("cuda")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = RenderConfig(num_samples=1, max_depth=5, estimator="reference")

    def table(bvh):
        return {"fat": bvh.fat.cpu(), "n_tris": bvh.n_tris,
                "leaf_size": bvh.leaf_size, "stack_size": bvh.stack_size}

    def sort(*xs):
        perm = torch.argsort(ray_key(xs[0], xs[1]), stable=True)
        return [x[perm].contiguous() for x in xs]

    def cpu(xs):
        return [x.cpu() for x in xs]

    def camera(scn, c, f0, size):
        film = Film(fov=f0.fov, width=size, height=size)
        ids = torch.from_numpy(Renderer(scn, c, film, cfg).pixel_order()
                               ).to(dev)
        spp = torch.full_like(ids, SPP)
        o, d = generate_rays(c, film, ids, stratified_jitter(SEED, ids, spp))
        return ids, spp, o, d

    def bounces(scn, ids, spp, o, d, depth, n):
        """(rays, shadow rays and their max_dist) of the first n bounces of
        one plain pass to `depth`."""
        state = wf._init_state(o, d, depth, ids)
        out = []
        for b in range(n):
            hit = intersect_scene(scn, state[0], state[1])
            sh = sk.fused_shade_reference(scn, state[1], hit, state[2],
                                          state[5], state[6], state[10], spp,
                                          SEED, b, depth)
            out.append((state[0], state[1], sh["shadow_o"], sh["shadow_d"],
                        sh["dist_adj_t"]))
            state = wf._bounce_step(scn, SEED, spp, depth, b, state,
                                    kernels=False)
        return out

    data = {"tables": {}, "groups": []}
    mesh, mcam, mf0 = load_scene_file(
        os.path.join(root, "scenes", "parity_mesh_mid.txt"), device=dev)
    data["tables"]["mesh_mid"] = table(mesh.tri_bvh)
    recs = bounces(mesh, *camera(mesh, mcam, mf0, MESH_SIZE), 5, 6)
    data["groups"].append({
        "name": "mesh_mid K3, 6 bounces", "kind": "k3",
        "launches": [("mesh_mid", cpu(sort(o, d))) for o, d, *_ in recs]})
    data["groups"].append({
        "name": "mesh_mid K4, 6 bounces", "kind": "k4",
        "launches": [("mesh_mid", cpu(sort(so, sd, md)))
                     for *_, so, sd, md in recs]})
    del mesh, recs

    city = city_builder(CITY_TRIS).build(device=dev)
    ccam, cfilm = city_view(city.triangles.mat_id.shape[0], CITY_SIZE,
                            device=dev)
    data["tables"]["city_327k"] = table(city.tri_bvh)
    recs = bounces(city, *camera(city, ccam, cfilm, CITY_SIZE), 4, 2)
    for b, (o, d, *_) in enumerate(recs):
        data["groups"].append({
            "name": f"city_327k K3, {('camera', 'bounce-1')[b]} rays",
            "kind": "k3", "launches": [("city_327k", cpu(sort(o, d)))]})
    del city, recs

    big = city_builder(BIG_TRIS).build(device=dev)
    parts = big.tri_parts
    for k, p in enumerate(parts):
        data["tables"][f"city_7m part {k}"] = table(p)
    data["tables"]["city_7m"] = table(big.tri_bvh)
    bcam, bfilm = city_view(big.triangles.mat_id.shape[0], BIG_SIZE,
                            device=dev)
    recs = bounces(big, *camera(big, bcam, bfilm, BIG_SIZE), 5, 2)
    for b, (o, d, so, sd, smd) in enumerate(recs):
        rays_of = ("camera", "bounce-1")[b]
        o, d = sort(o, d)
        whole = [("city_7m", cpu([o, d]))]
        for kind in ("k3", "k5"):
            data["groups"].append({
                "name": f"city_7m {kind.upper()} whole table, {rays_of} "
                        f"rays", "kind": kind, "launches": whole})
        perm = bvh4_parts.part_sort(parts, o, d)[1]
        o, d = o[perm].contiguous(), d[perm].contiguous()
        t = torch.full((o.shape[0],), TMAX, device=dev)
        tri = torch.full((o.shape[0],), -1, dtype=torch.int32, device=dev)
        rays, launches = cpu([o, d]), []  # the rays saved once
        for k, p in enumerate(parts):
            launches.append((f"city_7m part {k}", rays + cpu([t, tri])))
            t, tri = bvh4_closest_hit_init(p, o, d, t, tri)
        data["groups"].append({
            "name": f"city_7m K3 _init per part, {rays_of} rays",
            "kind": "k3_init", "launches": launches})
        data["groups"].append({  # the same launches, the tensors saved once
            "name": f"city_7m K5 per part, {rays_of} rays",
            "kind": "k5", "launches": launches})
        so, sd, smd = sort(so, sd, smd)
        best = torch.full_like(smd, TMAX)
        md, rays, launches = smd, cpu([so, sd]), []
        for k, p in enumerate(parts):
            launches.append((f"city_7m part {k}", rays + cpu([md])))
            best = torch.minimum(best, bvh4_any_hit(p, so, sd, md))
            md = torch.where(best < smd, 0.0, smd)
        data["groups"].append({
            "name": f"city_7m K4 per part, bounce-{b} shadow rays",
            "kind": "k4", "launches": launches})
    del big, parts, recs
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(data, path)


def _one(root: str, path: str) -> dict:
    """Hash and time every group with the package under `root`."""
    root = ab_roots.import_root(root)
    import torch

    from craytracer_tpu_torch.accel import bvh4_kernel as bk
    from craytracer_tpu_torch.accel import bvh4_split_kernel as sp
    from craytracer_tpu_torch.scene.types import BVH4Arrays

    dev = torch.device("cuda")
    bk.LIBRARY.load()
    out = {"root": root, "ptxas": [
        line.strip() for line in bk.LIBRARY.ptxas_log.splitlines()
        if "registers" in line or "spill" in line or "stack frame" in line]}
    data = torch.load(path)
    tables = {k: BVH4Arrays(fat=v["fat"].to(dev), n_tris=v["n_tris"],
                            leaf_size=v["leaf_size"],
                            stack_size=v["stack_size"])
              for k, v in data["tables"].items()}
    topos = {}  # K5's topology tables, made before the timing

    def k5(bvh, o, d, t0=None, tri0=None):
        return sp.bvh4_closest_hit_split_kernel(bvh, o, d, t0, tri0,
                                                topo=topos[id(bvh)])

    fns = {"k3": bk.bvh4_closest_hit_kernel,
           "k3_init": bk.bvh4_closest_hit_init_kernel,
           "k4": bk.bvh4_any_hit_kernel, "k5": k5}
    on_card = {}  # a tensor the inputs share (a part chain's rays) copied once

    def card(x):
        if id(x) not in on_card:
            on_card[id(x)] = x.to(dev)
        return on_card[id(x)]

    for g in data["groups"]:
        fn = fns[g["kind"]]
        calls = [(tables[name], [card(x) for x in xs])
                 for name, xs in g["launches"]]
        if g["kind"] == "k5":
            sp.LIBRARY.load()
            topos.update((id(b), sp.split_topology(b)) for b, _ in calls)
        h = hashlib.sha256()
        for bvh, xs in calls:
            res = fn(bvh, *xs)
            for r in (res if isinstance(res, tuple) else (res,)):
                h.update(r.cpu().numpy().tobytes())

        def run():
            for bvh, xs in calls:
                fn(bvh, *xs)

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
        out[g["name"]] = {"hash": h.hexdigest()[:16],
                          "ms_per_launch": statistics.median(ts) / len(calls),
                          "launches": len(calls), "runs_ms": ts}
        del calls
    topos.clear()
    on_card.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--out")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--prepare", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--inputs", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.prepare:
        _prepare(args.inputs)
        return 0
    if args.one:
        print(json.dumps(_one(args.one, args.inputs)), flush=True)
        return 0
    if not args.roots:
        ap.error("give at least one ROOT")
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = _inputs_path(here)
    proc = subprocess.run(
        [sys.executable, "-m", "craytracer_tpu_torch.profiling.ab_bvh4",
         "--prepare", "--inputs", path],
        capture_output=True, text=True, cwd=here, timeout=1800)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        print(f"FAIL: making the inputs exited {proc.returncode}")
        return 1
    results = ab_roots.run_roots(__file__, args.roots,
                                 ("--inputs", path), timeout=1800)
    if results is None:
        return 1
    card = ab_roots.card()
    print(card)
    same = ab_roots.report("ab-bvh4", card, results, [
        (f"{name}, {results[0][name]['launches']} launches per run, median "
         f"of 5, ms per launch", lambda r, n=name: r[n]["ms_per_launch"],
         lambda r, n=name: r[n]["hash"])
        for name in results[0] if name not in ("root", "ptxas")])
    print(f"[ab-bvh4] every root's outputs bit-equal in every group: {same}")
    ab_roots.write_out(args.out, card, results)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
