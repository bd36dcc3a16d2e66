"""Start a world of ranks and run sharded cases in it; the multi-rank
dryrun (counterpart of __graft_entry__.py:59 `dryrun_multichip`).

    python -m craytracer_tpu_torch.parallel.dryrun [--ranks 4]
        [--device cpu] [--backend gloo] [--timeout 600]

runs, in `--ranks` processes: a ray-sharded forward pass and train step
on scenes/parity_cornell.txt (K1 on the card), a ray-sharded forward pass
of an icosphere mesh over bvh4 (K3 -> K2 -> K4 on the card) and, with 4
or more ranks and an even count, the geometry-sharded train step of that
mesh on a (ranks / 2, 2) mesh. It prints each case's loss or image mean
and exits 1 unless every one is finite. Ranks on one card share it over
gloo (NCCL refuses two ranks on one GPU); `--backend nccl` needs a card
per rank.

`launch(world, cases, ...)` is the launcher behind it, which the tests and
chip_smoke.py drive with their own cases: it writes the cases to a
temporary directory, starts `world` copies of this module as rank
processes (`--rank`), which meet through a file rendezvous there, run
every case (`run_case`) and pickle their results back; it waits for all
of them within one timeout, kills them all when it runs out, and raises
with a rank's stderr when one fails. The rank processes import torch,
numpy and the port only. They run on one thread each and load the kernel
libraries the parent built (`prebuild`): each process builds what it
finds missing, so building in the parent first saves every rank an nvcc
run. Launch counters are per process: each case's counts are read in the
rank and sent back.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from craytracer_tpu_torch.parallel.geom import (geom_sharded_render_pass,
                                                geom_sharded_train_step,
                                                shard_scene_geometry)
from craytracer_tpu_torch.parallel.overlap import bucketed_train_step
from craytracer_tpu_torch.parallel.sharded import (gather_rays,
                                                   make_geom_mesh,
                                                   ray_block,
                                                   sharded_render_pass,
                                                   sharded_train_step)
from craytracer_tpu_torch.scene import types as T

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CORNELL = os.path.join(REPO, "scenes", "parity_cornell.txt")


def counters() -> dict:
    """The launch counters of the kernels a sharded case can run."""
    from craytracer_tpu_torch.accel import bvh4_kernel as bk
    from craytracer_tpu_torch.integrator import pass_kernel as pk
    from craytracer_tpu_torch.integrator import shade_kernel as sk

    return {"k1_pass": pk.KERNEL, "k1_pass_rays": pk.RAYS_KERNEL,
            "k2_shade": sk.KERNEL, "k3_bvh4_closest": bk.CLOSEST,
            "k3_init_bvh4_closest": bk.CLOSEST_INIT, "k4_bvh4_any": bk.ANY}


def prebuild(scenes) -> None:
    """Build K1, K3/K3 `_init`/K4 and K2 for the feature mask of each of
    `scenes` in this process, before the ranks start."""
    from craytracer_tpu_torch import cuda_build
    from craytracer_tpu_torch.accel import bvh4_kernel as bk
    from craytracer_tpu_torch.integrator import pass_kernel as pk
    from craytracer_tpu_torch.integrator import shade_kernel as sk
    from craytracer_tpu_torch.integrator.gate import shade_features

    masks = sorted({shade_features(s) for s in scenes})
    cuda_build.build_all([pk.LIBRARY, bk.LIBRARY,
                          *(sk.library(m) for m in masks)])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev, fn):
    """(fn's result, its launch counts, its seconds), the counts set to 0
    just before and read just after."""
    cnt = counters()
    for c in cnt.values():
        c.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, {k: c.launches for k, c in cnt.items()}, \
        time.perf_counter() - t0


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    return x


def run_case(case: dict, device=None):
    """Run one case on this rank; every rank of the world must call it
    (its mesh's groups are made collectively). Returns None on a rank
    outside the case's mesh, else a dict of CPU results.

    A case: "kind" "render" or "train"; "mesh" (R, G); "scene" (a port
    scene, or a picklable callable that returns one, so a rank builds a
    large scene itself), "camera", "film" (port objects; a G > 1 mesh
    shards the scene's triangles with "accel", default "bvh4", and with
    "part_budget" in bytes cuts each bvh4 shard's table into parts under
    that budget in place of PART_BUDGET_BYTES); "depth"; "seed". A render
    case: "spp" (a list: one pass each), "estimator", "fast_shade"
    (default True), "kernels" (render_sample's; True takes the wrappers,
    on CPU tensors their plain versions, so a cut shard walks its parts),
    "compact_at" (R = 1 only: render_sample over the whole image with the
    compaction bounce forced), "first_hit" (also the reduced bounce-0 hit's
    group and prim ids of the first pass; with "part_budget", also this
    shard's own (t, prim) of those rays through its parts and through its
    uncut table). It returns the rank's triangle count, its table's part
    count and the seconds it took to make and place its scene, and per
    pass the image,
    good_paths, ray and shadow-ray counts of every pixel id, the launch
    counts and the seconds. A train case: "step" "sharded" or "bucketed"
    (G = 1), "spp", "target" [N, 3], "repeats"; it returns loss, grads
    (by float_leaves name), the launch counts and seconds of each step."""
    n_r, n_g = case["mesh"]
    mesh = make_geom_mesh(n_r, n_g, device)
    if mesh is None:
        return None
    dev = mesh.device
    t0 = time.perf_counter()
    scene, tri_base = case["scene"], 0
    if callable(scene):
        scene = scene()
    whole = scene
    if n_g > 1:
        with _part_budget(case.get("part_budget")):
            scene, tri_base = shard_scene_geometry(
                whole, n_g, mesh.geom.index, case.get("accel", "bvh4"))
    scene, camera, film = (T.to_device(x, dev) for x in (
        scene, case["camera"], case["film"]))
    ids = torch.arange(film.num_pixels, dtype=torch.int32, device=dev)
    depth, seed = case["depth"], case["seed"]
    _sync(dev)
    out = {"rank": dist.get_rank(), "tri_base": tri_base,
           "n_tris": scene.triangles.mat_id.shape[0],
           "parts": len(scene.tri_parts or ()),
           "scene_seconds": time.perf_counter() - t0, "passes": []}
    if case["kind"] == "render":
        kernels = case.get("kernels")
        kw = dict(estimator=case.get("estimator", "reference"),
                  fast_shade=case.get("fast_shade", True), with_metrics=True)
        if "compact_at" in case:
            from craytracer_tpu_torch.integrator.wavefront import (
                render_sample)

            if n_r != 1:
                raise ValueError("compact_at: a (1, G) mesh only")

            def one(spp):
                img, good, m = render_sample(
                    scene, camera, film, ids, seed, spp, depth,
                    kw["estimator"], general=not kw["fast_shade"],
                    kernels=kernels, compact_at=case["compact_at"],
                    geom_axis=mesh.geom,
                    tri_base=tri_base, with_metrics=True)
                return img, good, m["lane_rays"], m["lane_shadow_rays"]
        elif n_g > 1:
            render = geom_sharded_render_pass(mesh, depth, kernels=kernels,
                                              **kw)

            def one(spp):
                return render(scene, tri_base, camera, film, ids, seed, spp)
        else:
            render = sharded_render_pass(mesh, depth, **kw)

            def one(spp):
                return render(scene, camera, film, ids, seed, spp)
        with torch.no_grad():
            for spp in case["spp"]:
                res, counts, secs = _timed(dev, lambda: one(spp))
                out["passes"].append({
                    "spp": spp, "L": res[0], "good": res[1],
                    "lane_rays": res[2], "lane_shadow_rays": res[3],
                    "counts": counts, "seconds": secs})
            if case.get("first_hit"):
                on = dev.type == "cuda" if kernels is None else kernels
                out["first_hit"] = _first_hit(mesh, scene, camera, film,
                                              ids, seed, case["spp"][0],
                                              tri_base, on)
                if n_g > 1 and "part_budget" in case:
                    uncut, _ = shard_scene_geometry(
                        whole, n_g, mesh.geom.index, "bvh4")
                    out["shard_hit"] = [_shard_hit(
                        T.to_device(s, dev), mesh, camera, film, ids, seed,
                        case["spp"][0], on) for s in (scene, uncut)]
    else:
        target = case["target"].to(dev)
        if n_g > 1:
            step = geom_sharded_train_step(mesh, depth)
            args = (scene, tri_base)
        else:
            make = {"sharded": sharded_train_step,
                    "bucketed": bucketed_train_step}[case["step"]]
            step, args = make(mesh, depth), (scene,)
        for _ in range(case.get("repeats", 1)):
            (loss, grads), counts, secs = _timed(dev, lambda: step(
                *args, camera, film, ids, seed, case["spp"], target))
            out["passes"].append({"loss": float(loss), "grads": grads,
                                  "counts": counts, "seconds": secs})
    return _cpu(out)


def _camera_rays(mesh, camera, film, ids, seed, spp):
    from craytracer_tpu_torch.integrator.wavefront import (camera_rays,
                                                           film_jitter)

    block = ray_block(ids, mesh.rays)
    return camera_rays(camera, film, block, seed, spp,
                       film_jitter(seed, block, spp))


def _first_hit(mesh, scene, camera, film, ids, seed, spp, tri_base,
               kernels):
    """The bounce-0 hit's (group, prim) of every pixel id, the prims
    global: the camera rays of this rank's block through the search (K3
    with `kernels`) and, over a geometry axis, `reduce_hit`."""
    from craytracer_tpu_torch.integrator.wavefront import _closest_hit

    o, d = _camera_rays(mesh, camera, film, ids, seed, spp)
    hit = _closest_hit(scene, o, d, kernels, mesh.geom, tri_base)
    return gather_rays(torch.stack([hit.group, hit.prim], dim=1),
                       ids.shape[0], mesh.rays)


def _shard_hit(shard, mesh, camera, film, ids, seed, spp, kernels):
    """This shard's own closest triangle (t, shard-local id) of the
    camera rays of this rank's block, before any reduction."""
    from craytracer_tpu_torch.ops.intersect import _tri_closest

    o, d = _camera_rays(mesh, camera, film, ids, seed, spp)
    return _tri_closest(shard, o, d, kernels)


@contextlib.contextmanager
def _part_budget(budget):
    """bvh4_parts.PART_BUDGET_BYTES set to `budget` inside the block (left
    as it is for None)."""
    from craytracer_tpu_torch.accel import bvh4_parts

    old = bvh4_parts.PART_BUDGET_BYTES
    if budget is not None:
        bvh4_parts.PART_BUDGET_BYTES = int(budget)
    try:
        yield
    finally:
        bvh4_parts.PART_BUDGET_BYTES = old


def launch(world: int, cases, backend: str = "gloo", device=None,
           timeout: float = 300.0):
    """Run `cases` in a new world of `world` rank processes (module
    docstring): returns (results, setup) where results[rank][case] is
    run_case's dict or None, and setup[rank] the seconds from the launch
    until the rank's process group was up. `device` None
    puts each rank on the card (rank % cards)."""
    tmp = tempfile.mkdtemp(prefix="cray_ranks_")
    procs, logs = [], []
    try:
        with open(os.path.join(tmp, "cases.pkl"), "wb") as f:
            pickle.dump(cases, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
        for r in range(world):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __spec__.name, "--rank", str(r),
                 "--world", str(world), "--dir", tmp, "--backend", backend,
                 "--device", device or "", "--timeout", str(timeout),
                 "--t0", repr(time.time())],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
        for r, p in enumerate(procs):
            if p.returncode != 0:
                logs[r].seek(0)
                tail = logs[r].read()[-4000:]
                raise RuntimeError(
                    f"rank {r} of {world} " + ("did not finish within "
                    f"{timeout} s" if p.returncode is None else
                    f"exited {p.returncode}") + f":\n{tail}")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return ([x["cases"] for x in results],
                [x["setup_seconds"] for x in results])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(args) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        args.backend, init_method=f"file://{os.path.join(args.dir, 'rdv')}",
        world_size=args.world, rank=args.rank,
        timeout=datetime.timedelta(seconds=args.timeout))
    setup = time.time() - args.t0
    try:
        with open(os.path.join(args.dir, "cases.pkl"), "rb") as f:
            cases = pickle.load(f)
        results = [run_case(case, args.device or None) for case in cases]
        with open(os.path.join(args.dir, f"rank{args.rank}.pkl"),
                  "wb") as f:
            pickle.dump({"cases": results, "setup_seconds": setup}, f)
    finally:
        dist.destroy_process_group()


def dryrun_cases(n: int) -> list:
    """The dryrun's cases for `n` ranks: __graft_entry__.py's shapes (8 x
    (8 n) pixels for Cornell, 8 x (8 n / 2) for the mesh; depth 2)."""
    from craytracer_tpu_torch.camera import Film, make_camera
    from craytracer_tpu_torch.io.scenefile import load_scene_file
    from craytracer_tpu_torch.scene.build import SceneBuilder
    from craytracer_tpu_torch.scene.city import icosphere

    scene, cam, film = load_scene_file(CORNELL, device="cpu")
    film = dataclasses.replace(film, width=8 * n, height=8)
    cornell = dict(scene=scene, camera=cam, film=film, depth=2, seed=0,
                   spp=0, mesh=(n, 1))
    b = SceneBuilder()
    b.add_matte("w", (0.7, 0.7, 0.7))
    b.add_emissive("l", (1, 1, 1), 30.0)
    b.add_rect((-20, 0, -20), (40, 0, 0), (0, 0, 40), "w")
    b.add_rect((-2, 12, -2), (4, 0, 0), (0, 0, 4), "l")
    v, f = icosphere(2)
    up = np.array([0.0, 1.5, 0.0])
    b.add_triangles_array(v[f[:, 0]] + up, v[f[:, 1]] + up, v[f[:, 2]] + up,
                          "w")
    mesh_film = Film(fov=torch.tensor(math.radians(45.0)),
                     width=8 * max(n // 2, 1), height=8)
    mesh = dict(scene=b.build(accel="bvh4", device="cpu"),
                camera=make_camera((0.0, 3.0, 8.0), (0.0, 1.5, 0.0),
                                   device="cpu"),
                film=mesh_film, depth=2, seed=0, spp=0)
    cases = [dict(cornell, kind="render", spp=[0], name="cornell forward"),
             dict(cornell, kind="train", step="sharded",
                  target=torch.zeros((film.num_pixels, 3)),
                  name="cornell train step"),
             dict(mesh, kind="render", spp=[0], mesh=(n, 1),
                  name="mesh forward")]
    if n >= 4 and n % 2 == 0:
        cases.append(dict(mesh, kind="train", mesh=(n // 2, 2),
                          target=torch.zeros((mesh_film.num_pixels, 3)),
                          name="mesh geometry-sharded train step"))
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when left out")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args)
        return 0
    n = args.ranks
    T.resolve_device(args.device)  # raises without a card unless cpu
    cases = dryrun_cases(n)
    if args.device is None:
        prebuild([c["scene"] for c in cases])
    results, setup = launch(n, cases, args.backend, args.device,
                            args.timeout)
    ok = True
    for i, case in enumerate(cases):
        r0 = results[0][i]
        for p in r0["passes"]:
            if case["kind"] == "render":
                v = float(p["L"].mean())
                what = f"image mean {v:.6f}"
            else:
                v = p["loss"] + sum(float(g.abs().sum())
                                    for g in p["grads"].values())
                color = float(p["grads"]["materials.color"].abs().sum())
                what = f"loss {p['loss']:.6f}, |dL/dcolor| {color:.6f}"
            good = math.isfinite(v)
            ok &= good
            print(f"dryrun {case['name']} (mesh {case['mesh'][0]} x "
                  f"{case['mesh'][1]}, {args.backend}): {what}, launches "
                  f"{ {k: c for k, c in p['counts'].items() if c} } — "
                  + ("OK" if good else "FAIL"), flush=True)
    print(f"dryrun: {n} ranks up in {max(setup):.2f} s", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
