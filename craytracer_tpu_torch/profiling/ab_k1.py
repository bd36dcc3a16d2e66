"""Same-call A/B of bare K1 between checkouts of the port.

    python -m craytracer_tpu_torch.profiling.ab_k1 ROOT [ROOT ...]
        [--out FILE.json]

Each ROOT is a directory holding a `craytracer_tpu_torch/` package, its
`scenes/` and `tests/torch_prim_scenes.py` (an older checkout unpacked
with `git archive`, or `.` for this one). The roots are timed one after
another, each in a fresh process that imports the package from its root
and builds its own K1, so give them in an interleaved order (parent,
change, change, parent) to see the machine's drift. A process times
bare K1 launches on prebuilt inputs (`PassKernel.launch`, whose
signature every checkout of the port shares) on the five scenes K1
renders in `chip_smoke.py` (parity_cornell, parity_mix, the plane/disk
and AABOX scenes, thin-lens parity_cornell), 512x512, depth 5, at two
launch sizes: one spp per launch (262,144 lanes, 16 launches per run)
and 16 spp per launch (4,194,304 lanes, 2 launches per run); CUDA
events after a warm-up,
median of 5 runs, ms per spp-pass. It also hashes the outputs (L and the
four counter rows) of one launch per scene, so the summary says whether
every root computes the same function bit for bit, and prints ptxas'
register and spill lines of its K1 build. Prints one JSON line per
process, the card's name and power limit, and per scene and size each
root's time and the later roots' mean over the first root's. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys

if __package__:
    from craytracer_tpu_torch.profiling import ab_roots
else:  # a child process, started by file path: a sibling import
    import ab_roots

SIZE, DEPTH, WIDE = 512, 5, 16
SCENES = ("cornell", "parity_mix", "plane_disk", "aabox", "thinlens_cornell")


def _scenes(root, dev):
    """{name: (scene, camera, film)} built by the package under `root`."""
    import torch

    from craytracer_tpu_torch.camera import Film, make_camera
    from craytracer_tpu_torch.io.scenefile import load_scene_file
    from craytracer_tpu_torch.scene.build import SceneBuilder

    sys.path.insert(0, os.path.join(root, "tests"))
    import torch_prim_scenes as prim_scenes

    out = {}
    for name, path in (("cornell", "parity_cornell.txt"),
                       ("parity_mix", "parity_mix.txt")):
        scn, cam, f0 = load_scene_file(os.path.join(root, "scenes", path),
                                       device=dev)
        out[name] = (scn, cam, Film(fov=f0.fov, width=SIZE, height=SIZE))
    for name in ("plane_disk", "aabox"):
        b = SceneBuilder()
        eye, look, fov, _ = prim_scenes.SCENES[name](b)
        out[name] = (b.build(device=dev), make_camera(eye, look, device=dev),
                     Film(fov=torch.tensor(fov, device=dev), width=SIZE,
                          height=SIZE))
    scn, cam, film = out["cornell"]
    out["thinlens_cornell"] = (scn, prim_scenes.thinlens(cam), film)
    return out


def _one(root: str) -> dict:
    """Time bare K1 on every scene and size with the package under
    `root`."""
    root = ab_roots.import_root(root)
    import torch

    from craytracer_tpu_torch.camera import THINLENS
    from craytracer_tpu_torch.integrator import pass_kernel as pk

    dev = torch.device("cuda")
    pk.LIBRARY.load()
    out = {"root": root, "ptxas": [
        line.strip() for line in pk.LIBRARY.ptxas_log.splitlines()
        if "registers" in line or "spill" in line]}
    pix = torch.arange(SIZE * SIZE, dtype=torch.int32, device=dev)
    for name, (scn, cam, film) in _scenes(root, dev).items():
        tab = pk.kernel_tables(scn, cam, film)
        counts = pk.table_counts(scn)
        full = pk.shade_features(scn) != 0
        thin = cam.camera_type == THINLENS

        def launch(p, sp):
            return pk.KERNEL.launch(tab, counts, p, sp, 0, DEPTH, False,
                                    SIZE, full, thin)

        L, g = launch(pix, torch.full_like(pix, 5))
        torch.cuda.synchronize()
        h = hashlib.sha256(L.cpu().numpy().tobytes())
        h.update(g.cpu().numpy().tobytes())
        res = {"hash": h.hexdigest()[:16]}
        for label, spl, per_run in (("1spp", 1, 16), ("16spp", WIDE, 2)):
            p = pix.repeat(spl)
            lane_spp = torch.arange(spl, dtype=torch.int32,
                                    device=dev).repeat_interleave(pix.numel())
            runs = [[lane_spp + 1000 + spl * (per_run * r + k)
                     for k in range(per_run)] for r in range(6)]
            for sp in runs[0]:
                launch(p, sp)
            ts = []
            for spps in runs[1:]:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                for sp in spps:
                    launch(p, sp)
                stop.record()
                torch.cuda.synchronize()
                ts.append(start.elapsed_time(stop))
            res[label] = {"ms_per_spp_pass":
                          statistics.median(ts) / (per_run * spl),
                          "runs_ms": ts}
        out[name] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--out")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(_one(args.one)), flush=True)
        return 0
    if not args.roots:
        ap.error("give at least one ROOT")
    results = ab_roots.run_roots(__file__, args.roots)
    if results is None:
        return 1
    card = ab_roots.card()
    print(card)
    same = ab_roots.report("ab-k1", card, results, [
        (f"{name} {SIZE}x{SIZE} depth {DEPTH}, {label} per launch, median "
         f"of 5, ms per spp-pass",
         lambda r, n=name, lb=label: r[n][lb]["ms_per_spp_pass"],
         lambda r, n=name: r[n]["hash"])
        for name in SCENES for label in ("1spp", "16spp")])
    print(f"[ab-k1] every root's outputs bit-equal on every scene: {same}")
    ab_roots.write_out(args.out, card, results)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
