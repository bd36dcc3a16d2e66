"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It imports only the port (craytracer_tpu_torch),
never JAX or the JAX package. Phases, each printing its own lines:

1. device: a CUDA card must be present; prints nvidia-smi's name and
   power limit.
2. build: compiles K1 (csrc/pass_kernel.cu, nvcc, sm_90a) from the
   checkout into craytracer_tpu_torch/_build/ and prints the build time.
3. kernel vs plain: K1 against its plain PyTorch version on the card, on
   scenes/parity_cornell.txt at 64x64, depth 0, 2 and 5, scalar and
   per-lane spp, both raygen variants; then at the main path's own shape,
   512x512 lanes in the Renderer's Morton order with its per-lane spp
   (first and last pass), depth 0, 2 and 5. At least 99.9% of lanes must
   have equal `good`, L within 1e-4 (absolute + relative) on those lanes,
   rays and shadow_rays within 0.1% (exact at depth 0).
4. main path: the port's Renderer at 512x512, depth 5, 64 spp, reference
   estimator. Every pass must launch K1 once and no NaN may be
   substituted; the image must match tests/goldens/golden_cornell.is by
   tone-mapped 8x8 block means (the thresholds of
   tests/test_reference_parity.py). The PPM goes to
   craytracer_tpu_torch/_build/.
5. time: 512x512, depth 5, 16 passes per timed run, CUDA events after a
   warm-up, median of 5, in turns: bare K1 launches on prebuilt inputs,
   K1 through the fused_pass wrapper, and the plain version. Rays/s
   counts rays + shadow_rays from the kernel's own counters. The last
   timed pass of K1 (through the wrapper) and of the plain version are
   held against each other as in phase 3. The JSON line's "ms" is the
   bare launch, "plain_ms" the plain version, per pass; "max_abs_err" is
   the largest |dL| over all lanes of every phase-3 and phase-5 check.

Then one JSON line describing the kernels, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero without it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(REPO, "scenes", "parity_cornell.txt")
GOLDEN = os.path.join(REPO, "tests", "goldens", "golden_cornell.is")
L_TOL = 1e-4


def _tonemapped(img):
    return (1.0 - np.exp(-2.0 * np.clip(img, 0.0, None))) ** (1.0 / 2.2)


def _block_means(img, blocks=8):
    h, w, _ = img.shape
    tm = _tonemapped(img).mean(-1)
    return tm.reshape(blocks, h // blocks, blocks, w // blocks).mean(
        axis=(1, 3))


def _compare(kernel_out, plain_out, depth):
    """K1 vs plain on one batch: (share of lanes with differing good, max
    |dL| over agreeing lanes, max |dL| overall, failures)."""
    (Lk, gk, mk), (Lp, gp, mp) = kernel_out, plain_out
    Lk, Lp = Lk.double(), Lp.double()
    same = gk == gp
    dL = (Lk - Lp).abs()
    close = (dL <= L_TOL + L_TOL * Lp.abs()).all(dim=1)
    bad_share = 1.0 - same.double().mean().item()
    ok_share = (same & close).double().mean().item()
    err_same = dL[same].max().item() if bool(same.any()) else 0.0
    fails = []
    if ok_share < 0.999:
        fails.append(f"only {ok_share:.5f} of lanes agree")
    if not torch.isfinite(Lk).all():
        fails.append("non-finite L from K1")
    for key in ("rays", "shadow_rays"):
        a, b = int(mk[key]), int(mp[key])
        if depth == 0 and a != b or abs(a - b) > 1e-3 * max(b, 1):
            fails.append(f"{key} {a} vs {b}")
    return bad_share, err_same, dL.max().item(), fails


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (this smoke test needs the card)")
        return 1
    sys.path.insert(0, REPO)
    from craytracer_tpu_torch.camera import Film
    from craytracer_tpu_torch.integrator import pass_kernel as pk
    from craytracer_tpu_torch.integrator.render import RenderConfig, Renderer
    from craytracer_tpu_torch.io.image import write_ppm
    from craytracer_tpu_torch.io.imagestate import read_reference_is
    from craytracer_tpu_torch.io.scenefile import load_scene_file

    dev = torch.device("cuda", 0)
    fails: list[str] = []

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(f"[device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    pk.KERNEL.build()
    print(f"[build] K1 built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {' '.join(pk.NVCC_FLAGS)})", flush=True)
    for line in pk.KERNEL.ptxas_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] ptxas: {line.strip()}")

    scene, cam, film0 = load_scene_file(SCENE, device=dev)

    # ---- 3. kernel vs plain
    err_max = 0.0

    def check(label, film, pix, spp, seed, depth, raygen, out_k=None,
              out_p=None):
        """Hold K1 against the plain version on one batch (running both
        unless their outputs are given) and record any failure."""
        nonlocal err_max
        if out_k is None:
            args = (scene, cam, film, pix, spp, seed, depth)
            out_k = pk.fused_pass(*args, raygen=raygen)
            out_p = pk.fused_pass_reference(*args, raygen=raygen)
        torch.cuda.synchronize()
        bad, err_same, err_all, f = _compare(out_k, out_p, depth)
        err_max = max(err_max, err_all)
        print(f"[kernel-vs-plain] {label} depth {depth} raygen {raygen}: "
              f"lanes {pix.shape[0]}, good differs on {bad:.5f}, max|dL| "
              f"{err_same:.3g} (agreeing lanes) {err_all:.3g} (all), rays "
              f"{int(out_k[2]['rays'])}/{int(out_p[2]['rays'])}, shadow_rays "
              f"{int(out_k[2]['shadow_rays'])}/"
              f"{int(out_p[2]['shadow_rays'])}"
              + (" FAIL " + "; ".join(f) if f else ""), flush=True)
        fails.extend(f"{label} depth {depth} {raygen}: {x}" for x in f)

    size = 64
    film = Film(fov=film0.fov, width=size, height=size)
    n = film.num_pixels
    pix1 = torch.arange(n, dtype=torch.int32, device=dev)
    pix2 = pix1.repeat(2)
    spp2 = 3 + torch.arange(2, dtype=torch.int32,
                            device=dev).repeat_interleave(n)
    for depth in (0, 2, 5):
        for spp_kind, pix, spp in (("scalar", pix1, 5),
                                   ("per-lane", pix2, spp2)):
            for raygen in ("strat", "plain"):
                check(f"64x64 spp {spp_kind}", film, pix, spp, 7, depth,
                      raygen)

    # the main path's own inputs: 512x512 lanes in the Renderer's Morton
    # order, per-lane spp as its first and last passes give them
    size = 512
    film = Film(fov=film0.fov, width=size, height=size)
    cfg = RenderConfig(num_samples=64, max_depth=5, estimator="reference")
    morton = torch.from_numpy(
        Renderer(scene, cam, film, cfg).pixel_order()).to(dev)
    for depth, s in ((0, 0), (2, 0), (5, 0), (5, cfg.num_samples - 1)):
        spp = torch.full_like(morton, s)
        check(f"512x512 Morton spp {s}", film, morton, spp, cfg.seed, depth,
              "strat")

    # ---- 4. main path
    r = Renderer(scene, cam, film, cfg)
    pk.KERNEL.launches = 0
    t0 = time.perf_counter()
    r.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = pk.KERNEL.launches
    ours = r.raw_mean()
    accum, spp, w, h = read_reference_is(GOLDEN)
    ref = (accum / spp).reshape(h, w, 3)
    rb, ob = _block_means(ref), _block_means(ours)
    full_r, full_o = _tonemapped(ref).mean(), _tonemapped(ours).mean()
    dev_b = np.abs(ob - rb)
    pk.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ppm = str(pk.BUILD_DIR / "cornell_512.ppm")
    write_ppm(ppm, r.image())
    print(f"[main-path] Renderer 512x512 64 spp depth 5: {dt:.2f} s, "
          f"{r.passes} passes, {launches} K1 launches, {r.nan_count} NaN; "
          f"tone-mapped mean {full_o:.4f} vs golden {full_r:.4f}, block dev "
          f"max {dev_b.max():.4f}, share < 0.02 {(dev_b < 0.02).mean():.3f};"
          f" wrote {os.path.relpath(ppm, REPO)}", flush=True)
    if launches != r.passes or launches == 0:
        fails.append(f"{launches} K1 launches for {r.passes} passes")
    if r.nan_count:
        fails.append(f"{r.nan_count} NaN samples substituted")
    if ours.shape != (size, size, 3) or not np.isfinite(ours).all():
        fails.append("image is not finite [512, 512, 3]")
    if not abs(full_o - full_r) < 0.02 * max(full_r, 0.05):
        fails.append(f"tone-mapped mean {full_o} vs {full_r}")
    if not (dev_b.max() < 0.05 and (dev_b < 0.02).mean() > 0.9):
        fails.append("golden block means disagree")

    # ---- 5. time
    pix = torch.arange(size * size, dtype=torch.int32, device=dev)
    passes = 16

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def timed(fn, spp0):
        """`passes` wrapper calls (tables, launch, counter sums) in a row;
        returns the time and the last pass's output."""
        start, stop = events()
        start.record()
        for s in range(passes):
            out = fn(scene, cam, film, pix, spp0 + s, 0, 5, raygen="plain")
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop), out

    tab = pk.kernel_tables(scene, cam, film)
    counts = (scene.materials.mat_type.shape[0],
              scene.lights.light_type.shape[0], scene.rects.mat_id.shape[0],
              scene.triangles.mat_id.shape[0])

    def timed_kernel(spp0):
        """`passes` bare K1 launches on prebuilt inputs."""
        spps = [torch.full_like(pix, spp0 + s) for s in range(passes)]
        start, stop = events()
        start.record()
        outs = [pk.KERNEL.launch(tab, *counts, pix, sp, 0, 5, False, size)
                for sp in spps]
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop), sum(int(g[1].sum() + g[2].sum())
                                             for _, g in outs)

    timed(pk.fused_pass, 1000)
    timed(pk.fused_pass_reference, 1000)
    timed_kernel(1000)
    t_k, t_w, t_p, rays_k = [], [], [], []
    for rep in range(5):
        spp0 = 2000 + passes * rep
        ms, rays = timed_kernel(spp0)
        t_k.append(ms)
        rays_k.append(rays)
        ms, out_k = timed(pk.fused_pass, spp0)
        t_w.append(ms)
        ms, out_p = timed(pk.fused_pass_reference, spp0)
        t_p.append(ms)
    # the timed passes' own outputs: the last pass of the last run
    check(f"512x512 raster spp {spp0 + passes - 1} (timed)", film, pix,
          spp0 + passes - 1, 0, 5, "plain", out_k, out_p)
    med_k, med_w, med_p = (statistics.median(t) for t in (t_k, t_w, t_p))
    rays_med = rays_k[t_k.index(med_k)]

    def runs(ts):
        return ", ".join(f"{t:.3f}" for t in ts)

    print(f"[time] {card}, 512x512 depth 5, {passes} passes per run, median "
          f"of 5: K1 launch {med_k / passes:.4f} ms/pass "
          f"({rays_med / (med_k / 1e3):.6g} rays/s; runs {runs(t_k)} ms); "
          f"K1 through fused_pass {med_w / passes:.4f} ms/pass "
          f"({rays_med / (med_w / 1e3):.6g} rays/s; runs {runs(t_w)} ms); "
          f"plain PyTorch {med_p / passes:.4f} ms/pass (runs {runs(t_p)} "
          f"ms); {rays_med} rays + shadow rays per run", flush=True)

    if fails:
        for f in fails:
            print(f"FAIL: {f}")
        return 1
    print(json.dumps({"kernels": [{
        "name": "k1_pass", "route": "cuda",
        "source": "craytracer_tpu_torch/csrc/pass_kernel.cu",
        "replaces": "craytracer_tpu/integrator/pallas_shade.py:781",
        "launches": launches, "max_abs_err": err_max,
        "ms": med_k / passes, "plain_ms": med_p / passes}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
