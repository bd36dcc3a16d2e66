"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. It imports only the port (craytracer_tpu_torch),
never JAX or the JAX package. Phases, each printing its own lines:

1. device: a CUDA card must be present; prints nvidia-smi's name and
   power limit.
2. build: compiles K1 (csrc/pass_kernel.cu), K2 (csrc/shade_kernel.cu),
   K3/K3 `_init`/K4 (csrc/bvh4_traverse.cu), K5 (csrc/bvh4_split.cu), K6
   (csrc/tri_closest.cu) and P1 (csrc/pop_probe.cu) from the checkout with
   one nvcc each, all started together (sm_90a), into
   craytracer_tpu_torch/_build/;
   prints each build's seconds and ptxas' registers and spills for every
   kernel and instantiation (K1 and K2 each as the matte-only core,
   `<false>`, and the full core, `<true>`); then builds the native scene
   runtime (native/craynative.cpp, g++).
3. K1 vs plain: K1 against its plain PyTorch version on the card, on
   scenes/parity_cornell.txt at 64x64, depth 0, 2 and 5, scalar and
   per-lane spp, both raygen variants; then at the Cornell main path's own
   shape, 512x512 lanes in the Renderer's Morton order with its per-lane
   spp (first and last pass), depth 0, 2 and 5. At least 99.9% of lanes
   must have equal `good`, L within 1e-4 (absolute + relative) on those
   lanes, rays and shadow_rays within 0.1% (exact at depth 0).
4. Cornell main path: the port's Renderer at 512x512, depth 5, 64 spp,
   reference estimator; every launch count is set to 0 just before it and
   read just after: one K1 launch per pass, no K2/K3/K4 launch, no NaN
   substituted; the image must match tests/goldens/golden_cornell.is by
   tone-mapped 8x8 block means (the thresholds of
   tests/test_reference_parity.py).
5. Cornell time: 512x512, depth 5, 16 passes per timed run, CUDA events
   after a warm-up, median of 5, in turns: bare K1 launches on prebuilt
   inputs, K1 through fused_pass, and the plain version; the last timed
   passes of K1 and of the plain version are held against each other.
6. K3/K4 vs plain on scenes/parity_mesh_mid.txt (20,480 triangles): the
   512x512 camera rays in Morton order, the bounce-1 and bounce-3 rays and
   shadow rays of one plain pass, and 64k seeded random rays with 1%
   escape lanes. Bars: hit masks and ids equal and t within rtol 1e-6 on
   >= 99.99% of hit lanes; the any-hit verdict t < max_dist and, for the
   shadow rays, the `lit` predicate equal on >= 99.99% of lanes.
7. K2 vs plain on the hit records of bounces 0, 1 and 4 of that pass:
   float outputs within 1e-5 (absolute + relative), int outputs equal on
   >= 99.9% of lanes.
8. whole mesh pass vs plain: trace_paths through the kernels (K3 -> K2 ->
   K4, with the ray_key sorts) against the plain trace_paths (no sort) at
   512x512 Morton lanes, per-lane spp, depth 0, 2, 5 (spp 0) and depth 5
   (spp 63), with phase 3's bars.
9. mesh main path: the Renderer on parity_mesh_mid at 512x512, depth 5,
   64 spp, reference estimator; counts set to 0 just before and read just
   after: K3, K2 and K4 launch passes x 6 times each, K1 never, no NaN;
   the image against tests/goldens/golden_mesh_mid.is, and parity_mesh
   the same way against golden_mesh.is. PPMs go to
   craytracer_tpu_torch/_build/.
10. mesh time (CUDA events after a warm-up, median of 5): parity_mesh_mid
   512x512 depth 5 rays/s through render_sample over 16 passes (live
   closest-hit rays + shadow rays, from the counters); bare K3, K2 and K4
   per launch on the six bounces of one pass's real inputs, and the plain
   versions once; then the bench_mesh.py city of 327,680 triangles
   (craytracer_tpu_torch/scene/city.py): its build seconds, 256x256
   depth 4 rays/s, and bare K3 per launch on camera and bounce-1 rays,
   each with and without the ray_key sort.
11. K1's full core vs plain: scenes/parity_mix.txt (4 spheres, 3 rects;
   matte, Oren-Nayar, plastic, mirror, gold) at 512x512 Morton lanes,
   depth 0, 2, 5 (spp 0) and 5 (spp 63); then the four sphere scenes of
   tests/torch_sphere_scenes.py (mirror and clipped sphere, sphere light, Oren-Nayar /
   plastic / metal, glass / transparent) at 512x512, depth 0 and their
   own depth; phase 3's bars.
12. K2's full core vs plain on the bounce 0, 1 and 4 hit records of a
   plain 512x512 pass over parity_mix and over glass_spheres; phase 7's
   bars.
13. parity_mix through trace_paths(fast_shade="shade") (K2 with the plain
   sphere and rect intersection, K2 launched once per bounce and nothing
   else) against the plain trace_paths at depth 0, 2 and 5; phase 3's
   bars.
14. parity_mix main path: the Renderer at 512x512, depth 5, 64 spp,
   reference estimator; counts set to 0 just before and read just after:
   one K1 launch per pass and nothing else, no NaN; the image against
   tests/goldens/golden_mix.is.
15. parity_mix time (as phase 5): bare K1, K1 through fused_pass and the
   plain version per pass, rays/s and K1's bound (the operations of one
   plain pass's live lanes: prim tests, shading and each hit material's
   lobe, and each shadow ray's prim tests); Cornell's bare K1 on the
   matte-only and the full core in turns; bare K2's full core on the six
   bounces of a parity_mix pass against its plain version and bound.
16. K1 vs plain on planes, disks, boxes and the thin lens: the plane/disk
   and the AABOX scenes of tests/torch_prim_scenes.py and parity_cornell
   with a thin-lens camera (lens_radius 0.2, focal_length 3.0; both
   jitter variants) at 512x512 Morton lanes, depth 0, 2, 5 (spp 0) and 5
   (spp 63); phase 3's bars.
17. scenes/parity_prims.txt (a torus and a box behind their affines, a
   disk, rects) through trace_paths(fast_shade="shade") (K2 with the
   plain intersection of every group, one K2 launch per bounce and
   nothing else) against the plain trace_paths at depth 0, 2 and 5,
   phase 3's bars; then K2 vs plain on the bounce 0, 1 and 4 hit records,
   phase 7's bars.
18. parity_prims main path: the Renderer at 512x512, depth 5, 64 spp,
   reference estimator; counts set to 0 just before and read just after:
   K2 passes x 6 times and nothing else, no NaN; the image against
   tests/goldens/golden_prims.is. Then the AABOX scene through the
   Renderer (64 spp): one K1 launch per pass and nothing else, no NaN.
19. times (as phase 5): bare K1 per pass on the plane/disk, AABOX and
   thin-lens Cornell scenes with its bound, the plain version timed once;
   parity_prims ms/pass and rays/s through render_sample.
20. the city at CITY_TRIS triangles (6,999,040: the San-Miguel-scale
   scene the partitioned BVH4 was built for): its triangle count, fat
   rows and bytes, part count, each part's rows and stack size, the host
   build and partition seconds; every part under the 120 MiB budget and
   every triangle in exactly one part. Main path: the Renderer at
   512x512, depth 5, CITY_SPP spp (one per pass), counts set to 0 just
   before and read just after: K2 passes x 6, K3 `_init` and K4 passes x
   6 x parts, nothing else, no NaN, a finite image. Then ms/pass and
   rays/s through render_sample, median of 5.
21. K3 `_init` vs plain on the city: 512x512 camera rays and bounce-1
   rays in the route's order (ray_key sort, then the part sort), every
   part with the best hit of the parts before it carried: t and ids
   bit-equal on every lane of every part. The whole parts route against
   monolithic K3 on the same rays: t bit-equal on every lane, the lanes
   whose id differs on an exact tie of t counted. K2 vs plain on the
   bounce-0 and bounce-1 hit records of the parts route, phase 7's bars.
   On the plain shade's shadow rays of those bounces: K4 on every part
   against the plain any hit with the max_dist the route carries in
   (occluded lanes 0), t bit-equal on every lane; the route's t
   bit-equal with that plain chain; monolithic K4 bit-equal with its
   plain version; the verdicts of the route, the plain parts any hit
   and monolithic K4 equal on every lane.
22. K5 on the city: on the monolithic table and on every part, without
   and with a carried hit (the route's on the parts; half the lanes at
   half their closest t on the whole table), bit-equal with the plain
   version and with K3 / K3 `_init`; bare K5 against bare K3 and K3
   `_init` on the same sorted camera rays.
23. K6 on parity_mesh_mid's 20,480 triangles (pack_triangles) against
   its 512x512 camera rays: t and idx bit-equal with the plain version
   on every lane; bare K6 and the plain version timed.
24. P1 on the city's fat table: every mode bit-equal with its plain
   version at 4 packets and 48 pops; then ns per pop of every mode, the
   slope between 512 and 1,536 pops over 4,224 packets of camera rays;
   bare and plain full mode at 128 pops, t and sink bit-equal.

Then one JSON line describing the kernels (each with its launches on its
main path: K1 on parity_mix's, K2-K4 on parity_mesh_mid's, K3 `_init`
on the 7M city's; K5, K6 and P1 lie on no path: 0;
max_abs_err over its checks, ms per bare launch, the plain version's ms,
and bound_ms: the larger of the bytes it must move over 3.35 TB/s and
the operations this run's inputs need over 67 TFLOP/s f32, counted from
the CUDA sources; for K3/K4 both are counted from the rows the plain
traversal pops: each visited row read once, and per pop the slab tests
of its internal children and the triangle tests of its filled slots; K5
the same pops, reading a visited row's topology and its leaf children's
slots; K6 one Moller-Trumbore test per (ray, table column) pair; P1 the
full mode's box, slot and sort operations per lane and pop;
library_ms is null, since no single
PyTorch call computes any of these functions), the nvidia-smi line, and
as the last line {"ok": true, "device": {...}}. Any failure exits
non-zero without them.
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
MESH_MID = os.path.join(REPO, "scenes", "parity_mesh_mid.txt")
MESH = os.path.join(REPO, "scenes", "parity_mesh.txt")
MIX = os.path.join(REPO, "scenes", "parity_mix.txt")
GOLDEN_MIX = os.path.join(REPO, "tests", "goldens", "golden_mix.is")
PRIMS = os.path.join(REPO, "scenes", "parity_prims.txt")
GOLDEN_PRIMS = os.path.join(REPO, "tests", "goldens", "golden_prims.is")
L_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, published
# operations per unit of work, counted from the CUDA sources (f32 adds,
# multiplies, divisions, square roots, min/max and compares; integer
# hashing and address arithmetic left out)
BOX_OPS = 25  # K3/K4: one child's slab test
SLOT_OPS = 53  # K3/K4: one triangle slot's Moller-Trumbore test
SORT_OPS = 16  # K3/K4: the sorting network and the push, once per pop
RECT_OPS = 52  # K1 rect_t
TRI_OPS = 50  # K1 tri_t
SPHERE_OPS = 80  # K1 sphere_t: the quadratic and two window tests
PLANE_OPS = 17  # K1 plane_t
DISK_OPS = 33  # K1 disk_t: plane_t and the radius test
AABOX_OPS = 70  # K1 box_t: the affine ray, three divisions, the slabs
LENS_OPS = 58  # K1's thin-lens raygen, once per lane (pinhole's left out)
SHADE_OPS = 330  # shade_core.cuh, one lane and bounce
# K1's prim test per row, in table_counts' order after materials and
# lights: spheres, planes, rects, disks, triangles, boxes
ROW_OPS = (SPHERE_OPS, PLANE_OPS, RECT_OPS, DISK_OPS, TRI_OPS, AABOX_OPS)
# what shade_core<true> adds to SHADE_OPS for a lane of each material
# type: MATTE's two Oren-Nayar scales (only with F_OREN), the mirror
# reflection, PLASTIC's remapped lobes, both pdfs and the FresnelBlend f,
# METAL's half-vector, D twice, Lambda twice and three conductor Fresnels,
# TRANSPARENT's dielectric Fresnel, GLASS's half-vector, Fresnel and one
# branch
OREN_OPS, MIRROR_OPS, PLASTIC_OPS, METAL_OPS = 90, 10, 170, 250
TRANSPARENT_OPS, GLASS_OPS = 45, 330
K2_LANE_BYTES = 15 * 4 + 4 + 4 + 1 + 1 + 4 + 4 + 23 * 4 + 4 * 4
ROW_BYTES = 108 * 4  # the columns K3/K4 load of a row: boxes, children, slots
TOPO_BYTES = 28 * 4  # the columns K5 loads of a topology row
PAIR_BYTES = 20 * 4  # a leaf child's two slots, which K5 loads
K6_OPS = 53  # K6: one (ray, triangle) Moller-Trumbore test
CITY_TRIS = 7_000_000  # the 7M class the partitioned BVH4 was built for
CITY_SPP = 4


def _bound(nbytes, ops):
    """(bound ms, what bounds it) for one launch."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def _pop_bound(bvh, visits, lanes, lane_bytes=32, split=False):
    """Bound of one K3/K4/K5 launch from the rows its rays popped
    (`visits`, [M] pops per row): each visited row read once (K3/K4: its
    108 used columns; K5: its topology and its leaf children's slots) and
    each lane's `lane_bytes` of ray, max_dist or carried hit, and result;
    per pop, a slab test for each internal child (child id >= 0) and a
    Moller-Trumbore test for each filled slot (triangle id >= 0) of the
    popped row, and the sort."""
    fat = bvh.fat
    internal = (fat[:, 24:28] >= 0).sum(1)
    row_ops = (BOX_OPS * internal
               + SLOT_OPS * (fat[:, 37:108:10] >= 0).sum(1) + SORT_OPS)
    seen = visits > 0
    row_bytes = (int((TOPO_BYTES + PAIR_BYTES * (4 - internal[seen])).sum())
                 if split else int(seen.sum()) * ROW_BYTES)
    return _bound(row_bytes + lanes * lane_bytes,
                  int((visits * row_ops).sum()))


def _tonemapped(img):
    return (1.0 - np.exp(-2.0 * np.clip(img, 0.0, None))) ** (1.0 / 2.2)


def _block_means(img, blocks=8):
    h, w, _ = img.shape
    tm = _tonemapped(img).mean(-1)
    return tm.reshape(blocks, h // blocks, blocks, w // blocks).mean(
        axis=(1, 3))


def _golden(ours, golden_path):
    """Tone-mapped mean and 8x8 block-mean agreement with a golden:
    (mean ours, mean golden, max block dev, share of blocks < 0.02,
    failures)."""
    from craytracer_tpu_torch.io.imagestate import read_reference_is

    accum, spp, w, h = read_reference_is(golden_path)
    ref = (accum / spp).reshape(h, w, 3)
    dev_b = np.abs(_block_means(ours) - _block_means(ref))
    full_r, full_o = _tonemapped(ref).mean(), _tonemapped(ours).mean()
    fails = []
    if not np.isfinite(ours).all():
        fails.append("image is not finite")
    if not abs(full_o - full_r) < 0.02 * max(full_r, 0.05):
        fails.append(f"tone-mapped mean {full_o} vs {full_r}")
    if not (dev_b.max() < 0.05 and (dev_b < 0.02).mean() > 0.9):
        fails.append("golden block means disagree")
    return full_o, full_r, dev_b.max(), (dev_b < 0.02).mean(), fails


def _compare(kernel_out, plain_out, depth):
    """Kernel route vs plain on one batch: (share of lanes with differing
    good, max |dL| over agreeing lanes, max |dL| overall, failures)."""
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
        fails.append("non-finite L from the kernels")
    for key in ("rays", "shadow_rays"):
        a, b = int(mk[key]), int(mp[key])
        if depth == 0 and a != b or abs(a - b) > 1e-3 * max(b, 1):
            fails.append(f"{key} {a} vs {b}")
    return bad_share, err_same, dL.max().item(), fails


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _timed(fn):
    """ms of fn() between CUDA events (fn's own return value too)."""
    start, stop = _events()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def _median5(fn):
    """Warm-up, then the median of 5 timed runs and the five times."""
    fn()
    torch.cuda.synchronize()
    ts = [_timed(fn)[0] for _ in range(5)]
    return statistics.median(ts), ts


def _runs(ts):
    return ", ".join(f"{t:.3f}" for t in ts)


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (this smoke test needs the card)")
        return 1
    sys.path.insert(0, REPO)
    from craytracer_tpu_torch import cuda_build, native
    from craytracer_tpu_torch.accel import bvh4_kernel as bk
    from craytracer_tpu_torch.accel import bvh4_parts
    from craytracer_tpu_torch.accel import bvh4_split_kernel as sp
    from craytracer_tpu_torch.accel.bvh4 import (
        bvh4_any_hit_stats, bvh4_closest_hit_init_stats,
        bvh4_closest_hit_stats)
    from craytracer_tpu_torch.camera import (THINLENS, Film, generate_rays,
                                             make_camera)
    from craytracer_tpu_torch.constants import K_EPSILON, TMAX
    from craytracer_tpu_torch.integrator import pass_kernel as pk
    from craytracer_tpu_torch.integrator import shade_kernel as sk
    from craytracer_tpu_torch.integrator import wavefront as wf
    from craytracer_tpu_torch.integrator.render import RenderConfig, Renderer
    from craytracer_tpu_torch.io.image import write_ppm
    from craytracer_tpu_torch.io.scenefile import load_scene_file
    from craytracer_tpu_torch.ops.intersect import intersect_scene
    from craytracer_tpu_torch.ops import tri_kernel
    from craytracer_tpu_torch.ops.raysort import ray_key
    from craytracer_tpu_torch.profiling import pop_probe as pp
    from craytracer_tpu_torch.sampling.multijitter import stratified_jitter
    from craytracer_tpu_torch.scene.build import SceneBuilder
    from craytracer_tpu_torch.scene.city import city_builder, city_view

    dev = torch.device("cuda", 0)
    fails: list[str] = []
    counters = {"k1_pass": pk.KERNEL, "k2_shade": sk.KERNEL,
                "k3_bvh4_closest": bk.CLOSEST, "k4_bvh4_any": bk.ANY,
                "k3_init_bvh4_closest": bk.CLOSEST_INIT,
                "k5_bvh4_split": sp.SPLIT,
                "k6_tri_closest": tri_kernel.KERNEL,
                "p1_pop_probe": pp.KERNEL}
    err = dict.fromkeys(counters, 0.0)  # max |kernel - plain| per kernel

    def reset_counts():
        for c in counters.values():
            c.launches = 0

    def counts():
        return {k: c.launches for k, c in counters.items()}

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(f"[device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # ---- 2. build
    libs = {"k1_pass": pk.LIBRARY, "k2_shade": sk.LIBRARY,
            "k3_bvh4_closest + k3_init + k4_bvh4_any": bk.LIBRARY,
            "k5_bvh4_split": sp.LIBRARY,
            "k6_tri_closest": tri_kernel.LIBRARY,
            "p1_pop_probe": pp.LIBRARY}
    t0 = time.perf_counter()
    cuda_build.build_all(libs.values())
    print(f"[build] K1, K2, K3/K3 _init/K4, K5, K6, P1 built in parallel in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{' '.join(cuda_build.NVCC_FLAGS)})", flush=True)
    t0 = time.perf_counter()
    native.library()
    print(f"[build] native scene runtime ({native.SOURCE.name}, g++ "
          f"{' '.join(native.CXX_FLAGS)}) ready in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, lib in libs.items():
        secs = ("cached" if lib.build_seconds is None
                else f"{lib.build_seconds:.2f} s")
        print(f"[build] {name} ({lib.source.name}): {secs}")
        for line in lib.ptxas_log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"[build]   ptxas: {line.strip()}")

    scene, cam, film0 = load_scene_file(SCENE, device=dev)

    # ---- 3. K1 vs plain
    def check(label, film, pix, spp, seed, depth, raygen, out_k=None,
              out_p=None, scn=None, camera=None):
        """Hold K1 against the plain version on one batch (running both
        unless their outputs are given; the Cornell scene unless another is
        given) and record any failure."""
        if out_k is None:
            args = (scn or scene, camera or cam, film, pix, spp, seed, depth)
            out_k = pk.fused_pass(*args, raygen=raygen)
            out_p = pk.fused_pass_reference(*args, raygen=raygen)
        torch.cuda.synchronize()
        bad, err_same, err_all, f = _compare(out_k, out_p, depth)
        err["k1_pass"] = max(err["k1_pass"], err_all)
        print(f"[kernel-vs-plain] {label} depth {depth} raygen {raygen}: "
              f"lanes {pix.shape[0]}, good differs on {bad:.5f}, max|dL| "
              f"{err_same:.3g} (agreeing lanes) {err_all:.3g} (all), rays "
              f"{int(out_k[2]['rays'])}/{int(out_p[2]['rays'])}, shadow_rays "
              f"{int(out_k[2]['shadow_rays'])}/"
              f"{int(out_p[2]['shadow_rays'])}"
              + (" FAIL " + "; ".join(f) if f else ""), flush=True)
        fails.extend(f"{label} depth {depth} {raygen}: {x}" for x in f)

    def expect(label, got, **want):
        """Fail unless the launch counts are `want` (0 where not named)."""
        w = {k: want.get(k, 0) for k in counters}
        if got != w:
            fails.append(f"{label} launches {got}, want {w}")

    def main_path(label, scn, c, fm, golden=None, config=None):
        """The Renderer on `scn` at the spp and depth of `config` (cfg
        unless given), every count set to 0 just before it and read just
        after; prints its line, writes its PPM, records NaN, image and
        golden failures. Returns (passes, launches)."""
        config = config or cfg
        r = Renderer(scn, c, fm, config)
        reset_counts()
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = counts()
        ours = r.raw_mean()
        ppm = str(cuda_build.BUILD_DIR / f"{label}_512.ppm")
        write_ppm(ppm, r.image())
        if golden is None:
            what = f"mean {ours.mean():.4f}"
            if not ours.mean() > 0.01:
                fails.append(f"{label}: image mean {ours.mean()}")
        else:
            full_o, full_r, dev_max, share, f = _golden(ours, golden)
            what = (f"tone-mapped mean {full_o:.4f} vs golden {full_r:.4f}, "
                    f"block dev max {dev_max:.4f}, share < 0.02 {share:.3f}")
            fails.extend(f"{label} golden: {x}" for x in f)
        print(f"[main-path] Renderer {label} {fm.width}x{fm.height} "
              f"{config.num_samples} spp depth {config.max_depth}: "
              f"{dt:.2f} s, "
              f"{r.passes} passes, launches {got}, {r.nan_count} NaN; {what};"
              f" wrote {os.path.relpath(ppm, REPO)}", flush=True)
        if r.passes == 0:
            fails.append(f"{label}: no pass")
        if r.nan_count:
            fails.append(f"{label}: {r.nan_count} NaN samples substituted")
        if ours.shape != (fm.height, fm.width, 3) or not np.isfinite(
                ours).all():
            fails.append(f"{label}: the image is not finite [H, W, 3]")
        return r.passes, got

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

    # ---- 4. Cornell main path
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    n_p, launches_cornell = main_path("cornell", scene, cam, film, GOLDEN)
    expect("cornell", launches_cornell, k1_pass=n_p)

    # ---- 5. Cornell time
    pix = torch.arange(size * size, dtype=torch.int32, device=dev)
    passes = 16

    def timed_passes(fn, spp0, scn=scene, camera=cam, fm=film):
        """`passes` wrapper calls (tables, launch, counter sums) in a row;
        returns the time and the last pass's output."""
        return _timed(lambda: [fn(scn, camera, fm, pix, spp0 + s, 0, 5,
                                  raygen="plain") for s in range(passes)][-1])

    def timed_kernel(spp0, scn=scene, camera=cam, fm=film, full=None):
        """`passes` bare K1 launches on prebuilt inputs (the scene's own
        core unless `full` picks one); returns the time and the (rays,
        shadow rays) they traced."""
        tab = pk.kernel_tables(scn, camera, fm)
        spps = [torch.full_like(pix, spp0 + s) for s in range(passes)]
        f = pk.shade_features(scn) != 0 if full is None else full
        thin = camera.camera_type == THINLENS
        ms, outs = _timed(lambda: [
            pk.KERNEL.launch(tab, pk.table_counts(scn), pix, sp, 0, 5,
                             False, size, f, thin)
            for sp in spps])
        return ms, (sum(int(g[1].sum()) for _, g in outs),
                    sum(int(g[2].sum()) for _, g in outs))

    timed_passes(pk.fused_pass, 1000)
    timed_passes(pk.fused_pass_reference, 1000)
    timed_kernel(1000)
    t_k, t_w, t_p, rays_k = [], [], [], []
    for rep in range(5):
        spp0 = 2000 + passes * rep
        ms, rays = timed_kernel(spp0)
        t_k.append(ms)
        rays_k.append(rays)
        ms, out_k = timed_passes(pk.fused_pass, spp0)
        t_w.append(ms)
        ms, out_p = timed_passes(pk.fused_pass_reference, spp0)
        t_p.append(ms)
    # the timed passes' own outputs: the last pass of the last run
    check(f"512x512 raster spp {spp0 + passes - 1} (timed)", film, pix,
          spp0 + passes - 1, 0, 5, "plain", out_k, out_p)
    med_k, med_w, med_p = (statistics.median(t) for t in (t_k, t_w, t_p))
    n_rays, n_shadow = rays_k[t_k.index(med_k)]
    rays_med = n_rays + n_shadow
    prim_ops = 8 * RECT_OPS + 20 * TRI_OPS
    tab = pk.kernel_tables(scene, cam, film)
    k1_bound = _bound(
        (tab.numel() * 4 + size * size * (8 + 28)),
        (n_rays * (prim_ops + SHADE_OPS) + n_shadow * prim_ops) / passes)
    print(f"[time] {card}, cornell 512x512 depth 5, {passes} passes per "
          f"run, median of 5: K1 launch {med_k / passes:.4f} ms/pass "
          f"({rays_med / (med_k / 1e3):.6g} rays/s; runs {_runs(t_k)} ms); "
          f"K1 through fused_pass {med_w / passes:.4f} ms/pass "
          f"({rays_med / (med_w / 1e3):.6g} rays/s; runs {_runs(t_w)} ms); "
          f"plain PyTorch {med_p / passes:.4f} ms/pass (runs {_runs(t_p)} "
          f"ms); {n_rays} rays + {n_shadow} shadow rays per run; K1 bound "
          f"{k1_bound[0]:.4f} ms/pass ({k1_bound[1]})", flush=True)
    kernels = {"k1_pass": {
        "name": "k1_pass", "route": "cuda",
        "source": "craytracer_tpu_torch/csrc/pass_kernel.cu",
        "replaces": "craytracer_tpu/integrator/pallas_shade.py:781",
        "launches": launches_cornell["k1_pass"],
        "ms": med_k / passes, "plain_ms": med_p / passes,
        "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
        "library_ms": None}}

    # ---- 6. K3/K4 vs plain on parity_mesh_mid
    mesh, mcam, mfilm0 = load_scene_file(MESH_MID, device=dev)
    bvh = mesh.tri_bvh
    mfilm = Film(fov=mfilm0.fov, width=size, height=size)
    mmorton = torch.from_numpy(
        Renderer(mesh, mcam, mfilm, cfg).pixel_order()).to(dev)
    print(f"[mesh] parity_mesh_mid: {bvh.n_tris} triangles, "
          f"{bvh.fat.shape[0]} fat rows, stack {bvh.stack_size}, route "
          f"{wf.production_fast_shade(mesh, mcam, mfilm)}", flush=True)

    def plain_records(scn, o, d, pix, spp, depth):
        """(ray state, hit record, shade outputs) of every bounce of one
        plain pass."""
        state = wf._init_state(o, d, depth, pix)
        recs = []
        for b in range(depth + 1):
            hit = intersect_scene(scn, state[0], state[1])
            out = sk.fused_shade_reference(scn, state[1], hit, state[2],
                                           state[5], state[6], state[10],
                                           spp, cfg.seed, b, depth)
            recs.append((state, hit, out))
            state = wf._bounce_step(scn, cfg.seed, spp, depth, b, state,
                                    kernels=False)
        return recs

    mspp = torch.zeros_like(mmorton)
    o_cam, d_cam = generate_rays(mcam, mfilm, mmorton,
                                 stratified_jitter(cfg.seed, mmorton, mspp))
    recs = plain_records(mesh, o_cam, d_cam, mmorton, mspp, 5)
    torch.cuda.synchronize()

    def check_k3(label, o, d, bvh_=bvh):
        t_k, tri_k = bk.bvh4_closest_hit_kernel(bvh_, o, d)
        t_p, tri_p = bvh4_closest_hit_stats(bvh_, o, d)[:2]
        hit_p = t_p < TMAX
        same = (tri_k == tri_p) & ((t_k - t_p).abs() <= 1e-6 * t_p.abs())
        agree = (same & hit_p).sum().item() / max(hit_p.sum().item(), 1)
        masks = ((t_k < TMAX) == hit_p).double().mean().item()
        exact = (torch.equal(t_k, t_p), torch.equal(tri_k, tri_p))
        e = (t_k - t_p)[hit_p & (tri_k == tri_p)].abs().max().item() \
            if bool(hit_p.any()) else 0.0
        err["k3_bvh4_closest"] = max(err["k3_bvh4_closest"], e)
        bad = agree < 0.9999 or masks < 0.9999
        print(f"[k3-vs-plain] {label}: rays {o.shape[0]}, hits "
              f"{int(hit_p.sum())}, ids and t agree on {agree:.6f} of hit "
              f"lanes, hit masks on {masks:.6f} of lanes, bit-equal t/ids "
              f"{exact}, max|dt| {e:.3g}" + (" FAIL" if bad else ""),
              flush=True)
        if bad:
            fails.append(f"K3 {label}: {agree} / {masks}")

    def check_k4(label, o, d, md, dadj=None):
        t_k = bk.bvh4_any_hit_kernel(bvh, o, d, md)
        t_p = bvh4_any_hit_stats(bvh, o, d, md)[0]
        verdict = ((t_k < md) == (t_p < md)).double().mean().item()
        both = (t_k < TMAX) & (t_p < TMAX)
        e = (t_k - t_p)[both].abs().max().item() if bool(both.any()) else 0.0
        err["k4_bvh4_any"] = max(err["k4_bvh4_any"], e)
        msg = (f"[k4-vs-plain] {label}: rays {o.shape[0]}, occluded "
               f"{int((t_p < md).sum())}, verdicts agree on {verdict:.6f}, "
               f"bit-equal t {torch.equal(t_k, t_p)}, max|dt| {e:.3g}")
        bad = verdict < 0.9999
        if dadj is not None:
            band = dadj - torch.clamp(1e-3 * dadj, min=K_EPSILON)
            lit = ((t_k >= band) == (t_p >= band)).double().mean().item()
            msg += f", lit agrees on {lit:.6f}"
            bad = bad or lit < 0.9999
        print(msg + (" FAIL" if bad else ""), flush=True)
        if bad:
            fails.append(f"K4 {label}")

    gen = torch.Generator(device=dev).manual_seed(3)
    t_cam = bvh4_closest_hit_stats(bvh, o_cam, d_cam)[0]
    check_k3("512x512 camera rays (Morton)", o_cam, d_cam)
    md_cam = torch.where(t_cam < TMAX, t_cam * (0.5 + torch.rand(
        t_cam.shape, generator=gen, device=dev)), 5.0)
    md_cam[1::3] = 1e30
    check_k4("512x512 camera rays, max_dist around the hit", o_cam, d_cam,
             md_cam)
    for b in (1, 3):
        state, _, out = recs[b]
        check_k3(f"bounce-{b} rays", state[0], state[1])
        check_k4(f"bounce-{b} shadow rays", out["shadow_o"], out["shadow_d"],
                 out["dist_adj_t"], out["dist_adj"])
    nr = 65536
    o_r = torch.rand((nr, 3), generator=gen, device=dev) * torch.tensor(
        [20.0, 4.0, 20.0], device=dev) - torch.tensor([10.0, 0.0, 10.0],
                                                      device=dev)
    d_r = torch.nn.functional.normalize(
        torch.randn((nr, 3), generator=gen, device=dev), dim=1)
    o_r[: nr // 100] = 3.0e18
    d_r[: nr // 100] = torch.tensor([1.0, 0.0, 0.0], device=dev)
    check_k3("64k random rays, 1% escape", o_r, d_r)
    check_k4("64k random rays, 1% escape, max_dist U(0, 20)", o_r, d_r,
             torch.rand(nr, generator=gen, device=dev) * 20.0)

    # ---- 7. K2 vs plain
    float_keys = ("L_add", "shadow_o", "shadow_d", "dist_adj", "dist_adj_t",
                  "contrib_cand", "new_o", "new_d", "new_beta")
    int_keys = ("good_inc", "want_shadow", "new_alive", "new_prev_sg")

    def check_k2(label, scn, recs_, spp, bounces=(0, 1, 4)):
        """K2 against the plain shade on the same hit records (a plain
        pass's, or the route's): floats within 1e-5 (absolute + relative),
        int outputs on >= 99.9% of lanes."""
        for b in bounces:
            state, hit, ref = recs_[b]
            got = sk.fused_shade(scn, state[1], hit, state[2], state[5],
                                 state[6], state[10], spp, cfg.seed, b, 5)
            torch.cuda.synchronize()
            e = max((got[k] - ref[k]).abs().max().item() for k in float_keys)
            close = all(bool(torch.allclose(got[k], ref[k], rtol=1e-5,
                                            atol=1e-5)) for k in float_keys)
            ints = min((got[k] == ref[k]).double().mean().item()
                       for k in int_keys)
            err["k2_shade"] = max(err["k2_shade"], e)
            bad = not close or ints < 0.999
            print(f"[k2-vs-plain] {label} bounce {b}: lanes "
                  f"{state[1].shape[0]}, alive {int(state[5].sum())}, max|d| "
                  f"floats {e:.3g}, int rows equal on >= {ints:.6f}"
                  + (" FAIL" if bad else ""), flush=True)
            if bad:
                fails.append(f"K2 {label} bounce {b}")

    check_k2("mesh_mid", mesh, recs, mspp)

    # ---- 8. whole mesh pass vs plain
    for depth, s in ((0, 0), (2, 0), (5, 0), (5, cfg.num_samples - 1)):
        spp = torch.full_like(mmorton, s)
        o, d = generate_rays(mcam, mfilm, mmorton,
                             stratified_jitter(cfg.seed, mmorton, spp))
        out_k = wf.trace_paths(mesh, o, d, cfg.seed, mmorton, spp, depth,
                               with_metrics=True, fast_shade="shade")
        out_p = wf.trace_paths(mesh, o, d, cfg.seed, mmorton, spp, depth,
                               with_metrics=True)
        torch.cuda.synchronize()
        bad, err_same, err_all, f = _compare(out_k, out_p, depth)
        print(f"[pass-vs-plain] mesh_mid 512x512 Morton spp {s} depth "
              f"{depth}: good differs on {bad:.5f}, max|dL| {err_same:.3g} "
              f"(agreeing lanes) {err_all:.3g} (all), rays "
              f"{int(out_k[2]['rays'])}/{int(out_p[2]['rays'])}, shadow_rays "
              f"{int(out_k[2]['shadow_rays'])}/"
              f"{int(out_p[2]['shadow_rays'])}"
              + (" FAIL " + "; ".join(f) if f else ""), flush=True)
        fails.extend(f"mesh pass depth {depth}: {x}" for x in f)

    # ---- 9. mesh main path
    for name, path, gold in (
            ("parity_mesh_mid", MESH_MID, "golden_mesh_mid.is"),
            ("parity_mesh", MESH, "golden_mesh.is")):
        scn, c, f0 = load_scene_file(path, device=dev)
        n_p, got = main_path(name, scn, c,
                             Film(fov=f0.fov, width=size, height=size),
                             os.path.join(REPO, "tests", "goldens", gold))
        if name == "parity_mesh_mid":
            launches_mesh = got
        expect(name, got, k2_shade=6 * n_p, k3_bvh4_closest=6 * n_p,
               k4_bvh4_any=6 * n_p)

    # ---- 10. mesh time
    mpasses = 16

    def mesh_passes(s0):
        return [wf.render_sample(mesh, mcam, mfilm, mmorton, cfg.seed,
                                 s0 + s, 5) for s in range(mpasses)][-1]

    def pass_rays(scn, c, fm, ids, s0, np_, depth):
        total = 0
        for s in range(np_):
            o, d = generate_rays(c, fm, ids, stratified_jitter(
                cfg.seed, ids, s0 + s))
            _, _, m = wf.trace_paths(scn, o, d, cfg.seed, ids, s0 + s, depth,
                                     with_metrics=True, fast_shade="shade")
            total += int(m["rays"]) + int(m["shadow_rays"])
        return total

    med_m, t_m = _median5(lambda: mesh_passes(3000))
    rays_m = pass_rays(mesh, mcam, mfilm, mmorton, 3000, mpasses, 5)
    print(f"[time] {card}, parity_mesh_mid 512x512 depth 5, {mpasses} "
          f"passes through render_sample per run, median of 5: "
          f"{med_m / mpasses:.4f} ms/pass, {rays_m / (med_m / 1e3):.6g} "
          f"rays/s ({rays_m} rays + shadow rays per run; runs "
          f"{_runs(t_m)} ms)", flush=True)

    # bare kernels on the six bounces of one pass's real inputs, in the
    # order the route hands them over (ray_key-sorted for K3 and K4), as
    # launches on prebuilt inputs and outputs
    def sorted_rays(o, d, *extra):
        perm = torch.argsort(ray_key(o, d), stable=True)
        return tuple(x[perm].contiguous() for x in (o, d) + extra)

    k3_in = [sorted_rays(st[0], st[1]) for st, _, _ in recs]
    k4_in = [sorted_rays(out["shadow_o"], out["shadow_d"], out["dist_adj_t"])
             for _, _, out in recs]
    k2_in = [(st[1], hit, st[2], st[5], st[6], st[10], mspp, cfg.seed, b, 5)
             for b, (st, hit, _) in enumerate(recs)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    keep = []  # the prebuilt outputs stay alive while the pointers are used

    def empty(*shape, dtype=torch.float32):
        keep.append(torch.empty(shape, dtype=dtype, device=dev))
        return keep[-1].data_ptr()

    lib3, lib2 = bk.LIBRARY.load(), sk.LIBRARY.load()
    fat_args = (bvh.fat.data_ptr(), bvh.fat.shape[0], bvh.stack_size)
    k3_calls = [fat_args + (o.data_ptr(), d.data_ptr(), o.shape[0],
                            empty(o.shape[0]),
                            empty(o.shape[0], dtype=torch.int32), stream)
                for o, d in k3_in]
    k4_calls = [fat_args + (o.data_ptr(), d.data_ptr(), md.data_ptr(),
                            o.shape[0], empty(o.shape[0]), stream)
                for o, d, md in k4_in]
    tab2 = sk.shade_tables(mesh)
    k2_calls = [(tab2.data_ptr(), tab2.numel(),
                 mesh.materials.mat_type.shape[0],
                 mesh.lights.light_type.shape[0], d.data_ptr(),
                 hit.point.data_ptr(), hit.normal.data_ptr(),
                 hit.dpdu.data_ptr(), beta.data_ptr(), hit.t.data_ptr(),
                 hit.mat_id.data_ptr(), al.data_ptr(), psg.data_ptr(),
                 px.data_ptr(), sp.data_ptr(), 0, d.shape[0], seed, bo, dp,
                 sk.RR_START, 0, empty(7, d.shape[0], 3), empty(2, d.shape[0]),
                 empty(4, d.shape[0], dtype=torch.int32), stream)
                for d, hit, beta, al, psg, px, sp, seed, bo, dp in k2_in]
    bare = {
        "k3_bvh4_closest": lambda: [lib3.k3_closest_launch(*a)
                                    for a in k3_calls],
        "k2_shade": lambda: [lib2.k2_shade_launch(*a) for a in k2_calls],
        "k4_bvh4_any": lambda: [lib3.k4_any_launch(*a) for a in k4_calls]}
    plain = {
        "k3_bvh4_closest": lambda: [bvh4_closest_hit_stats(bvh, *a)
                                    for a in k3_in],
        "k2_shade": lambda: [sk.fused_shade_reference(mesh, *a)
                             for a in k2_in],
        "k4_bvh4_any": lambda: [bvh4_any_hit_stats(bvh, *a) for a in k4_in]}
    sources = {"k2_shade": ("craytracer_tpu_torch/csrc/shade_kernel.cu",
                            "craytracer_tpu/integrator/pallas_shade.py:240"),
               "k3_bvh4_closest": (
                   "craytracer_tpu_torch/csrc/bvh4_traverse.cu",
                   "craytracer_tpu/accel/pallas_bvh4.py:146"),
               "k4_bvh4_any": ("craytracer_tpu_torch/csrc/bvh4_traverse.cu",
                               "craytracer_tpu/accel/pallas_bvh4.py:451")}
    # bounds per launch, from this pass's inputs (the rows each launch's
    # rays pop, from the plain traversal's counters)
    def pops_and_bound(stats_fn, bvh_, *args):
        visits = torch.zeros(bvh_.fat.shape[0], dtype=torch.int64,
                             device=dev)
        pops = stats_fn(bvh_, *args, visits=visits)[-1]
        return pops, _pop_bound(bvh_, visits, args[0].shape[0])

    k3_pb = [pops_and_bound(bvh4_closest_hit_stats, bvh, *a) for a in k3_in]
    k4_pb = [pops_and_bound(bvh4_any_hit_stats, bvh, *a) for a in k4_in]
    k3_pops, k4_pops = [p for p, _ in k3_pb], [p for p, _ in k4_pb]
    lanes = [a[0].shape[0] for a in k3_in]
    bounds = {
        "k3_bvh4_closest": [b for _, b in k3_pb],
        "k4_bvh4_any": [b for _, b in k4_pb],
        "k2_shade": [_bound(nl * K2_LANE_BYTES, nl * SHADE_OPS)
                     for nl in lanes]}
    for name in ("k3_bvh4_closest", "k2_shade", "k4_bvh4_any"):
        med, ts = _median5(bare[name])
        if any(bare[name]()):
            fails.append(f"bare {name} launch failed")
        ms_plain = _timed(plain[name])[0] / len(recs)
        bms = sum(b for b, _ in bounds[name]) / len(recs)
        by = bounds[name][0][1]
        extra = ""
        if name != "k2_shade":
            pops = k3_pops if name == "k3_bvh4_closest" else k4_pops
            extra = (f", pops per lane mean "
                     f"{sum(int(p.sum()) for p in pops) / sum(lanes):.3f} max "
                     f"{max(int(p.max()) for p in pops)}")
        print(f"[time] {card}, {name} on the 6 bounces of one "
              f"parity_mesh_mid 512x512 pass: bare {med / len(recs):.4f} "
              f"ms/launch (runs of 6 {_runs(ts)} ms), plain "
              f"{ms_plain:.4f} ms/launch (timed once), bound {bms:.4f} "
              f"ms/launch ({by}){extra}", flush=True)
        src, rep = sources[name]
        kernels[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches_mesh[name], "ms": med / len(recs),
            "plain_ms": ms_plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None}

    # the city of bench_mesh.py:18-53 (327,680 triangles)
    builder = city_builder(327680)
    t0 = time.perf_counter()
    city = builder.build(device=dev)
    build_s = time.perf_counter() - t0
    n_city = city.triangles.mat_id.shape[0]
    ccam, cfilm = city_view(n_city, 256, device=dev)
    cids = torch.from_numpy(Renderer(city, ccam, cfilm, cfg).pixel_order()
                            ).to(dev)
    cpasses = 4
    med_c, t_c = _median5(lambda: [
        wf.render_sample(city, ccam, cfilm, cids, cfg.seed, 4000 + s, 4)
        for s in range(cpasses)])
    rays_c = pass_rays(city, ccam, cfilm, cids, 4000, cpasses, 4)
    print(f"[time] {card}, city {n_city} triangles ({city.tri_bvh.fat.shape[0]}"
          f" fat rows, stack {city.tri_bvh.stack_size}): host build "
          f"{build_s:.2f} s; 256x256 depth 4, {cpasses} passes through "
          f"render_sample per run, median of 5: {med_c / cpasses:.4f} "
          f"ms/pass, {rays_c / (med_c / 1e3):.6g} rays/s ({rays_c} rays + "
          f"shadow rays per run; runs {_runs(t_c)} ms)", flush=True)
    s0 = torch.zeros_like(cids)
    oc, dc = generate_rays(ccam, cfilm, cids,
                           stratified_jitter(cfg.seed, cids, s0))
    check_k3("city 256x256 camera rays", oc, dc, city.tri_bvh)
    st1 = wf._bounce_step(city, cfg.seed, s0, 4, 0,
                          wf._init_state(oc, dc, 4, cids), kernels=True)
    for label, o, d in (("camera", oc, dc), ("bounce-1", st1[0], st1[1])):
        os_, ds_ = sorted_rays(o, d)
        t_u = _median5(lambda: bk.bvh4_closest_hit_kernel(
            city.tri_bvh, o, d))[0]
        t_s = _median5(lambda: bk.bvh4_closest_hit_kernel(
            city.tri_bvh, os_, ds_))[0]
        pops, cb = pops_and_bound(bvh4_closest_hit_stats, city.tri_bvh, o, d)
        print(f"[time] {card}, city bare K3 on {o.shape[0]} {label} rays: "
              f"{t_u:.4f} ms unsorted (Morton pixel order), {t_s:.4f} ms "
              f"ray_key-sorted; bound {cb[0]:.4f} ms ({cb[1]}); pops per "
              f"lane mean {pops.double().mean().item():.3f} max "
              f"{int(pops.max())}", flush=True)

    # ---- 11. parity_mix: K1's full core vs plain
    from craytracer_tpu_torch.integrator.gate import F_OREN
    from craytracer_tpu_torch.scene import types as T

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_sphere_scenes as sphere_scenes

    mix, xcam, xfilm0 = load_scene_file(MIX, device=dev)
    xfilm = Film(fov=xfilm0.fov, width=size, height=size)
    print(f"[mix] parity_mix: {mix.spheres.mat_id.shape[0]} spheres, "
          f"{mix.rects.mat_id.shape[0]} rects, material types "
          f"{mix.mat_types_present}, feature mask {pk.shade_features(mix)}, "
          f"route {wf.production_fast_shade(mix, xcam, xfilm)}", flush=True)
    for depth, s in ((0, 0), (2, 0), (5, 0), (5, cfg.num_samples - 1)):
        check(f"parity_mix 512x512 Morton spp {s}", xfilm, morton,
              torch.full_like(morton, s), cfg.seed, depth, "strat", scn=mix,
              camera=xcam)
    lib_scenes = {}
    for name, build in sphere_scenes.SCENES.items():
        b = SceneBuilder()
        eye, look, fov, depth = build(b)
        lib_scenes[name] = (b.build(device=dev),
                            make_camera(eye, look, device=dev),
                            Film(fov=torch.tensor(fov, device=dev),
                                 width=size, height=size))
        for dp in (0, depth):
            check(f"{name} 512x512 Morton spp 0", lib_scenes[name][2],
                  morton, torch.zeros_like(morton), cfg.seed, dp, "strat",
                  scn=lib_scenes[name][0], camera=lib_scenes[name][1])

    # ---- 12. K2's full core vs plain on parity_mix and glass bounce states
    zspp = torch.zeros_like(morton)
    xrecs = {}
    for name, (scn, c, fm) in (("parity_mix", (mix, xcam, xfilm)),
                               ("glass_spheres",
                                lib_scenes["glass_spheres"])):
        o, d = generate_rays(c, fm, morton,
                             stratified_jitter(cfg.seed, morton, zspp))
        xrecs[name] = plain_records(scn, o, d, morton, zspp, 5)
        check_k2(name, scn, xrecs[name], zspp)

    # ---- 13. parity_mix per bounce (K2, plain sphere/rect intersection)
    def check_shade_route(label, scn, c, fm):
        """trace_paths through K2 (one launch per bounce, nothing else)
        against the plain trace_paths at 512x512 Morton lanes, spp 0,
        depth 0, 2 and 5; phase 3's bars."""
        o, d = generate_rays(c, fm, morton,
                             stratified_jitter(cfg.seed, morton, zspp))
        for depth in (0, 2, 5):
            reset_counts()
            out_k = wf.trace_paths(scn, o, d, cfg.seed, morton, zspp, depth,
                                   with_metrics=True, fast_shade="shade")
            got = counts()
            out_p = wf.trace_paths(scn, o, d, cfg.seed, morton, zspp, depth,
                                   with_metrics=True)
            torch.cuda.synchronize()
            bad, err_same, err_all, f = _compare(out_k, out_p, depth)
            print(f"[pass-vs-plain] {label} shade route 512x512 Morton spp 0 "
                  f"depth {depth}: launches {got}, good differs on "
                  f"{bad:.5f}, max|dL| {err_same:.3g} (agreeing lanes) "
                  f"{err_all:.3g} (all), rays {int(out_k[2]['rays'])}/"
                  f"{int(out_p[2]['rays'])}, shadow_rays "
                  f"{int(out_k[2]['shadow_rays'])}/"
                  f"{int(out_p[2]['shadow_rays'])}"
                  + (" FAIL " + "; ".join(f) if f else ""), flush=True)
            fails.extend(f"{label} shade route depth {depth}: {x}"
                         for x in f)
            expect(f"{label} shade route depth {depth}", got,
                   k2_shade=depth + 1)

    check_shade_route("parity_mix", mix, xcam, xfilm)

    # ---- 14. parity_mix main path
    n_p, launches_mix = main_path("parity_mix", mix, xcam, xfilm, GOLDEN_MIX)
    expect("parity_mix", launches_mix, k1_pass=n_p)

    # ---- 15. parity_mix time, Cornell on the full core, K2's full core
    xfeat = pk.shade_features(mix)
    timed_passes(pk.fused_pass, 1000, mix, xcam, xfilm)
    timed_passes(pk.fused_pass_reference, 1000, mix, xcam, xfilm)
    timed_kernel(1000, mix, xcam, xfilm)
    tx_k, tx_w, tx_p, rays_x = [], [], [], []
    for rep_ in range(5):
        spp0 = 2000 + passes * rep_
        ms, rays = timed_kernel(spp0, mix, xcam, xfilm)
        tx_k.append(ms)
        rays_x.append(rays)
        ms, out_k = timed_passes(pk.fused_pass, spp0, mix, xcam, xfilm)
        tx_w.append(ms)
        ms, out_p = timed_passes(pk.fused_pass_reference, spp0, mix, xcam,
                                 xfilm)
        tx_p.append(ms)
    check(f"parity_mix 512x512 raster spp {spp0 + passes - 1} (timed)",
          xfilm, pix, spp0 + passes - 1, 0, 5, "plain", out_k, out_p)
    mxk, mxw, mxp = (statistics.median(t) for t in (tx_k, tx_w, tx_p))
    nx_rays, nx_shadow = rays_x[tx_k.index(mxk)]
    def lobe_ops(scn):
        """What shade_core<true> adds per hit lane of each material."""
        return {T.MAT_MATTE: OREN_OPS if pk.shade_features(scn) & F_OREN
                else 0,
                T.MAT_MIRROR: MIRROR_OPS, T.MAT_PLASTIC: PLASTIC_OPS,
                T.MAT_METAL: METAL_OPS, T.MAT_TRANSPARENT: TRANSPARENT_OPS,
                T.MAT_GLASS: GLASS_OPS}

    def k1_pass_ops(scn, recs_, lens=False):
        """The operations one K1 pass needs, from a plain pass's records
        (Morton, spp 0): per bounce, every live lane's prim tests and
        shading, each hit lane's material lobe, each shadow ray's prim
        tests; the thin-lens raygen once per lane."""
        prim = sum(k * c for k, c in zip(ROW_OPS, pk.table_counts(scn)[2:]))
        extra = lobe_ops(scn)
        ops = LENS_OPS * recs_[0][0][0].shape[0] if lens else 0
        for st, hit, out in recs_:
            live = st[5] & (hit.t < TMAX)
            mt = scn.materials.mat_type[hit.mat_id.long()][live]
            ops += int(st[5].sum()) * (prim + SHADE_OPS)
            ops += sum(int((mt == m).sum()) * v for m, v in extra.items())
            ops += int(out["want_shadow"].sum()) * prim
        return ops

    ops_x = k1_pass_ops(mix, xrecs["parity_mix"])
    extra = lobe_ops(mix)
    tab_x = pk.kernel_tables(mix, xcam, xfilm)
    kx_bound = _bound(tab_x.numel() * 4 + size * size * (8 + 28), ops_x)
    print(f"[time] {card}, parity_mix 512x512 depth 5, {passes} passes per "
          f"run, median of 5: K1 launch {mxk / passes:.4f} ms/pass "
          f"({(nx_rays + nx_shadow) / (mxk / 1e3):.6g} rays/s; runs "
          f"{_runs(tx_k)} ms); K1 through fused_pass {mxw / passes:.4f} "
          f"ms/pass ({(nx_rays + nx_shadow) / (mxw / 1e3):.6g} rays/s; runs "
          f"{_runs(tx_w)} ms); plain PyTorch {mxp / passes:.4f} ms/pass (runs "
          f"{_runs(tx_p)} ms); {nx_rays} rays + {nx_shadow} shadow rays per "
          f"run; K1 bound {kx_bound[0]:.4f} ms/pass ({kx_bound[1]}, "
          f"{ops_x} operations per pass)", flush=True)
    # Cornell on the full core against the matte-only core, in turns
    t_c0, t_cf = [], []
    for rep_ in range(5):
        for full, ts_ in ((False, t_c0), (True, t_cf)):
            ts_.append(timed_kernel(3000 + passes * rep_, full=full)[0])
    print(f"[time] {card}, cornell 512x512 depth 5, bare K1 in turns, median "
          f"of 5: matte-only core {statistics.median(t_c0) / passes:.4f} "
          f"ms/pass (runs {_runs(t_c0)} ms), full core "
          f"{statistics.median(t_cf) / passes:.4f} ms/pass (runs "
          f"{_runs(t_cf)} ms)", flush=True)
    # bare K2 (full core) on the six bounces of parity_mix's plain pass
    tab2x = sk.shade_tables(mix)
    k2x_calls = [(tab2x.data_ptr(), tab2x.numel(),
                  mix.materials.mat_type.shape[0],
                  mix.lights.light_type.shape[0], st[1].data_ptr(),
                  hit.point.data_ptr(), hit.normal.data_ptr(),
                  hit.dpdu.data_ptr(), st[2].data_ptr(), hit.t.data_ptr(),
                  hit.mat_id.data_ptr(), st[5].data_ptr(), st[6].data_ptr(),
                  st[10].data_ptr(), zspp.data_ptr(), 0, st[1].shape[0],
                  cfg.seed, b, 5, sk.RR_START, int(xfeat != 0),
                  empty(7, st[1].shape[0], 3), empty(2, st[1].shape[0]),
                  empty(4, st[1].shape[0], dtype=torch.int32), stream)
                 for b, (st, hit, _) in enumerate(xrecs["parity_mix"])]
    med2x, ts2x = _median5(lambda: [lib2.k2_shade_launch(*a)
                                    for a in k2x_calls])
    ms2x_plain = _timed(lambda: [
        sk.fused_shade_reference(mix, st[1], hit, st[2], st[5], st[6],
                                 st[10], zspp, cfg.seed, b, 5)
        for b, (st, hit, _) in enumerate(xrecs["parity_mix"])])[0] / 6
    ops2x = sum(int(st[5].sum()) * SHADE_OPS + sum(
        int((mix.materials.mat_type[hit.mat_id.long()][st[5] & (hit.t < TMAX)]
             == m).sum()) * v for m, v in extra.items())
        for st, hit, _ in xrecs["parity_mix"])
    b2x = _bound(6 * size * size * K2_LANE_BYTES, ops2x)
    print(f"[time] {card}, k2_shade (full core) on the 6 bounces of one "
          f"parity_mix 512x512 pass: bare {med2x / 6:.4f} ms/launch (runs of "
          f"6 {_runs(ts2x)} ms), plain {ms2x_plain:.4f} ms/launch (timed "
          f"once), bound {b2x[0] / 6:.4f} ms/launch ({b2x[1]})", flush=True)
    kernels["k1_pass"].update(
        launches=launches_mix["k1_pass"], ms=mxk / passes,
        plain_ms=mxp / passes, bound_ms=kx_bound[0], bound_by=kx_bound[1])

    # ---- 16. K1 vs plain: planes, disks, boxes, thin lens
    import torch_prim_scenes as prim_scenes

    bounce_scenes = {}
    for name, build in prim_scenes.SCENES.items():
        b = SceneBuilder()
        eye, look, fov, _ = build(b)
        bounce_scenes[name] = (b.build(device=dev),
                               make_camera(eye, look, device=dev),
                               Film(fov=torch.tensor(fov, device=dev),
                                    width=size, height=size))
    bounce_scenes["thinlens_cornell"] = (scene, prim_scenes.thinlens(cam),
                                         film)
    for name, (scn, c, fm) in bounce_scenes.items():
        c_ = pk.table_counts(scn)
        print(f"[prims] {name}: rows (sph, pl, rect, dsk, tri, box) "
              f"{tuple(c_[2:])}, camera type {c.camera_type}, feature mask "
              f"{pk.shade_features(scn)}, route "
              f"{wf.production_fast_shade(scn, c, fm)}", flush=True)
        if wf.production_fast_shade(scn, c, fm) != "bounce":
            fails.append(f"{name} is not on K1's route")
        for raygen in (("strat", "plain") if name == "thinlens_cornell"
                       else ("strat",)):
            for depth, s in ((0, 0), (2, 0), (5, 0), (5, cfg.num_samples - 1)):
                check(f"{name} 512x512 Morton spp {s}", fm, morton,
                      torch.full_like(morton, s), cfg.seed, depth, raygen,
                      scn=scn, camera=c)

    # ---- 17. parity_prims through the "shade" route, K2 on its hits
    prims, pcam, pfilm0 = load_scene_file(PRIMS, device=dev)
    pfilm = Film(fov=pfilm0.fov, width=size, height=size)
    print(f"[prims] parity_prims: instanced kinds "
          f"{prims.instanced.kind.tolist()}, {prims.disks.mat_id.shape[0]} "
          f"disks, {prims.rects.mat_id.shape[0]} rects, route "
          f"{wf.production_fast_shade(prims, pcam, pfilm)}", flush=True)
    if wf.production_fast_shade(prims, pcam, pfilm) != "shade":
        fails.append("parity_prims is not on the shade route")
    check_shade_route("parity_prims", prims, pcam, pfilm)
    o, d = generate_rays(pcam, pfilm, morton,
                         stratified_jitter(cfg.seed, morton, zspp))
    check_k2("parity_prims", prims, plain_records(prims, o, d, morton, zspp,
                                                  5), zspp)

    # ---- 18. parity_prims main path; the AABOX scene's main path
    n_p, got = main_path("parity_prims", prims, pcam, pfilm, GOLDEN_PRIMS)
    expect("parity_prims", got, k2_shade=6 * n_p)
    n_p, got = main_path("aabox", *bounce_scenes["aabox"])
    expect("aabox", got, k1_pass=n_p)

    # ---- 19. times: bare K1 on the new scenes, parity_prims per pass
    for name, (scn, c, fm) in bounce_scenes.items():
        lens = c.camera_type == THINLENS
        o, d = wf.camera_rays(c, fm, morton, cfg.seed, zspp,
                              stratified_jitter(cfg.seed, morton, zspp))
        ops_ = k1_pass_ops(scn, plain_records(scn, o, d, morton, zspp, 5),
                           lens)
        bnd = _bound(pk.kernel_tables(scn, c, fm).numel() * 4
                     + size * size * (8 + 28), ops_)
        timed_kernel(1000, scn, c, fm)
        tk, rays_ = [], []
        for rep_ in range(5):
            ms, rays = timed_kernel(2000 + passes * rep_, scn, c, fm)
            tk.append(ms)
            rays_.append(rays)
        med = statistics.median(tk)
        nr_, ns_ = rays_[tk.index(med)]
        ms_plain = timed_passes(pk.fused_pass_reference, 2000, scn, c, fm)[0]
        print(f"[time] {card}, {name} 512x512 depth 5, {passes} passes per "
              f"run, median of 5: K1 launch {med / passes:.4f} ms/pass "
              f"({(nr_ + ns_) / (med / 1e3):.6g} rays/s; runs {_runs(tk)} "
              f"ms); plain PyTorch {ms_plain / passes:.4f} ms/pass (timed "
              f"once); {nr_} rays + {ns_} shadow rays per run; K1 bound "
              f"{bnd[0]:.4f} ms/pass ({bnd[1]}, {ops_} operations per pass)",
              flush=True)

    def prims_passes(s0):
        return [wf.render_sample(prims, pcam, pfilm, morton, cfg.seed, s0 + s,
                                 5) for s in range(passes)][-1]

    med_pr, t_pr = _median5(lambda: prims_passes(3000))
    rays_pr = pass_rays(prims, pcam, pfilm, morton, 3000, passes, 5)
    print(f"[time] {card}, parity_prims 512x512 depth 5, {passes} passes "
          f"through render_sample per run, median of 5: "
          f"{med_pr / passes:.4f} ms/pass, {rays_pr / (med_pr / 1e3):.6g} "
          f"rays/s ({rays_pr} rays + shadow rays per run; runs "
          f"{_runs(t_pr)} ms)", flush=True)

    # ---- 20. the 7M city through the parts route (the slice's main path)
    t0 = time.perf_counter()
    big_builder = city_builder(CITY_TRIS)
    t_tris = time.perf_counter() - t0
    t0 = time.perf_counter()
    big = big_builder.build(device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    del big_builder
    parts = big.tri_parts or ()
    n_big = big.triangles.mat_id.shape[0]
    fat_bytes = big.tri_bvh.fat.numel() * 4
    t0 = time.perf_counter()
    again = bvh4_parts.partition_bvh4(big.tri_bvh,
                                      bvh4_parts.PART_BUDGET_BYTES)
    t_part = time.perf_counter() - t0
    same_cut = len(again) == len(parts) and all(
        torch.equal(a.fat, b.fat) and a.stack_size == b.stack_size
        for a, b in zip(again, parts))
    del again
    print(f"[city] {card}, {n_big} triangles, {big.tri_bvh.fat.shape[0]} "
          f"fat rows ({fat_bytes} bytes, stack {big.tri_bvh.stack_size}), "
          f"{len(parts)} parts under the {bvh4_parts.PART_BUDGET_BYTES}-byte "
          f"budget; host: triangles {t_tris:.2f} s, SceneBuilder.build (SAH "
          f"BVH4, partition, copy to the card) {t_build:.2f} s, "
          f"partition_bvh4 alone {t_part:.2f} s, the same parts {same_cut}",
          flush=True)
    print(f"[city] parts (rows, stack size): "
          f"{[(p.fat.shape[0], p.stack_size) for p in parts]}", flush=True)
    ids = torch.cat([p.fat[:, 37:108:10].reshape(-1) for p in parts])
    ids = torch.sort(ids[ids >= 0].long()).values
    if len(parts) < 3 or not same_cut or any(
            p.fat.numel() * 4 > bvh4_parts.PART_BUDGET_BYTES for p in parts):
        fails.append(f"city: {len(parts)} parts, same cut {same_cut}")
    if not torch.equal(ids, torch.arange(n_big, device=dev)):
        fails.append("city: a triangle is not in exactly one part")
    del ids
    bcam, bfilm = city_view(n_big, size, device=dev)
    bcfg = RenderConfig(num_samples=CITY_SPP, max_depth=5,
                        estimator="reference")
    n_p, launches_city = main_path("city_7m", big, bcam, bfilm, config=bcfg)
    expect("city_7m", launches_city, k2_shade=6 * n_p,
           k3_init_bvh4_closest=6 * n_p * len(parts),
           k4_bvh4_any=6 * n_p * len(parts))
    bids = torch.from_numpy(Renderer(big, bcam, bfilm, bcfg).pixel_order()
                            ).to(dev)
    bpasses = 3
    med_b, t_b = _median5(lambda: [
        wf.render_sample(big, bcam, bfilm, bids, cfg.seed, 5000 + s, 5)
        for s in range(bpasses)])
    rays_b = pass_rays(big, bcam, bfilm, bids, 5000, bpasses, 5)
    print(f"[time] {card}, city {n_big} triangles ({len(parts)} parts) "
          f"512x512 depth 5, {bpasses} passes through render_sample per run, "
          f"median of 5: {med_b / bpasses:.4f} ms/pass, "
          f"{rays_b / (med_b / 1e3):.6g} rays/s ({rays_b} rays + shadow "
          f"rays per run; runs {_runs(t_b)} ms)", flush=True)

    # ---- 21. K3 _init vs plain per part; the parts route vs monolithic
    bspp = torch.zeros_like(bids)
    ob, db = generate_rays(bcam, bfilm, bids,
                           stratified_jitter(cfg.seed, bids, bspp))
    bst0 = wf._init_state(ob, db, 5, bids)
    bst1 = wf._bounce_step(big, cfg.seed, bspp, 5, 0, bst0, kernels=True)

    def route_order(o, d):
        """The rays in the order the route walks the parts in: the
        ray_key sort, then the part sort."""
        o, d = sorted_rays(o, d)
        perm = bvh4_parts.part_sort(parts, o, d)[1]
        return o[perm].contiguous(), d[perm].contiguous()

    walks = {}  # label -> rays and per part (in, out, visits, pops)
    for label, st in (("camera", bst0), ("bounce-1", bst1)):
        o, d = route_order(st[0], st[1])
        t = torch.full((o.shape[0],), TMAX, device=dev)
        tri = torch.full((o.shape[0],), -1, dtype=torch.int32, device=dev)
        steps, bit_eq, replaced = [], 0, []
        for p in parts:
            t_k, tri_k = bk.bvh4_closest_hit_init_kernel(p, o, d, t, tri)
            visits = torch.zeros(p.fat.shape[0], dtype=torch.int64,
                                 device=dev)
            t_p, tri_p, pops = bvh4_closest_hit_init_stats(
                p, o, d, t, tri, visits=visits)
            eq = torch.equal(t_k, t_p) and torch.equal(tri_k, tri_p)
            bit_eq += eq
            both = (t_k < TMAX) & (t_p < TMAX)
            if bool(both.any()):
                err["k3_init_bvh4_closest"] = max(
                    err["k3_init_bvh4_closest"],
                    (t_k - t_p)[both].abs().max().item())
            if not eq:
                fails.append(f"K3 _init {label} part {len(steps)}")
            replaced.append(int((tri_p != tri).sum()))
            steps.append((p, t, tri, t_p, tri_p, visits, pops))
            t, tri = t_p, tri_p
        t_m, tri_m = bk.bvh4_closest_hit_kernel(big.tri_bvh, o, d)
        t_r, tri_r = bvh4_parts.parts_closest_hit_kernel(parts, o, d)
        t_eq = torch.equal(t, t_m) and torch.equal(t_r, t)
        ties = int(((t == t_m) & (tri != tri_m)).sum())
        print(f"[k3-init-vs-plain] city {label} rays {o.shape[0]}: K3 _init "
              f"bit-equal with the plain version on {bit_eq} of "
              f"{len(parts)} parts (t and ids, every lane); lanes whose "
              f"best hit a part replaced: {replaced}; the parts route vs "
              f"monolithic K3: t bit-equal {t_eq}, hits "
              f"{int((t < TMAX).sum())}, lanes whose id differs on an exact tie of t {ties}"
              + ("" if t_eq and bit_eq == len(parts) else " FAIL"),
              flush=True)
        if not t_eq:
            fails.append(f"city {label}: parts route t differs from K3")
        walks[label] = (o, d, steps, t_m, tri_m)
    # K2 vs plain on the city's bounce-0 and bounce-1 hit records (the
    # parts route's), then the shadow rays of the plain shade through the
    # parts any hit
    city_recs = {}
    for b, st in ((0, bst0), (1, bst1)):
        hit = intersect_scene(big, st[0], st[1], kernels=True)
        city_recs[b] = (st, hit, sk.fused_shade_reference(
            big, st[1], hit, st[2], st[5], st[6], st[10], bspp, cfg.seed, b,
            5))
    check_k2("city", big, city_recs, bspp, bounces=(0, 1))
    for b in (0, 1):
        out = city_recs[b][2]
        so, sd, smd, sadj = sorted_rays(out["shadow_o"], out["shadow_d"],
                                        out["dist_adj_t"], out["dist_adj"])
        t_pa = bvh4_parts.parts_any_hit_kernel(parts, so, sd, smd)
        # K4 on every part against the plain any hit on the same inputs:
        # the max_dist the route carries in (0 on lanes occluded before)
        best_p = torch.full_like(smd, TMAX)
        md, k4_eq = smd, 0
        for p in parts:
            t_k = bk.bvh4_any_hit_kernel(p, so, sd, md)
            t_p = bvh4_any_hit_stats(p, so, sd, md)[0]
            k4_eq += torch.equal(t_k, t_p)
            both = (t_k < TMAX) & (t_p < TMAX)
            if bool(both.any()):
                err["k4_bvh4_any"] = max(err["k4_bvh4_any"],
                                         (t_k - t_p)[both].abs().max().item())
            best_p = torch.minimum(best_p, t_p)
            md = torch.where(best_p < smd, 0.0, smd)
        route_eq = torch.equal(t_pa, best_p)
        t_pl = bvh4_parts.parts_any_hit(parts, so, sd, smd)
        t_mo = bk.bvh4_any_hit_kernel(big.tri_bvh, so, sd, smd)
        t_mp = bvh4_any_hit_stats(big.tri_bvh, so, sd, smd)[0]
        mono_eq = torch.equal(t_mo, t_mp)
        occ = t_mp < smd
        same_v = all(torch.equal(x < smd, occ) for x in (t_pa, t_pl, t_mo))
        band = sadj - torch.clamp(1e-3 * sadj, min=K_EPSILON)
        lit = ((t_pa >= band) == (t_mo >= band)).double().mean().item()
        ok = k4_eq == len(parts) and route_eq and mono_eq and same_v
        print(f"[parts-any-vs-plain] city bounce-{b} shadow rays "
              f"{so.shape[0]}, occluded {int(occ.sum())}: K4 bit-equal with "
              f"the plain any hit on {k4_eq} of {len(parts)} parts (the "
              f"route's carried max_dist), the route's t bit-equal with the "
              f"plain chain {route_eq}; monolithic K4 bit-equal with plain "
              f"{mono_eq}; verdicts of the route, the plain parts any hit, "
              f"monolithic K4 and its plain version equal on every lane "
              f"{same_v}; lit (route vs monolithic K4) agrees on {lit:.6f}"
              + ("" if ok else " FAIL"), flush=True)
        if not ok:
            fails.append(f"city bounce-{b}: parts any hit")
    del city_recs, out

    # ---- 22. K5 on the city's monolithic table and its parts
    o, d, steps, t_m, tri_m = walks["camera"]
    topo_m = sp.split_topology(big.tri_bvh)
    topos = [sp.split_topology(p) for p in parts]
    t_pm, tri_pm, _ = bvh4_closest_hit_stats(big.tri_bvh, o, d)
    half = (torch.arange(o.shape[0], device=dev) % 2 == 0) & (t_pm < TMAX)
    t0h = torch.where(half, t_pm * 0.5, torch.full_like(t_pm, TMAX))
    tri0h = torch.where(half, 7777, -1).to(torch.int32)
    k5_checks = []
    k5_out = sp.bvh4_closest_hit_split_kernel(big.tri_bvh, o, d, topo=topo_m)
    k5_checks.append(("whole table, no carried hit", k5_out, (t_pm, tri_pm),
                      (t_m, tri_m)))
    k5_out = sp.bvh4_closest_hit_split_kernel(big.tri_bvh, o, d, t0h, tri0h,
                                              topo=topo_m)
    k5_checks.append((
        "whole table, half the lanes carried",
        k5_out, bvh4_closest_hit_init_stats(big.tri_bvh, o, d, t0h,
                                            tri0h)[:2],
        bk.bvh4_closest_hit_init_kernel(big.tri_bvh, o, d, t0h, tri0h)))
    for k, (p, t_in, tri_in, t_p, tri_p, _, _) in enumerate(steps):
        k5_checks.append((
            f"part {k}, the route's carried hit",
            sp.bvh4_closest_hit_split_kernel(p, o, d, t_in, tri_in,
                                             topo=topos[k]),
            (t_p, tri_p), bk.bvh4_closest_hit_init_kernel(p, o, d, t_in,
                                                          tri_in)))
        k5_checks.append((
            f"part {k}, no carried hit",
            sp.bvh4_closest_hit_split_kernel(p, o, d, topo=topos[k]),
            bvh4_closest_hit_stats(p, o, d)[:2],
            bk.bvh4_closest_hit_kernel(p, o, d)))
    k5_bad = []
    for label, (t5, tri5), (tp_, trp_), (tk_, trk_) in k5_checks:
        ok = (torch.equal(t5, tp_) and torch.equal(tri5, trp_)
              and torch.equal(t5, tk_) and torch.equal(tri5, trk_))
        both = (t5 < TMAX) & (tp_ < TMAX)
        if bool(both.any()):
            err["k5_bvh4_split"] = max(err["k5_bvh4_split"],
                                       (t5 - tp_)[both].abs().max().item())
        if not ok:
            k5_bad.append(label)
    print(f"[k5-vs-plain] city camera rays {o.shape[0]}: K5 bit-equal with "
          f"the plain version and with K3 / K3 _init on "
          f"{len(k5_checks) - len(k5_bad)} of {len(k5_checks)} tables "
          f"(the whole table with and without a carried hit, every part "
          f"with the route's carried hit and without one)"
          + (f" FAIL {k5_bad}" if k5_bad else ""), flush=True)
    fails.extend(f"K5 city {x}" for x in k5_bad)
    del k5_checks, k5_out
    t_k3m = _median5(lambda: bk.bvh4_closest_hit_kernel(big.tri_bvh, o, d))
    t_k5m = _median5(lambda: sp.bvh4_closest_hit_split_kernel(
        big.tri_bvh, o, d, topo=topo_m))
    t_k3p = _median5(lambda: [bk.bvh4_closest_hit_init_kernel(
        p, o, d, t_in, tri_in) for p, t_in, tri_in, *_ in steps])
    t_k5p = _median5(lambda: [sp.bvh4_closest_hit_split_kernel(
        p, o, d, t_in, tri_in, topo=topos[k])
        for k, (p, t_in, tri_in, *_) in enumerate(steps)])
    print(f"[time] {card}, city {o.shape[0]} camera rays (route order), "
          f"median of 5: whole table bare K3 {t_k3m[0]:.4f} ms, bare K5 "
          f"{t_k5m[0]:.4f} ms; the {len(parts)} parts, the route's carried "
          f"hits: bare K3 _init {t_k3p[0]:.4f} ms, bare K5 {t_k5p[0]:.4f} ms "
          f"(all parts; runs K3 {_runs(t_k3m[1])}; K5 {_runs(t_k5m[1])}; "
          f"K3 _init {_runs(t_k3p[1])}; K5 parts {_runs(t_k5p[1])} ms); "
          f"parts route / whole-table K3 {t_k3p[0] / t_k3m[0]:.3f}",
          flush=True)
    # per launch, over both ray sets: bare K3 _init and K5, plain, bounds
    k3i_ms, k3i_plain, k3i_bounds, k5_bounds = 0.0, 0.0, [], []
    n_launch = 0
    for label in walks:
        o_, d_, steps_, _, _ = walks[label]
        k3i_ms += _median5(lambda: [bk.bvh4_closest_hit_init_kernel(
            p, o_, d_, t_in, tri_in) for p, t_in, tri_in, *_ in steps_])[0]
        k3i_plain += _timed(lambda: [bvh4_closest_hit_init_stats(
            p, o_, d_, t_in, tri_in) for p, t_in, tri_in, *_ in steps_])[0]
        for p, _, _, _, _, visits, _ in steps_:
            k3i_bounds.append(_pop_bound(p, visits, o_.shape[0], 40))
            k5_bounds.append(_pop_bound(p, visits, o_.shape[0], 40, True))
        n_launch += len(steps_)
    k5_ms = t_k5p[0] / len(parts)
    k5_plain = _timed(lambda: [bvh4_closest_hit_init_stats(
        p, o, d, t_in, tri_in) for p, t_in, tri_in, *_ in steps])[0] / len(
        parts)
    k5_bound = k5_bounds[:len(parts)]
    pops_all = [int(st[6].sum()) for lb in walks for st in walks[lb][2]]
    print(f"[time] {card}, k3_init_bvh4_closest per launch on the city "
          f"(camera and bounce-1 rays, every part): bare "
          f"{k3i_ms / n_launch:.4f} ms, plain {k3i_plain / n_launch:.4f} ms "
          f"(timed once), bound "
          f"{sum(b for b, _ in k3i_bounds) / n_launch:.4f} ms "
          f"({k3i_bounds[0][1]}); pops per lane and part mean "
          f"{sum(pops_all) / (n_launch * o.shape[0]):.3f}; k5_bvh4_split "
          f"per launch on the camera rays' parts: bare {k5_ms:.4f} ms, "
          f"plain {k5_plain:.4f} ms, bound "
          f"{sum(b for b, _ in k5_bound) / len(parts):.4f} ms "
          f"({k5_bound[0][1]})", flush=True)
    kernels["k3_init_bvh4_closest"] = {
        "name": "k3_init_bvh4_closest", "route": "cuda",
        "source": "craytracer_tpu_torch/csrc/bvh4_traverse.cu",
        "replaces": "craytracer_tpu/accel/pallas_bvh4.py:126",
        "launches": launches_city["k3_init_bvh4_closest"],
        "ms": k3i_ms / n_launch, "plain_ms": k3i_plain / n_launch,
        "bound_ms": sum(b for b, _ in k3i_bounds) / n_launch,
        "bound_by": k3i_bounds[0][1], "library_ms": None}
    kernels["k5_bvh4_split"] = {
        "name": "k5_bvh4_split", "route": "cuda",
        "source": "craytracer_tpu_torch/csrc/bvh4_split.cu",
        "replaces": "craytracer_tpu/accel/pallas_bvh4.py:683",
        "launches": launches_city["k5_bvh4_split"], "ms": k5_ms,
        "plain_ms": k5_plain,
        "bound_ms": sum(b for b, _ in k5_bound) / len(parts),
        "bound_by": k5_bound[0][1], "library_ms": None}
    del walks, steps, topos, topo_m

    # ---- 23. K6 on parity_mesh_mid's triangles and camera rays
    soa = tri_kernel.pack_triangles(*(x.cpu().numpy() for x in (
        mesh.triangles.v0, mesh.triangles.v1, mesh.triangles.v2)),
        device=dev)
    t6, i6 = tri_kernel.triangle_closest_kernel(o_cam, d_cam, soa)
    ms6_plain, (t6p, i6p) = _timed(
        lambda: tri_kernel.triangle_closest(o_cam, d_cam, soa))
    eq6 = torch.equal(t6, t6p) and torch.equal(i6, i6p)
    both = (t6 < TMAX) & (t6p < TMAX)
    err["k6_tri_closest"] = ((t6 - t6p)[both].abs().max().item()
                             if bool(both.any()) else 0.0)
    med6, ts6 = _median5(
        lambda: tri_kernel.triangle_closest_kernel(o_cam, d_cam, soa))
    pairs = o_cam.shape[0] * soa.shape[1]
    b6 = _bound(soa.numel() * 4 + o_cam.shape[0] * 32, pairs * K6_OPS)
    print(f"[k6-vs-plain] parity_mesh_mid {soa.shape[1]} table columns "
          f"({mesh.triangles.mat_id.shape[0]} triangles) x {o_cam.shape[0]} "
          f"camera rays: t and idx bit-equal on every lane {eq6}, hits "
          f"{int((i6p >= 0).sum())}" + ("" if eq6 else " FAIL"), flush=True)
    print(f"[time] {card}, k6_tri_closest on those rays, median of 5: bare "
          f"{med6:.4f} ms (runs {_runs(ts6)} ms), plain {ms6_plain:.4f} ms "
          f"(timed once), bound {b6[0]:.4f} ms ({b6[1]}, {pairs} pair "
          f"tests)", flush=True)
    if not eq6:
        fails.append("K6 parity_mesh_mid")
    kernels["k6_tri_closest"] = {
        "name": "k6_tri_closest", "route": "cuda",
        "source": "craytracer_tpu_torch/csrc/tri_closest.cu",
        "replaces": "craytracer_tpu/ops/pallas_tri.py:35",
        "launches": launches_city["k6_tri_closest"], "ms": med6,
        "plain_ms": ms6_plain, "bound_ms": b6[0], "bound_by": b6[1],
        "library_ms": None}
    del soa, t6, i6, t6p, i6p

    # ---- 24. P1 on the city's fat table
    fat_c = big.tri_bvh.fat
    o4, d4 = sorted_rays(ob, db)
    p1_bad = []
    for mode in pp.MODES:
        tk1, sk1 = pp.pop_probe_kernel(fat_c, o4[:128].contiguous(),
                                       d4[:128].contiguous(), mode, 48)
        tp1, sp1 = pp.pop_probe(fat_c, o4[:128], d4[:128], mode, 48)
        if not (torch.equal(tk1, tp1) and torch.equal(sk1, sp1)):
            p1_bad.append(mode)
        fin = (tk1 < 1e30) & (tp1 < 1e30)
        if bool(fin.any()):
            err["p1_pop_probe"] = max(err["p1_pop_probe"],
                                      (tk1 - tp1)[fin].abs().max().item())
    print(f"[p1-vs-plain] city fat table, 4 packets, 48 pops: t and sink "
          f"bit-equal in {len(pp.MODES) - len(p1_bad)} of {len(pp.MODES)} "
          f"modes" + (f" FAIL {p1_bad}" if p1_bad else ""), flush=True)
    fails.extend(f"P1 mode {m}" for m in p1_bad)
    packets = 4224
    op, dp = o4[:packets * pp.PACKET].contiguous(), d4[
        :packets * pp.PACKET].contiguous()
    per_pop = pp.measure(fat_c, op, dp, pops=512)
    print(f"[time] {card}, p1_pop_probe on the city fat table, {packets} "
          f"packets of 32 camera rays, slope between 512 and 1536 pops "
          f"(median of 5 each): ns per pop of the launch "
          f"{json.dumps({k: round(v[0], 3) for k, v in per_pop.items()})}; "
          f"ns per packet-pop "
          f"{json.dumps({k: round(v[1], 5) for k, v in per_pop.items()})}",
          flush=True)
    p1_pops = 128
    med_p1, ts_p1 = _median5(lambda: pp.pop_probe_kernel(fat_c, op, dp,
                                                         "full", p1_pops))
    ms_p1_plain, (tpf, spf) = _timed(lambda: pp.pop_probe(
        fat_c, op, dp, "full", p1_pops))
    tkf, skf = pp.pop_probe_kernel(fat_c, op, dp, "full", p1_pops)
    eq_p1 = torch.equal(tkf, tpf) and torch.equal(skf, spf)
    fin = (tkf < 1e30) & (tpf < 1e30)
    if bool(fin.any()):
        err["p1_pop_probe"] = max(err["p1_pop_probe"],
                                  (tkf - tpf)[fin].abs().max().item())
    if not eq_p1:
        fails.append("P1 full mode at the timed size")
    rows_p1 = len(set(pp.lcg_nodes(p1_pops, fat_c.shape[0])))
    b_p1 = _bound(rows_p1 * ROW_BYTES + op.shape[0] * 32,
                  op.shape[0] * p1_pops * (4 * BOX_OPS + 8 * SLOT_OPS
                                           + SORT_OPS))
    print(f"[time] {card}, p1_pop_probe full mode, {op.shape[0]} lanes x "
          f"{p1_pops} pops, median of 5: bare {med_p1:.4f} ms (runs "
          f"{_runs(ts_p1)} ms), plain {ms_p1_plain:.4f} ms (timed once), "
          f"bound {b_p1[0]:.4f} ms ({b_p1[1]}); t and sink bit-equal "
          f"with the plain version {eq_p1}" + ("" if eq_p1 else " FAIL"),
          flush=True)
    kernels["p1_pop_probe"] = {
        "name": "p1_pop_probe", "route": "cuda",
        "source": "craytracer_tpu_torch/csrc/pop_probe.cu",
        "replaces": "profiling/ablate_pallas_pop.py:43",
        "launches": launches_city["p1_pop_probe"], "ms": med_p1,
        "plain_ms": ms_p1_plain, "bound_ms": b_p1[0], "bound_by": b_p1[1],
        "library_ms": None}

    if fails:
        for f in fails:
            print(f"FAIL: {f}")
        return 1
    for name in kernels:
        kernels[name]["max_abs_err"] = err[name]
    print(json.dumps({"kernels": [kernels[k] for k in counters]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
