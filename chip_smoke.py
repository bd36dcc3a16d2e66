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
   kernel and instantiation (K1's eight: the matte-only or the full core,
   with or without plane/disk rows, with or without box rows; K2 once
   per feature mask the run meets: 0, the matte-only core, and
   parity_mix's and glass_spheres' masks, each with its lobes only);
   beside them, in a thread, builds the native scene runtime
   (native/craynative.cpp) and the image decoders (csrc/imgdecode.cpp)
   with g++.
3. K1 vs plain: K1 against its plain PyTorch version on the card, on
   scenes/parity_cornell.txt at 64x64, depth 0, 2 and 5, scalar and
   per-lane spp, both raygen variants; then at the Cornell main path's own
   shape, 512x512 lanes in the Renderer's Morton order with its per-lane
   spp (first and last pass), depth 0, 2 and 5. K1's bars: on every
   lane `good`, the ray and shadow-ray counts equal, L within 2e-5
   (absolute + relative), and the per-bounce histogram of live lanes
   equal.
4. Cornell main path: the port's Renderer at 512x512, depth 5, 64 spp,
   reference estimator; every launch count is set to 0 just before it and
   read just after: one K1 launch per pass, no K2/K3/K4 launch, no NaN
   substituted; the image must match tests/goldens/golden_cornell.is by
   tone-mapped 8x8 block means (the thresholds of
   tests/test_reference_parity.py).
5. Cornell time: 512x512, depth 5, 8 passes per timed run, CUDA events
   after a warm-up, median of 3, in turns: bare K1 launches on prebuilt
   inputs, K1 through fused_pass, and the plain version; the last timed
   passes of K1 and of the plain version are held against each other;
   then bare K1 at 16 spp per launch (4,194,304 lanes, 2 launches per
   run), ms per spp-pass.
6. K3/K4 vs plain on scenes/parity_mesh_mid.txt (20,480 triangles): the
   512x512 camera rays in Morton order, the bounce-1 and bounce-3 rays and
   shadow rays of one plain pass, and 64k seeded random rays with 1%
   escape lanes. Bars: K3's t and ids and K4's t bit-equal with the plain
   traversal's on every lane (so the any-hit verdict and the shadow
   rays' `lit` predicate agree too).
7. K2 vs plain on the hit records of bounces 0, 1 and 4 of that pass:
   float outputs within 1e-5 (absolute + relative), int outputs equal on
   every lane.
8. whole mesh pass vs plain: trace_paths through the kernels (K3 -> K2 ->
   K4, with the ray_key sorts) against the plain trace_paths (no sort) at
   512x512 Morton lanes, per-lane spp, depth 0, 2, 5 (spp 0) and depth 5
   (spp 63), with phase 3's bars (the North star's): on every lane
   `good`, the ray and shadow-ray counts equal, L within 2e-5 (absolute +
   relative), and the per-bounce histogram of live lanes equal.
9. mesh main path: the Renderer on parity_mesh_mid at 512x512, depth 5,
   64 spp, reference estimator; counts set to 0 just before and read just
   after: K3, K2 and K4 launch passes x 6 times each, K1 never, no NaN;
   the image against tests/goldens/golden_mesh_mid.is, and parity_mesh
   the same way against golden_mesh.is. PPMs go to
   craytracer_tpu_torch/_build/.
10. mesh time (CUDA events after a warm-up, median of 3): parity_mesh_mid
   512x512 depth 5 rays/s through render_sample over 16 passes (live
   closest-hit rays + shadow rays, from the counters); bare K3, K2 and K4
   per launch on the six bounces of one pass's real inputs, and the plain
   versions once; each K3/K4 bound counted twice (the rows' boxes and
   their filled slots, all the result needs and the bound the JSON line
   keeps, and whole rows), the pops per lane and the
   share of lane-pops that warps of 32 one-ray-per-thread lanes leave
   idle (1 - sum of pops / sum of 32 x the warp's most pops, the rays in
   the route's order) on the camera rays, the bounce-1 rays and all six
   bounces; then the bench_mesh.py city of 327,680 triangles
   (craytracer_tpu_torch/scene/city.py): its build seconds, 256x256
   depth 4 rays/s, and bare K3 per launch on camera and bounce-1 rays,
   each with and without the ray_key sort.
11. K1's full core vs plain: scenes/parity_mix.txt (4 spheres, 3 rects;
   matte, Oren-Nayar, plastic, mirror, gold) at 512x512 Morton lanes,
   depth 0, 2, 5 (spp 0) and 5 (spp 63); then the four sphere scenes of
   tests/torch_sphere_scenes.py (mirror and clipped sphere, sphere light, Oren-Nayar /
   plastic / metal, glass / transparent) at 512x512, depth 0 and their
   own depth; phase 3's K1 bars.
12. K2 with lobes (each scene's mask) vs plain on the bounce 0, 1 and 4
   hit records of a plain 512x512 pass over parity_mix and over
   glass_spheres; phase 7's bars.
13. parity_mix through trace_paths(fast_shade="shade") (K2 with the plain
   sphere and rect intersection, K2 launched once per bounce and nothing
   else) against the plain trace_paths at depth 0, 2 and 5; phase 8's
   bars.
14. parity_mix main path: the Renderer at 512x512, depth 5, 64 spp,
   reference estimator; counts set to 0 just before and read just after:
   one K1 launch per pass and nothing else, no NaN; the image against
   tests/goldens/golden_mix.is.
15. parity_mix time (as phase 5): bare K1, K1 through fused_pass and the
   plain version per pass, rays/s and K1's bound (the operations of one
   plain pass's live lanes: prim tests, shading and each hit material's
   lobe, and each shadow ray's prim tests) and bare K1 at 16 spp per
   launch; the share of lane-bounces that warps of 32 one-path-per-thread
   lanes leave idle on Cornell's and parity_mix's plain passes (per 32
   consecutive Morton lanes, 32 x the longest path's bounces minus the
   sum; the schedule K1 had before its persistent warps); Cornell's bare
   K1 on the matte-only and the full core in turns; bare K2 (parity_mix's
   mask) on the six bounces of a parity_mix pass against its plain version
   and bound.
16. K1 vs plain on planes, disks, boxes and the thin lens: the plane/disk
   and the AABOX scenes of tests/torch_prim_scenes.py and parity_cornell
   with a thin-lens camera (lens_radius 0.2, focal_length 3.0; both
   jitter variants) at 512x512 Morton lanes, depth 0, 2, 5 (spp 0) and 5
   (spp 63); phase 3's K1 bars.
17. scenes/parity_prims.txt (a torus and a box behind their affines, a
   disk, rects) through trace_paths(fast_shade="shade") (K2 with the
   plain intersection of every group, one K2 launch per bounce and
   nothing else) against the plain trace_paths at depth 0, 2 and 5,
   phase 8's bars; then K2 vs plain on the bounce 0, 1 and 4 hit records,
   phase 7's bars.
18. parity_prims main path: the Renderer at 512x512, depth 5, 64 spp
   (16 a pass), reference estimator; counts set to 0 just before and
   read just after:
   K2 passes x 6 times and nothing else, no NaN; the image against
   tests/goldens/golden_prims.is. Then the AABOX scene through the
   Renderer (64 spp): one K1 launch per pass and nothing else, no NaN.
19. times (as phase 5): bare K1 per pass on the plane/disk, AABOX and
   thin-lens Cornell scenes with its bound, the idle lane-bounce share of
   phase 15 and bare K1 at 16 spp per launch, the plain version timed
   once; parity_prims ms/pass and rays/s through render_sample.
20. the city at CITY_TRIS triangles (6,999,040: the San-Miguel-scale
   scene the partitioned BVH4 was built for): its triangle count, fat
   rows and bytes, part count, each part's rows and stack size, the host
   build and partition seconds; every part under the 120 MiB budget and
   every triangle in exactly one part. Main path: the Renderer at
   512x512, depth 5, CITY_SPP spp (one per pass), counts set to 0 just
   before and read just after: K2 passes x 6, K3 `_init` and K4 passes x
   6 x parts, nothing else, no NaN, a finite image. Then ms/pass and
   rays/s through render_sample, median of 3.
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
   and monolithic K4 equal on every lane; bare K4 per part on those
   inputs, timed, with its bound from the rows the plain any hit pops
   (both counts, as phase 10) and the idle lane-pop share over the parts
   and on the last part.
22. K5 on the city: on the monolithic table and on every part, without
   and with a carried hit (the route's on the parts; half the lanes at
   half their closest t on the whole table), bit-equal with the plain
   version and with K3 / K3 `_init`; bare K5 against bare K3 and K3
   `_init` on the same sorted camera rays; bare K3 `_init` per launch
   with both bounds and the idle lane-pop share of the camera and
   bounce-1 rays over the parts.
23. K6 on parity_mesh_mid's 20,480 triangles (pack_triangles) against
   its 512x512 camera rays: t and idx bit-equal with the plain version
   on every lane; bare K6 and the plain version timed.
24. P1 on the city's fat table: every mode bit-equal with its plain
   version at 4 packets and 48 pops; then ns per pop of every mode, the
   slope between 512 and 1,536 pops over 4,224 packets of camera rays;
   bare and plain full mode at 128 pops, t and sink bit-equal.
25. the general route (the torch-op shading of every lobe and light,
   wavefront.py `_general_step`) through K3 and K4 against the general
   route with the plain traversal on parity_mesh_mid at 512x512 Morton
   lanes, depth 0, 2, 5 (spp 0) and 5 (spp 63); then against the "shade"
   route (K2; K3 and K4 on the mesh) on parity_mix and parity_mesh_mid at
   depth 5; phase 8's bars. A lane that differs is printed with the
   bounce where the two routes part and their state there.
26. golden_mix and golden_mesh_mid through the forced general route
   (render_sample(general=True), 512x512, depth 5, 64 spp, the
   Renderer's Morton order and NaN rule); counts set to 0 just before
   and read just after: K3 and K4 passes x 6 on the mesh, nothing else.
27. scenes that take the general route by themselves, through the
   Renderer at 512x512, depth 5, 16 spp in one pass:
   scenes/materials_scene.txt (no
   kernel launch) and parity_mesh_mid's geometry with a disk light, a
   constant env light and an anisotropic Trowbridge-Reitz metal
   (tests/torch_general_scenes.py `mesh_env_disk`: K3 and K4 passes x 6,
   nothing else); no NaN, a finite image.
28. times, in turns, median of 3: ms/pass and rays/s through
   render_sample of the "shade" and the general route on
   parity_mesh_mid and of the general route on phase 27's mesh scene.

29. golden_textured (scenes/parity_textured.txt: a checker on a rect and
   a smooth quad mesh, an EXR texture env, CRAY_TEX_FLOAT_DIV255=1)
   through the Renderer at 128x128, depth 5, 160 spp (16 a pass), reference
   estimator (tests/test_reference_parity.py:133-154); counts set to 0
   just before and read just after: no launch (under 64 triangles, no
   bvh4), no NaN; the image against golden_textured.is. Then the same
   scene with accel="bvh4": the general route through K3 and K4 against
   the general route with the plain traversal at 512x512 Morton lanes,
   depth 5, phase 8's bars.
30. the fullscene (craytracer_tpu_torch/scene/fullscene.py writes
   scenes/fullscene.obj unless it already holds the 380-sphere OBJ,
   timed): scenes/fullscene.txt (558,592 triangles, checked; MATERIAL
   FROM_MTL, PNG textures and normal map, HDR env with IMPORTANCE, two
   lamp mesh lights), its load seconds,
   triangles, fat rows, table MB, part count and route (whole-table K3
   and K4 on the general route); the general route through K3 and K4
   against the plain traversal at 512x512 Morton lanes, depth 0, 2, 5
   (spp 0) and 5 (spp 63), phase 8's bars; K3 and K4 alone on the
   route's bounce-0 and bounce-1 rays and shadow rays, bit-equal with the
   plain traversal; then the Renderer at 512x512, depth 5, 16 spp in one
   pass: counts set to 0 just before and read just after, K3 and K4 passes x 6
   and nothing else, no NaN, a finite image.
31. the quad mesh light of tests/test_mis.py:76-104 at 512x512
   (tests/torch_textured_scenes.py): the valid bounce-0 NEE samples per
   light row at the camera rays' hits, with the general step's
   uniforms; under the principled power the mesh light gets them, under
   the reference power beside a rect lamp it gets none (alone it takes
   the uniform fallback, power 1); each scene's route (the quad beside
   the rect lamp at reference power takes K1's "bounce": its mesh row has
   power 0, as the JAX gate reads the powers; the others "general") and
   each through the Renderer (16 spp in one pass, physical estimator):
   one K1 launch
   per pass on the "bounce" scene, no launch on the others, no NaN, a lit
   image.
32. times, in turns, median of 3: ms/pass and rays/s through
   render_sample of the fullscene and of parity_textured at 512x512,
   depth 5, with profile_render's wall, device time and idle share at 2
   spp, one per pass, depth 1 (depth 5 before PR 15: the trace's event
   processing took the smoke's time budget); bare K3 and K4 per launch on the fullscene's
   bounce-0 and bounce-1 rays and shadow rays (ray_key-sorted), with
   their bounds counted as phase 10 counts them.
33. the field of FIELD_SPHERES (10,000) random spheres of
   bench_spheres.py (scene/sphere_field.py): its build seconds, fat rows
   and stack bound of the sphere BVH4, its route ("shade": the torch-op
   sphere walk, then K2); trace_paths through K2 against the plain
   trace_paths at 512x512 Morton lanes, depth 0, 2, 5 (spp 0) and 5 (spp
   63), phase 8's bars; K2 vs plain on the bounce 0, 1 and 4 hit records,
   phase 7's bars; main path: the Renderer at 512x512, depth 5, 4 spp,
   counts set to 0 just before and read just after: K2 passes x 6 and
   nothing else, no NaN; then ms/pass and rays/s through render_sample at
   512x512 and at bench_spheres.py's 256x256, both depth 3 (depth 5 at
   512x512 before PR 15), median of 3, profile_render's wall, device time
   and idle share at 256x256 depth 1, 1 spp (512x512 depth 5 before PR 15: 85 s
   of event processing), bare K2 on the
   six bounces of one pass with its bound, and the plain sphere walk per
   bounce (closest hit and shadow any hit).
34. the MIS estimator on the fullscene: the general route through K3 and
   K4 against the plain traversal at 512x512 Morton lanes, depth 0, 2, 5,
   phase 8's bars; main path: the Renderer at 512x512, depth 5, 16 spp in
   one pass, estimator "mis", counts set to 0 just before and read just
   after: K3
   and K4 passes x 6 and nothing else, no NaN; ms/pass through
   render_sample of "mis" and "physical" in turns, median of 3.
35. the MIS estimator unbiased on the card: tests/test_mis.py's glossy
   scene (a rough SILVER floor, a 4 x 4 lamp) through the Renderer at
   512x512 x 64 spp (16 a pass), depth 3, under "mis" (the general
   route, no launch)
   and "physical" (K1, one launch per pass): no NaN, and the image means
   within tests/test_mis.py:58's rtol 0.12.
36. (run right after phase 15, before the process's first torch.profiler
   session) K2's design: every mask variant built so far, with ptxas'
   registers and spills; on the six bounce records of parity_mesh_mid
   (the matte core), parity_mix and glass_spheres (cores with lobes): the
   device events of six fused_shade calls on a warmed
   scene, which must be exactly one K2 kernel a call (torch.profiler, CPU
   and CUDA activities; a trace that lost events is taken again); bare K2
   ms per launch, fused_shade's device ms per call (CUDA events, the run
   enqueued behind a device-side sleep) and wall ms per call, beside the
   177-byte-per-lane bound.
37. the inverse path (slice G) on the inverse mesh demo's scene
   (craytracer_tpu_torch/examples/inverse_mesh_demo.py: a 320-triangle
   bvh4 GOLD icosphere on a 64x64 textured floor, 12,289 parameters,
   MIS, depth 2): (a) the target at 512x512 x 8 spp without grad, route
   "general", K3 and K4 24 launches each; this path's camera and bounce-1
   rays through K3 and K4 against the plain traversal (phase 6's bars)
   and its whole pass (phase 8's); (b) one gradient at the starting
   parameters through the kernels and through the plain traversal
   (kernels=False): the loss bit-equal, alpha's and every texel's
   gradient within rtol 1e-5 + 1e-5 max|g|, finite, the route "general"
   under autograd, K3 = K4 = 24 and K1 = K2 = 0 (0 for the plain
   version); then, in turns, one deterministic gradient as
   InverseRenderer takes it and one of the same loss with the default
   atomic accumulation, for the cost of the deterministic one;
   (c) one InverseRenderer step at
   512x512 x 8 spp: loss, grad norm, seconds and peak memory a step, the
   launches set to 0 just before each step and read just after, K3 = K4
   = spp x (depth + 1) (no remat), K1 = K2 = 0; (d) at 128x128, 2
   steps + save + load + 2 steps equal 4 straight steps bit for bit
   (params and optimizer state); (e) one gradient on the fullscene at
   512x512 x 1 spp, MIS, depth 2, with respect to texture 0's texels and
   a METAL row's roughness, through K3/K4: finite, seconds and peak
   memory.
38-43. slice F (`slice_f_phases`, run before phase 37; `python3
   chip_smoke.py --slice-f` builds the kernels and runs these alone,
   with no result line), each at 512x512 with the launches set to 0
   just before each main path and read just after:
38. compaction: parity_mesh_mid at depth 8, `trace_paths(compact_at=2)`
   through K3 -> K2 -> K4 against the dense trace (L, good, the lane
   counters and the live histogram bit-equal) and against its plain
   version (phase 8's bars), K3 = K2 = K4 = 2 + 7 x (1 + hi) where hi
   says whether the second half ran; the Renderer at 4 spp compacted
   (the auto policy) and with compact_at=0 (accum bit-equal), and with
   spp_batch=0 (B = 7: one pass, compacted and dense bit-equal, within
   1e-6 of seven passes of one spp); ms/pass compacted and dense through
   render_sample, in turns, median of 3.
39. tiles, order, resume on Cornell (K1) and parity_mesh_mid (K3 -> K2
   -> K4), 8 spp: tile_pixels=65536 within 1e-6 of untiled with 4x the
   launches, raster bit-equal with Morton, 4 + 4 spp resumed from the
   saved .npz bit-equal with 8 straight.
40. the NaN scene of tests/test_nan_log.py through K1 (2 spp, depth 3):
   the Renderer's NaN samples equal K1's NaN lanes and the plain pass's
   (> 0), the NaN lanes and `good` equal per lane, raw_mean finite, the
   log written with a non-finite retraced L.
41. a multijittered table (64 x 83): K1's external-ray mode against its
   plain version on Cornell and parity_mix (spp 0 and 63, depth 0 and
   5, phase 3's bars); the Renderer with the table launches it once a
   pass (`k1_pass_rays`); bare K1 on the table's rays and with its own
   raygen, in turns, and the bound (24 B of rays a lane more).
42. WHITTED (depth 3) and RAYCAST on parity_mesh_mid through K3 / K4
   against the plain traversal (the camera rays' hits bit-equal, L
   within 2e-5), K3 once a bounce and K4 once a bounce and light, also
   through the Renderer; `render_aovs` through K3 bit-equal with the
   plain AOVs.
43. the command line in subprocesses: a config.txt (parity_mesh_mid),
   --spp-batch 0 (B = 7), --stats, --probe, -o .exr; then -s resume
   (7 + 7 spp) bit-equal with 14 straight (run beside the first); the
   summary lines' route, launches and B checked.
44-48. slice I part 2 and slice F part 3 (`slice_i_phases`, after
   phase 43; `python3 chip_smoke.py --slice-i` builds the kernels and
   runs these alone, with no result line), at 512x512 on
   parity_mesh_mid, the launches set to 0 just before each main path and
   read just after:
44. bvh, bvh4q, grid, binned and hybrid's tables built on the card
   (seconds and bytes); their closest hits on the Morton camera rays and
   the bounce-1 rays of one plain pass against K3 on the bvh4 table (ids
   equal on every lane, t within 5e-6 relative; binned's matmul form
   within JAX's binned bar, 1e-4 relative and absolute, where a lane
   whose ids differ must hit both triangles at one distance within that
   bar: a ray through a shared edge), their any hits on that pass's
   shadow rays against K4 (verdicts equal); ms per traversal, median of
   3, K3 and K4 beside them for scale; hybrid's closest-hit table
   bit-equal with the bvh4 scene's.
45. each accelerator's `trace_paths` at depth 5 through the kernels
   against its plain version (phase 8's bars): K2 = 6, K3 = 6 on hybrid
   and 0 elsewhere, K4 = K1 = 0.
46. the Renderer on each against golden_mesh_mid.is, at 16 spp (8 a
   pass), binned at 12 (one pass); no NaN; ms/pass; K2 = passes x 6 (and
   K3 on hybrid).
47. `ao_test` at the camera hits through K4 (one launch) bit-equal with
   the plain any hit.
48. the command line in subprocesses: Cornell through K1 with --serve,
   --live 4 and --interactive (its /status and a /frame.png fetched while
   it renders, then "p 10,20" and "stop" through its stdin), the preview
   PNG in this process, a config's GRID (bvh4 with the warning) and
   --accel grid (K2 only), and a `caustic_map yes` scene's `proj map:`
   line; the three batch runs go side by side with the live one.
49-50. slice H (`slice_h_phases`, after phase 48; `python3 chip_smoke.py
   --slice-h` builds the kernels and runs these alone, with no result
   line):
49. two rank processes (parallel/dryrun.py `launch`), both on cuda:0
   over gloo, which reduces CUDA tensors through the host (NCCL refuses
   two ranks on one GPU), the kernels built here first; depth 5. (a)
   scenes/parity_cornell.txt at 512x512 through sharded_render_pass, 2
   ray ranks, six passes (spp 0, 63, 1-4): one K1 launch per rank per
   pass and nothing else (counts set to 0 in the rank just before each
   pass and read just after, sent back); at spp 0 and 63 L, good and the
   ray and shadow-ray counts of every lane bit-equal with this process's
   render_sample. (b) scenes/parity_mesh_mid.txt at 512x512 through
   geom_sharded_render_pass, 2 geometry shards (bvh4, the "shade"
   route): K3 = K2 = K4 = 6 per rank per pass, K1 0; at spp 0 and 63
   `good` and the counters equal and L within 2e-5 (absolute + relative)
   of render_sample on every lane; the lanes whose bounce-0 winning
   triangle differs from the unsharded search's, counted. (c)
   sharded_train_step and bucketed_train_step on 2 ray ranks and
   geom_sharded_train_step on a (1, 2) mesh, the inverse demo's scene at
   128x128, depth 2, zero target, three steps each: loss and every float
   leaf's gradient within 1e-4 / 1e-6 of this process's autograd of the
   same loss (of the geometry step, the mean of the two ranks' gradients:
   under JAX's convention each geometry rank's own differs), seconds per
   step. (d) NCCL at world size 1 in this
   process through (a)'s code: bit-equal with render_sample. ms per pass
   of (a) and (b) (host clock, median of the last four passes) and the
   ranks' setup seconds. In the same world: (e) scenes/parity_mesh_mid.txt
   over 2 geometry shards of the bvh table (the "shade" route; K2 = 6 a
   rank and pass, nothing else) and (f) the 6,999,040-triangle city over
   2 geometry shards at 256x256, depth 4 (bench_mesh.py's setting), each
   rank making the city's triangles itself and its shard's bvh4 table,
   which passes the part budget and is cut into parts (K3 `_init` and K4
   per part of the rank's shard and bounce, K2 a bounce); each at spp 0
   and 63 against the one-process pass (phase 20's city, or one built
   here) with (b)'s bars, the bounce-0 winners that differ counted, ms
   per pass (the spp-63 pass) and each rank's seconds to make and place
   its shard.
50. the XL fullscene: scene/fullscene.py writes scenes/fullscene_xl.obj
   (450 spheres, timed; deleted in a finally), scenes/fullscene_xl.txt
   loaded and built (timed): 2,568,192 triangles, fat rows, table MB, part
   count (past PART_BUDGET_BYTES: parts), route "general"; the general
   route through K3 `_init` and K4 per part against the plain traversal at
   512x512 Morton lanes, depth 5, spp 0, phase 8's bars, K3 `_init` = K4 =
   6 x parts; the Renderer at 512x512 x 4 spp, counts set to 0 just
   before and read just after (K3 `_init` = K4 = 6 x parts x passes), no
   NaN, a finite image.
51-54. slice K (`slice_k_phases`, after phase 50; `python3 chip_smoke.py
   --slice-k` builds the kernels and runs these alone, with no result
   line):
51. tests/torch_general_scenes.py `mesh_env_disk` (parity_mesh_mid's
   20,480 triangles in an anisotropic Trowbridge-Reitz metal, a disk
   light, a constant env light) built with bvh4 and with each of bvh,
   bvh4q, grid, binned and hybrid; `trace_paths` on the gate's route,
   which must be "general", at 512x512 Morton lanes, depth 5, spp 0 and
   63, each bounce's hits recorded; each accelerator's pass held against
   the bvh4 scene's K3/K4 pass on the same rays with phase 8's bars on
   every lane, binned's lanes whose first differing winner is a ray
   through an edge the two triangles share at one distance (phase 44's
   test) counted, named and excused; launches, the counts set to 0 just
   before each pass and read just after: K3 = 6 on hybrid (K4 = 0: its
   shadows are binned's), none on the other four; then hybrid against
   bvh4 under MIS at spp 0. ms per pass.
52. the Renderer on scenes/parity_textured.txt built with each of the
   five, at phase 29's setting (128x128, depth 5, 160 spp, the reference
   estimator; 32 spp per pass): route "general", inside golden_textured's
   bars, no NaN, K3 = 6 a pass on hybrid and nothing else; ms per pass.
53. the XL fullscene of phase 50 (not built again): phase 37 (e)'s
   gradient (512x512 x 1 spp, MIS, depth 2, of the mean image with
   respect to texture 0's texels and a METAL row's alpha) with the search
   through K3 `_init` and K4 per part (K3 `_init` = K4 = 3 x parts, K1 =
   K2 = K3 = 0), again with each bounce checkpointed (`trace_paths(remat
   =True)`: twice the launches), and with the plain traversal
   (kernels=False); the loss bit-equal, every gradient within rtol 1e-5
   + 1e-5 max|g| of the plain one, finite; seconds and peak memory.
54. the albedo-recovery demo (examples/inverse_demo.py): 60
   InverseRenderer steps at 32x32; every loss finite, and on each of the
   4 sample sets the steps cycle over (the target is rendered from the
   first) the last loss below the first, the run's last step included;
   no launch (a scene without triangles); the recovered albedos beside
   the targets, s/step.
55. slice L (`slice_l_phases`, after phase 54; `python3 chip_smoke.py
   --slice-l` builds the kernels and runs it alone, with no result
   line), the texture decoders of csrc/imgdecode.cpp (g++, on the host):
   (a) every committed fixture of craytracer_tpu_torch/testdata/textures/
   (PNG, JPEG, PNM, BMP, TGA, GIF variants) decoded and hashed against
   manifest.json, the SHA-256 of PIL's decode of each (the card's
   machine has no PIL); (b) scenes/parity_textured.txt with accel bvh4
   and its checker replaced by each lossless re-encoding (palette PNG,
   interlaced PNG, 16-bit RGB PNG, BMP-24, RLE TGA, GIF): the texture
   pack equal to the PPM scene's and a 512x512 Morton, depth-5 general
   pass through K3/K4 bit-equal with the PPM scene's, the counts set to
   0 just before each pass and read just after (K3 = K4 = 6, nothing
   else); (c) the 4:2:0 JPEG checker through the Renderer (128x128 x 64
   spp, 2 passes): no NaN, a finite image, the PPM scene's launch counts
   (K3 = K4 = 12); (d) host seconds per decode, median of 3, of the
   fullscene's three 512x512 PNGs, the 2048x2048 4:2:0 JPEG fixture and
   a 4096x4096 PNG written by `encode_png`, with the host's CPU model
   and the card's line. Budget: 20 s.
56. slice M (`slice_m_phases`, after phase 55; `python3 chip_smoke.py
   --slice-m` builds the kernels and runs it alone, with no result
   line), the TIFF, DDS, lossless WebP, PSD and PIL-own PNM decoders of
   csrc/imgdecode_*.h (g++, on the host): (a) every fixture manifest.json
   marks "phase": 56 decoded and hashed against the SHA-256 of PIL's
   decode; (b) parity_textured with its checker replaced by each lossless
   re-encoding (LZW TIFF with the horizontal predictor, tiled Deflate
   TIFF, uncompressed DDS, lossless WebP, PackBits PSD): texels equal to
   the PPM scene's and the 512x512 Morton depth-5 general pass through
   K3/K4 bit-equal with it, K3 = K4 = 6 and nothing else; (c) host
   seconds per decode, median of 3, of the 2048x2048 LZW + predictor TIFF
   and lossless WebP fixtures and of a 2048x2048 BC7 DDS tiled from the
   256x256 fixture (its texels checked equal to the fixture's, tiled),
   with the host's CPU model and the card's line. Budget: 15 s.

Then one JSON line describing the kernels (each with its launches on its
main path: K1 on parity_mix's, K2-K4 on parity_mesh_mid's, K2 plus the
sphere field's, K3 and K4 plus the fullscene's under both estimators, K3
`_init` on the 7M city's; K3 and K4 also carry the general route's
traversal (phases 25-30, 34) and the inverse path's detached search
(phase 37's step), which adds no kernel, K2-K4 phase 38's
compacted Renderer, K2 (K3 on hybrid) phase 46's accelerators, K1 and
K2-K4 the ranks' sharded passes of phase 49 (a) and (b), K2 (e)'s and
K2, K3 `_init` and K4 (f)'s, K3 `_init` and K4 the XL Renderer of phase
50, K3 hybrid's general route in phases 51-52, K3 `_init` and K4 phase
53's XL gradients through the kernels, K3 and K4 phase 55's textured
passes and Renderers and phase 56's textured passes;
`k1_pass_rays`, K1's external-ray mode, on Cornell
with a multijittered table (phase 41); K5, K6 and P1 lie on no path: 0;
max_abs_err over its checks, ms per bare launch (K2's launches enqueued
behind a device-side sleep, so the events time the card alone), the
plain version's ms,
and bound_ms: the larger of the bytes it must move over 3.35 TB/s and
the operations this run's inputs need over 67 TFLOP/s f32, counted from
the CUDA sources; for K3, K3 `_init`, K4 and K5 both are counted from
the rows the plain traversal pops: each visited row's boxes and its
filled slots read once, and per pop the slab tests of its internal
children and the triangle tests of its filled slots; K6 one
Moller-Trumbore test per (ray, table column) pair; P1 the
full mode's box, slot and sort operations per lane and pop;
library_ms is null, since no single
PyTorch call computes any of these functions), the nvidia-smi line, and
as the last line {"ok": true, "device": {...}}. Any failure exits
non-zero without them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

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
L_TOL = 2e-5  # the North star's radiance bar, on every lane
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
# K2 per lane: 78 bytes in (five 3-vectors, t, material id, two flags,
# pixel, spp), 99 out (seven 3-vectors, two floats, an int32 count, three
# bool flags)
K2_LANE_BYTES = 15 * 4 + 4 + 4 + 1 + 1 + 4 + 4 + 23 * 4 + 4 + 3
ROW_BYTES = 108 * 4  # the columns K3/K4 load of a row: boxes, children, slots
BOX_BYTES = 28 * 4  # a row's boxes and child ids (K5's topology row)
SLOT_BYTES = 10 * 4  # one filled slot: a triangle's 9 floats and its id
K6_OPS = 53  # K6: one (ray, triangle) Moller-Trumbore test
CITY_TRIS = 7_000_000  # the 7M class the partitioned BVH4 was built for
CITY_SPP = 4
FIELD_SPHERES = 10_000  # bench_spheres.py's default field
WIDE = 16  # spp per K1 launch of the second timed launch size
REPS = 3  # timed runs after the warm-up, of which every time is the median
SLEEP_CYCLES = 20_000_000  # ~10 ms at the H100's clock


def _bound(nbytes, ops):
    """(bound ms, what bounds it) for one launch."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def _pop_bound(bvh, visits, lanes, lane_bytes=32, split=False):
    """Bound of one K3/K4/K5 launch from the rows its rays popped
    (`visits`, [M] pops per row): each visited row read once (its 108 used
    columns, or with `split` only what the result needs of it: its boxes
    and child ids and its filled slots, not the slots of internal or empty
    children) and each lane's `lane_bytes` of ray, max_dist or carried hit,
    and result; per pop, a slab test for each internal child (child id >=
    0) and a Moller-Trumbore test for each filled slot (triangle id >= 0)
    of the popped row, and the sort."""
    fat = bvh.fat
    internal = (fat[:, 24:28] >= 0).sum(1)
    filled = (fat[:, 37:108:10] >= 0).sum(1)
    row_ops = BOX_OPS * internal + SLOT_OPS * filled + SORT_OPS
    seen = visits > 0
    row_bytes = (int((BOX_BYTES + SLOT_BYTES * filled[seen]).sum())
                 if split else int(seen.sum()) * ROW_BYTES)
    return _bound(row_bytes + lanes * lane_bytes,
                  int((visits * row_ops).sum()))


def _children(bvh):
    """The table's children by kind, the empty ones (the builder's
    sentinel box) also as a share of those not internal, whose slots the
    walk past the L2 would read without its empty-child skip."""
    fat = bvh.fat
    internal = int((fat[:, 24:28] >= 0).sum())
    empty = int((fat[:, 0:12:3] > fat[:, 12:24:3]).sum())
    leaf = fat.shape[0] * 4 - internal - empty
    return (f"children internal / leaf / empty {internal} / {leaf} / "
            f"{empty} (empty: {empty / (leaf + empty):.4f} of those not "
            f"internal)")


def _edge_ties(tri64, o, d, lanes, ids_a, ids_b):
    """Of `lanes`, where two traversals name different triangles, those
    whose ray hits both triangles at one distance, within the binned bar
    of 1e-4 (barycentric coordinates and t, absolute and relative): a ray
    through the edge between two triangles, where either id is the
    closest hit within the matmul form's rounding (its numerators are
    expanded about the treelet's center, so a barycentric coordinate
    carries about 1e-4 of absolute error on parity_mesh_mid).
    Moller-Trumbore in f64 on the scene's corners (`tri64`: v0, v1, v2 as
    f64): (mask, t of the first ids, t of the second)."""
    o, d = o[lanes].double(), d[lanes].double()

    def mt(tri):
        v0, v1, v2 = (x[tri.long()] for x in tri64)
        e1, e2 = v1 - v0, v2 - v0
        p = torch.cross(d, e2, dim=1)
        inv = 1.0 / (e1 * p).sum(1)
        tv = o - v0
        q = torch.cross(tv, e1, dim=1)
        return ((tv * p).sum(1) * inv, (d * q).sum(1) * inv,
                (e2 * q).sum(1) * inv)

    (ba, ga, ta), (bb, gb, tb) = mt(ids_a[lanes]), mt(ids_b[lanes])
    on = [(b >= -1e-4) & (g >= -1e-4) & (b + g <= 1.0 + 1e-4)
          for b, g in ((ba, ga), (bb, gb))]
    return (on[0] & on[1]
            & ((ta - tb).abs() <= 1e-4 + 1e-4 * tb.abs())), ta, tb


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


def _compare(kernel_out, plain_out):
    """Kernel route vs plain on one batch, the North star's bars: (share of
    lanes with differing good, max |dL| over agreeing lanes, max |dL|
    overall, failures). `good`, each lane's ray and shadow-ray counts and
    the per-bounce histogram of live lanes equal, L within L_TOL (absolute
    + relative) on every lane. K1's whole pass and the per-bounce routes'
    whole passes are both held to them."""
    (Lk, gk, mk), (Lp, gp, mp) = kernel_out, plain_out
    Lk, Lp = Lk.double(), Lp.double()
    same = gk == gp
    dL = (Lk - Lp).abs()
    close = (dL <= L_TOL + L_TOL * Lp.abs()).all(dim=1)
    bad_share = 1.0 - same.double().mean().item()
    ok_share = (same & close).double().mean().item()
    err_same = dL[same].max().item() if bool(same.any()) else 0.0
    fails = []
    if ok_share < 1.0:
        fails.append(f"only {ok_share:.7f} of lanes agree")
    if not torch.isfinite(Lk).all():
        fails.append("non-finite L from the kernels")
    for key in ("lane_rays", "lane_shadow_rays", "bounce_live"):
        if not torch.equal(mk[key], mp[key]):
            fails.append(f"{key} differs")
    for key in ("rays", "shadow_rays"):
        if int(mk[key]) != int(mp[key]):
            fails.append(f"{key} {int(mk[key])} vs {int(mp[key])}")
    return bad_share, err_same, dL.max().item(), fails


def _idle_share(work):
    """The share of lane-work that warps of 32 one-item-per-thread lanes
    leave idle, the lanes in the order given (`work`: a list of [N] counts
    per lane, such as a plain pass's bounces or a traversal's pops): per
    32 consecutive lanes, 32 x the lane with the most work minus the sum,
    over the sum of 32 x the most."""
    used = slots = 0
    for x in work:
        w = x[:x.shape[0] // 32 * 32].to(torch.int64).reshape(-1, 32)
        used += int(w.sum())
        slots += 32 * int(w.max(dim=1).values.sum())
    return 1.0 - used / max(slots, 1)


def _bounces(recs):
    """Each lane's bounces on a plain pass (`recs`: plain_records)."""
    return sum(st[5].to(torch.int64) for st, _, _ in recs)


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _timed(fn, queued=False):
    """ms of fn() between CUDA events (fn's own return value too); with
    `queued`, the card first sleeps ~10 ms so that the host has enqueued
    all of fn's launches before the first starts, and the events time the
    device alone."""
    start, stop = _events()
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def _median(fn, queued=False):
    """Warm-up, then the median of REPS timed runs and their times."""
    fn()
    torch.cuda.synchronize()
    ts = [_timed(fn, queued)[0] for _ in range(REPS)]
    return statistics.median(ts), ts


def _runs(ts):
    return ", ".join(f"{t:.3f}" for t in ts)


def slice_f_phases(ctx) -> None:
    """Phases 38-43: slice F on the card (module docstring). `ctx` carries
    the run's device, card line, failure list, error and kernel tables,
    the launch counters, and the seed; failures are appended."""
    from craytracer_tpu_torch import cuda_build
    from craytracer_tpu_torch.accel import bvh4_kernel as bk
    from craytracer_tpu_torch.accel.bvh4 import (bvh4_any_hit_stats,
                                                 bvh4_closest_hit_stats)
    from craytracer_tpu_torch.camera import Film, make_camera
    from craytracer_tpu_torch.constants import TMAX
    from craytracer_tpu_torch.integrator import pass_kernel as pk
    from craytracer_tpu_torch.integrator import wavefront as wf
    from craytracer_tpu_torch.integrator.aov import render_aovs
    from craytracer_tpu_torch.integrator.render import (RenderConfig,
                                                        Renderer)
    from craytracer_tpu_torch.integrator.whitted import trace_whitted
    from craytracer_tpu_torch.io.imagestate import (load_image_state,
                                                    save_image_state)
    from craytracer_tpu_torch.io.scenefile import load_scene_file
    from craytracer_tpu_torch.sampling.tables import make_sample_table
    from craytracer_tpu_torch.scene.build import SceneBuilder

    dev, card, fails, err, kernels = (ctx.dev, ctx.card, ctx.fails, ctx.err,
                                      ctx.kernels)
    counters, seed, size = ctx.counters, 0, getattr(ctx, "size", 512)
    out_dir = cuda_build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)

    def reset():
        for c in counters.values():
            c.launches = 0

    def counts():
        return {k: c.launches for k, c in counters.items()}

    def expect(label, got, **want):
        w = {k: want.get(k, 0) for k in counters}
        if got != w:
            fails.append(f"{label} launches {got}, want {w}")

    def render(scn, c, fm, **kw):
        """A Renderer run, counts set to 0 just before and read just
        after: (renderer, seconds, launches)."""
        r = Renderer(scn, c, fm, RenderConfig(**kw))
        reset()
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0, counts()

    def check(label, ok, detail=""):
        print(f"[slice-f] {label}: {detail}" + ("" if ok else " FAIL"),
              flush=True)
        if not ok:
            fails.append(f"{label}: {detail}")

    mesh, mcam, mf0 = load_scene_file(MESH_MID, device=dev)
    mfilm = Film(fov=mf0.fov, width=size, height=size)
    corn, ccam, cf0 = load_scene_file(SCENE, device=dev)
    cfilm = Film(fov=cf0.fov, width=size, height=size)
    morton = torch.from_numpy(Renderer(
        mesh, mcam, mfilm, RenderConfig()).pixel_order()).to(dev)

    # ---- 38. compaction on parity_mesh_mid at depth 8
    depth = 8
    spp = torch.full_like(morton, 5)
    o, d = wf.camera_rays(mcam, mfilm, morton, seed, spp,
                          wf.film_jitter(seed, morton, spp))
    reset()
    comp = wf.trace_paths(mesh, o, d, seed, morton, spp, depth,
                          with_metrics=True, fast_shade="shade", compact_at=2)
    got_c = counts()
    dense = wf.trace_paths(mesh, o, d, seed, morton, spp, depth,
                           with_metrics=True, fast_shade="shade")
    plain = wf.trace_paths(mesh, o, d, seed, morton, spp, depth,
                           with_metrics=True, compact_at=2)
    torch.cuda.synchronize()
    hi = int(comp[2]["compact_hi"])
    same = (torch.equal(comp[0], dense[0]) and torch.equal(comp[1], dense[1])
            and all(torch.equal(comp[2][k], dense[2][k]) for k in (
                "lane_rays", "lane_shadow_rays", "bounce_live")))
    per = 2 + (depth - 1) * (1 + hi)
    bad, e_same, e_all, f = _compare(comp, plain)
    check("38 compaction trace 512x512 depth 8", same and not f
          and got_c == {**dict.fromkeys(counters, 0), "k2_shade": per,
                        "k3_bvh4_closest": per, "k4_bvh4_any": per},
          f"compacted vs dense: L, good, lane counters, histogram bit-equal "
          f"{same}; compacted kernels vs compacted plain: max|dL| "
          f"{e_all:.3g} {f}; live per bounce "
          f"{comp[2]['bounce_live'].tolist()}; hi {hi}; launches {got_c} "
          f"(derived: K3 = K2 = K4 = 2 + 7 x (1 + hi) = {per})")
    mspp = 4
    runs = {}
    for label, at in (("compacted", None), ("dense", 0)):
        hi0 = wf.COMPACTION.hi
        r, dt, got = render(mesh, mcam, mfilm, num_samples=mspp,
                            max_depth=depth, compact_at=at)
        his = wf.COMPACTION.hi - hi0
        runs[label] = r
        want = (2 * r.passes + (depth - 1) * (r.passes + his)
                if at is None else (depth + 1) * r.passes)
        expect(f"38 Renderer {label}", got, k2_shade=want,
               k3_bvh4_closest=want, k4_bvh4_any=want)
        print(f"[slice-f] 38 Renderer parity_mesh_mid {size}x{size} {mspp} "
              f"spp depth {depth} {label}: {dt:.3f} s, {r.passes} passes, "
              f"second halves run {his}, launches {got}", flush=True)
        if at is None:
            for k in ("k2_shade", "k3_bvh4_closest", "k4_bvh4_any"):
                if k in kernels:
                    kernels[k]["launches"] += got[k]
    check("38 Renderer compacted vs dense", torch.equal(
        runs["compacted"].accum, runs["dense"].accum), "accum bit-equal")
    batched = {}
    for label, at in (("compacted", None), ("dense", 0)):
        hi0 = wf.COMPACTION.hi
        r, dt, got = render(mesh, mcam, mfilm, num_samples=7,
                            max_depth=depth, spp_batch=0, compact_at=at)
        his = wf.COMPACTION.hi - hi0
        batched[label] = r
        want = (2 + (depth - 1) * (1 + his) if at is None else depth + 1)
        expect(f"38 Renderer B=0 {label}", got, k2_shade=want,
               k3_bvh4_closest=want, k4_bvh4_any=want)
        print(f"[slice-f] 38 Renderer spp_batch=0 -> B={r.spp_batch}, 7 spp "
              f"{label}: {dt:.3f} s, {r.passes} passes, hi {his}, launches "
              f"{got}", flush=True)
    straight = Renderer(mesh, mcam, mfilm, RenderConfig(
        num_samples=7, max_depth=depth, spp_batch=1))
    straight.render()
    check("38 spp_batch=0", batched["compacted"].spp_batch == 7
          and batched["compacted"].passes == 1
          and torch.equal(batched["compacted"].accum, batched["dense"].accum)
          and torch.allclose(batched["compacted"].accum, straight.accum,
                             rtol=1e-6, atol=1e-6),
          "B=7 in one pass; compacted vs dense accum bit-equal, vs 7 passes "
          "of B=1 within 1e-6 (summation order)")
    tms = {"compacted": [], "dense": []}
    for rep in range(REPS):
        for label, at in (("compacted", 2), ("dense", 0)):
            t0 = time.perf_counter()
            for k in range(4):
                wf.render_sample(mesh, mcam, mfilm, morton, seed,
                                 100 + 4 * rep + k, depth, compact_at=at)
            torch.cuda.synchronize()
            tms[label].append((time.perf_counter() - t0) * 1e3 / 4)
    mc, md = (statistics.median(tms[k]) for k in ("compacted", "dense"))
    print(f"[time] {card}, parity_mesh_mid {size}x{size} depth {depth} "
          f"through render_sample, 4 passes per run, in turns, median of {REPS}: "
          f"compacted {mc:.4f} ms/pass (runs {_runs(tms['compacted'])}), "
          f"dense {md:.4f} ms/pass (runs {_runs(tms['dense'])}), compacted "
          f"/ dense {mc / md:.4f}", flush=True)

    # ---- 39. tiles, order, resume
    for name, scn, c, fm, depth, per_pass in (
            ("cornell", corn, ccam, cfilm, 5, {"k1_pass": 1}),
            ("parity_mesh_mid", mesh, mcam, mfilm, 5,
             {"k2_shade": 6, "k3_bvh4_closest": 6, "k4_bvh4_any": 6})):
        base, _, got = render(scn, c, fm, num_samples=8, max_depth=depth)
        expect(f"39 {name} untiled", got,
               **{k: v * base.passes for k, v in per_pass.items()})
        tiled, _, got_t = render(scn, c, fm, num_samples=8, max_depth=depth,
                                 tile_pixels=65536)
        expect(f"39 {name} tiled", got_t,
               **{k: 4 * v * base.passes for k, v in per_pass.items()})
        raster, _, _ = render(scn, c, fm, num_samples=8, max_depth=depth,
                              ray_order="raster")
        half, _, _ = render(scn, c, fm, num_samples=4, max_depth=depth)
        path = str(out_dir / f"resume_{name}")
        save_image_state(path, half.accum, half.spp_done, seed)
        acc, spp_done, s = load_image_state(path)
        resumed = Renderer(scn, c, fm, RenderConfig(num_samples=4,
                                                    max_depth=depth, seed=s))
        resumed.resume_from(acc, spp_done)
        resumed.render()
        dt_max = (tiled.accum - base.accum).abs().max().item() / 8
        check(f"39 {name} {size}x{size} 8 spp", dt_max <= 1e-6
              and torch.equal(raster.accum, base.accum)
              and torch.equal(resumed.accum, base.accum)
              and resumed.spp_done == 8,
              f"tiled (65,536 pixels, launches {got_t}) vs untiled max |d "
              f"mean| {dt_max:.3g}; raster vs Morton bit-equal "
              f"{torch.equal(raster.accum, base.accum)}; 4 + 4 resumed from "
              f"the .npz vs 8 straight bit-equal "
              f"{torch.equal(resumed.accum, base.accum)}")

    # ---- 40. the NaN scene through K1 and its retrace
    nb = SceneBuilder()
    nb.add_matte("floor", (0.7, 0.7, 0.7))
    nb.add_emissive("bad", (float("nan"), 1.0, 1.0), intensity=5.0)
    nb.add_emissive("lamp", (1.0, 0.95, 0.9), intensity=10.0)
    nb.add_rect((-4, 0, -4), (8, 0, 0), (0, 0, 8), "floor")
    nb.add_sphere((0.0, 0.8, 0.0), 0.6, "bad")
    nb.add_rect((-1, 3, -1), (2, 0, 0), (0, 0, 2), "lamp")
    nscene = nb.build(device=dev)
    ncam = make_camera((0, 2, 4), (0, 0.6, 0), device=dev)
    nfilm = Film(fov=torch.tensor(np.radians(45.0), dtype=torch.float32,
                                  device=dev), width=size, height=size)
    log_path = out_dir / "trace_log.txt"
    log_path.unlink(missing_ok=True)
    route = wf.production_fast_shade(nscene, ncam, nfilm, max_depth=3)
    r, dt, got = render(nscene, ncam, nfilm, num_samples=2, max_depth=3,
                        nan_log_path=str(log_path), nan_log_max=4)
    expect("40 NaN scene", got, k1_pass=r.passes)
    nids = torch.arange(size * size, dtype=torch.int32, device=dev)
    plain_nan = kern_nan = 0
    lanes_ok = True
    for s in range(2):
        kout = pk.fused_pass(nscene, ncam, nfilm, nids, s, seed, 3)
        pout = pk.fused_pass_reference(nscene, ncam, nfilm, nids, s, seed, 3)
        kn, pn = torch.isnan(kout[0]), torch.isnan(pout[0])
        kern_nan += int(kn.any(dim=1).sum())
        plain_nan += int(pn.any(dim=1).sum())
        fin = ~(kn | pn).any(dim=1)
        lanes_ok &= (torch.equal(kn, pn) and torch.equal(kout[1], pout[1])
                     and bool(((kout[0] - pout[0]).abs()[fin] <= L_TOL
                               + L_TOL * pout[0].abs()[fin]).all()))
    text = log_path.read_text() if log_path.exists() else ""
    check(f"40 NaN retrace {size}x{size} 2 spp depth 3 (route {route})",
          route == "bounce" and r.nan_count == plain_nan == kern_nan > 0
          and lanes_ok and np.isfinite(r.raw_mean()).all()
          and text.count("NaN/Inf sample") == 2 * 4 and "L=(nan" in text,
          f"{dt:.3f} s, launches {got}; NaN samples {r.nan_count}, K1's NaN "
          f"lanes {kern_nan}, the plain pass's {plain_nan}, NaN lanes and "
          f"good equal per lane {lanes_ok}; raw_mean finite "
          f"{bool(np.isfinite(r.raw_mean()).all())}; log "
          f"{text.count('NaN/Inf sample')} samples, a non-finite retraced L "
          f"{'L=(nan' in text}")

    # ---- 41. table sampler: K1's external-ray mode
    table = make_sample_table("multijittered", 64, 83, seed=seed,
                              device=dev)
    cmorton = torch.from_numpy(Renderer(
        corn, ccam, cfilm, RenderConfig()).pixel_order()).to(dev)
    mix, xcam, xf0 = load_scene_file(MIX, device=dev)
    xfilm = Film(fov=xf0.fov, width=size, height=size)
    for name, scn, c, fm in (("cornell", corn, ccam, cfilm),
                             ("parity_mix", mix, xcam, xfilm)):
        for s in (0, 63):
            sp = torch.full_like(cmorton, s)
            o, d = wf.camera_rays(c, fm, cmorton, seed, sp,
                                  wf.film_jitter(seed, cmorton, sp, table))
            for depth in (0, 5):
                args = (scn, c, fm, cmorton, sp, seed, depth)
                kout = pk.fused_pass(*args, raygen=None, rays=(o, d))
                pout = pk.fused_pass_reference(*args, raygen=None,
                                               rays=(o, d))
                torch.cuda.synchronize()
                bad, e_same, e_all, f = _compare(kout, pout)
                err["k1_pass_rays"] = max(err["k1_pass_rays"], e_all)
                check(f"41 K1 rays vs plain {name} {size}x{size} Morton spp "
                      f"{s} depth {depth}", not f,
                      f"good differs on {bad:.5f}, max|dL| {e_all:.3g}, rays "
                      f"{int(kout[2]['rays'])}/{int(pout[2]['rays'])} {f}")
        r, dt, got = render(scn, c, fm, num_samples=16, max_depth=5,
                            sampler=table)
        expect(f"41 {name} Renderer with a sampler", got,
               k1_pass_rays=r.passes)
        print(f"[slice-f] 41 Renderer {name} {size}x{size} 16 spp depth 5, "
              f"multijittered table: {dt:.3f} s, launches {got}, "
              f"{r.nan_count} NaN, mean {r.raw_mean().mean():.5f}",
              flush=True)
        if name == "cornell":
            launches_rays = got["k1_pass_rays"]
        if r.nan_count or not np.isfinite(r.raw_mean()).all():
            fails.append(f"41 {name}: not finite")
    # bare launch times on prebuilt inputs, rays vs in-kernel raygen
    tab = pk.kernel_tables(corn, ccam, cfilm)
    cnt = pk.table_counts(corn)
    passes = 16
    spps = [torch.full_like(cmorton, 200 + k) for k in range(passes)]
    rays = []
    for sp in spps:
        o, d = wf.camera_rays(ccam, cfilm, cmorton, seed, sp,
                              wf.film_jitter(seed, cmorton, sp, table))
        rays.append((o.contiguous(), d.contiguous()))

    def bare(ext):
        return lambda: [
            (pk.RAYS_KERNEL if ext else pk.KERNEL).launch(
                tab, cnt, cmorton, sp, seed, 5, True, size, False, False,
                rays[k] if ext else None)
            for k, sp in enumerate(spps)]

    def plain_passes():
        return [pk.fused_pass_reference(corn, ccam, cfilm, cmorton, sp, seed,
                                        5, raygen=None, rays=rays[k])
                for k, sp in enumerate(spps)]

    ts = {"rays": [], "strat": [], "plain": []}
    fns = {"rays": bare(True), "strat": bare(False), "plain": plain_passes}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    outs = None
    for _ in range(REPS):
        for k, fn in fns.items():
            ms, out = _timed(fn)
            ts[k].append(ms)
            if k == "rays":
                outs = out
    n_rays = sum(int(g[1].sum()) for _, g in outs)
    n_shadow = sum(int(g[2].sum()) for _, g in outs)
    med = {k: statistics.median(v) / passes for k, v in ts.items()}
    prim_ops = 8 * RECT_OPS + 20 * TRI_OPS
    bound = _bound(tab.numel() * 4 + size * size * (8 + 24 + 28),
                   (n_rays * (prim_ops + SHADE_OPS)
                    + n_shadow * prim_ops) / passes)
    print(f"[time] {card}, cornell {size}x{size} depth 5, multijittered "
          f"table, {passes} launches per run, in turns, median of {REPS}: bare K1 "
          f"on external rays {med['rays']:.4f} ms/launch (runs "
          f"{_runs(ts['rays'])} ms), bare K1 with its raygen (strat) "
          f"{med['strat']:.4f} ms/launch (runs {_runs(ts['strat'])} ms), "
          f"plain {med['plain']:.4f} ms/pass; bound {bound[0]:.4f} ms "
          f"({bound[1]}: 24 B of rays a lane more than strat; "
          f"{n_rays} rays + {n_shadow} shadow rays per run)", flush=True)
    kernels["k1_pass_rays"] = {
        "name": "k1_pass_rays", "route": "cuda",
        "source": "craytracer_tpu_torch/csrc/pass_kernel.cu",
        "replaces": "craytracer_tpu/integrator/pallas_shade.py:781",
        "launches": launches_rays, "ms": med["rays"],
        "plain_ms": med["plain"], "bound_ms": bound[0],
        "bound_by": bound[1], "library_ms": None}

    # ---- 42. WHITTED, RAYCAST and AOVs on parity_mesh_mid
    n_lights = mesh.lights.light_type.shape[0]
    sp = torch.full_like(morton, 3)
    o, d = wf.camera_rays(mcam, mfilm, morton, seed, sp,
                          wf.film_jitter(seed, morton, sp))
    t_k, tri_k = bk.bvh4_closest_hit_kernel(mesh.tri_bvh, o, d)
    t_p, tri_p = bvh4_closest_hit_stats(mesh.tri_bvh, o, d)[:2]
    md = torch.where(t_p < TMAX, t_p * 0.999, 5.0)
    k4_same = torch.equal(bk.bvh4_any_hit_kernel(mesh.tri_bvh, o, d, md),
                          bvh4_any_hit_stats(mesh.tri_bvh, o, d, md)[0])
    check("42 K3/K4 on the camera rays", torch.equal(t_k, t_p)
          and torch.equal(tri_k, tri_p) and k4_same,
          "t and ids bit-equal with the plain traversal; K4 bit-equal")
    for mode, depth in (("WHITTED", 3), ("RAYCAST", 0)):
        cont = mode == "WHITTED"
        reset()
        Lk = trace_whitted(mesh, o, d, seed, morton, sp, depth, cont,
                           kernels=True)
        got = counts()
        Lp = trace_whitted(mesh, o, d, seed, morton, sp, depth, cont)
        torch.cuda.synchronize()
        e = (Lk - Lp).abs().max().item()
        iters = depth + 1
        check(f"42 {mode} {size}x{size} depth {depth} kernels vs plain",
              bool(torch.allclose(Lk, Lp, rtol=L_TOL, atol=L_TOL))
              and bool(torch.isfinite(Lk).all())
              and got == {**dict.fromkeys(counters, 0),
                          "k3_bvh4_closest": iters,
                          "k4_bvh4_any": iters * n_lights},
              f"max|dL| {e:.3g}, mean {Lk.mean().item():.5f}, launches "
              f"{got} (K3 = {iters} bounces, K4 = bounces x {n_lights} "
              f"lights)")
        r, dt, got = render(mesh, mcam, mfilm, num_samples=2,
                            max_depth=depth, trace_type=mode)
        expect(f"42 Renderer {mode}", got,
               k3_bvh4_closest=iters * r.passes,
               k4_bvh4_any=iters * n_lights * r.passes)
        print(f"[slice-f] 42 Renderer {mode} 2 spp depth {depth}: {dt:.3f} "
              f"s, launches {got}, mean {r.raw_mean().mean():.5f}",
              flush=True)
    reset()
    ak = render_aovs(mesh, mcam, mfilm)
    got = counts()
    ap = render_aovs(mesh, mcam, mfilm, kernels=False)
    check("42 AOVs kernels vs plain", all(torch.equal(ak[k], ap[k])
                                          for k in ak)
          and got == {**dict.fromkeys(counters, 0), "k3_bvh4_closest": 1},
          f"every buffer bit-equal, launches {got}")

    # ---- 43. the command line in a subprocess on the card
    cfg_path = out_dir / "config_smoke.txt"
    cfg_path.write_text(f"# chip_smoke phase 43\nscene_file {MESH_MID}\n"
                        "num_samples 7\nnum_sample_sets 83\nmax_depth 5\n"
                        "trace_type PATHTRACE\naccel_struct BVH4\n")
    cli = [sys.executable, "-m", "craytracer_tpu_torch", "--config",
           str(cfg_path), "--size", str(size), "--spp-batch", "0"]
    out_a, out_b, out_c = (str(out_dir / f"cli_{k}.exr") for k in "abc")
    lines = {}

    def report(key, t0, rc, out, err):
        lines[key] = out
        summary = (out.strip().splitlines() or [""])[-1]
        print(f"[slice-f] 43 CLI {key} ({time.perf_counter() - t0:.2f} s, "
              f"exit {rc}): {summary}", flush=True)
        if rc:
            fails.append(f"43 CLI {key} exit {rc}: {err[-2000:]}")

    # c (14 straight) runs beside a, then b (a's state resumed)
    t_c = time.perf_counter()
    pc = subprocess.Popen(cli + ["--spp", "14", "-o", out_c],
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, cwd=REPO)
    try:
        for key, extra in (("a", ["--stats", "--probe", "100,200", "-o",
                                  out_a]),
                           ("b", ["-s", out_a[:-4] + "_state.npz", "-o",
                                  out_b])):
            t0 = time.perf_counter()
            p = subprocess.run(cli + extra, capture_output=True, text=True,
                               cwd=REPO, timeout=300)
            report(key, t0, p.returncode, p.stdout, p.stderr)
        out, err = pc.communicate(timeout=300)
        report("c", t_c, pc.returncode, out, err)
    finally:
        if pc.poll() is None:
            pc.kill()
            pc.wait()
    if any(f.startswith("43 CLI") for f in fails):
        return
    a = load_image_state(out_a[:-4] + "_state.npz")
    b = load_image_state(out_b[:-4] + "_state.npz")
    c = load_image_state(out_c[:-4] + "_state.npz")
    ok = (a[1] == 7 and b[1] == c[1] == 14
          and np.array_equal(b[0], c[0])
          and "route shade" in lines["a"] and "spp batch 7" in lines["a"]
          and "launches K1 0, K2 6, K3 6, K4 6, K1 rays 0" in lines["a"]
          and "K2 12, K3 12, K4 12" in lines["c"]
          and "bvh4:" in lines["a"] and "probe (100,200)" in lines["a"]
          and "resumed from" in lines["b"])
    check("43 CLI", ok, f"states spp {a[1]}, {b[1]}, {c[1]}; 7 + 7 resumed "
          f"vs 14 straight bit-equal {np.array_equal(b[0], c[0])}")


def slice_i_phases(ctx) -> None:
    """Phases 44-48: slice I part 2 and slice F part 3 on the card (module
    docstring). `ctx` as for `slice_f_phases`; failures are appended."""
    import socket
    import urllib.request

    from craytracer_tpu_torch import cuda_build
    from craytracer_tpu_torch.accel import binned as ab
    from craytracer_tpu_torch.accel import bvh4_kernel as bk
    from craytracer_tpu_torch.camera import Film
    from craytracer_tpu_torch.constants import TMAX
    from craytracer_tpu_torch.integrator import shade_kernel as sk
    from craytracer_tpu_torch.integrator import wavefront as wf
    from craytracer_tpu_torch.integrator.render import (RenderConfig,
                                                        Renderer)
    from craytracer_tpu_torch.io.scenefile import load_scene_file
    from craytracer_tpu_torch.io.teximage import read_png
    from craytracer_tpu_torch.ops.intersect import _WALKS, intersect_scene
    from craytracer_tpu_torch.ops.raysort import sorted_traversal
    from craytracer_tpu_torch.sampling.rng import uniforms
    from craytracer_tpu_torch.scene import types as T
    from craytracer_tpu_torch.utils.ao import ao_test

    dev, card, fails, kernels = ctx.dev, ctx.card, ctx.fails, ctx.kernels
    counters, seed, size = ctx.counters, 0, getattr(ctx, "size", 512)
    out_dir = cuda_build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)

    def reset():
        for c in counters.values():
            c.launches = 0

    def counts():
        return {k: c.launches for k, c in counters.items()}

    def check(label, ok, detail=""):
        print(f"[slice-i] {label}: {detail}" + ("" if ok else " FAIL"),
              flush=True)
        if not ok:
            fails.append(f"{label}: {detail}")

    def table_bytes(table):
        return sum(t.numel() * t.element_size()
                   for t in T.tensor_leaves(table))

    # ---- 44. the accelerators against bvh4's K3 and K4
    mesh, mcam, mf0 = load_scene_file(MESH_MID, device=dev)
    mfilm = Film(fov=mf0.fov, width=size, height=size)
    morton = torch.from_numpy(Renderer(
        mesh, mcam, mfilm, RenderConfig()).pixel_order()).to(dev)
    scenes = {}
    for accel in ("bvh", "bvh4q", "grid", "binned", "hybrid"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scenes[accel] = load_scene_file(MESH_MID, accel=accel,
                                        device=dev)[0]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tabs = [scenes[accel].tri_bvh, scenes[accel].tri_shadow]
        print(f"[slice-i] 44 {accel}: scene load and table build "
              f"{dt:.3f} s (host build, then to the card), table bytes "
              + " + ".join(f"{table_bytes(t):,}" for t in tabs
                           if t is not None), flush=True)
    hyb = scenes["hybrid"]
    check("44 hybrid's closest-hit table", torch.equal(
        hyb.tri_bvh.fat, mesh.tri_bvh.fat) and hyb.tri_parts is None,
        "bit-equal with the bvh4 scene's, no parts")
    spp0 = torch.zeros_like(morton)
    o_cam, d_cam = wf.camera_rays(mcam, mfilm, morton, seed, spp0,
                                  wf.film_jitter(seed, morton, spp0))
    st = wf._init_state(o_cam, d_cam, 5, morton)
    hit0 = intersect_scene(mesh, o_cam, d_cam)
    out0 = sk.fused_shade_reference(mesh, d_cam, hit0, st[2], st[5], st[6],
                                    st[10], spp0, seed, 0, 5)
    alive = out0["new_alive"]
    o_b1, d_b1 = out0["new_o"][alive], out0["new_d"][alive]
    ws = out0["want_shadow"]
    o_sh, d_sh = out0["shadow_o"][ws], out0["shadow_d"][ws]
    md_sh = out0["dist_adj_t"][ws]
    print(f"[slice-i] 44 ray sets: camera {o_cam.shape[0]}, bounce 1 "
          f"{o_b1.shape[0]}, shadow {o_sh.shape[0]} (one plain pass, "
          "spp 0)", flush=True)
    refs = {name: bk.bvh4_closest_hit_kernel(mesh.tri_bvh, o, d)
            for name, (o, d) in (("camera", (o_cam, d_cam)),
                                 ("bounce 1", (o_b1, d_b1)))}
    ref_any = bk.bvh4_any_hit_kernel(mesh.tri_bvh, o_sh, d_sh, md_sh)
    occl = ref_any < md_sh

    def closest_fn(accel):
        table = scenes[accel].tri_bvh
        if accel == "binned":
            return lambda o, d: ab.binned_closest_hit(table, o, d, mxu=True)
        return lambda o, d: _WALKS[accel][0](table, o, d)

    def any_fn(accel):
        """The triangles' any hit as shadow_distance takes it (binned
        behind the ray_key sort, over tri_shadow for hybrid)."""
        scn = scenes[accel]
        if accel in ("binned", "hybrid"):
            table = scn.tri_shadow if accel == "hybrid" else scn.tri_bvh
            return lambda o, d, m: sorted_traversal(
                lambda oo, dd, mm: ab.binned_any_hit(table, oo, dd, mm,
                                                     mxu=True), o, d, m)
        return lambda o, d, m: _WALKS[accel][1](scn.tri_bvh, o, d, m)

    tri64 = [x.double() for x in (mesh.triangles.v0, mesh.triangles.v1,
                                  mesh.triangles.v2)]

    for accel in ("bvh", "bvh4q", "grid", "binned", "hybrid"):
        # binned's matmul form holds JAX's own binned bar
        # (tests/test_binned.py:37-49): t within 1e-4 relative and
        # absolute; the others 5e-6 relative (bit-equal as measured)
        tol = (1e-4, 1e-4) if accel == "binned" else (5e-6, 0.0)
        if accel != "hybrid":
            for name, (o, d) in (("camera", (o_cam, d_cam)),
                                 ("bounce 1", (o_b1, d_b1))):
                fn = closest_fn(accel)
                t_a, i_a = fn(o, d)
                t_r, i_r = refs[name]
                diff = torch.nonzero(i_a != i_r)[:, 0]
                ties, ta, tb = _edge_ties(tri64, o, d, diff, i_a, i_r)
                hit = (i_r >= 0) & (i_a == i_r)
                err_t = ((t_a - t_r).abs()
                         - tol[0] * t_r.abs())[hit].max().item() \
                    if bool(hit.any()) else 0.0
                rel = ((t_a - t_r).abs() / t_r.abs())[hit].max().item() \
                    if bool(hit.any()) else 0.0
                runs = [_timed(lambda: fn(o, d))[0] for _ in range(REPS)]
                ms = statistics.median(runs)
                named = ", ".join(
                    f"lane {int(ln)}: {int(i_a[ln])} / K3 {int(i_r[ln])} "
                    f"t {float(x):.7g} / {float(y):.7g}"
                    for ln, x, y in zip(diff[:4], ta[:4], tb[:4]))
                check(f"44 {accel} closest hit, {name} rays",
                      bool(ties.all()) and err_t <= tol[1]
                      and (accel == "binned" or diff.numel() == 0)
                      and bool((t_a[i_r < 0] == TMAX).all()),
                      f"ids equal to K3's on {i_r.numel() - diff.numel()} "
                      f"of {i_r.numel()} lanes; of the other "
                      f"{diff.numel()}, {int(ties.sum())} hit both "
                      f"triangles at one distance ({named}); max relative dt "
                      f"{rel:.3g} (bar {tol[0]:g} relative + {tol[1]:g}); "
                      f"{ms:.3f} ms per traversal (median of {REPS}: "
                      f"{_runs(runs)}), {card}")
        fn = any_fn(accel)
        t_a = fn(o_sh, d_sh, md_sh)
        same = torch.equal(t_a < md_sh, occl)
        runs = [_timed(lambda: fn(o_sh, d_sh, md_sh))[0] for _ in range(REPS)]
        ms = statistics.median(runs)
        check(f"44 {accel} any hit, shadow rays", same,
              f"verdicts equal to K4's {same} ({int(occl.sum())} of "
              f"{occl.numel()} occluded); {ms:.3f} ms per traversal "
              f"(median of {REPS}: {_runs(runs)}), {card}")
    for name, (o, d) in (("camera", (o_cam, d_cam)),
                         ("bounce 1", (o_b1, d_b1))):
        ms, runs = _median(lambda: bk.bvh4_closest_hit_kernel(
            mesh.tri_bvh, o, d))
        print(f"[slice-i] 44 bvh4 K3 for scale, {name} rays: {ms:.3f} ms "
              f"(median of {REPS}: {_runs(runs)}), {card}", flush=True)
    ms, runs = _median(lambda: bk.bvh4_any_hit_kernel(mesh.tri_bvh, o_sh,
                                                       d_sh, md_sh))
    print(f"[slice-i] 44 bvh4 K4 for scale, shadow rays: {ms:.3f} ms "
          f"(median of {REPS}: {_runs(runs)}), {card}", flush=True)

    # ---- 45. each accelerator's pass: kernels against its plain version
    depth = 5
    for accel, scn in scenes.items():
        reset()
        k_out = wf.trace_paths(scn, o_cam, d_cam, seed, morton, spp0, depth,
                               with_metrics=True, fast_shade="shade")
        got = counts()
        p_out = wf.trace_paths(scn, o_cam, d_cam, seed, morton, spp0, depth,
                               with_metrics=True)
        torch.cuda.synchronize()
        bad, e_same, e_all, f = _compare(k_out, p_out)
        want = {**dict.fromkeys(counters, 0), "k2_shade": depth + 1}
        if accel == "hybrid":
            want["k3_bvh4_closest"] = depth + 1
        check(f"45 {accel} trace_paths {size}x{size} depth {depth} kernels "
              "vs plain", not f and got == want,
              f"good differs on {bad:.7f} of lanes, max|dL| {e_all:.3g}, "
              f"rays {int(k_out[2]['rays'])}, shadow rays "
              f"{int(k_out[2]['shadow_rays'])}, launches {got} {f}")

    # ---- 46. the Renderer on each accelerator against golden_mesh_mid
    golden = os.path.join(REPO, "tests", "goldens", "golden_mesh_mid.is")
    for accel in ("hybrid", "bvh", "grid", "bvh4q", "binned"):
        # binned's walk is the slowest by far: 12 spp in one pass, the
        # others 16 in two
        spp, batch = (12, 12) if accel == "binned" else (16, 8)
        scn = scenes[accel]
        r = Renderer(scn, mcam, mfilm, RenderConfig(num_samples=spp,
                                                    max_depth=depth,
                                                    spp_batch=batch))
        reset()
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = counts()
        full_o, full_r, dmax, share, gf = _golden(r.raw_mean(), golden)
        per = (depth + 1) * r.passes
        want = {**dict.fromkeys(counters, 0), "k2_shade": per}
        if accel == "hybrid":
            want["k3_bvh4_closest"] = per
        for k in ("k2_shade", "k3_bvh4_closest"):
            if k in kernels:
                kernels[k]["launches"] += got[k]
        check(f"46 Renderer {accel} {size}x{size} x {spp} spp depth {depth}",
              not gf and r.nan_count == 0 and got == want,
              f"{r.passes} passes of B {r.spp_batch}, {dt:.3f} s, "
              f"{1e3 * dt / r.passes:.1f} ms/pass, {card}; tone-mapped mean "
              f"{full_o:.5f} vs golden {full_r:.5f}, block dev max "
              f"{dmax:.4f}, share < 0.02 {share:.3f}, NaN substituted "
              f"{r.nan_count}, launches {got} {gf}")

    # ---- 47. AO on parity_mesh_mid's bvh4 at the camera hits
    hits = hit0.t < TMAX
    hp, nrm = hit0.point[hits], hit0.normal[hits]
    u2 = uniforms(seed, morton[hits], 0, 0, 2)
    reset()
    t_k = ao_test(mesh, hp, nrm, u2)
    got = counts()
    t_p = ao_test(mesh, hp, nrm, u2, kernels=False)
    same = torch.equal(t_k, t_p)
    check("47 ao_test through K4 vs the plain any hit", same
          and got == {**dict.fromkeys(counters, 0), "k4_bvh4_any": 1},
          f"{hp.shape[0]} hits, t bit-equal {same}, occluded "
          f"{(t_k < TMAX).double().mean().item():.4f}, launches {got}")

    # ---- 48. the command line and the live views; the three batch runs
    # go side by side with the live one (each process takes seconds to
    # start), and every process started here is waited for or killed
    cli = [sys.executable, "-m", "craytracer_tpu_torch"]
    cfg_path = out_dir / "config_grid.txt"
    cfg_path.write_text(f"scene_file {MESH_MID}\nnum_samples 1\n"
                        "max_depth 5\naccel_struct GRID\n")
    caus = out_dir / "caustic_scene.txt"
    caus.write_text(
        "IMAGE_WIDTH 64\nIMAGE_HEIGHT 64\n\n"
        "MATERIAL MATTE\nNAME floor\nCOLOR 0.6 0.6 0.6\nSIGMA 0\n\n"
        "MATERIAL GLASS\nNAME gl\nROUGHNESS 0\n\n"
        "OBJECT SPHERE\nCENTER 0 2 0\nRADIUS 1\nMATERIAL gl\n\n"
        "OBJECT RECTANGLE\nPOINT -20 -1 -20\nWIDTH 40 0 0\n"
        "HEIGHT 0 0 40\nMATERIAL floor\n\n"
        "POINT_LIGHT\nPOINT 0 8 0\nCOLOR 1 1 1\nINTENSITY 50\n\n")
    ccfg = out_dir / "config_caustic.txt"
    ccfg.write_text(f"scene_file {caus}\nnum_samples 1\nmax_depth 1\n"
                    "caustic_map yes\n")
    batch = {
        "config GRID": ["--config", str(cfg_path), "--size", str(size),
                        "-o", str(out_dir / "cli_grid_a.ppm")],
        "--accel grid": ["--config", str(cfg_path), "--size", str(size),
                         "--accel", "grid", "-o",
                         str(out_dir / "cli_grid_b.ppm")],
        "caustic_map": ["--config", str(ccfg), "-o",
                        str(out_dir / "cli_caustic.ppm")]}
    procs, files = {}, []
    t_batch = time.perf_counter()
    for key, extra in batch.items():
        name = key.replace(" ", "_").strip("-")
        fo = open(out_dir / f"cli_{name}.out", "w+")
        fe = open(out_dir / f"cli_{name}.err", "w+")
        files += [fo, fe]
        procs[key] = (subprocess.Popen(cli + extra, cwd=REPO, stdout=fo,
                                       stderr=fe, text=True), fo, fe)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log_path = out_dir / "cli_live.log"
    err_path = out_dir / "cli_live.err"
    try:
        with open(log_path, "w") as log, open(err_path, "w") as errf:
            p = subprocess.Popen(
                cli + [SCENE, "--size", str(size), "--spp", "100000",
                       "--depth", "5", "--serve", str(port), "--live", "4",
                       "--interactive", "-o", str(out_dir / "cli_live.ppm")],
                cwd=REPO, stdin=subprocess.PIPE, stdout=log, stderr=errf,
                text=True)
            try:
                status = None
                deadline = time.time() + 120
                while time.time() < deadline and p.poll() is None:
                    try:
                        status = json.loads(urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/status",
                            timeout=5).read())
                        if status["spp"] >= 8:
                            break
                    except OSError:
                        pass
                    time.sleep(0.2)
                p.stdin.write("p 10,20\n")
                p.stdin.flush()
                time.sleep(1.0)
                frame = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/frame.png", timeout=5).read()
                status2 = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/status", timeout=5).read())
                p.stdin.write("stop\n")
                p.stdin.flush()
                p.stdin.close()
                rc = p.wait(timeout=120)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out = log_path.read_text()
        (out_dir / "cli_live.png").write_bytes(frame)
        img = read_png(str(out_dir / "cli_live.png"))
        summary = (out.strip().splitlines() or [""])[-1]
        passes = int(summary.split(" passes")[0].rsplit(" ", 1)[1]) \
            if " passes" in summary else -1
        ok = (rc == 0 and img.shape == (size, size, 3) and img.max() > 0
              and status is not None and 8 <= status["spp"] <= status2["spp"]
              and status2["total"] == 100000 and status2["nan"] == 0
              and "probe (10,20) @" in out and "stopped at" in out
              and "\x1b[38;2;" in out and "route bounce" in summary
              and f"launches K1 {passes}, K2 0, K3 0, K4 0" in summary
              and f"live view: http://localhost:{port}/" in out)
        check("48 CLI on Cornell through K1 with --serve, --live 4, "
              "--interactive", ok,
              f"exit {rc}; /status while rendering {status} then {status2};"
              f" /frame.png {len(frame)} bytes, {img.shape}; {passes} "
              f"passes; summary: {summary[:200]}")
        if not ok:
            print(out[-3000:], (err_path.read_text())[-3000:], flush=True)
        corn, ccam, cf0 = load_scene_file(SCENE, device=dev)
        prev = out_dir / "preview.png"
        r = Renderer(corn, ccam, Film(fov=cf0.fov, width=size, height=size),
                     RenderConfig(num_samples=4, max_depth=5,
                                  preview_path=str(prev), preview_every=2))
        r.render()
        pv = read_png(str(prev))
        want = (np.clip(r.image(), 0, 1) * 255).astype(np.uint8)
        check("48 preview PNG every 2 passes", np.array_equal(pv, want),
              f"{prev.name} {pv.shape} equals the last pass's image")
        res = {}
        for key, (q, fo, fe) in procs.items():
            rc_q = q.wait(timeout=300)
            fo.seek(0)
            fe.seek(0)
            res[key] = (rc_q, fo.read(), fe.read())
            print(f"[slice-i] 48 CLI {key} (exit {rc_q}, the three batch "
                  f"runs {time.perf_counter() - t_batch:.2f} s side by side "
                  f"with the live one): "
                  f"{(res[key][1].strip().splitlines() or [''])[-1]}",
                  flush=True)
    finally:
        for q, _, _ in procs.values():
            if q.poll() is None:
                q.kill()
                q.wait()
        for f in files:
            f.close()
    (ra, oa, ea), (rb, ob, eb) = res["config GRID"], res["--accel grid"]
    check("48 config GRID on the card, then --accel grid", ra == 0
          and rb == 0
          and "using bvh4 on the card (pass --accel grid to force)" in ea
          and "launches K1 0, K2 6, K3 6, K4 6" in oa
          and "CPU-era" not in eb and "launches K1 0, K2 6, K3 0, K4 0" in ob,
          "the config's GRID takes bvh4 (K3/K4) with the warning; an "
          "explicit --accel grid launches K2 and no K3")
    rc_c, oc, _ = res["caustic_map"]
    lines = [ln for ln in oc.splitlines() if ln.startswith("proj map:")]
    check("48 caustic_map", rc_c == 0 and len(lines) == 1
          and lines[0].startswith("proj map: point light 0 at [0.0, 8.0, "
                                  "0.0] coverage 0.")
          and lines[0].endswith(" (1 caustic objects)"),
          f"exit {rc_c}: {lines}")


def slice_h_phases(ctx) -> None:
    """Phases 49-50: slice H on the card (module docstring). `ctx` as for
    `slice_f_phases`; failures are appended."""
    import datetime
    import functools
    import tempfile

    import torch.distributed as dist

    from craytracer_tpu_torch.accel.bvh4_parts import PART_BUDGET_BYTES
    from craytracer_tpu_torch.camera import Film, make_camera
    from craytracer_tpu_torch.examples import inverse_mesh_demo as demo
    from craytracer_tpu_torch.integrator import wavefront as wf
    from craytracer_tpu_torch.integrator.render import (RenderConfig,
                                                        Renderer)
    from craytracer_tpu_torch.io.scenefile import load_scene_file
    from craytracer_tpu_torch.parallel import dryrun
    from craytracer_tpu_torch.parallel.sharded import (_grads, _mse,
                                                       with_grad_leaves)
    from craytracer_tpu_torch.scene import city, fullscene
    from craytracer_tpu_torch.scene import types as T

    dev, card, fails, kernels = ctx.dev, ctx.card, ctx.fails, ctx.kernels
    counters, seed, depth = ctx.counters, 0, 5
    size = getattr(ctx, "size", 512)
    passes = [0, 63, 1, 2, 3, 4]  # checked: the first two; timed: the rest

    def check(label, ok, detail=""):
        print(f"[slice-h] {label}: {detail}" + ("" if ok else " FAIL"),
              flush=True)
        if not ok:
            fails.append(f"{label}: {detail}")

    def add_launches(got):
        for name, n in got.items():
            if name in kernels:
                kernels[name]["launches"] += n

    def close(a, b, rtol, atol):
        """|a - b| <= atol + rtol |b| everywhere, and the worst excess."""
        a, b = a.double().cpu(), b.double().cpu()
        excess = ((a - b).abs() - atol - rtol * b.abs()).max().item() \
            if a.numel() else 0.0
        return a.shape == b.shape and excess <= 0.0, excess

    # ---- 49. slice H: every rank on this card, gloo, kernels prebuilt
    corn, ccam, cf0 = load_scene_file(SCENE, device="cpu")
    mesh, mcam, mf0 = load_scene_file(MESH_MID, device="cpu")
    cfilm = Film(fov=cf0.fov, width=size, height=size)
    mfilm = Film(fov=mf0.fov, width=size, height=size)
    dscene, _ = demo.build(demo.checker(64), device="cpu")
    dcam = make_camera(demo.EYE, demo.LOOK, device="cpu")
    dfilm = Film(fov=torch.tensor(np.radians(demo.FOV_DEG),
                                  dtype=torch.float32), width=128,
                 height=128)
    t0 = time.perf_counter()
    dryrun.prebuild([corn, mesh, dscene])
    print(f"[slice-h] 49 kernels prebuilt in this process before the ranks "
          f"start: {time.perf_counter() - t0:.2f} s", flush=True)
    ray_case = dict(kind="render", mesh=(2, 1), scene=corn, camera=ccam,
                    film=cfilm, depth=depth, seed=seed, spp=passes)
    geom_case = dict(kind="render", mesh=(1, 2), scene=mesh, camera=mcam,
                     film=mfilm, depth=depth, seed=seed, spp=passes,
                     first_hit=True)
    train = dict(kind="train", scene=dscene, camera=dcam, film=dfilm,
                 depth=2, seed=7, spp=0, repeats=3,
                 target=torch.zeros((dfilm.num_pixels, 3)))
    trains = {"sharded (2, 1)": dict(train, mesh=(2, 1), step="sharded"),
              "bucketed (2, 1)": dict(train, mesh=(2, 1), step="bucketed"),
              "geometry (1, 2)": dict(train, mesh=(1, 2))}
    # (e) bvh shards of parity_mesh_mid; (f) the 7M city past the part
    # budget, each rank making the city's triangles itself (a 1 GB pickle
    # otherwise) and its shard's bvh4 table and parts
    mesh_bvh = load_scene_file(MESH_MID, accel="bvh", device="cpu")[0]
    spp_ef = passes[:2]  # checked; the second (spp 63) also timed
    bvh_case = dict(geom_case, scene=mesh_bvh, accel="bvh", spp=spp_ef)
    n_city = CITY_TRIS // city.TRIS_PER_SPHERE * city.TRIS_PER_SPHERE
    kcam, kfilm = city.city_view(n_city, 256, device="cpu")
    city_depth = 4  # bench_mesh.py's setting
    city_case = dict(kind="render", mesh=(1, 2), camera=kcam, film=kfilm,
                     scene=functools.partial(city.city_scene, CITY_TRIS,
                                             "none", "cpu"),
                     depth=city_depth, seed=seed, spp=spp_ef,
                     first_hit=True)
    cases = [ray_case, geom_case, *trains.values(), bvh_case, city_case]
    t0 = time.perf_counter()
    results, setup = dryrun.launch(2, cases, "gloo", None, timeout=700)
    wall = time.perf_counter() - t0
    print(f"[slice-h] 49 two rank processes, both on cuda:0 over gloo (its "
          f"CUDA tensors reduce through the host; NCCL refuses two ranks on "
          f"one GPU): {card}; process group up after {max(setup):.2f} s, "
          f"the world's {len(cases)} cases done in {wall:.2f} s", flush=True)

    def one_process(scn, c, fm, spp, depth=depth):
        ids = torch.arange(fm.num_pixels, dtype=torch.int32, device=dev)
        with torch.no_grad():
            img, good, m = wf.render_sample(
                T.to_device(scn, dev), T.to_device(c, dev),
                T.to_device(fm, dev), ids, seed, spp, depth,
                with_metrics=True)
        return img, good, m["lane_rays"], m["lane_shadow_rays"]

    def pass_ms(rank_out, first=2):
        return statistics.median(
            p["seconds"] for p in rank_out["passes"][first:]) * 1e3

    def geom_shards(label, i, scn, c, fm, dpt, want):
        """A geometry-sharded case against the one-process pass: at the
        first two spp `good` and the counters equal and L within 2e-5 on
        every lane; the launches `want` (a callable of the rank's result)
        a rank and pass; the bounce-0 winners that differ, counted."""
        for k, spp in enumerate(passes[:2]):
            ref = one_process(scn, c, fm, spp, dpt)
            for r in results:
                p = r[i]["passes"][k]
                ok_l, excess = close(p["L"], ref[0], L_TOL, L_TOL)
                same = [torch.equal(p[key], ref[j].cpu()) for j, key in
                        enumerate(("good", "lane_rays", "lane_shadow_rays"),
                                  1)]
                check(f"{label} spp {spp} rank {r[i]['rank']}",
                      ok_l and all(same),
                      f"good, rays, shadow rays equal {same}; L within 2e-5 "
                      f"{ok_l} (worst excess {excess:.3g})")
        ids = torch.arange(fm.num_pixels, dtype=torch.int32, device=dev)
        c_d, fm_d = T.to_device(c, dev), T.to_device(fm, dev)
        o, d = wf.camera_rays(c_d, fm_d, ids, seed, 0,
                              wf.film_jitter(seed, ids, 0))
        with torch.no_grad():
            hit = wf._closest_hit(T.to_device(scn, dev), o, d, True, None,
                                  0)
        ref_hit = torch.stack([hit.group, hit.prim], dim=1).cpu()
        for r in results:
            out = r[i]
            diff = int((out["first_hit"] != ref_hit).any(dim=1).sum())
            got = [p["counts"] for p in out["passes"]]
            w = want(out)
            check(f"{label} rank {out['rank']} (tri_base {out['tri_base']}, "
                  f"{out['n_tris']} triangles, {out['parts']} parts)",
                  all(g == dict(dict.fromkeys(g, 0), **w) for g in got),
                  f"launches {got[0]} per pass x {len(got)} (want {w}); "
                  f"bounce-0 winning triangle differs from the unsharded one "
                  f"on {diff} of {ids.shape[0]} lanes; its scene made and "
                  f"placed in {out['scene_seconds']:.2f} s")
            add_launches({k: sum(g[k] for g in got) for k in got[0]})
        print(f"[time] {card}, {label} {fm.width}x{fm.height} depth {dpt}, "
              f"G=2 on one card: {pass_ms(results[0][i], 1):.3f} / "
              f"{pass_ms(results[1][i], 1):.3f} ms per pass (rank 0 / 1, "
              f"host clock, the per-bounce hit reductions through the host "
              f"included; the spp-63 pass, after the first); rank setup "
              f"{max(setup):.2f} s", flush=True)

    # (a) ray-sharded Cornell: one K1 launch per rank per pass, every lane
    # equal to the one-process pass
    for k, spp in enumerate(passes[:2]):
        ref = one_process(corn, ccam, cfilm, spp)
        for r in results:
            p = r[0]["passes"][k]
            same = [torch.equal(p[key], ref[i].cpu()) for i, key in
                    enumerate(("L", "good", "lane_rays", "lane_shadow_rays"))]
            check(f"49 (a) ray-sharded Cornell 512x512 R=2 spp {spp} rank "
                  f"{r[0]['rank']}", all(same),
                  f"L, good, rays, shadow rays bit-equal with the one-process"
                  f" pass {same}")
    for r in results:
        got = [p["counts"] for p in r[0]["passes"]]
        check(f"49 (a) launches rank {r[0]['rank']}", all(
            g == dict(g, k1_pass=1) and sum(g.values()) == 1 for g in got),
            f"{got[0]} per pass x {len(got)} (one K1 a pass, nothing else)")
        add_launches({k: sum(g[k] for g in got) for k in got[0]})
    print(f"[time] {card}, 49 (a) ray-sharded Cornell 512x512 depth 5, R=2 "
          f"on one card: {pass_ms(results[0][0]):.3f} / "
          f"{pass_ms(results[1][0]):.3f} ms per pass (rank 0 / 1, host clock"
          f" around the pass and its all-reduce, median of {len(passes) - 2})",
          flush=True)

    # (b) geometry-sharded mesh: K3 = K2 = K4 = 6 per rank per pass, good
    # and the counters equal to the one-process pass, L within 2e-5
    for k, spp in enumerate(passes[:2]):
        ref = one_process(mesh, mcam, mfilm, spp)
        for r in results:
            p = r[1]["passes"][k]
            ok_l, excess = close(p["L"], ref[0], L_TOL, L_TOL)
            same = [torch.equal(p[key], ref[i].cpu()) for i, key in
                    enumerate(("good", "lane_rays", "lane_shadow_rays"), 1)]
            check(f"49 (b) geometry-sharded parity_mesh_mid 512x512 G=2 spp "
                  f"{spp} rank {r[1]['rank']}", ok_l and all(same),
                  f"good, rays, shadow rays equal {same}; L within 2e-5 "
                  f"{ok_l} (worst excess {excess:.3g})")
    ids = torch.arange(mfilm.num_pixels, dtype=torch.int32, device=dev)
    o, d = wf.camera_rays(T.to_device(mcam, dev), T.to_device(mfilm, dev),
                          ids, seed, 0, wf.film_jitter(seed, ids, 0))
    with torch.no_grad():
        hit = wf._closest_hit(T.to_device(mesh, dev), o, d, True, None, 0)
    ref_hit = torch.stack([hit.group, hit.prim], dim=1).cpu()
    for r in results:
        diff = int((r[1]["first_hit"] != ref_hit).any(dim=1).sum())
        got = [p["counts"] for p in r[1]["passes"]]
        check(f"49 (b) rank {r[1]['rank']} (tri_base {r[1]['tri_base']}, "
              f"{r[1]['n_tris']} triangles)", all(
                  g == dict(g, k2_shade=6, k3_bvh4_closest=6, k4_bvh4_any=6)
                  and sum(g.values()) == 18 for g in got),
              f"launches {got[0]} per pass x {len(got)} (K3 = K2 = K4 = 6, "
              f"K1 0); bounce-0 winning triangle differs from the "
              f"unsharded one on {diff} of {ids.shape[0]} lanes")
        add_launches({k: sum(g[k] for g in got) for k in got[0]})
    print(f"[time] {card}, 49 (b) geometry-sharded parity_mesh_mid 512x512 "
          f"depth 5, G=2 on one card: {pass_ms(results[0][1]):.3f} / "
          f"{pass_ms(results[1][1]):.3f} ms per pass (rank 0 / 1, host clock,"
          f" the per-bounce hit reductions through the host included, "
          f"median of {len(passes) - 2})", flush=True)

    # (e) bvh shards: K2 = 6 a rank and pass, no K3 / K4
    geom_shards("49 (e) bvh geometry shards of parity_mesh_mid", 5,
                mesh_bvh, mcam, mfilm, depth,
                lambda out: {"k2_shade": depth + 1})
    # (f) the 7M city's shards, each past the part budget: K3 _init and K4
    # per part of the rank's shard a bounce, K2 a bounce
    big = getattr(ctx, "city", None)
    if big is None:
        t0 = time.perf_counter()
        big = city.city_scene(CITY_TRIS, device=dev)
        torch.cuda.synchronize()
        print(f"[slice-h] 49 (f) the one-process city built here: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    check("49 (f) shards past the budget", all(
        r[6]["parts"] > 1 and r[6]["n_tris"] * 2 >= n_city
        for r in results), f"parts per rank "
        f"{[r[6]['parts'] for r in results]} under the "
        f"{PART_BUDGET_BYTES} B budget; the one-process table "
        f"{len(big.tri_parts or ())} parts")
    b = city_depth + 1
    geom_shards("49 (f) the 7M city over 2 geometry shards", 6, big, kcam,
                kfilm, city_depth,
                lambda out: {"k2_shade": b,
                             "k3_init_bvh4_closest": b * out["parts"],
                             "k4_bvh4_any": b * out["parts"]})
    del big

    # (c) the train steps against the one-process gradient
    dsc = T.to_device(dscene, dev)
    scene_g, leaves = with_grad_leaves(dsc)
    img = wf.render_sample(scene_g, T.to_device(dcam, dev),
                           T.to_device(dfilm, dev),
                           torch.arange(dfilm.num_pixels, dtype=torch.int32,
                                        device=dev), 7, 0, 2,
                           estimator="physical")
    loss1 = _mse(img, torch.zeros_like(img))
    grads1 = dict(zip(leaves, _grads(loss1, leaves)))
    loss1 = float(loss1.detach())
    for i, (name, case) in enumerate(trains.items(), 2):
        outs = [r[i] for r in results]
        if case["mesh"][1] > 1:
            # JAX's convention (parallel/geom.py): each geometry rank's
            # gradient is its own, the winner's fill taking G times the
            # cotangent; their mean over the axis is the gradient, and of
            # the triangle rows each shard's block
            ps = [o["passes"][-1] for o in outs]
            grads = {k: sum(p["grads"][k] for p in ps) / 2.0
                     for k in ps[0]["grads"] if not k.startswith("triangles.")}
            for k in ps[0]["grads"]:
                if k.startswith("triangles."):
                    grads[k] = torch.cat([p["grads"][k][:o["n_tris"]]
                                          for p, o in zip(ps, outs)]) / 2.0
            outs = [dict(outs[0], rank="0 + 1 (mean over the geometry "
                         "axis)", passes=[dict(ps[0], grads=grads)])]
        for o in outs:
            p = o["passes"][-1]
            bad = []
            ok, ex = close(torch.tensor(p["loss"]), torch.tensor(loss1),
                           1e-4, 1e-6)
            if not ok:
                bad.append(f"loss {p['loss']} vs {loss1}")
            for leaf, g in p["grads"].items():
                ok, ex = close(g, grads1[leaf].cpu(), 1e-4, 1e-6)
                if not ok:
                    bad.append(f"{leaf} (excess {ex:.3g})")
            check(f"49 (c) {name} train step rank {o['rank']}", not bad,
                  f"loss {p['loss']:.9g} vs one process {loss1:.9g}, "
                  f"{len(p['grads'])} leaves within 1e-4 / 1e-6"
                  + (f"; off: {bad}" if bad else ""))
        secs = [q["seconds"] for q in results[0][i]["passes"]]
        print(f"[time] {card}, 49 (c) {name} train step, demo scene 128x128 "
              f"depth 2: {', '.join(f'{s:.3f}' for s in secs)} s per step "
              f"(the first with the rank's warm-up)", flush=True)

    # (d) NCCL at world size 1 through (a)'s code, in this process
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'rdv')}",
            world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
        try:
            out = dryrun.run_case(dict(ray_case, mesh=(1, 1),
                                       spp=passes[:2]), None)
        finally:
            dist.destroy_process_group()
    for k, spp in enumerate(passes[:2]):
        ref = one_process(corn, ccam, cfilm, spp)
        p = out["passes"][k]
        same = [torch.equal(p[key], ref[i].cpu()) for i, key in
                enumerate(("L", "good", "lane_rays", "lane_shadow_rays"))]
        check(f"49 (d) NCCL world size 1, (a)'s code, spp {spp}", all(same)
              and p["counts"]["k1_pass"] == 1,
              f"bit-equal with the one-process pass {same}, launches "
              f"{p['counts']}; {time.perf_counter() - t0:.2f} s with the "
              f"group's setup")

    # ---- 50. the XL fullscene through the parts route
    xl_obj = fullscene.OBJ_XL
    try:
        t0 = time.perf_counter()
        fullscene.write_obj(xl_obj, fullscene.SPHERES_XL, xl=True)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        xl, xcam, xf0 = load_scene_file(
            os.path.join(REPO, "scenes", "fullscene_xl.txt"), device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        if os.path.exists(xl_obj):
            os.remove(xl_obj)
    xfilm = Film(fov=xf0.fov, width=size, height=size)
    table, parts = xl.tri_bvh, xl.tri_parts or ()
    route = wf.production_fast_shade(xl, xcam, xfilm)
    n_xl = xl.triangles.mat_id.shape[0]
    check("50 XL fullscene", n_xl == fullscene.triangle_count(
        fullscene.SPHERES_XL, xl=True) == 2_568_192 and route == "general"
        and len(parts) > 1,
        f"{card}; OBJ written in {write_s:.2f} s (then deleted), "
        f"scenes/fullscene_xl.txt loaded and built in {load_s:.2f} s: "
        f"{n_xl} triangles, {table.fat.shape[0]} fat rows, "
        f"{table.fat.numel() * 4 / 1e6:.1f} MB table, {len(parts)} parts "
        f"under the {PART_BUDGET_BYTES} B budget, route {route}")
    xcfg = RenderConfig(num_samples=4, max_depth=depth,
                        estimator="reference")
    xids = torch.from_numpy(Renderer(xl, xcam, xfilm, xcfg).pixel_order()
                            ).to(dev)
    spp = torch.zeros_like(xids)
    o, d = wf.camera_rays(xcam, xfilm, xids, seed, spp,
                          wf.film_jitter(seed, xids, spp))
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    out_k = wf.trace_paths(xl, o, d, seed, xids, spp, depth,
                           with_metrics=True, fast_shade="shade",
                           general=True)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    got = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    out_p = wf.trace_paths(xl, o, d, seed, xids, spp, depth,
                           with_metrics=True, general=True)
    torch.cuda.synchronize()
    t_p = time.perf_counter() - t0
    bad, err_same, err_all, f = _compare(out_k, out_p)
    check("50 XL general route through K3 _init / K4 per part vs plain, "
          "512x512 Morton lanes, depth 5, spp 0", not f and
          got["k3_init_bvh4_closest"] == got["k4_bvh4_any"] == 6 * len(parts)
          and got["k3_bvh4_closest"] == 0,
          f"good differs on {bad:.5f}, max|dL| {err_same:.3g} (agreeing "
          f"lanes) {err_all:.3g} (all), launches {got}; {t_k:.2f} s "
          f"through the kernels, {t_p:.2f} s plain" + (f"; {f}" if f else ""))
    r = Renderer(xl, xcam, xfilm, xcfg)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    r.render()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {k: c.launches for k, c in counters.items()}
    img = r.raw_mean()
    check("50 XL Renderer 512x512 x 4 spp depth 5", r.nan_count == 0 and
          np.isfinite(img).all() and img.mean() > 0.0 and
          got["k3_init_bvh4_closest"] == got["k4_bvh4_any"]
          == 6 * len(parts) * r.passes,
          f"{dt:.2f} s, {r.passes} passes, launches {got}, {r.nan_count} "
          f"NaN, mean {img.mean():.4f}")
    add_launches(got)
    ctx.xl = (xl, xcam, xfilm)  # phase 53's scene, not built again


def slice_k_phases(ctx) -> None:
    """Phases 51-54: slice K on the card (module docstring). `ctx` as for
    `slice_f_phases`, with phase 50's XL fullscene in `ctx.xl` when this
    run loaded it (else it is written and loaded here); failures are
    appended."""
    import torch_general_scenes as general_scenes
    from craytracer_tpu_torch.camera import Film, make_camera
    from craytracer_tpu_torch.examples import inverse_demo
    from craytracer_tpu_torch.examples import inverse_mesh_demo as mdemo
    from craytracer_tpu_torch.integrator import wavefront as wf
    from craytracer_tpu_torch.integrator.render import (RenderConfig,
                                                        Renderer)
    from craytracer_tpu_torch.interop import numpy_leaves, scene_from_numpy
    from craytracer_tpu_torch.inverse import (InverseConfig, deterministic,
                                              render_mean)
    from craytracer_tpu_torch.io.objloader import load_obj
    from craytracer_tpu_torch.io.scenefile import load_scene_file
    from craytracer_tpu_torch.scene import fullscene
    from craytracer_tpu_torch.scene import types as T
    from craytracer_tpu_torch.scene.build import SceneBuilder

    dev, card, fails, kernels = ctx.dev, ctx.card, ctx.fails, ctx.kernels
    counters, seed, depth = ctx.counters, 0, 5
    size = getattr(ctx, "size", 512)
    accels = ("bvh", "bvh4q", "grid", "binned", "hybrid")

    def reset():
        for c in counters.values():
            c.launches = 0

    def counts():
        return {k: c.launches for k, c in counters.items()}

    def want(**kw):
        return {**dict.fromkeys(counters, 0), **kw}

    def check(label, ok, detail=""):
        print(f"[slice-k] {label}: {detail}" + ("" if ok else " FAIL"),
              flush=True)
        if not ok:
            fails.append(f"{label}: {detail}")

    def add_launches(got, *names):
        for name in names:
            if name in kernels:
                kernels[name]["launches"] += got[name]

    # ---- 51. mesh_env_disk on the general route under every accelerator
    shapes = [(sh.positions, sh.indices) for sh in load_obj(
        os.path.join(REPO, "scenes", "parity_mesh_mid.obj"))[0]]
    scenes = {}
    for accel in ("bvh4",) + accels:
        b = SceneBuilder()
        eye, look, fov, _ = general_scenes.mesh_env_disk(b, shapes)
        t0 = time.perf_counter()
        scenes[accel] = scene_from_numpy(general_scenes.make_anisotropic(
            numpy_leaves(b.build(accel=accel, device="cpu"))), device=dev)
        torch.cuda.synchronize()
        print(f"[slice-k] 51 mesh_env_disk with {accel}: built and placed "
              f"in {time.perf_counter() - t0:.3f} s (host build, then to "
              f"the card)", flush=True)
    cam = make_camera(eye, look, device=dev)
    film = Film(fov=torch.tensor(fov, dtype=torch.float32, device=dev),
                width=size, height=size)
    morton = torch.from_numpy(Renderer(scenes["bvh4"], cam, film,
                                       RenderConfig()).pixel_order()).to(dev)
    tri64 = [x.double() for x in (scenes["bvh4"].triangles.v0,
                                  scenes["bvh4"].triangles.v1,
                                  scenes["bvh4"].triangles.v2)]

    def traced(scn, s, mis=False):
        """trace_paths on the gate's route at spp `s` on every lane, each
        bounce's hits recorded, the counts set to 0 just before and read
        just after: (route, (L, good, metrics), hits, launches, ms)."""
        route = wf.production_fast_shade(scn, cam, film,
                                         "mis" if mis else "physical", depth)
        spp = torch.full_like(morton, s)
        o, d = wf.camera_rays(cam, film, morton, seed, spp,
                              wf.film_jitter(seed, morton, spp))
        hits, closest = [], wf._closest_hit

        def record(scene, o, d, *a, **k):
            hit = closest(scene, o, d, *a, **k)
            hits.append((o, d, hit.group, hit.prim))
            return hit

        wf._closest_hit = record
        try:
            reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = wf.trace_paths(scn, o, d, seed, morton, spp, depth,
                                 with_metrics=True, fast_shade="shade",
                                 general=route == "general", mis=mis)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = counts()
        finally:
            wf._closest_hit = closest
        return route, out, hits, got, ms

    def against(out, ref, hits, ref_hits, edges_ok):
        """Phase 8's bars on every lane against the bvh4 pass; with
        `edges_ok`, a lane that differs is excused when its first bounce
        whose winner differs has a ray through an edge the two triangles
        share at one distance (phase 44's count). (failures, excused lane
        ids)."""
        (Lk, gk, mk), (Lp, gp, mp) = out, ref
        Lk, Lp = Lk.double(), Lp.double()
        ok = ((gk == gp) & ((Lk - Lp).abs()
                            <= L_TOL + L_TOL * Lp.abs()).all(dim=1)
              & (mk["lane_rays"] == mp["lane_rays"])
              & (mk["lane_shadow_rays"] == mp["lane_shadow_rays"]))
        bad = torch.nonzero(~ok)[:, 0]
        edge = torch.zeros_like(bad, dtype=torch.bool)
        seen = torch.zeros_like(edge)
        for (o, d, g, p), (_, _, g0, p0) in zip(hits, ref_hits):
            new = ((g != g0) | (p != p0))[bad] & ~seen
            if bool(new.any()):
                lanes = bad[new]
                tris = ((g[lanes] == T.GROUP_TRIANGLE)
                        & (g0[lanes] == T.GROUP_TRIANGLE))
                edge[new] = _edge_ties(tri64, o, d, lanes, p, p0)[0] & tris
                seen |= new
        excused = bad[edge] if edges_ok else bad[:0]
        f = []
        if bad.numel() > excused.numel():
            f.append(f"{bad.numel() - excused.numel()} lanes off the bars")
        if not bad.numel():
            for key in ("bounce_live", "rays", "shadow_rays"):
                if not torch.equal(mk[key], mp[key]):
                    f.append(f"{key} differs")
        if not bool(torch.isfinite(Lk).all()):
            f.append("non-finite L")
        return f, excused

    refs = {}
    for s in (0, 63):
        refs[s] = traced(scenes["bvh4"], s)
        route, _, _, got, ms = refs[s]
        check(f"51 bvh4 reference pass spp {s}", route == "general"
              and got == want(k3_bvh4_closest=depth + 1,
                              k4_bvh4_any=depth + 1),
              f"route {route}, launches {got}, {ms:.1f} ms, {card}")
    for accel in accels:
        for s in (0, 63):
            route, out, hits, got, ms = traced(scenes[accel], s)
            f, excused = against(out, refs[s][1], hits, refs[s][2],
                                 accel == "binned")
            w = want(k3_bvh4_closest=depth + 1) if accel == "hybrid" \
                else want()
            named = ", ".join(str(int(x)) for x in excused[:8])
            check(f"51 {accel} general route {size}x{size} depth {depth} "
                  f"spp {s} vs bvh4's K3/K4 pass", route == "general"
                  and not f and got == w,
                  f"route {route}; {excused.numel()} shared-edge lanes "
                  f"excused ({named}); launches {got}; {ms:.1f} ms per pass"
                  f", {card}" + (f"; {f}" if f else ""))
            add_launches(got, "k3_bvh4_closest")
    route_r, ref_m, ref_mh, got, ms_r = traced(scenes["bvh4"], 0, mis=True)
    route, out, hits, got_h, ms = traced(scenes["hybrid"], 0, mis=True)
    f, _ = against(out, ref_m, hits, ref_mh, False)
    check(f"51 hybrid under MIS {size}x{size} depth {depth} spp 0 vs bvh4's "
          "MIS pass", route == route_r == "general" and not f
          and got == want(k3_bvh4_closest=depth + 1, k4_bvh4_any=depth + 1)
          and got_h == want(k3_bvh4_closest=depth + 1),
          f"launches bvh4 {got}, hybrid {got_h}; {ms_r:.1f} / {ms:.1f} ms "
          f"per pass, {card}" + (f"; {f}" if f else ""))
    add_launches(got_h, "k3_bvh4_closest")
    del scenes, refs, route_r, ref_m, ref_mh, out, hits

    # ---- 52. the Renderer on parity_textured under every accelerator
    textured = os.path.join(REPO, "scenes", "parity_textured.txt")
    golden = os.path.join(REPO, "tests", "goldens", "golden_textured.is")
    cfg = RenderConfig(num_samples=160, max_depth=depth,
                       estimator="reference", spp_batch=32)
    os.environ["CRAY_TEX_FLOAT_DIV255"] = "1"  # the golden's EXR scale
    try:
        tex = {a: load_scene_file(textured, accel=a, device=dev)
               for a in accels}
    finally:
        del os.environ["CRAY_TEX_FLOAT_DIV255"]
    t_all = time.perf_counter()
    for accel, (scn, c, fm) in tex.items():
        route = wf.production_fast_shade(scn, c, fm, cfg.estimator, depth)
        r = Renderer(scn, c, fm, cfg)
        reset()
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = counts()
        full_o, full_r, dmax, share, gf = _golden(r.raw_mean(), golden)
        w = want(k3_bvh4_closest=(depth + 1) * r.passes) \
            if accel == "hybrid" else want()
        check(f"52 Renderer parity_textured {accel} {fm.width}x{fm.height} "
              f"x {cfg.num_samples} spp depth {depth}", route == "general"
              and not gf and r.nan_count == 0 and got == w,
              f"route {route}, {r.passes} passes of B {r.spp_batch}, "
              f"{dt:.3f} s, {1e3 * dt / r.passes:.1f} ms/pass, {card}; "
              f"tone-mapped mean {full_o:.5f} vs golden {full_r:.5f}, block "
              f"dev max {dmax:.4f}, share < 0.02 {share:.3f}, NaN "
              f"substituted {r.nan_count}, launches {got} {gf}")
        add_launches(got, "k3_bvh4_closest")
    print(f"[slice-k] 52 the five Renderers: "
          f"{time.perf_counter() - t_all:.2f} s", flush=True)
    del tex

    # ---- 53. the XL fullscene's gradient through the parts route
    if getattr(ctx, "xl", None) is None:
        try:
            t0 = time.perf_counter()
            fullscene.write_obj(fullscene.OBJ_XL, fullscene.SPHERES_XL,
                                xl=True)
            xs, xc, xf0 = load_scene_file(
                os.path.join(REPO, "scenes", "fullscene_xl.txt"), device=dev)
        finally:
            if os.path.exists(fullscene.OBJ_XL):
                os.remove(fullscene.OBJ_XL)
        ctx.xl = (xs, xc, Film(fov=xf0.fov, width=512, height=512))
        print(f"[slice-k] 53 the XL fullscene written and loaded here: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    xl, xcam, xfilm = ctx.xl
    parts = len(xl.tri_parts or ())
    t_off = int(xl.textures.offset[0])
    t_n = int(xl.textures.width[0]) * int(xl.textures.height[0])
    metal = int(torch.nonzero(xl.materials.mat_type == T.MAT_METAL)[0])
    graft = mdemo.grafter(xl, metal)
    gcfg = InverseConfig(max_depth=2, estimator="mis", spp_per_step=1)
    gpix = torch.arange(xfilm.num_pixels, dtype=torch.int32, device=dev)

    def xl_grad(kernels, remat=False):
        """The mean image's gradient w.r.t. texture 0's texels and the
        METAL row's alpha (phase 37 (e)), the counts set to 0 just before
        and read just after: (loss, texel grad, alpha grad, s, GB,
        launches)."""
        p = {"texels": xl.textures.texels[t_off:t_off + t_n].clone()
             .requires_grad_(True),
             "alpha": xl.materials.alphax[metal].clone().requires_grad_(True)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        with deterministic():
            if remat:
                o, d = wf.camera_rays(xcam, xfilm, gpix, 7, 0,
                                      wf.film_jitter(7, gpix, 0))
                img = wf.trace_paths(graft(xl, p), o, d, 7, gpix, 0,
                                     gcfg.max_depth, fast_shade="shade",
                                     mis=True, remat=True)[0]
            else:
                img = render_mean(graft(xl, p), xcam, xfilm, gpix, 7, 0,
                                  gcfg, kernels=kernels)
            loss = img.mean()
            loss.backward()
        torch.cuda.synchronize()
        return (loss.detach(), p["texels"].grad, p["alpha"].grad,
                time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() / 1e9, counts())

    per = (gcfg.max_depth + 1) * parts
    grads = {}
    for label, kern, remat, w in (
            ("plain", False, False, want()),  # first: it pays the warm-up
            ("kernels", None, False, want(k3_init_bvh4_closest=per,
                                          k4_bvh4_any=per)),
            ("kernels, remat", None, True,
             want(k3_init_bvh4_closest=2 * per, k4_bvh4_any=2 * per))):
        grads[label] = g = xl_grad(kern, remat)
        loss, gt, ga, secs, gb, got = g
        check(f"53 XL fullscene gradient through the {label}, 512x512 x 1 "
              f"spp, MIS depth 2", got == w and bool(torch.isfinite(gt).all())
              and bool(torch.isfinite(ga)) and float(gt.abs().max()) > 0.0,
              f"{xl.triangles.mat_id.shape[0]} triangles in {parts} parts; "
              f"loss {float(loss):.9g}, d/d alpha {float(ga):.6g}, |d/d "
              f"texels| max {float(gt.abs().max()):.6g}; {secs:.3f} s, peak "
              f"{gb:.2f} GB, {card}; launches {got} (want K3 _init = K4 = "
              f"{'2 x ' if remat else ''}(depth 2 + 1) x {parts} parts)")
        if kern is None:
            add_launches(got, "k3_init_bvh4_closest", "k4_bvh4_any")
    lp, gtp, gap = grads["plain"][:3]
    for label in ("kernels", "kernels, remat"):
        lk, gtk, gak = grads[label][:3]
        dt_ = (gtk - gtp).abs()
        bar_t = 1e-5 * float(gtp.abs().max()) + 1e-5 * gtp.abs()
        bar_a = 1e-5 * abs(float(gap)) + 1e-5 * abs(float(gap))
        check(f"53 XL gradient through the {label} vs plain",
              torch.equal(lk, lp) and bool((dt_ <= bar_t).all())
              and abs(float(gak - gap)) <= bar_a,
              f"loss bit-equal {torch.equal(lk, lp)}; max |d texel grad| "
              f"{float(dt_.max()):.3g} (bar rtol 1e-5 + 1e-5 max|g| = "
              f"{1e-5 * float(gtp.abs().max()):.3g}); |d alpha grad| "
              f"{abs(float(gak - gap)):.3g} (bar {bar_a:.3g})")
    del grads

    # ---- 54. the albedo-recovery demo: 60 steps at 32x32
    dd = inverse_demo.demo(32, device=dev)
    inv = inverse_demo.renderer(dd)
    steps = 60
    reset()
    t0 = time.perf_counter()
    inv.run(steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = counts()
    losses = [h[0] for h in inv.history]
    # step k renders sample set k mod spp_cycle; the target is set 0's, so
    # each set's losses carry their own noise floor: compare within a set
    cyc = dd["config"].spp_cycle
    sets = [(losses[k], losses[k + (steps - 1 - k) // cyc * cyc])
            for k in range(cyc)]
    back, ball = ([round(float(v), 4) for v in x.detach()]
                  for x in inv.params)
    check(f"54 inverse_demo {steps} steps at 32x32", inv.nan_steps == 0
          and all(np.isfinite(losses)) and all(b < a for a, b in sets)
          and got == want(),
          f"loss first -> last of each of the {cyc} sample sets "
          f"{', '.join(f'{a:.6g} -> {b:.6g}' for a, b in sets)}; "
          f"recovered back wall "
          f"{back} (target {list(inverse_demo.TARGET_BACK)}), sphere {ball} "
          f"(target {list(inverse_demo.TARGET_BALL)}); {dt:.2f} s, "
          f"{dt / steps:.3f} s/step, {card}; launches {got} (no triangle: "
          "the general route's brute force)")


def _host_cpu() -> str:
    """The host's CPU model, with the fields that tell the part where a
    virtual machine reports the model as "unknown"."""
    import platform

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                k, _, v = ln.partition(":")
                info.setdefault(k.strip(), v.strip())
    except OSError:
        pass
    return "; ".join(f"{k} {info[k]}" for k in (
        "model name", "vendor_id", "cpu family", "model", "CPU implementer",
        "CPU part") if k in info) + (f"; {platform.machine()}, "
                                     f"{os.cpu_count()} CPUs")


def _texture_rig(ctx, tag, tmp):
    """What phases 55 and 56 share: launch counts, a check that records
    failures under [tag], parity_textured (bvh4, on the card) with its
    checker replaced by a fixture, and the 512x512 Morton depth-5 general
    pass of a scene with the counts set to 0 just before it."""
    import shutil

    from craytracer_tpu_torch.camera import Film, generate_rays
    from craytracer_tpu_torch.integrator import wavefront as wf
    from craytracer_tpu_torch.integrator.render import (RenderConfig,
                                                        Renderer)
    from craytracer_tpu_torch.io.scenefile import load_scene_file
    from craytracer_tpu_torch.sampling.multijitter import stratified_jitter

    dev, counters, depth = ctx.dev, ctx.counters, 5
    rig = SimpleNamespace(depth=depth, counters=counters)
    rig.fx = os.path.join(REPO, "craytracer_tpu_torch", "testdata",
                          "textures")

    def reset():
        for c in counters.values():
            c.launches = 0

    def counts():
        return {k: c.launches for k, c in counters.items()}

    def want(**kw):
        return {**dict.fromkeys(counters, 0), **kw}

    def check(label, ok, detail=""):
        print(f"[{tag}] {label}: {detail}" + ("" if ok else " FAIL"),
              flush=True)
        if not ok:
            ctx.fails.append(f"{label}: {detail}")

    def add_launches(got):
        for name in ("k3_bvh4_closest", "k4_bvh4_any"):
            if name in ctx.kernels:
                ctx.kernels[name]["launches"] += got[name]

    textured = os.path.join(REPO, "scenes", "parity_textured.txt")
    with open(textured) as f:
        scene_text = f.read()

    def variant(name):
        """parity_textured with its checker replaced by fixture `name`,
        loaded with bvh4 on the card."""
        d = os.path.join(tmp, name.replace(".", "_"))
        os.makedirs(d)
        for f in ("parity_tex_quad.obj", "parity_tex_env.exr"):
            shutil.copy(os.path.join(REPO, "scenes", f), d)
        shutil.copy(os.path.join(rig.fx, name), d)
        path = os.path.join(d, "parity_textured.txt")
        with open(path, "w") as f:
            f.write(scene_text.replace("parity_tex_checker.ppm", name))
        return load_scene_file(path, accel="bvh4", device=dev)[0]

    ppm, cam, film0 = load_scene_file(textured, accel="bvh4", device=dev)
    film = Film(fov=film0.fov, width=512, height=512)
    cfg = RenderConfig(max_depth=depth)
    ids = torch.from_numpy(Renderer(ppm, cam, film, cfg).pixel_order()).to(
        dev)
    spp = torch.zeros_like(ids)
    o, d = generate_rays(cam, film, ids,
                         stratified_jitter(cfg.seed, ids, spp))

    def general_pass(scn):
        reset()
        t0 = time.perf_counter()
        out = wf.trace_paths(scn, o, d, cfg.seed, ids, spp, depth,
                             with_metrics=True, fast_shade="shade",
                             general=True)
        torch.cuda.synchronize()
        return out, counts(), time.perf_counter() - t0

    def same_pass(out, ref):
        return (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
                and all(torch.equal(torch.as_tensor(out[2][k]),
                                    torch.as_tensor(ref[2][k]))
                        for k in ref[2]))

    rig.__dict__.update(reset=reset, counts=counts, want=want, check=check,
                        add_launches=add_launches, variant=variant, ppm=ppm,
                        cam=cam, film0=film0, general_pass=general_pass,
                        same_pass=same_pass)
    return rig


def _manifest_check(rig, names, manifest):
    """Decode each fixture of `names` and hold it to its manifest hash."""
    import hashlib

    from craytracer_tpu_torch.io.teximage import decode_file

    bad = []
    t0 = time.perf_counter()
    for name in names:
        w = manifest[name]
        try:
            got = decode_file(os.path.join(rig.fx, name))
            ok = (list(got.shape) == w["shape"] and hashlib.sha256(
                got.tobytes()).hexdigest() == w["sha256"])
        except (OSError, ValueError, NotImplementedError) as e:
            ok, name = False, f"{name} ({e})"
        if not ok:
            bad.append(name)
    return bad, time.perf_counter() - t0


def slice_l_phases(ctx) -> None:
    """Phase 55: slice L on the card's host (module docstring). `ctx` as
    for `slice_f_phases`; failures are appended."""
    import shutil
    import tempfile

    from craytracer_tpu_torch.integrator.render import (RenderConfig,
                                                        Renderer)
    from craytracer_tpu_torch.io import imgdecode
    from craytracer_tpu_torch.io.image import write_png
    from craytracer_tpu_torch.io.teximage import decode_file

    card = ctx.card
    t_phase = time.perf_counter()
    cpu = _host_cpu()
    tmp = tempfile.mkdtemp(prefix="slice_l_")
    try:
        rig = _texture_rig(ctx, "slice-l", tmp)
        check, want, depth = rig.check, rig.want, rig.depth
        fx = rig.fx

        # ---- 55 (a). every fixture of slice L against PIL's manifest
        t0 = time.perf_counter()
        imgdecode.library()
        build_s = time.perf_counter() - t0
        with open(os.path.join(fx, "manifest.json")) as f:
            manifest = json.load(f)
        names = sorted(k for k, v in manifest.items()
                       if v.get("phase", 55) == 55)
        bad, dt = _manifest_check(rig, names, manifest)
        check(f"55 (a) {len(names)} fixtures (PNG, JPEG, PNM, BMP, TGA, "
              "GIF) against the SHA-256 of PIL's decode", not bad,
              f"decoder ready in {build_s:.2f} s (g++ "
              f"{' '.join(imgdecode.CXX_FLAGS)}), all decoded in "
              f"{dt:.3f} s; differing: {bad}")

        # ---- 55 (b). the checker in six lossless encodings: the general
        # route's pass bit-equal to the PPM scene's
        ppm, cam, film0 = rig.ppm, rig.cam, rig.film0
        rig.general_pass(ppm)  # warm-up
        ref, got, dt = rig.general_pass(ppm)
        six = want(k3_bvh4_closest=depth + 1, k4_bvh4_any=depth + 1)
        rig.add_launches(got)
        check("55 (b) parity_textured (PPM checker) bvh4 512x512 Morton "
              f"depth {depth} general route", got == six,
              f"{dt * 1e3:.1f} ms, launches {got}, L mean "
              f"{float(ref[0].mean()):.6f}")
        for name in ("checker_palette.png", "checker_interlaced.png",
                     "checker_rgb16.png", "checker_24.bmp",
                     "checker_rle.tga", "checker.gif"):
            vs = rig.variant(name)
            texels = torch.equal(vs.textures.texels, ppm.textures.texels)
            out, got, dt = rig.general_pass(vs)
            rig.add_launches(got)
            same = rig.same_pass(out, ref)
            check(f"55 (b) {name}", texels and same and got == six,
                  f"texels equal {texels}, pass bit-equal {same}, "
                  f"{dt * 1e3:.1f} ms, launches {got}")

        # ---- 55 (c). the 4:2:0 JPEG checker through the Renderer
        rcfg = RenderConfig(num_samples=64, max_depth=depth,
                            estimator="reference", spp_batch=32)
        runs = {}
        for label, scn in (("ppm", ppm), ("jpeg",
                                          rig.variant("checker_420.jpg"))):
            r = Renderer(scn, cam, film0, rcfg)
            rig.reset()
            t0 = time.perf_counter()
            r.render()
            torch.cuda.synchronize()
            runs[label] = (r, rig.counts(), time.perf_counter() - t0)
            rig.add_launches(runs[label][1])
        r, got, dt = runs["jpeg"]
        img = r.raw_mean()
        w6 = want(k3_bvh4_closest=(depth + 1) * r.passes,
                  k4_bvh4_any=(depth + 1) * r.passes)
        finite = bool(np.isfinite(np.asarray(img)).all())
        check(f"55 (c) Renderer parity_textured with checker_420.jpg bvh4 "
              f"{film0.width}x{film0.height} x {rcfg.num_samples} spp",
              r.nan_count == 0 and finite and got == w6 == runs["ppm"][1],
              f"{r.passes} passes, {dt:.3f} s, NaN substituted "
              f"{r.nan_count}, finite {finite}, launches {got} (PPM scene "
              f"{runs['ppm'][1]}), mean {float(np.asarray(img).mean()):.5f} "
              f"(PPM {float(np.asarray(runs['ppm'][0].raw_mean()).mean()):.5f})")

        # ---- 55 (d). host seconds per decode, median of 3
        big = np.zeros((4096, 4096, 3), np.uint8)
        yy, xx = np.mgrid[0:4096, 0:4096]
        big[..., 0] = (xx // 7 + yy // 11) % 256
        big[..., 1] = (xx * yy // 4096) % 256
        big[..., 2] = (xx ^ yy) % 256
        png4096 = os.path.join(tmp, "big_4096.png")
        t0 = time.perf_counter()
        write_png(png4096, big)
        enc_s = time.perf_counter() - t0
        files = [os.path.join(REPO, "scenes", f) for f in (
            "fullscene_checker.png", "fullscene_noise.png",
            "fullscene_normal.png")]
        files += [os.path.join(fx, "big_2048_420.jpg"), png4096]
        for path in files:
            ts = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                a = decode_file(path)
                ts.append(time.perf_counter() - t0)
            ok = path != png4096 or np.array_equal(a, big)
            check(f"55 (d) decode {os.path.basename(path)}", ok,
                  f"{a.shape[1]}x{a.shape[0]}, "
                  f"{os.path.getsize(path)} bytes: "
                  f"{statistics.median(ts):.4f} s median of {REPS} (runs "
                  f"{', '.join(f'{t:.4f}' for t in ts)}) on the host, "
                  f"{cpu}; card {card}" + (
                      f"; written by encode_png in {enc_s:.2f} s, decoded "
                      "back equal" if path == png4096 else ""))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[slice-l] phase 55: {time.perf_counter() - t_phase:.2f} s",
          flush=True)


def slice_m_phases(ctx) -> None:
    """Phase 56: slice M on the card's host (module docstring). `ctx` as
    for `slice_f_phases`; failures are appended."""
    import shutil
    import struct
    import tempfile

    from craytracer_tpu_torch.io import imgdecode
    from craytracer_tpu_torch.io.teximage import decode_file

    card = ctx.card
    t_phase = time.perf_counter()
    cpu = _host_cpu()
    tmp = tempfile.mkdtemp(prefix="slice_m_")
    try:
        rig = _texture_rig(ctx, "slice-m", tmp)
        check, want, depth, fx = rig.check, rig.want, rig.depth, rig.fx

        # ---- 56 (a). every fixture of slice M against PIL's manifest
        t0 = time.perf_counter()
        imgdecode.library()
        build_s = time.perf_counter() - t0
        with open(os.path.join(fx, "manifest.json")) as f:
            manifest = json.load(f)
        names = sorted(k for k, v in manifest.items() if v.get("phase") == 56)
        bad, dt = _manifest_check(rig, names, manifest)
        check(f"56 (a) {len(names)} fixtures (TIFF, DDS, lossless WebP, PSD, "
              "PIL's own PNM) against the SHA-256 of PIL's decode",
              not bad and len(names) > 0,
              f"decoder ready in {build_s:.2f} s (g++ "
              f"{' '.join(imgdecode.CXX_FLAGS)}), all decoded in "
              f"{dt:.3f} s; differing: {bad}")

        # ---- 56 (b). the checker in five lossless encodings: the general
        # route's pass bit-equal to the PPM scene's
        ppm = rig.ppm
        rig.general_pass(ppm)  # warm-up
        ref, got, dt = rig.general_pass(ppm)
        six = want(k3_bvh4_closest=depth + 1, k4_bvh4_any=depth + 1)
        rig.add_launches(got)
        check("56 (b) parity_textured (PPM checker) bvh4 512x512 Morton "
              f"depth {depth} general route", got == six,
              f"{dt * 1e3:.1f} ms, launches {got}, L mean "
              f"{float(ref[0].mean()):.6f}")
        for name in ("checker_lzw_pred.tif", "checker_deflate_tiled.tif",
                     "checker.dds", "checker_lossless.webp",
                     "checker_rle.psd"):
            vs = rig.variant(name)
            texels = torch.equal(vs.textures.texels, ppm.textures.texels)
            out, got, dt = rig.general_pass(vs)
            rig.add_launches(got)
            same = rig.same_pass(out, ref)
            check(f"56 (b) {name}", texels and same and got == six,
                  f"texels equal {texels}, pass bit-equal {same}, "
                  f"{dt * 1e3:.1f} ms, launches {got}")

        # ---- 56 (c). host seconds per decode, median of 3: the 2048x2048
        # LZW + predictor TIFF, lossless WebP, and a BC7 DDS tiled from
        # the 256x256 fixture (BC7 blocks decode alone: its texels are
        # the fixture's, tiled)
        with open(os.path.join(fx, "bc7_256.dds"), "rb") as f:
            small = f.read()
        hdr = bytearray(small[:148])
        struct.pack_into("<II", hdr, 12, 2048, 2048)
        blocks = np.frombuffer(small[148:], np.uint8).reshape(64, 64, 16)
        bc7 = os.path.join(tmp, "bc7_2048.dds")
        with open(bc7, "wb") as f:
            f.write(bytes(hdr) + np.tile(blocks, (8, 8, 1)).tobytes())
        tiled = np.tile(decode_file(os.path.join(fx, "bc7_256.dds")),
                        (8, 8, 1))
        for path in (os.path.join(fx, "big_2048_lzw_pred.tif"), bc7,
                     os.path.join(fx, "big_2048_lossless.webp")):
            ts = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                a = decode_file(path)
                ts.append(time.perf_counter() - t0)
            ok = a.shape == (2048, 2048, 3) and (
                path != bc7 or np.array_equal(a, tiled))
            check(f"56 (c) decode {os.path.basename(path)}", ok,
                  f"{a.shape[1]}x{a.shape[0]}, "
                  f"{os.path.getsize(path)} bytes: "
                  f"{statistics.median(ts):.4f} s median of {REPS} (runs "
                  f"{', '.join(f'{t:.4f}' for t in ts)}) on the host, "
                  f"{cpu}; card {card}" + (
                      "; equal to the 256x256 fixture's texels tiled"
                      if path == bc7 else ""))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[slice-m] phase 56: {time.perf_counter() - t_phase:.2f} s",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (this smoke test needs the card)")
        return 1
    sys.path.insert(0, REPO)
    from craytracer_tpu_torch import cuda_build, native
    from craytracer_tpu_torch.inverse import CUBLAS_CONFIG
    # before the first cuBLAS call: phase 37's bit-exact resume
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_CONFIG)
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
    from craytracer_tpu_torch.integrator.gate import shade_features
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
                "p1_pop_probe": pp.KERNEL, "k1_pass_rays": pk.RAYS_KERNEL}
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
    # K2 once per feature mask this run meets: the matte scenes' 0,
    # parity_mix's and glass_spheres'
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_sphere_scenes as sphere_scenes

    gb = SceneBuilder()
    sphere_scenes.glass_spheres(gb)
    k2_masks = sorted({0, shade_features(gb.build(device="cpu")),
                       shade_features(load_scene_file(MIX, device="cpu")[0])})
    libs = {"k1_pass": pk.LIBRARY,
            **{f"k2_shade mask {m}": sk.library(m) for m in k2_masks},
            "k3_bvh4_closest + k3_init + k4_bvh4_any": bk.LIBRARY,
            "k5_bvh4_split": sp.LIBRARY,
            "k6_tri_closest": tri_kernel.LIBRARY,
            "p1_pop_probe": pp.LIBRARY}
    # the host libraries' g++ builds run in a thread beside nvcc's
    from craytracer_tpu_torch.io import imgdecode

    def host_libs():
        t = time.perf_counter()
        native.library()
        imgdecode.library()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host_build = pool.submit(host_libs)
        cuda_build.build_all(libs.values())
        print(f"[build] K1, K2, K3/K3 _init/K4, K5, K6, P1 built in parallel "
              f"in {time.perf_counter() - t0:.2f} s (nvcc "
              f"{' '.join(cuda_build.NVCC_FLAGS)})", flush=True)
        host_s = host_build.result()
    print(f"[build] native scene runtime ({native.SOURCE.name}, g++ "
          f"{' '.join(native.CXX_FLAGS)}) and the image decoders "
          f"({imgdecode.SOURCE.name}, g++ {' '.join(imgdecode.CXX_FLAGS)}) "
          f"ready in {host_s:.2f} s beside nvcc", flush=True)
    for name, lib in libs.items():
        secs = ("cached" if lib.build_seconds is None
                else f"{lib.build_seconds:.2f} s")
        print(f"[build] {name} ({lib.source.name}): {secs}")
        for line in lib.ptxas_log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"[build]   ptxas: {line.strip()}")

    ctx = SimpleNamespace(dev=dev, card=card, fails=fails, err=err,
                          kernels={}, counters=counters)
    if sys.argv[1:] == ["--slice-f"]:
        # phases 38-43 alone, to try them out: no result line
        slice_f_phases(ctx)
        for f in fails:
            print(f"FAIL: {f}")
        print(json.dumps({"slice_f_only": True, "failures": len(fails),
                          "k1_pass_rays": ctx.kernels.get("k1_pass_rays")}))
        return 1 if fails else 0
    if sys.argv[1:] == ["--slice-i"]:
        # phases 44-48 alone, to try them out: no result line
        slice_i_phases(ctx)
        for f in fails:
            print(f"FAIL: {f}")
        print(json.dumps({"slice_i_only": True, "failures": len(fails)}))
        return 1 if fails else 0
    if sys.argv[1:] == ["--slice-h"]:
        # phases 49-50 alone, to try them out: no result line
        slice_h_phases(ctx)
        for f in fails:
            print(f"FAIL: {f}")
        print(json.dumps({"slice_h_only": True, "failures": len(fails)}))
        return 1 if fails else 0
    if sys.argv[1:] == ["--slice-l"]:
        # phase 55 alone, to try it out: no result line
        slice_l_phases(ctx)
        for f in fails:
            print(f"FAIL: {f}")
        print(json.dumps({"slice_l_only": True, "failures": len(fails)}))
        return 1 if fails else 0
    if sys.argv[1:] == ["--slice-m"]:
        # phase 56 alone, to try it out: no result line
        slice_m_phases(ctx)
        for f in fails:
            print(f"FAIL: {f}")
        print(json.dumps({"slice_m_only": True, "failures": len(fails)}))
        return 1 if fails else 0
    if sys.argv[1:] == ["--slice-k"]:
        # phases 51-54 alone, to try them out: no result line
        slice_k_phases(ctx)
        for f in fails:
            print(f"FAIL: {f}")
        print(json.dumps({"slice_k_only": True, "failures": len(fails)}))
        return 1 if fails else 0

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
        bad, err_same, err_all, f = _compare(out_k, out_p)
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
    passes = 8

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

    def timed_wide(scn=scene, camera=cam, fm=film):
        """Bare K1 at WIDE spp per launch (WIDE x 262,144 lanes), two
        launches per run after a warm-up, median of REPS: (ms per spp-pass,
        the runs' ms, rays + shadow rays per run)."""
        tab = pk.kernel_tables(scn, camera, fm)
        pw = pix.repeat(WIDE)
        lane_spp = torch.arange(WIDE, dtype=torch.int32,
                                device=dev).repeat_interleave(pix.shape[0])
        f = pk.shade_features(scn) != 0
        thin = camera.camera_type == THINLENS
        runs = [[lane_spp + (6000 + WIDE * (2 * r + k)) for k in range(2)]
                for r in range(REPS + 1)]

        def run(spps):
            return [pk.KERNEL.launch(tab, pk.table_counts(scn), pw, sp, 0, 5,
                                     False, size, f, thin) for sp in spps]

        run(runs[0])
        ts, rays = [], []
        for spps in runs[1:]:
            ms, outs = _timed(lambda: run(spps))
            ts.append(ms)
            rays.append(sum(int(g[1].sum() + g[2].sum()) for _, g in outs))
        med = statistics.median(ts)
        return med / (2 * WIDE), ts, rays[ts.index(med)]

    def print_wide(name, scn=scene, camera=cam, fm=film):
        ms, ts, rays = timed_wide(scn, camera, fm)
        rate = rays / (ms * 2 * WIDE / 1e3)
        print(f"[time] {card}, {name} 512x512 depth 5, bare K1 at {WIDE} spp "
              f"per launch ({WIDE * size * size} lanes), 2 launches per run, "
              f"median of {REPS}: {ms:.4f} ms per spp-pass ({rate:.6g} rays/s; "
              f"runs {_runs(ts)} ms)", flush=True)
        return ms

    timed_passes(pk.fused_pass, 1000)
    timed_passes(pk.fused_pass_reference, 1000)
    timed_kernel(1000)
    t_k, t_w, t_p, rays_k = [], [], [], []
    for rep in range(REPS):
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
          f"run, median of {REPS}: K1 launch {med_k / passes:.4f} ms/pass "
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
    print_wide("cornell")

    # ---- 6. K3/K4 vs plain on parity_mesh_mid
    mesh, mcam, mfilm0 = load_scene_file(MESH_MID, device=dev)
    bvh = mesh.tri_bvh
    mfilm = Film(fov=mfilm0.fov, width=size, height=size)
    mmorton = torch.from_numpy(
        Renderer(mesh, mcam, mfilm, cfg).pixel_order()).to(dev)
    print(f"[mesh] parity_mesh_mid: {bvh.n_tris} triangles, "
          f"{bvh.fat.shape[0]} fat rows, stack {bvh.stack_size}, "
          f"{_children(bvh)}, route "
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

    def k2_bare(scn, recs_, spp):
        """Bare K2 on each bounce of a plain pass's records: launches on
        prebuilt inputs and outputs, not counted (a list of error codes per
        call)."""
        calls = []
        for b, (st, hit, _) in enumerate(recs_):
            v, args, out = sk.prepare_launch(scn, st[1], hit, st[2], st[5],
                                             st[6], st[10], spp, cfg.seed, b,
                                             5)
            calls.append((v.load().k2_shade_launch, args, out))
        return lambda: [fn(*args) for fn, args, _ in calls]

    mspp = torch.zeros_like(mmorton)
    o_cam, d_cam = generate_rays(mcam, mfilm, mmorton,
                                 stratified_jitter(cfg.seed, mmorton, mspp))
    recs = plain_records(mesh, o_cam, d_cam, mmorton, mspp, 5)
    torch.cuda.synchronize()

    def check_k3(label, o, d, bvh_=bvh):
        """K3 against the plain traversal: t and ids bit-equal on every
        lane."""
        t_k, tri_k = bk.bvh4_closest_hit_kernel(bvh_, o, d)
        t_p, tri_p = bvh4_closest_hit_stats(bvh_, o, d)[:2]
        hit_p = t_p < TMAX
        lanes = ((t_k == t_p) & (tri_k == tri_p)).double().mean().item()
        both = hit_p & (t_k < TMAX)
        e = (t_k - t_p)[both].abs().max().item() if bool(both.any()) else 0.0
        err["k3_bvh4_closest"] = max(err["k3_bvh4_closest"], e)
        bad = not (torch.equal(t_k, t_p) and torch.equal(tri_k, tri_p))
        print(f"[k3-vs-plain] {label}: rays {o.shape[0]}, hits "
              f"{int(hit_p.sum())}, t and ids bit-equal on {lanes:.6f} of "
              f"lanes, max|dt| {e:.3g}" + (" FAIL" if bad else ""),
              flush=True)
        if bad:
            fails.append(f"K3 {label}: bit-equal on {lanes} of lanes")

    def check_k4(label, o, d, md, dadj=None, bvh_=bvh):
        """K4 against the plain any hit: t bit-equal on every lane (so the
        verdict and, for shadow rays, the `lit` test too)."""
        t_k = bk.bvh4_any_hit_kernel(bvh_, o, d, md)
        t_p = bvh4_any_hit_stats(bvh_, o, d, md)[0]
        lanes = (t_k == t_p).double().mean().item()
        both = (t_k < TMAX) & (t_p < TMAX)
        e = (t_k - t_p)[both].abs().max().item() if bool(both.any()) else 0.0
        err["k4_bvh4_any"] = max(err["k4_bvh4_any"], e)
        msg = (f"[k4-vs-plain] {label}: rays {o.shape[0]}, occluded "
               f"{int((t_p < md).sum())}, t bit-equal on {lanes:.6f} of "
               f"lanes, max|dt| {e:.3g}")
        bad = not torch.equal(t_k, t_p)
        if dadj is not None:
            band = dadj - torch.clamp(1e-3 * dadj, min=K_EPSILON)
            lit = ((t_k >= band) == (t_p >= band)).double().mean().item()
            msg += f", lit agrees on {lit:.6f}"
        print(msg + (" FAIL" if bad else ""), flush=True)
        if bad:
            fails.append(f"K4 {label}: bit-equal on {lanes} of lanes")

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
        int outputs equal on every lane."""
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
            bad = not close or ints < 1.0
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
        bad, err_same, err_all, f = _compare(out_k, out_p)
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

    med_m, t_m = _median(lambda: mesh_passes(3000))
    rays_m = pass_rays(mesh, mcam, mfilm, mmorton, 3000, mpasses, 5)
    print(f"[time] {card}, parity_mesh_mid 512x512 depth 5, {mpasses} "
          f"passes through render_sample per run, median of {REPS}: "
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

    lib3 = bk.LIBRARY.load()
    fat_args = (bvh.fat.data_ptr(), bvh.fat.shape[0], bvh.stack_size)
    k3_calls = [fat_args + (o.data_ptr(), d.data_ptr(), o.shape[0],
                            empty(o.shape[0]),
                            empty(o.shape[0], dtype=torch.int32), stream)
                for o, d in k3_in]
    k4_calls = [fat_args + (o.data_ptr(), d.data_ptr(), md.data_ptr(),
                            o.shape[0], empty(o.shape[0]), stream)
                for o, d, md in k4_in]
    bare = {
        "k3_bvh4_closest": lambda: [lib3.k3_closest_launch(*a)
                                    for a in k3_calls],
        "k2_shade": k2_bare(mesh, recs, mspp),
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
    def pops_and_bound(stats_fn, bvh_, *args, lane_bytes=32):
        """Pops per lane and the launch's bound twice: reading each
        visited row's boxes and its filled slots (all the result needs of
        a row: the bound the kernel table keeps), and reading whole
        rows."""
        visits = torch.zeros(bvh_.fat.shape[0], dtype=torch.int64,
                             device=dev)
        pops = stats_fn(bvh_, *args, visits=visits)[-1]
        n = args[0].shape[0]
        return (pops, _pop_bound(bvh_, visits, n, lane_bytes, split=True),
                _pop_bound(bvh_, visits, n, lane_bytes))

    k3_pb = [pops_and_bound(bvh4_closest_hit_stats, bvh, *a) for a in k3_in]
    k4_pb = [pops_and_bound(bvh4_any_hit_stats, bvh, *a) for a in k4_in]
    k3_pops, k4_pops = [p for p, *_ in k3_pb], [p for p, *_ in k4_pb]
    lanes = [a[0].shape[0] for a in k3_in]
    bounds = {
        "k3_bvh4_closest": [b for _, b, _ in k3_pb],
        "k4_bvh4_any": [b for _, b, _ in k4_pb],
        "k2_shade": [_bound(nl * K2_LANE_BYTES, nl * SHADE_OPS)
                     for nl in lanes]}
    row_bounds = {"k3_bvh4_closest": [b for *_, b in k3_pb],
                  "k4_bvh4_any": [b for *_, b in k4_pb]}
    for name in ("k3_bvh4_closest", "k2_shade", "k4_bvh4_any"):
        med, ts = _median(bare[name], queued=name == "k2_shade")
        if any(bare[name]()):
            fails.append(f"bare {name} launch failed")
        ms_plain = _timed(plain[name])[0] / len(recs)
        bms = sum(b for b, _ in bounds[name]) / len(recs)
        by = bounds[name][0][1]
        extra = ""
        if name != "k2_shade":
            pops = k3_pops if name == "k3_bvh4_closest" else k4_pops
            extra = (f"; whole rows read: bound "
                     f"{sum(b for b, _ in row_bounds[name]) / len(recs):.4f}"
                     f" ms/launch; pops per lane mean "
                     f"{sum(int(p.sum()) for p in pops) / sum(lanes):.3f} max "
                     f"{max(int(p.max()) for p in pops)}; lane-pops idle in "
                     f"one-ray-per-thread warps: camera rays "
                     f"{_idle_share(pops[:1]):.4f}, bounce 1 "
                     f"{_idle_share(pops[1:2]):.4f}, six bounces "
                     f"{_idle_share(pops):.4f}")
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
    med_c, t_c = _median(lambda: [
        wf.render_sample(city, ccam, cfilm, cids, cfg.seed, 4000 + s, 4)
        for s in range(cpasses)])
    rays_c = pass_rays(city, ccam, cfilm, cids, 4000, cpasses, 4)
    print(f"[time] {card}, city {n_city} triangles ({city.tri_bvh.fat.shape[0]}"
          f" fat rows, stack {city.tri_bvh.stack_size}, "
          f"{_children(city.tri_bvh)}): host build "
          f"{build_s:.2f} s; 256x256 depth 4, {cpasses} passes through "
          f"render_sample per run, median of {REPS}: {med_c / cpasses:.4f} "
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
        t_u = _median(lambda: bk.bvh4_closest_hit_kernel(
            city.tri_bvh, o, d))[0]
        t_s = _median(lambda: bk.bvh4_closest_hit_kernel(
            city.tri_bvh, os_, ds_))[0]
        pops, cb, cb_rows = pops_and_bound(bvh4_closest_hit_stats,
                                           city.tri_bvh, o, d)
        print(f"[time] {card}, city bare K3 on {o.shape[0]} {label} rays: "
              f"{t_u:.4f} ms unsorted (Morton pixel order), {t_s:.4f} ms "
              f"ray_key-sorted; bound {cb[0]:.4f} ms ({cb[1]}; whole rows "
              f"read: {cb_rows[0]:.4f} ms); pops per lane mean "
              f"{pops.double().mean().item():.3f} max {int(pops.max())}",
              flush=True)

    # ---- 11. parity_mix: K1's full core vs plain
    from craytracer_tpu_torch.integrator.gate import F_OREN
    from craytracer_tpu_torch.scene import types as T

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
        depth 0, 2 and 5; phase 8's bars."""
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
            bad, err_same, err_all, f = _compare(out_k, out_p)
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
    for rep_ in range(REPS):
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
          f"run, median of {REPS}: K1 launch {mxk / passes:.4f} ms/pass "
          f"({(nx_rays + nx_shadow) / (mxk / 1e3):.6g} rays/s; runs "
          f"{_runs(tx_k)} ms); K1 through fused_pass {mxw / passes:.4f} "
          f"ms/pass ({(nx_rays + nx_shadow) / (mxw / 1e3):.6g} rays/s; runs "
          f"{_runs(tx_w)} ms); plain PyTorch {mxp / passes:.4f} ms/pass (runs "
          f"{_runs(tx_p)} ms); {nx_rays} rays + {nx_shadow} shadow rays per "
          f"run; K1 bound {kx_bound[0]:.4f} ms/pass ({kx_bound[1]}, "
          f"{ops_x} operations per pass)", flush=True)
    mix_wide = print_wide("parity_mix", mix, xcam, xfilm)
    # the lane-bounces one path per thread leaves idle (the schedule K1
    # had before its persistent warps), from the plain passes' bounce
    # masks in the Renderer's Morton order
    c_o, c_d = generate_rays(cam, film, morton,
                             stratified_jitter(cfg.seed, morton, zspp))
    crecs = plain_records(scene, c_o, c_d, morton, zspp, 5)
    print(f"[idle] 512x512 Morton spp 0 depth 5, share of lane-bounces "
          f"idle in warps of 32 one-path-per-thread lanes: cornell "
          f"{_idle_share([_bounces(crecs)]):.4f}, parity_mix "
          f"{_idle_share([_bounces(xrecs['parity_mix'])]):.4f}", flush=True)
    del crecs
    # Cornell on the full core against the matte-only core, in turns
    t_c0, t_cf = [], []
    for rep_ in range(REPS):
        for full, ts_ in ((False, t_c0), (True, t_cf)):
            ts_.append(timed_kernel(3000 + passes * rep_, full=full)[0])
    print(f"[time] {card}, cornell 512x512 depth 5, bare K1 in turns, median "
          f"of {REPS}: matte-only core {statistics.median(t_c0) / passes:.4f} "
          f"ms/pass (runs {_runs(t_c0)} ms), full core "
          f"{statistics.median(t_cf) / passes:.4f} ms/pass (runs "
          f"{_runs(t_cf)} ms)", flush=True)
    # bare K2 (parity_mix's mask) on the six bounces of its plain pass
    med2x, ts2x = _median(k2_bare(mix, xrecs["parity_mix"], zspp),
                           queued=True)
    ms2x_plain = _timed(lambda: [
        sk.fused_shade_reference(mix, st[1], hit, st[2], st[5], st[6],
                                 st[10], zspp, cfg.seed, b, 5)
        for b, (st, hit, _) in enumerate(xrecs["parity_mix"])])[0] / 6
    ops2x = sum(int(st[5].sum()) * SHADE_OPS + sum(
        int((mix.materials.mat_type[hit.mat_id.long()][st[5] & (hit.t < TMAX)]
             == m).sum()) * v for m, v in extra.items())
        for st, hit, _ in xrecs["parity_mix"])
    b2x = _bound(6 * size * size * K2_LANE_BYTES, ops2x)
    print(f"[time] {card}, k2_shade (mask {xfeat}) on the 6 bounces of one "
          f"parity_mix 512x512 pass: bare {med2x / 6:.4f} ms/launch (runs of "
          f"6 {_runs(ts2x)} ms), plain {ms2x_plain:.4f} ms/launch (timed "
          f"once), bound {b2x[0] / 6:.4f} ms/launch ({b2x[1]})", flush=True)

    # ---- 36. K2: its builds, one launch per warmed fused_shade call, bare
    # and wrapper times on the matte core and the cores with lobes; run
    # here, before this process's first torch.profiler session (phase 32):
    # after several sessions in one process the traces may lose device
    # events
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for mask, lib in sorted(sk.variants().items()):
        regs = " | ".join(line.strip() for line in lib.ptxas_log.splitlines()
                          if "registers" in line or "spill" in line)
        secs = ("cached" if lib.build_seconds is None
                else f"{lib.build_seconds:.2f} s")
        print(f"[k2] variant mask {mask} ({lib.name}, built {secs}): ptxas "
              f"{regs}", flush=True)
    for label, scn, recs_, spp_ in (
            ("parity_mesh_mid", mesh, recs, mspp),
            ("parity_mix", mix, xrecs["parity_mix"], zspp),
            ("glass_spheres", lib_scenes["glass_spheres"][0],
             xrecs["glass_spheres"], zspp)):
        calls = [(scn, st[1], hit, st[2], st[5], st[6], st[10], spp_,
                  cfg.seed, b, 5) for b, (st, hit, _) in enumerate(recs_)]
        sk.fused_shade(*calls[0])  # a warmed scene: its build and table
        torch.cuda.synchronize()
        for _ in range(6):  # a trace that lost events is taken again
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for a in calls:
                    sk.fused_shade(*a)
                torch.cuda.synchronize()
            on_dev = [e.name for e in prof.events()
                      if e.device_type == DeviceType.CUDA]
            if len(on_dev) >= len(calls):
                break
        one = (len(on_dev) == len(calls)
               and all("k2_shade_kernel" in x for x in on_dev))
        if not one:
            fails.append(f"{label}: {len(calls)} warmed fused_shade calls "
                         f"ran {on_dev}")
        med_b, ts_b = _median(k2_bare(scn, recs_, spp_), queued=True)
        _, t_dev = _median(lambda: [sk.fused_shade(*a) for a in calls],
                            queued=True)
        t0 = time.perf_counter()
        for _ in range(20):
            for a in calls:
                sk.fused_shade(*a)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / (20 * len(calls))
        lobes = lobe_ops(scn)
        nl = sum(st[1].shape[0] for st, _, _ in recs_)
        ops = sum(int(st[5].sum()) * SHADE_OPS + sum(
            int((scn.materials.mat_type[hit.mat_id.long()][
                st[5] & (hit.t < TMAX)] == m).sum()) * v
            for m, v in lobes.items()) for st, hit, _ in recs_)
        bnd = _bound(nl * K2_LANE_BYTES, ops)
        print(f"[k2] {card}, {label} (mask {shade_features(scn)}) 512x512, "
              f"the 6 bounces of one plain pass: {len(on_dev)} device "
              f"events in {len(calls)} warmed fused_shade calls "
              f"({', '.join(sorted({x[:40] for x in on_dev}))}); bare K2 "
              f"{med_b / 6:.4f} ms/launch "
              f"(runs of 6 {_runs(ts_b)} ms); fused_shade "
              f"{statistics.median(t_dev) / 6:.4f} ms/call on the device "
              f"(runs of 6 {_runs(t_dev)} ms), wall {wall:.4f} ms/call; "
              f"bound {bnd[0] / 6:.4f} ms/launch ({bnd[1]}, "
              f"{K2_LANE_BYTES} B/lane)" + ("" if one else " FAIL"),
              flush=True)

    kernels["k1_pass"].update(
        launches=launches_mix["k1_pass"], ms=mxk / passes,
        plain_ms=mxp / passes, bound_ms=kx_bound[0], bound_by=kx_bound[1],
        ms_per_pass_at_16_spp=mix_wide)

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
    n_p, got = main_path("parity_prims", prims, pcam, pfilm, GOLDEN_PRIMS,
                         config=dataclasses.replace(cfg, spp_batch=16))
    expect("parity_prims", got, k2_shade=6 * n_p)
    n_p, got = main_path("aabox", *bounce_scenes["aabox"])
    expect("aabox", got, k1_pass=n_p)

    # ---- 19. times: bare K1 on the new scenes, parity_prims per pass
    for name, (scn, c, fm) in bounce_scenes.items():
        lens = c.camera_type == THINLENS
        o, d = wf.camera_rays(c, fm, morton, cfg.seed, zspp,
                              stratified_jitter(cfg.seed, morton, zspp))
        recs_ = plain_records(scn, o, d, morton, zspp, 5)
        ops_ = k1_pass_ops(scn, recs_, lens)
        print(f"[idle] {name} 512x512 Morton spp 0 depth 5, share of "
              f"lane-bounces idle in warps of 32 one-path-per-thread lanes: "
              f"{_idle_share([_bounces(recs_)]):.4f}", flush=True)
        del recs_
        bnd = _bound(pk.kernel_tables(scn, c, fm).numel() * 4
                     + size * size * (8 + 28), ops_)
        timed_kernel(1000, scn, c, fm)
        tk, rays_ = [], []
        for rep_ in range(REPS):
            ms, rays = timed_kernel(2000 + passes * rep_, scn, c, fm)
            tk.append(ms)
            rays_.append(rays)
        med = statistics.median(tk)
        nr_, ns_ = rays_[tk.index(med)]
        ms_plain = timed_passes(pk.fused_pass_reference, 2000, scn, c, fm)[0]
        print(f"[time] {card}, {name} 512x512 depth 5, {passes} passes per "
              f"run, median of {REPS}: K1 launch {med / passes:.4f} ms/pass "
              f"({(nr_ + ns_) / (med / 1e3):.6g} rays/s; runs {_runs(tk)} "
              f"ms); plain PyTorch {ms_plain / passes:.4f} ms/pass (timed "
              f"once); {nr_} rays + {ns_} shadow rays per run; K1 bound "
              f"{bnd[0]:.4f} ms/pass ({bnd[1]}, {ops_} operations per pass)",
              flush=True)
        print_wide(name, scn, c, fm)

    ppasses = 4

    def prims_passes(s0):
        return [wf.render_sample(prims, pcam, pfilm, morton, cfg.seed, s0 + s,
                                 5) for s in range(ppasses)][-1]

    med_pr, t_pr = _median(lambda: prims_passes(3000))
    rays_pr = pass_rays(prims, pcam, pfilm, morton, 3000, ppasses, 5)
    print(f"[time] {card}, parity_prims 512x512 depth 5, {ppasses} passes "
          f"through render_sample per run, median of {REPS}: "
          f"{med_pr / ppasses:.4f} ms/pass, {rays_pr / (med_pr / 1e3):.6g} "
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
    ctx.city = big  # phase 49 (f)'s one-process city
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
          f"fat rows ({fat_bytes} bytes, stack {big.tri_bvh.stack_size}; "
          f"{_children(big.tri_bvh)}), "
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
    med_b, t_b = _median(lambda: [
        wf.render_sample(big, bcam, bfilm, bids, cfg.seed, 5000 + s, 5)
        for s in range(bpasses)])
    rays_b = pass_rays(big, bcam, bfilm, bids, 5000, bpasses, 5)
    print(f"[time] {card}, city {n_big} triangles ({len(parts)} parts) "
          f"512x512 depth 5, {bpasses} passes through render_sample per run, "
          f"median of {REPS}: {med_b / bpasses:.4f} ms/pass, "
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
    k4_city = []
    for b in (0, 1):
        out = city_recs[b][2]
        so, sd, smd, sadj = sorted_rays(out["shadow_o"], out["shadow_d"],
                                        out["dist_adj_t"], out["dist_adj"])
        t_pa = bvh4_parts.parts_any_hit_kernel(parts, so, sd, smd)
        # K4 on every part against the plain any hit on the same inputs:
        # the max_dist the route carries in (0 on lanes occluded before)
        best_p = torch.full_like(smd, TMAX)
        md, k4_eq, k4_in, k4_pops = smd, 0, [], []
        k4_bound = k4_rows = 0.0
        for p in parts:
            k4_in.append((p, md))
            t_k = bk.bvh4_any_hit_kernel(p, so, sd, md)
            visits = torch.zeros(p.fat.shape[0], dtype=torch.int64,
                                 device=dev)
            t_p, pops = bvh4_any_hit_stats(p, so, sd, md, visits=visits)
            k4_pops.append(pops)
            k4_bound += _pop_bound(p, visits, so.shape[0],
                                   split=True)[0] / len(parts)
            k4_rows += _pop_bound(p, visits, so.shape[0])[0] / len(parts)
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
        k4_ms, k4_ts = _median(lambda: [
            bk.bvh4_any_hit_kernel(p, so, sd, m_) for p, m_ in k4_in])
        k4_city.append((k4_ms / len(parts), k4_bound))
        print(f"[time] {card}, city bounce-{b} shadow rays, bare K4 on each "
              f"of the {len(parts)} parts with the route's carried max_dist,"
              f" median of {REPS}: {k4_ms / len(parts):.4f} ms per part (runs of "
              f"{len(parts)} {_runs(k4_ts)} ms); bound {k4_bound:.4f} ms per "
              f"part (bytes or operations of the rows the plain any hit "
              f"pops; whole rows read: {k4_rows:.4f} ms); lane-pops idle in "
              f"one-ray-per-thread warps {_idle_share(k4_pops):.4f} over the "
              f"parts, {_idle_share(k4_pops[-1:]):.4f} on the last part",
              flush=True)
    del city_recs, out
    kernels["k4_bvh4_any"].update(
        city_part_ms=statistics.mean(m_ for m_, _ in k4_city),
        city_part_bound_ms=statistics.mean(b_ for _, b_ in k4_city),
        city_launches_per_pass=6 * len(parts))

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
    t_k3m = _median(lambda: bk.bvh4_closest_hit_kernel(big.tri_bvh, o, d))
    t_k5m = _median(lambda: sp.bvh4_closest_hit_split_kernel(
        big.tri_bvh, o, d, topo=topo_m))
    t_k3p = _median(lambda: [bk.bvh4_closest_hit_init_kernel(
        p, o, d, t_in, tri_in) for p, t_in, tri_in, *_ in steps])
    t_k5p = _median(lambda: [sp.bvh4_closest_hit_split_kernel(
        p, o, d, t_in, tri_in, topo=topos[k])
        for k, (p, t_in, tri_in, *_) in enumerate(steps)])
    print(f"[time] {card}, city {o.shape[0]} camera rays (route order), "
          f"median of {REPS}: whole table bare K3 {t_k3m[0]:.4f} ms, bare K5 "
          f"{t_k5m[0]:.4f} ms; the {len(parts)} parts, the route's carried "
          f"hits: bare K3 _init {t_k3p[0]:.4f} ms, bare K5 {t_k5p[0]:.4f} ms "
          f"(all parts; runs K3 {_runs(t_k3m[1])}; K5 {_runs(t_k5m[1])}; "
          f"K3 _init {_runs(t_k3p[1])}; K5 parts {_runs(t_k5p[1])} ms); "
          f"parts route / whole-table K3 {t_k3p[0] / t_k3m[0]:.3f}",
          flush=True)
    # per launch, over both ray sets: bare K3 _init and K5, plain, bounds
    k3i_ms, k3i_plain, k3i_bounds, k3i_rows = 0.0, 0.0, [], []
    n_launch = 0
    for label in walks:
        o_, d_, steps_, _, _ = walks[label]
        k3i_ms += _median(lambda: [bk.bvh4_closest_hit_init_kernel(
            p, o_, d_, t_in, tri_in) for p, t_in, tri_in, *_ in steps_])[0]
        k3i_plain += _timed(lambda: [bvh4_closest_hit_init_stats(
            p, o_, d_, t_in, tri_in) for p, t_in, tri_in, *_ in steps_])[0]
        for p, _, _, _, _, visits, _ in steps_:
            k3i_bounds.append(_pop_bound(p, visits, o_.shape[0], 40, True))
            k3i_rows.append(_pop_bound(p, visits, o_.shape[0], 40))
        n_launch += len(steps_)
    k5_ms = t_k5p[0] / len(parts)
    k5_plain = _timed(lambda: [bvh4_closest_hit_init_stats(
        p, o, d, t_in, tri_in) for p, t_in, tri_in, *_ in steps])[0] / len(
        parts)
    k5_bound = k3i_bounds[:len(parts)]  # K5 needs what K3 _init needs
    pops_all = [int(st[6].sum()) for lb in walks for st in walks[lb][2]]
    idle = {lb: _idle_share([st[6] for st in walks[lb][2]]) for lb in walks}
    print(f"[time] {card}, k3_init_bvh4_closest per launch on the city "
          f"(camera and bounce-1 rays, every part): bare "
          f"{k3i_ms / n_launch:.4f} ms, plain {k3i_plain / n_launch:.4f} ms "
          f"(timed once), bound "
          f"{sum(b for b, _ in k3i_bounds) / n_launch:.4f} ms "
          f"({k3i_bounds[0][1]}; whole rows read: "
          f"{sum(b for b, _ in k3i_rows) / n_launch:.4f} ms); pops per lane "
          f"and part mean {sum(pops_all) / (n_launch * o.shape[0]):.3f}; "
          f"lane-pops idle in one-ray-per-thread warps over the parts: "
          + ", ".join(f"{lb} rays {v:.4f}" for lb, v in idle.items())
          + "; k5_bvh4_split "
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
    med6, ts6 = _median(
        lambda: tri_kernel.triangle_closest_kernel(o_cam, d_cam, soa))
    pairs = o_cam.shape[0] * soa.shape[1]
    b6 = _bound(soa.numel() * 4 + o_cam.shape[0] * 32, pairs * K6_OPS)
    print(f"[k6-vs-plain] parity_mesh_mid {soa.shape[1]} table columns "
          f"({mesh.triangles.mat_id.shape[0]} triangles) x {o_cam.shape[0]} "
          f"camera rays: t and idx bit-equal on every lane {eq6}, hits "
          f"{int((i6p >= 0).sum())}" + ("" if eq6 else " FAIL"), flush=True)
    print(f"[time] {card}, k6_tri_closest on those rays, median of {REPS}: bare "
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
          f"(median of {REPS} each): ns per pop of the launch "
          f"{json.dumps({k: round(v[0], 3) for k, v in per_pop.items()})}; "
          f"ns per packet-pop "
          f"{json.dumps({k: round(v[1], 5) for k, v in per_pop.items()})}",
          flush=True)
    p1_pops = 128
    med_p1, ts_p1 = _median(lambda: pp.pop_probe_kernel(fat_c, op, dp,
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
          f"{p1_pops} pops, median of {REPS}: bare {med_p1:.4f} ms (runs "
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

    # ---- 25. the general route with K3/K4 vs its plain traversal, and vs
    # the "shade" route
    from craytracer_tpu_torch.interop import numpy_leaves, scene_from_numpy
    from craytracer_tpu_torch.io.objloader import load_obj
    import torch_general_scenes as general_scenes

    def first_divergence(scn, o, d, ids, spp, depth, lanes, other,
                         mis=False):
        """Where each lane of `lanes` first parts between the general step
        through the kernels and `other` (("general" or "shade", kernels)):
        its bounce and the per-lane state there, both sides."""
        sa = sb = wf._init_state(o, d, depth, ids, mis)
        found = {}
        for b in range(depth + 1):
            sa = wf._general_step(scn, cfg.seed, spp, depth, b, sa,
                                  kernels=True, mis=mis)
            if other[0] == "general":
                sb = wf._general_step(scn, cfg.seed, spp, depth, b, sb,
                                      kernels=other[1], mis=mis)
            else:
                sb = wf._bounce_step(scn, cfg.seed, spp, depth, b, sb,
                                     kernels=other[1])
            for ln in lanes:
                if ln in found:
                    continue
                diff = [f"{name} {sa[i][ln].tolist()}/{sb[i][ln].tolist()}"
                        for i, name in ((5, "alive"), (4, "good"),
                                        (7, "rays"), (8, "shadow rays"))
                        if not torch.equal(sa[i][ln], sb[i][ln])]
                dl = (sa[3][ln] - sb[3][ln]).abs()
                if bool((dl > L_TOL + L_TOL * sb[3][ln].abs()).any()):
                    diff.append(f"L {sa[3][ln].tolist()}/"
                                f"{sb[3][ln].tolist()}")
                if diff:
                    found[ln] = f"bounce {b}: " + ", ".join(diff)
        return found

    def check_general(label, scn, o, d, ids, spp, depth, other, mis=False):
        """The general route (the MIS estimator's when `mis`) through the
        kernels against `other` on one batch, phase 8's bars; a lane that
        differs is printed with the bounce where it parts and the state
        there."""
        out_k = wf.trace_paths(scn, o, d, cfg.seed, ids, spp, depth,
                               with_metrics=True, fast_shade="shade",
                               general=True, mis=mis)
        out_p = wf.trace_paths(scn, o, d, cfg.seed, ids, spp, depth,
                               with_metrics=True,
                               fast_shade="shade" if other[1] else None,
                               general=other[0] == "general", mis=mis)
        torch.cuda.synchronize()
        bad, err_same, err_all, f = _compare(out_k, out_p)
        print(f"[general-vs-{other[0]}] {label} depth {depth}: good "
              f"differs on {bad:.5f}, max|dL| {err_same:.3g} (agreeing "
              f"lanes) {err_all:.3g} (all), rays {int(out_k[2]['rays'])}/"
              f"{int(out_p[2]['rays'])}, shadow_rays "
              f"{int(out_k[2]['shadow_rays'])}/"
              f"{int(out_p[2]['shadow_rays'])}"
              + (" FAIL " + "; ".join(f) if f else ""), flush=True)
        if f:
            (Lk, gk, mk), (Lp, gp, mp) = out_k, out_p
            off = ((gk != gp) | (mk["lane_rays"] != mp["lane_rays"])
                   | (mk["lane_shadow_rays"] != mp["lane_shadow_rays"])
                   | ((Lk - Lp).abs() > L_TOL + L_TOL * Lp.abs()).any(1))
            lanes = torch.nonzero(off).flatten()[:8].tolist()
            for ln, why in first_divergence(scn, o, d, ids, spp, depth,
                                            lanes, other, mis).items():
                print(f"[general-vs-{other[0]}]   lane {ln}: first parts "
                      f"at {why}", flush=True)
            fails.extend(f"general vs {other[0]} {label} depth {depth}: "
                         f"{x}" for x in f)

    for depth, s in ((0, 0), (2, 0), (5, 0), (5, cfg.num_samples - 1)):
        spp = torch.full_like(mmorton, s)
        o, d = generate_rays(mcam, mfilm, mmorton,
                             stratified_jitter(cfg.seed, mmorton, spp))
        check_general(f"mesh_mid 512x512 Morton spp {s}", mesh, o, d,
                      mmorton, spp, depth, ("general", False))
    for name, scn, c, fm, ids in (
            ("parity_mix", mix, xcam, xfilm, morton),
            ("mesh_mid", mesh, mcam, mfilm, mmorton)):
        spp = torch.zeros_like(ids)
        o, d = generate_rays(c, fm, ids, stratified_jitter(cfg.seed, ids,
                                                           spp))
        check_general(f"{name} 512x512 Morton spp 0", scn, o, d, ids, spp, 5,
                      ("shade", True))

    # ---- 26. the goldens through the forced general route
    def general_golden(label, scn, c, fm, golden):
        """render_sample(general=True) over cfg's passes in the Renderer's
        Morton order and NaN rule, the counts set to 0 just before and
        read just after; the image against `golden`. Returns (passes,
        launches)."""
        ids = torch.from_numpy(Renderer(scn, c, fm, cfg).pixel_order()
                               ).to(dev)
        accum = torch.zeros((fm.num_pixels, 3), device=dev)
        nan = 0
        reset_counts()
        t0 = time.perf_counter()
        for s in range(cfg.num_samples):
            vals = wf.render_sample(scn, c, fm, ids, cfg.seed,
                                    torch.full_like(ids, s), cfg.max_depth,
                                    cfg.estimator, general=True)
            nan_px = torch.isnan(vals).any(dim=-1)
            nan += int(nan_px.sum())
            vals = torch.where(nan_px[:, None], torch.nan_to_num(
                accum[ids.long()] / max(s, 1)), vals)
            accum.index_add_(0, ids.long(), vals)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = counts()
        ours = (accum / cfg.num_samples).cpu().numpy().reshape(
            fm.height, fm.width, 3)
        full_o, full_r, dev_max, share, f = _golden(ours, golden)
        print(f"[general-golden] {label} {fm.width}x{fm.height} "
              f"{cfg.num_samples} spp depth {cfg.max_depth} through "
              f"render_sample(general=True): {dt:.2f} s, launches {got}, "
              f"{nan} NaN; tone-mapped mean {full_o:.4f} vs golden "
              f"{full_r:.4f}, block dev max {dev_max:.4f}, share < 0.02 "
              f"{share:.3f}" + (" FAIL " + "; ".join(f) if f else ""),
              flush=True)
        fails.extend(f"{label} general golden: {x}" for x in f)
        if nan:
            fails.append(f"{label} general: {nan} NaN samples")
        return cfg.num_samples, got

    n_p, got = general_golden("parity_mix", mix, xcam, xfilm, GOLDEN_MIX)
    expect("parity_mix general", got)
    n_p, got = general_golden(
        "parity_mesh_mid", mesh, mcam, mfilm,
        os.path.join(REPO, "tests", "goldens", "golden_mesh_mid.is"))
    expect("parity_mesh_mid general", got, k3_bvh4_closest=6 * n_p,
           k4_bvh4_any=6 * n_p)

    # ---- 27. scenes that take the general route by themselves
    gcfg = RenderConfig(num_samples=16, max_depth=5, estimator="reference",
                        spp_batch=16)
    mat_s, mat_c, mat_f0 = load_scene_file(
        os.path.join(REPO, "scenes", "materials_scene.txt"), device=dev)
    mat_f = Film(fov=mat_f0.fov, width=size, height=size)
    b = SceneBuilder()
    eye, look, fov, _ = general_scenes.mesh_env_disk(
        b, [(sh.positions, sh.indices) for sh in load_obj(
            os.path.join(REPO, "scenes", "parity_mesh_mid.obj"))[0]])
    ged = scene_from_numpy(general_scenes.make_anisotropic(numpy_leaves(
        b.build(device="cpu"))), device=dev)
    ged_c = make_camera(eye, look, device=dev)
    ged_f = Film(fov=torch.tensor(fov, dtype=torch.float32, device=dev),
                 width=size, height=size)
    for label, scn, c, fm in (("materials_scene", mat_s, mat_c, mat_f),
                              ("mesh_mid_env_disk_aniso", ged, ged_c,
                               ged_f)):
        route = wf.production_fast_shade(scn, c, fm)
        print(f"[general] {label}: route {route}, material types "
              f"{scn.mat_types_present}, light types "
              f"{scn.light_types_present}, triangles "
              f"{scn.triangles.mat_id.shape[0]}", flush=True)
        if route != "general":
            fails.append(f"{label}: route {route}, not general")
        n_p, got = main_path(label, scn, c, fm, config=gcfg)
        if label == "materials_scene":
            expect(label, got)
        else:
            expect(label, got, k3_bvh4_closest=6 * n_p, k4_bvh4_any=6 * n_p)

    # ---- 28. general route times, in turns
    gpasses = 4
    runs = {
        "parity_mesh_mid shade route": (mesh, mcam, mfilm, mmorton, False),
        "parity_mesh_mid general route": (mesh, mcam, mfilm, mmorton, True),
        "mesh_mid_env_disk_aniso general route": (
            ged, ged_c, ged_f, torch.from_numpy(Renderer(
                ged, ged_c, ged_f, cfg).pixel_order()).to(dev), False)}

    def passes_of(scn, c, fm, ids, general):
        return lambda: [wf.render_sample(scn, c, fm, ids, cfg.seed, 5000 + s,
                                         5, general=general)
                        for s in range(gpasses)][-1]

    fns = {k: passes_of(*v) for k, v in runs.items()}
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(REPS):
        for k, fn in fns.items():
            times[k].append(_timed(fn)[0])
    for k, (scn, c, fm, ids, general) in runs.items():
        rays = 0
        for s in range(gpasses):
            o, d = generate_rays(c, fm, ids, stratified_jitter(
                cfg.seed, ids, 5000 + s))
            m = wf.trace_paths(scn, o, d, cfg.seed, ids, 5000 + s, 5,
                               with_metrics=True, fast_shade="shade",
                               general=general)[2]
            rays += int(m["rays"]) + int(m["shadow_rays"])
        med = statistics.median(times[k])
        print(f"[time] {card}, {k} 512x512 depth 5, {gpasses} passes through "
              f"render_sample per run, in turns, median of {REPS}: "
              f"{med / gpasses:.4f} ms/pass, {rays / (med / 1e3):.6g} rays/s "
              f"({rays} rays + shadow rays per run; runs "
              f"{_runs(times[k])} ms)", flush=True)

    # ---- 29. golden_textured through the Renderer; its bvh4 route
    import torch_textured_scenes as tex_scenes
    from craytracer_tpu_torch.core import math as vm
    from craytracer_tpu_torch.lights.lights import sample_one_light
    from craytracer_tpu_torch.profile_render import profile_render
    from craytracer_tpu_torch.sampling.rng import uniforms
    from craytracer_tpu_torch.scene import fullscene

    textured = os.path.join(REPO, "scenes", "parity_textured.txt")
    os.environ["CRAY_TEX_FLOAT_DIV255"] = "1"  # the golden's EXR scale
    try:
        tex_s, tex_c, tex_f = load_scene_file(textured, device=dev)
        tex_b = load_scene_file(textured, accel="bvh4", device=dev)[0]
    finally:
        del os.environ["CRAY_TEX_FLOAT_DIV255"]
    route = wf.production_fast_shade(tex_s, tex_c, tex_f)
    print(f"[textured] parity_textured: {tex_s.textures.width.shape[0]} "
          f"textures ({tex_s.textures.texels.shape[0]} texels), env kind "
          f"{tex_s.env.kind}, {tex_s.triangles.mat_id.shape[0]} triangles, "
          f"accel {tex_s.accel}, route {route}; with accel bvh4: "
          f"{tex_b.tri_bvh.fat.shape[0]} fat rows, route "
          f"{wf.production_fast_shade(tex_b, tex_c, tex_f)}", flush=True)
    if route != "general":
        fails.append(f"parity_textured: route {route}, not general")
    n_p, got = main_path(
        "parity_textured", tex_s, tex_c, tex_f,
        os.path.join(REPO, "tests", "goldens", "golden_textured.is"),
        config=RenderConfig(num_samples=160, max_depth=5,
                            estimator="reference", spp_batch=16))
    expect("parity_textured", got)
    tex512 = Film(fov=tex_f.fov, width=size, height=size)
    tids = torch.from_numpy(Renderer(tex_b, tex_c, tex512, cfg).pixel_order()
                            ).to(dev)
    spp = torch.zeros_like(tids)
    o, d = generate_rays(tex_c, tex512, tids,
                         stratified_jitter(cfg.seed, tids, spp))
    check_general("parity_textured bvh4 512x512 Morton spp 0", tex_b, o, d,
                  tids, spp, 5, ("general", False))

    # ---- 30. the fullscene: K3/K4 against the plain traversal, main path
    t0 = time.perf_counter()
    made = fullscene.ensure_obj()
    print(f"[fullscene] {os.path.relpath(fullscene.OBJ, REPO)} "
          f"{'generated' if made else 'present'}: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    full, fcam, ffilm0 = load_scene_file(
        os.path.join(REPO, "scenes", "fullscene.txt"), device=dev)
    load_s = time.perf_counter() - t0
    fbvh = full.tri_bvh
    ffilm = Film(fov=ffilm0.fov, width=size, height=size)
    route = wf.production_fast_shade(full, fcam, ffilm)
    print(f"[fullscene] scenes/fullscene.txt loaded and built in {load_s:.2f}"
          f" s: {fbvh.n_tris} triangles, {fbvh.fat.shape[0]} fat rows, "
          f"{fbvh.fat.numel() * 4 / 1e6:.1f} MB table, parts "
          f"{len(full.tri_parts) if full.tri_parts else 0}, route {route}; "
          f"material types {full.mat_types_present}, light types "
          f"{full.light_types_present}, {full.mesh_lights.surface_area.shape[0]}"
          f" mesh lights, {full.textures.width.shape[0]} textures, env "
          f"importance {full.env.importance}", flush=True)
    if route != "general" or full.tri_parts is not None:
        fails.append(f"fullscene: route {route}, parts {full.tri_parts}")
    if fbvh.n_tris != fullscene.triangle_count():
        fails.append(f"fullscene: {fbvh.n_tris} triangles, not the "
                     f"{fullscene.triangle_count()} of {fullscene.SPHERES} "
                     f"spheres")
    fids = torch.from_numpy(Renderer(full, fcam, ffilm, cfg).pixel_order()
                            ).to(dev)
    for depth, s in ((0, 0), (2, 0), (5, 0), (5, cfg.num_samples - 1)):
        spp = torch.full_like(fids, s)
        o, d = generate_rays(fcam, ffilm, fids,
                             stratified_jitter(cfg.seed, fids, spp))
        check_general(f"fullscene 512x512 Morton spp {s}", full, o, d, fids,
                      spp, depth, ("general", False))

    def general_bounce(scn, state, spp, bounce):
        """The shadow rays (origin, direction, max_dist) that the plain
        general step of `bounce` hands to shadow_distance, and the state
        after it."""
        seen, plain = [], wf.shadow_distance

        def grab(scene, o, d, md, kernels=False):
            seen.append((o, d, md))
            return plain(scene, o, d, md, kernels=kernels)

        wf.shadow_distance = grab
        try:
            nxt = wf._general_step(scn, cfg.seed, spp, 5, bounce, state,
                                   kernels=False)
        finally:
            wf.shadow_distance = plain
        return seen[0], nxt

    # K3 and K4 alone on the route's bounce-0 and bounce-1 rays and shadow
    # rays: t and ids bit-equal with the plain traversal on every lane
    spp = torch.zeros_like(fids)
    o, d = generate_rays(fcam, ffilm, fids,
                         stratified_jitter(cfg.seed, fids, spp))
    state = wf._init_state(o, d, 5, fids)
    frecs = []
    for b in (0, 1):
        shadow, nxt = general_bounce(full, state, spp, b)
        frecs.append((state[0], state[1], shadow))
        check_k3(f"fullscene bounce-{b} rays", state[0], state[1], fbvh)
        check_k4(f"fullscene bounce-{b} shadow rays", *shadow, bvh_=fbvh)
        state = nxt
    n_p, got = main_path("fullscene", full, fcam, ffilm,
                         config=RenderConfig(num_samples=16, max_depth=5,
                                             estimator="reference",
                                             spp_batch=16))
    expect("fullscene", got, k3_bvh4_closest=6 * n_p, k4_bvh4_any=6 * n_p)
    for name in ("k3_bvh4_closest", "k4_bvh4_any"):
        kernels[name]["launches"] += got[name]

    # ---- 31. the quad mesh light: NEE under the principled power only
    def bounce0_nee(scn, c, fm):
        """Valid bounce-0 NEE samples per light row: the rows the general
        step's pick and sample uniforms choose at the camera rays' hits."""
        ids = torch.arange(fm.num_pixels, dtype=torch.int32, device=dev)
        spp0 = torch.zeros_like(ids)
        o, d = generate_rays(c, fm, ids, stratified_jitter(cfg.seed, ids,
                                                           spp0))
        hit = intersect_scene(scn, o, d)
        u = uniforms(cfg.seed, ids, spp0, 0, 9, 0)
        ft, fb, fn = vm.make_shading_frame(hit.normal, hit.dpdu)
        ls = sample_one_light(scn, u[:, 4], u[:, 0:2], hit.point, fn, ft, fb)
        pick = torch.clamp(torch.searchsorted(scn.lights.power_cdf,
                                              u[:, 4].contiguous(),
                                              right=True),
                           0, scn.lights.light_type.shape[0] - 1)
        ok = ls.valid & hit.hit_mask
        return torch.bincount(pick[ok], minlength=scn.lights.light_type.shape[
            0]).tolist()

    pcfg = RenderConfig(num_samples=16, max_depth=5, estimator="physical",
                        spp_batch=16)
    for label, fn, power in (
            ("quad_lamp principled", tex_scenes.quad_lamp, "principled"),
            ("quad_lamp_and_rect reference", tex_scenes.quad_lamp_and_rect,
             "reference"),
            ("quad_lamp reference", tex_scenes.quad_lamp, "reference")):
        qb = SceneBuilder()
        eye, look, fov = fn(qb)
        qs = qb.build(light_power=power, device=dev)
        qc = make_camera(eye, look, device=dev)
        qf = Film(fov=torch.tensor(fov, dtype=torch.float32, device=dev),
                  width=size, height=size)
        types = qs.lights.light_type.tolist()
        row = types.index(T.LIGHT_MESH)
        nee = bounce0_nee(qs, qc, qf)
        print(f"[mesh-light] {label}: light types {types}, powers "
              f"{[round(x, 6) for x in qs.lights.power.tolist()]}, valid "
              f"bounce-0 NEE samples per row {nee}", flush=True)
        # alone in the reference mode the quad takes the uniform fallback
        # (every power 0 -> 1 / rows), so it is sampled there too
        want_nee = power == "principled" or len(types) == 1
        if (nee[row] > 0) != want_nee:
            fails.append(f"{label}: {nee[row]} NEE samples on the mesh light")
        # the mesh row at power 0 beside the rect lamp is never picked,
        # so that scene stays on K1, as the JAX gate keeps it
        route = wf.production_fast_shade(qs, qc, qf)
        want = "bounce" if label.startswith("quad_lamp_and_rect") else \
            "general"
        print(f"[mesh-light] {label}: route {route}", flush=True)
        if route != want:
            fails.append(f"{label}: route {route}, not {want}")
        n_p, got = main_path(label.replace(" ", "_"), qs, qc, qf,
                             config=pcfg)
        if want == "bounce":
            expect(label, got, k1_pass=n_p)
        else:
            expect(label, got)

    # ---- 32. times, in turns: fullscene and parity_textured at 512x512
    tex_ids = torch.from_numpy(Renderer(tex_s, tex_c, tex512, cfg)
                               .pixel_order()).to(dev)
    truns = {"fullscene": (full, fcam, ffilm, fids, False),
             "parity_textured": (tex_s, tex_c, tex512, tex_ids, False)}
    fns = {k: passes_of(*v) for k, v in truns.items()}
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(REPS):
        for k, fn in fns.items():
            times[k].append(_timed(fn)[0])
    for k, (scn, c, fm, ids, _) in truns.items():
        rays = 0
        for s in range(gpasses):
            o, d = generate_rays(c, fm, ids, stratified_jitter(
                cfg.seed, ids, 5000 + s))
            m = wf.trace_paths(scn, o, d, cfg.seed, ids, 5000 + s, 5,
                               with_metrics=True, fast_shade="shade")[2]
            rays += int(m["rays"]) + int(m["shadow_rays"])
        med = statistics.median(times[k])
        prof = profile_render(scn, c, fm, 2, 1, 1)
        print(f"[time] {card}, {k} 512x512 depth 5, {gpasses} passes through "
              f"render_sample per run, in turns, median of {REPS}: "
              f"{med / gpasses:.4f} ms/pass, {rays / (med / 1e3):.6g} rays/s "
              f"({rays} rays + shadow rays per run; runs "
              f"{_runs(times[k])} ms); profile_render 2 spp, one per pass, "
              "depth 1: "
              f"wall {prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f}"
              f" ms, idle share {prof['idle']:.4f}", flush=True)
    for b, (o_b, d_b, (so, sd, smd)) in enumerate(frecs):
        o_s, d_s = sorted_rays(o_b, d_b)
        so_s, sd_s, smd_s = sorted_rays(so, sd, smd)
        med3, ts3 = _median(lambda: bk.bvh4_closest_hit_kernel(fbvh, o_s,
                                                                d_s))
        med4, ts4 = _median(lambda: bk.bvh4_any_hit_kernel(fbvh, so_s, sd_s,
                                                            smd_s))
        pops3, b3, rows3 = pops_and_bound(bvh4_closest_hit_stats, fbvh, o_s,
                                          d_s)
        pops4, b4, rows4 = pops_and_bound(bvh4_any_hit_stats, fbvh, so_s,
                                          sd_s, smd_s)
        print(f"[time] {card}, fullscene bare K3 on the {o_s.shape[0]} "
              f"bounce-{b} rays (ray_key-sorted): {med3:.4f} ms (runs "
              f"{_runs(ts3)}), bound {b3[0]:.4f} ms ({b3[1]}; whole rows "
              f"{rows3[0]:.4f}), pops per lane mean "
              f"{pops3.double().mean().item():.3f} max {int(pops3.max())}; "
              f"bare K4 on its shadow rays: {med4:.4f} ms (runs "
              f"{_runs(ts4)}), bound {b4[0]:.4f} ms ({b4[1]}; whole rows "
              f"{rows4[0]:.4f}), pops per lane mean "
              f"{pops4.double().mean().item():.3f}", flush=True)

    # ---- 33. the sphere field: the "shade" route (the torch-op sphere
    # walk, then K2) against its plain version, main path, times
    from craytracer_tpu_torch.accel.bvh4_sphere import (bvh4s_any_hit,
                                                        bvh4s_closest_hit)
    from craytracer_tpu_torch.scene.sphere_field import (sphere_field,
                                                         sphere_field_view)

    t0 = time.perf_counter()
    field = sphere_field(FIELD_SPHERES, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    sbvh = field.sph_bvh
    scam, sfilm = sphere_field_view(FIELD_SPHERES, size, device=dev)
    route = wf.production_fast_shade(field, scam, sfilm)
    print(f"[spheres] sphere_field({FIELD_SPHERES}) built in {build_s:.2f} "
          f"s: {sbvh.n_prims} spheres, {sbvh.fat.shape[0]} fat rows "
          f"({sbvh.fat.numel() * 4 / 1e6:.2f} MB), stack {sbvh.stack_size}, "
          f"accel {field.accel}, route {route}, shading features "
          f"{shade_features(field)}", flush=True)
    if route != "shade" or sbvh.n_prims != FIELD_SPHERES:
        fails.append(f"sphere field: route {route}, {sbvh.n_prims} spheres")
    sids = torch.from_numpy(Renderer(field, scam, sfilm, cfg).pixel_order()
                            ).to(dev)
    for depth, s in ((0, 0), (2, 0), (5, 0), (5, cfg.num_samples - 1)):
        spp = torch.full_like(sids, s)
        o, d = generate_rays(scam, sfilm, sids,
                             stratified_jitter(cfg.seed, sids, spp))
        out_k = wf.trace_paths(field, o, d, cfg.seed, sids, spp, depth,
                               with_metrics=True, fast_shade="shade")
        out_p = wf.trace_paths(field, o, d, cfg.seed, sids, spp, depth,
                               with_metrics=True)
        torch.cuda.synchronize()
        bad, err_same, err_all, f = _compare(out_k, out_p)
        print(f"[pass-vs-plain] sphere_field 512x512 Morton spp {s} depth "
              f"{depth}: good differs on {bad:.5f}, max|dL| {err_same:.3g} "
              f"(agreeing lanes) {err_all:.3g} (all), rays "
              f"{int(out_k[2]['rays'])}/{int(out_p[2]['rays'])}, shadow_rays "
              f"{int(out_k[2]['shadow_rays'])}/"
              f"{int(out_p[2]['shadow_rays'])}"
              + (" FAIL " + "; ".join(f) if f else ""), flush=True)
        fails.extend(f"sphere field pass depth {depth}: {x}" for x in f)
    sspp = torch.zeros_like(sids)
    o, d = generate_rays(scam, sfilm, sids,
                         stratified_jitter(cfg.seed, sids, sspp))
    srecs = plain_records(field, o, d, sids, sspp, 5)
    check_k2("sphere_field", field, srecs, sspp)
    n_p, got = main_path("sphere_field", field, scam, sfilm,
                         config=RenderConfig(num_samples=4, max_depth=5,
                                             estimator="reference"))
    expect("sphere_field", got, k2_shade=6 * n_p)
    kernels["k2_shade"]["launches"] += got["k2_shade"]

    spasses = 1
    for label, fm, depth in (("512x512 depth 3", sfilm, 3),
                             ("256x256 depth 3 (bench_spheres.py's shape)",
                              sphere_field_view(FIELD_SPHERES, 256,
                                                device=dev)[1], 3)):
        ids = torch.from_numpy(Renderer(field, scam, fm, cfg).pixel_order()
                               ).to(dev)
        med, ts = _median(lambda: [
            wf.render_sample(field, scam, fm, ids, cfg.seed, 6000 + k, depth)
            for k in range(spasses)])
        rays = pass_rays(field, scam, fm, ids, 6000, spasses, depth)
        print(f"[time] {card}, sphere_field {label}, {spasses} passes "
              f"through render_sample per run, median of {REPS}: "
              f"{med / spasses:.4f} ms/pass, {rays / (med / 1e3):.6g} rays/s "
              f"({rays} rays + shadow rays per run; runs {_runs(ts)} ms)",
              flush=True)
    prof = profile_render(field, scam, sphere_field_view(
        FIELD_SPHERES, 256, device=dev)[1], 1, 1, 1)
    print(f"[time] {card}, sphere_field profile_render 256x256 depth 1, 1 "
          f"spp: wall {prof['wall_ms']:.3f} ms, device "
          f"{prof['device_ms']:.3f} ms, idle share {prof['idle']:.4f}",
          flush=True)
    # bare K2 on the six bounces of one pass (the matte core), and the
    # plain sphere walk each bounce pays: its closest hit on the bounce's
    # rays and its any hit on the bounce's shadow rays
    med2s, ts2s = _median(k2_bare(field, srecs, sspp), queued=True)
    nl = sum(st[1].shape[0] for st, _, _ in srecs)
    b2s = _bound(nl * K2_LANE_BYTES, nl * SHADE_OPS)
    walk_c = _timed(lambda: [bvh4s_closest_hit(sbvh, st[0], st[1])
                             for st, _, _ in srecs])[0] / len(srecs)
    walk_a = _timed(lambda: [bvh4s_any_hit(sbvh, out["shadow_o"],
                                           out["shadow_d"],
                                           out["dist_adj_t"])
                             for _, _, out in srecs])[0] / len(srecs)
    print(f"[time] {card}, sphere_field bare K2 (matte core) on the 6 "
          f"bounces of one 512x512 pass: {med2s / 6:.4f} ms/launch (runs of "
          f"6 {_runs(ts2s)} ms), bound {b2s[0] / 6:.4f} ms/launch "
          f"({b2s[1]}); the plain sphere walk per bounce (timed once): "
          f"closest hit {walk_c:.3f} ms, shadow any hit {walk_a:.3f} ms",
          flush=True)

    # ---- 34. MIS on the fullscene through K3/K4, main path, times
    for depth in (0, 2, 5):
        spp = torch.zeros_like(fids)
        o, d = generate_rays(fcam, ffilm, fids,
                             stratified_jitter(cfg.seed, fids, spp))
        check_general(f"fullscene mis 512x512 Morton spp 0", full, o, d,
                      fids, spp, depth, ("general", False), mis=True)
    n_p, got = main_path("fullscene_mis", full, fcam, ffilm,
                         config=RenderConfig(num_samples=16, max_depth=5,
                                             estimator="mis", spp_batch=16))
    expect("fullscene mis", got, k3_bvh4_closest=6 * n_p,
           k4_bvh4_any=6 * n_p)
    for name in ("k3_bvh4_closest", "k4_bvh4_any"):
        kernels[name]["launches"] += got[name]
    mpasses_f = 2

    def est_passes(est):
        return lambda: [wf.render_sample(full, fcam, ffilm, fids, cfg.seed,
                                         7000 + k, 5, est)
                        for k in range(mpasses_f)][-1]

    fns = {est: est_passes(est) for est in ("mis", "physical")}
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(REPS):
        for k, fn in fns.items():
            times[k].append(_timed(fn)[0])
    print(f"[time] {card}, fullscene 512x512 depth 5, {mpasses_f} passes "
          f"through render_sample per run, in turns, median of {REPS}: "
          + "; ".join(f"{k} {statistics.median(v) / mpasses_f:.4f} ms/pass "
                      f"(runs {_runs(v)} ms)" for k, v in times.items())
          + f"; mis / physical "
          f"{statistics.median(times['mis']) / statistics.median(times['physical']):.4f}",
          flush=True)

    # ---- 35. MIS unbiased on the card: tests/test_mis.py's glossy scene
    gb = SceneBuilder()
    eye, look, fov = tex_scenes.glossy_lamp(gb, 4.0)
    gls = gb.build(device=dev)
    gcam = make_camera(eye, look, device=dev)
    gfilm = Film(fov=torch.tensor(fov, dtype=torch.float32, device=dev),
                 width=size, height=size)
    means = {}
    for est in ("mis", "physical"):
        groute = wf.production_fast_shade(gls, gcam, gfilm, est)
        r = Renderer(gls, gcam, gfilm, RenderConfig(
            num_samples=64, max_depth=3, seed=11, estimator=est,
            spp_batch=16))
        reset_counts()
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = counts()
        img = r.raw_mean()
        means[est] = float(img.mean())
        print(f"[mis] glossy 4 x 4 lamp 512x512 64 spp depth 3, {est}: "
              f"route {groute}, {dt:.2f} s, {r.passes} passes, launches "
              f"{got}, {r.nan_count} NaN, mean {means[est]:.6f}", flush=True)
        if r.nan_count or not np.isfinite(img).all():
            fails.append(f"glossy {est}: {r.nan_count} NaN")
        expect(f"glossy {est}", got,
               **({"k1_pass": r.passes} if groute == "bounce" else {}))
    rel = abs(means["mis"] - means["physical"]) / means["physical"]
    print(f"[mis] glossy image means: mis {means['mis']:.6f}, physical "
          f"{means['physical']:.6f}, relative difference {rel:.4f} (bar 0.12,"
          f" tests/test_mis.py:58)" + (" FAIL" if rel > 0.12 else ""),
          flush=True)
    if rel > 0.12:
        fails.append(f"glossy: MIS mean off physical by {rel:.4f}")

    # ---- 38-43. slice F: compaction, tiles, resume, the NaN retrace, K1 on
    # a sampler's rays, WHITTED / RAYCAST / AOVs, the command line
    ctx.kernels = kernels
    slice_f_phases(ctx)

    # ---- 44-48. slice I part 2 and slice F part 3: the bvh, bvh4q, grid,
    # binned and hybrid accelerators, AO, the command line's live views
    slice_i_phases(ctx)

    # ---- 49-50. slice H: ray- and geometry-sharded passes and train steps
    # as ranks on this card; the XL fullscene through the parts route
    slice_h_phases(ctx)

    # ---- 51-54. slice K: the general route on every accelerator, the XL
    # gradient through the parts route, the albedo-recovery demo
    slice_k_phases(ctx)

    # ---- 55. slice L: the texture decoders on the card's host; the
    # checker in seven encodings through the general route and the Renderer
    slice_l_phases(ctx)

    # ---- 56. slice M: TIFF, DDS, lossless WebP, PSD and PIL's own PNM
    # on the card's host; the checker in five more encodings through K3/K4
    slice_m_phases(ctx)

    # ---- 37. the inverse path: gradients through the general route, the
    # search detached through K3/K4, and InverseRenderer
    from craytracer_tpu_torch.examples import inverse_mesh_demo as demo
    from craytracer_tpu_torch.inverse import (InverseRenderer, deterministic,
                                              render_mean)
    from craytracer_tpu_torch.scene import types as T

    def peak_reset():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9

    isize, steps_c = 512, 1
    t0 = time.perf_counter()
    reset_counts()
    dm = demo.demo(size=isize, tex=64, steps=steps_c, device=dev)
    torch.cuda.synchronize()
    got = counts()
    icfg, iscene, icam, ifilm = (dm["config"], dm["scene"], dm["cam"],
                                 dm["film"])
    per_pass = icfg.max_depth + 1
    with torch.no_grad():
        troute = wf.production_fast_shade(dm["scene_true"], icam, ifilm,
                                          icfg.estimator, icfg.max_depth)
    target = dm["target"]
    print(f"[inverse] (a) demo scene {iscene.tri_bvh.n_tris} triangles "
          f"(bvh4, {iscene.tri_bvh.fat.shape[0]} fat rows), 64x64x3 texels "
          f"+ alpha = {3 * 64 * 64 + 1} parameters; target {isize}x{isize} "
          f"x 8 spp, {icfg.estimator}, depth {icfg.max_depth}, no grad: "
          f"route {troute}, {time.perf_counter() - t0:.2f} s, launches "
          f"{got}, mean {float(target.mean()):.5f}", flush=True)
    expect("inverse target", got, k3_bvh4_closest=8 * per_pass,
           k4_bvh4_any=8 * per_pass)
    if troute != "general" or not bool(torch.isfinite(target).all()):
        fails.append(f"inverse target: route {troute} or not finite")

    # this path's own rays through K3 and K4 against the plain traversal
    ipix = torch.arange(ifilm.num_pixels, dtype=torch.int32, device=dev)
    ispp = torch.zeros_like(ipix)
    o_i, d_i = generate_rays(icam, ifilm, ipix,
                             stratified_jitter(7, ipix, ispp))
    ibvh = iscene.tri_bvh
    check_k3("inverse demo 512x512 camera rays", o_i, d_i, bvh_=ibvh)
    t_i = bvh4_closest_hit_stats(ibvh, o_i, d_i)[0]
    check_k4("inverse demo camera rays, max_dist around the hit", o_i, d_i,
             torch.where(t_i < TMAX, t_i * 0.999, 5.0), bvh_=ibvh)
    st1 = wf._general_step(iscene, 7, ispp, icfg.max_depth, 0,
                           wf._init_state(o_i, d_i, icfg.max_depth, ipix,
                                          True), kernels=False, mis=True)
    check_k3("inverse demo bounce-1 rays", st1[0], st1[1], bvh_=ibvh)
    check_general("inverse demo 512x512 spp 0", iscene, o_i, d_i, ipix,
                  ispp, icfg.max_depth, ("general", False), mis=True)

    def renderer(kernels=None, config=None, size_scene=None):
        dd = size_scene or dm
        return InverseRenderer(dd["scene"], dd["cam"], dd["film"],
                               dd["target"], dd["params0"], dd["apply_fn"],
                               config=config or dd["config"],
                               clip_fn=demo.clip_fn, kernels=kernels)

    # (b) one gradient at the starting parameters: kernels vs plain
    grads, grad_s = {}, {}
    for label, kern in (("kernels", None), ("plain", False)):
        inv = renderer(kern)
        with torch.enable_grad():
            groute = wf.production_fast_shade(
                dm["apply_fn"](iscene, inv.params), icam, ifilm,
                icfg.estimator, icfg.max_depth)
        peak_reset()
        reset_counts()
        t0 = time.perf_counter()
        loss, g = inv.value_and_grad()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = counts()
        ga, gt = g  # params sorted by name: alpha, texels
        grads[label] = (loss, ga, gt)
        grad_s[label] = dt
        print(f"[inverse] (b) gradient through the {label}: route {groute}, "
              f"loss {float(loss):.9g}, d/d alpha {float(ga):.6g}, "
              f"|d/d texels| max {float(gt.abs().max()):.6g}, "
              f"{int((gt != 0).any(-1).sum())} texels with a gradient, "
              f"{dt:.3f} s, peak "
              f"{peak_gb():.2f} GB, launches {got}", flush=True)
        want = ({} if kern is False else {"k3_bvh4_closest": 8 * per_pass,
                                          "k4_bvh4_any": 8 * per_pass})
        expect(f"inverse gradient {label}", got, **want)
        if groute != "general" or not (bool(torch.isfinite(gt).all())
                                       and bool(torch.isfinite(ga))):
            fails.append(f"inverse gradient {label}: route {groute} or a "
                         "non-finite gradient")
    # times after the warm-up, in turns, median of REPS: the gradient through
    # the kernels as InverseRenderer takes it (deterministic accumulation)
    # and the same loss's backward with the default atomic accumulation;
    # then the forward pass alone (the loss's graph built, no backward)
    inv = renderer()
    t_det, t_atom, g_atom = [], [], None
    inv_reps = 1  # each run takes seconds; one after the warm-up
    for _ in range(inv_reps):
        t0 = time.perf_counter()
        inv.value_and_grad()
        torch.cuda.synchronize()
        t_det.append(time.perf_counter() - t0)
        for p in inv._leaves:
            p.grad = None
        t0 = time.perf_counter()
        with torch.enable_grad():
            inv.loss(inv.params, 0).backward()
        torch.cuda.synchronize()
        t_atom.append(time.perf_counter() - t0)
        g_atom = inv.params["texels"].grad
    t0 = time.perf_counter()
    with torch.enable_grad():
        fwd = inv.loss(inv.params, 0)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    del fwd
    t_again = statistics.median(t_det)
    print(f"[time] {card}, one inverse gradient at {isize}x{isize} x "
          f"{icfg.spp_per_step} spp after the warm-up, in turns, median of "
          f"{inv_reps}: deterministic {t_again:.3f} s (runs {_runs(t_det)} "
          f"s), "
          f"atomic accumulation {statistics.median(t_atom):.3f} s (runs "
          f"{_runs(t_atom)} s), deterministic / atomic "
          f"{t_again / statistics.median(t_atom):.4f}; the forward pass "
          f"alone {t_fwd:.3f} s, so the backward {t_again - t_fwd:.3f} s; "
          f"the plain traversal's single run above {grad_s['plain']:.3f} s",
          flush=True)
    (lk, gak, gtk), (lp, gap, gtp) = grads["kernels"], grads["plain"]
    dgt = (gtk - gtp).abs()
    bar_t = 1e-5 * float(gtp.abs().max()) + 1e-5 * gtp.abs()
    bar_a = 1e-5 * abs(float(gap)) * 2
    ok_b = (torch.equal(lk, lp) and bool((dgt <= bar_t).all())
            and abs(float(gak - gap)) <= bar_a)
    print(f"[inverse] (b) kernels vs plain: loss bit-equal "
          f"{torch.equal(lk, lp)}, |d alpha| {abs(float(gak - gap)):.3g} "
          f"(bar {bar_a:.3g}), max |d texel grad| {float(dgt.max()):.3g} "
          f"(bar rtol 1e-5 + 1e-5 max|g| = "
          f"{1e-5 * float(gtp.abs().max()):.3g}); deterministic vs atomic "
          f"accumulation: max |d texel grad| "
          f"{float((g_atom - gtk).abs().max()):.3g}"
          + ("" if ok_b else " FAIL"), flush=True)
    if not ok_b:
        fails.append("inverse gradient: kernels and plain disagree")

    # (c) InverseRenderer: a step at 512x512, 8 spp
    inv = renderer()
    step_launch = icfg.spp_per_step * per_pass
    step_s, step_gb = [], []
    for k in range(steps_c):
        peak_reset()
        reset_counts()
        t0 = time.perf_counter()
        loss, gnorm = inv.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = counts()
        step_s.append(dt)
        step_gb.append(peak_gb())
        print(f"[inverse] (c) step {k + 1}: loss {loss:.9g}, grad norm "
              f"{gnorm:.6g}, alpha {float(inv.params['alpha']):.6f}, "
              f"{dt:.3f} s, peak {step_gb[-1]:.2f} GB, launches {got} "
              f"(derived: K3 = K4 = spp {icfg.spp_per_step} x (depth "
              f"{icfg.max_depth} + 1), no remat, = {step_launch})",
              flush=True)
        expect(f"inverse step {k + 1}", got, k3_bvh4_closest=step_launch,
               k4_bvh4_any=step_launch)
        for name in ("k3_bvh4_closest", "k4_bvh4_any"):
            kernels[name]["launches"] += got[name]
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fails.append(f"inverse step {k + 1}: loss {loss}, norm {gnorm}")
    print(f"[time] {card}, inverse step at {isize}x{isize} x "
          f"{icfg.spp_per_step} spp, MIS depth {icfg.max_depth}, "
          f"{3 * 64 * 64 + 1} parameters, deterministic: "
          f"{statistics.median(step_s):.3f} s/step (median of "
          f"{steps_c}: {_runs(step_s)} s), peak memory "
          f"{max(step_gb):.2f} GB", flush=True)

    # (d) resume on the card: 2 + save + load + 2 == 4 straight
    small = demo.demo(size=128, tex=64, steps=4, device=dev)
    a = renderer(size_scene=small)
    for _ in range(4):
        a.step()
    b = renderer(size_scene=small)
    for _ in range(2):
        b.step()
    ck = str(cuda_build.BUILD_DIR / "inverse_resume.pt")
    b.save_state(ck)
    c = renderer(size_scene=small).load_state(ck)
    for _ in range(2):
        c.step()
    same = all(torch.equal(a.params[k], c.params[k]) for k in a.params)
    sa, sc = a.opt.state_dict()["state"], c.opt.state_dict()["state"]
    same_opt = all(torch.equal(sa[i][n].cpu(), sc[i][n].cpu())
                   for i in sa for n in sa[i])
    print(f"[inverse] (d) 128x128: 2 steps + save + load + 2 steps vs 4 "
          f"straight: params bit-equal {same}, optimizer state bit-equal "
          f"{same_opt}, losses {[round(h[0], 9) for h in a.history]} / "
          f"{[round(h[0], 9) for h in c.history]}"
          + ("" if same and same_opt else " FAIL"), flush=True)
    if not (same and same_opt and a.history == c.history):
        fails.append("inverse resume on the card is not bit-exact")

    # (e) the fullscene: one gradient at 512x512, 1 spp, MIS, depth 2
    tid = 0
    t_off = int(full.textures.offset[tid])
    t_n = int(full.textures.width[tid]) * int(full.textures.height[tid])
    metal = int(torch.nonzero(full.materials.mat_type == T.MAT_METAL)[0])
    fparams = {"texels": full.textures.texels[t_off:t_off + t_n].clone()
               .requires_grad_(True),
               "alpha": full.materials.alphax[metal].clone()
               .requires_grad_(True)}
    fgraft = demo.grafter(full, metal)
    fcfg = dataclasses.replace(icfg, spp_per_step=1)
    fpix = torch.arange(ffilm.num_pixels, dtype=torch.int32, device=dev)
    peak_reset()
    reset_counts()
    t0 = time.perf_counter()
    with deterministic():
        fimg = render_mean(fgraft(full, fparams), fcam, ffilm, fpix, 7, 0,
                           fcfg)
        fimg.mean().backward()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = counts()
    fg_t, fg_a = fparams["texels"].grad, fparams["alpha"].grad
    print(f"[inverse] (e) fullscene {fbvh.n_tris} triangles 512x512 x 1 "
          f"spp, MIS depth 2: gradient of the mean image w.r.t. texture "
          f"{tid}'s {t_n} texels and material {metal}'s (METAL) alpha "
          f"{float(fparams['alpha']):.4f}: d/d alpha {float(fg_a):.6g}, "
          f"|d/d texels| max {float(fg_t.abs().max()):.6g}, "
          f"{int((fg_t != 0).any(-1).sum())} texels with a gradient; "
          f"{dt:.3f} s, peak {peak_gb():.2f} GB, launches {got}",
          flush=True)
    expect("fullscene gradient", got, k3_bvh4_closest=per_pass,
           k4_bvh4_any=per_pass)
    if not (bool(torch.isfinite(fg_t).all()) and bool(torch.isfinite(fg_a))
            and float(fg_t.abs().max()) > 0.0):
        fails.append("fullscene gradient: not finite or all zero")

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
