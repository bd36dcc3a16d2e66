"""The partitioned-table slice as a whole: a small city through the port's
kernel route with its table cut into parts, against the same scene
without parts and against the JAX package's pass.

The city is bench_mesh.py's (craytracer_tpu_torch/scene/city.py): 4
icospheres, 5,120 triangles (1,433 fat rows), ground and lamp rects. The
part budget is monkeypatched to a fifth of the table's bytes, so
SceneBuilder.build cuts it into 17 parts (scene/build.py), as it cuts a
San-Miguel-scale table at 120 MiB. The JAX scene comes from bench_mesh.py
`build_scene` with accel="bvh4"; its triangles and fat table equal the
port's bit for bit.

The pass: 32x32 from a camera near the spheres, two samples per pixel
(per-lane spp, 2,048 lanes), depth 0, 2 and 5. The port runs its kernel
route on CPU tensors (integrator/wavefront.py `_trace` with
kernels=True, the loop render_sample runs on the card; the wrappers take
their plain versions): the closest hit through the part sort and K3
`_init` part after part, the shadow any hit through K4 per part, behind
the ray_key sorts. References: the same route on the scene without
parts (monolithic K3 and K4), and the JAX XLA trace_paths.

Bars: rays and shadow rays exact; good equal and L within 2e-5
(absolute + relative) on >= 99.9% of lanes, the rest being lanes where
an exact tie of t picks another triangle. Measured: counters identical;
L bit-equal with the scene without parts on every lane, within 4.8e-7
of JAX's.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.integrator.wavefront import trace_paths as j_trace
from craytracer_tpu.accel.bvh4 import BVH4Arrays as JBVH4
from craytracer_tpu.accel.bvh4_parts import partition_bvh4 as j_partition
from craytracer_tpu_torch.accel import bvh4_kernel as bk
from craytracer_tpu_torch.accel import bvh4_parts
from craytracer_tpu_torch.camera import Film, generate_rays, make_camera
from craytracer_tpu_torch.integrator import wavefront as wf
from craytracer_tpu_torch.interop import numpy_leaves, scene_from_numpy
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter
from craytracer_tpu_torch.scene.city import city_builder
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401

torch.set_num_threads(2)
pytestmark = SAH_WARNING_IS_ERROR
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIS = 5120
SIZE = 32
SEED = 11


def _jax_city():
    sys.path.insert(0, os.path.join(REPO, "scenes"))
    sys.path.insert(0, REPO)
    from bench_mesh import build_scene

    return build_scene(TRIS, accel="bvh4")[0]


@pytest.fixture(scope="module")
def city():
    whole = city_builder(TRIS).build(device="cpu")
    budget = whole.tri_bvh.fat.numel() * 4 // 5
    mp = pytest.MonkeyPatch()
    mp.setattr(bvh4_parts, "PART_BUDGET_BYTES", budget)
    try:
        cut = city_builder(TRIS).build(device="cpu")
    finally:
        mp.undo()
    cam = make_camera((4, 6, 6), (-3, 2, -3), device="cpu")
    film = Film(fov=torch.tensor(np.radians(50.0), dtype=torch.float32),
                width=SIZE, height=SIZE)
    n = SIZE * SIZE
    pix = torch.arange(n, dtype=torch.int32).repeat(2)
    spp = torch.arange(2, dtype=torch.int32).repeat_interleave(n)
    o, d = generate_rays(cam, film, pix, stratified_jitter(SEED, pix, spp))
    return _jax_city(), whole, cut, budget, o, d, pix, spp


def test_city_and_parts_equal_jax(city):
    js, whole, cut, budget, *_ = city
    assert whole.tri_parts is None and whole.accel == cut.accel == "bvh4"
    for f in ("v0", "v1", "v2", "mat_id"):
        np.testing.assert_array_equal(getattr(whole.triangles, f).numpy(),
                                      np.asarray(getattr(js.triangles, f)))
    np.testing.assert_array_equal(cut.tri_bvh.fat.numpy(),
                                  np.asarray(js.tri_bvh.fat))
    jparts = j_partition(JBVH4(fat=js.tri_bvh.fat, n_tris=js.tri_bvh.n_tris,
                               leaf_size=js.tri_bvh.leaf_size,
                               stack_size=js.tri_bvh.stack_size), budget)
    assert len(cut.tri_parts) == len(jparts) >= 3
    for p, q in zip(cut.tri_parts, jparts):
        np.testing.assert_array_equal(p.fat.numpy(), np.asarray(q.fat))
        assert p.stack_size == q.stack_size
        assert p.fat.numel() * 4 <= budget
    # the parts ride along through the interop and a device move
    carried = scene_from_numpy(numpy_leaves(cut), device="cpu")
    assert len(carried.tri_parts) == len(cut.tri_parts)
    for p, q in zip(carried.tri_parts, cut.to("cpu").tri_parts):
        assert torch.equal(p.fat, q.fat) and p.stack_size == q.stack_size


def _check(ours, ref):
    L, good, m = ours
    Lr, goodr, mr = np.asarray(ref[0]), np.asarray(ref[1]), ref[2]
    L, good = L.numpy(), good.numpy()
    assert (int(m["rays"]), int(m["shadow_rays"])) == (
        int(mr["rays"]), int(mr["shadow_rays"]))
    same = good == goodr
    close = np.all(np.abs(L - Lr) <= 2e-5 + 2e-5 * np.abs(Lr), axis=1)
    assert (same & close).mean() >= 0.999, (same.mean(), close.mean())


@pytest.mark.parametrize("ref", ["no_parts", "jax_xla"])
@pytest.mark.parametrize("depth", [0, 2, 5])
def test_parts_route_pass_matches(city, depth, ref):
    js, whole, cut, _, o, d, pix, spp = city
    before = (bk.CLOSEST.launches, bk.CLOSEST_INIT.launches)
    ours = wf._trace(cut, o, d, SEED, pix, spp, depth, kernels=True)
    assert (bk.CLOSEST.launches, bk.CLOSEST_INIT.launches) == before
    if ref == "no_parts":
        want = wf._trace(whole, o, d, SEED, pix, spp, depth, kernels=True)
    else:
        want = j_trace(js, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                       SEED, jnp.asarray(pix.numpy()),
                       jnp.asarray(spp.numpy()), depth, with_metrics=True,
                       fast_shade=False)
    _check(ours, want)
    assert int(ours[2]["rays"]) > SIZE * SIZE
    if depth:
        assert int(ours[2]["shadow_rays"]) > 100
