"""The port's per-bounce gradient buckets (craytracer_tpu_torch/parallel/
overlap.py) against its single all-reduce step and the JAX package's
bucketed_train_step (tests/test_overlap.py's scene, film, depth, seed and
bars), and the counterpart of tests/test_pallas_shard.py.

The port's ranks are one world of 4 gloo processes on the CPU
(parallel/dryrun.py `launch`), started once for the module; JAX's
bucketed step runs here on a mesh of 4 of tests/conftest.py's virtual
devices while they work. The two port steps meet at test_overlap.py's
depth 3; JAX's bucketed step is held at depth 2, whose unrolled program
XLA compiles in about half the time of depth 3's, on the same code for
every bounce.
"""

import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.camera import Film as JFilm, make_camera as j_camera
from craytracer_tpu.parallel.overlap import bucketed_train_step as j_bucketed
from craytracer_tpu.parallel.sharded import make_mesh as j_mesh
from craytracer_tpu_torch.accel import bvh4_kernel, bvh4_parts
from craytracer_tpu_torch.accel.bvh4 import build_bvh4, bvh4_closest_hit
from craytracer_tpu_torch.interop import (camera_from_numpy, film_from_numpy,
                                          numpy_leaves, scene_from_numpy)
from craytracer_tpu_torch.parallel import dryrun
from craytracer_tpu_torch.scene.city import icosphere
from test_overlap import _tiny_scene

WORLD, TIMEOUT, DEPTH, JAX_DEPTH, SEED = 4, 240.0, 3, 2, 7


@pytest.fixture(scope="module")
def world():
    js = _tiny_scene()
    jc = j_camera((0, 2.0, 6.0), (0, 1.0, 0))
    jf = JFilm(fov=jnp.float32(np.radians(45.0)), width=16, height=16)
    n = jf.width * jf.height
    case = dict(kind="train", mesh=(WORLD, 1),
                scene=scene_from_numpy(numpy_leaves(js), device="cpu"),
                camera=camera_from_numpy(numpy_leaves(jc), device="cpu"),
                film=film_from_numpy(numpy_leaves(jf), device="cpu"),
                depth=DEPTH,
                seed=SEED, spp=0, target=torch.zeros((n, 3)))
    cases = [dict(case, step="bucketed"), dict(case, step="sharded"),
             dict(case, step="bucketed", depth=JAX_DEPTH)]
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(dryrun.launch, WORLD, cases, "gloo", "cpu", TIMEOUT)
        jloss, jgrads = j_bucketed(j_mesh(WORLD), JAX_DEPTH)(
            js, jc, jf, jnp.arange(n, dtype=jnp.int32), SEED, 0,
            jnp.zeros((n, 3), jnp.float32))
        results, _ = fut.result()
    return {"results": results, "jax": (float(jloss), jgrads)}


def test_bucketed_matches_single_all_reduce(world):
    """Every rank's bucketed loss and gradients against its single
    all-reduce step's (the JAX test's bars: loss rtol 1e-6, gradients
    rtol 1e-4, atol 1e-6), more than 5 leaves with a gradient, not all
    zero, and the same on every rank."""
    first = world["results"][0][0]["passes"][0]
    for r in world["results"]:
        pb, ps = r[0]["passes"][0], r[1]["passes"][0]
        np.testing.assert_allclose(pb["loss"], ps["loss"], rtol=1e-6)
        assert pb["grads"].keys() == ps["grads"].keys()
        checked = 0
        for name, g in pb["grads"].items():
            np.testing.assert_allclose(g.numpy(), ps["grads"][name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
            assert torch.equal(g, first["grads"][name])
            checked += 1
        assert checked > 5
        assert sum(float(g.abs().sum()) for g in pb["grads"].values()) > 0.0


def test_bucketed_matches_jax(world):
    """The bucketed step against JAX's bucketed_train_step on a mesh of the
    same size, at depth 2: loss rtol 1e-6, every float leaf's gradient
    rtol 1e-4, atol 1e-6."""
    jloss, jgrads = world["jax"]
    p = world["results"][0][2]["passes"][0]
    np.testing.assert_allclose(p["loss"], jloss, rtol=1e-6)
    nonzero = 0
    for name, g in p["grads"].items():
        group, field = name.split(".")
        ref = np.asarray(getattr(getattr(jgrads, group), field))
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
        nonzero += int((ref != 0).any())
    assert nonzero > 5


def _mesh_rays(n):
    """tests/test_pallas_shard.py's rays: an icosphere(2) scaled by 3,
    seeded directions from one eye."""
    v, f = icosphere(2)
    bvh = build_bvh4(v[f[:, 0]] * 3, v[f[:, 1]] * 3, v[f[:, 2]] * 3)
    rng = np.random.default_rng(3)
    o = torch.from_numpy(np.tile([[0.0, 0.5, 8.0]], (n, 1)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] -= 1.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return bvh, o, torch.from_numpy(d)


@pytest.mark.parametrize("variant", ["whole", "parts"])
def test_traversal_per_ray_shard(variant):
    """The rays split into 8 contiguous shards, each through the closest
    hit's wrapper (its plain version on the CPU; K3, and K3 `_init` per
    part, on the card): equal to the unsharded plain traversal, t and ids
    on every lane."""
    shards = 8
    bvh, o, d = _mesh_rays(128 * shards)
    if variant == "parts":
        parts = bvh4_parts.partition_bvh4(bvh, bvh.fat.numel())
        assert len(parts) > 1

        def closest(oo, dd):
            return bvh4_parts.parts_closest_hit_kernel(parts, oo, dd)
    else:
        def closest(oo, dd):
            return bvh4_kernel.bvh4_closest_hit_kernel(bvh, oo, dd)

    got = [closest(oo, dd) for oo, dd in zip(o.chunk(shards), d.chunk(shards))]
    t_ref, i_ref = bvh4_closest_hit(bvh, o, d)
    assert torch.equal(torch.cat([g[0] for g in got]), t_ref)
    assert torch.equal(torch.cat([g[1] for g in got]), i_ref)
    assert int((t_ref < 1e8).sum()) > 50
