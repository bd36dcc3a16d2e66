"""The port's ray sharding (craytracer_tpu_torch/parallel/sharded.py)
against its one-process pass and the JAX package's
craytracer_tpu/parallel/sharded.py, and the counterpart of
tests/test_multiprocess.py.

The port's ranks are one world of 4 gloo processes on the CPU
(parallel/dryrun.py `launch`), started once for the module and running
every case; the JAX side runs here on tests/conftest.py's 8 virtual
devices while they work. Scenes, cameras and films are JAX's, carried
over through interop. Bars: the sharded image equals the port's
one-process render_sample bit for bit on every lane (per-lane RNG,
per-lane kernels), `good` and the counters too, and JAX's
sharded_render_pass within 2e-5; the train step's loss within rtol 1e-5
and its gradients within rtol 1e-4, atol 1e-6 of JAX's
sharded_train_step (tests/test_geom_sharded.py:100-107's bars).
"""

import concurrent.futures
import datetime
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from __graft_entry__ import _cornell
from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.parallel.sharded import (make_mesh as j_mesh,
                                             sharded_render_pass as j_pass,
                                             sharded_train_step as j_step)
from craytracer_tpu_torch.integrator.wavefront import render_sample
from craytracer_tpu_torch.interop import (camera_from_numpy, film_from_numpy,
                                          numpy_leaves, scene_from_numpy)
from craytracer_tpu_torch.parallel import dryrun
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401

pytestmark = SAH_WARNING_IS_ERROR
SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
WORLD, TIMEOUT = 4, 240.0
# (name, scene file, ranks, seed, spp, depth, compared with JAX)
RENDERS = [("cornell_2", "parity_cornell.txt", 2, 5, 3, 5, True),
           ("cornell_4", "parity_cornell.txt", 4, 5, 3, 5, True),
           ("mesh_4", "parity_mesh.txt", 4, 2, 1, 3, False)]
SIZE = 16


def _port(js, jc, jf):
    return (scene_from_numpy(numpy_leaves(js), device="cpu"),
            camera_from_numpy(numpy_leaves(jc), device="cpu"),
            film_from_numpy(numpy_leaves(jf), device="cpu"))


def _one_rank(cases):
    """run_case of each case in a world of one rank: this process."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'rdv')}",
            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
        try:
            return [dryrun.run_case(c, "cpu") for c in cases]
        finally:
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(jax_native):  # noqa: F811
    jrenders, cases = {}, []
    for name, path, n, seed, spp, depth, _ in RENDERS:
        js, jc, jf = j_load(os.path.join(SCENES, path))
        jf = jf.replace(width=SIZE, height=SIZE)
        jrenders[name] = (js, jc, jf)
        s, c, f = _port(js, jc, jf)
        cases.append(dict(kind="render", mesh=(n, 1), scene=s, camera=c,
                          film=f, depth=depth, seed=seed, spp=[spp]))
    js, jc, jf = _cornell(SIZE, SIZE)
    s, c, f = _port(js, jc, jf)
    train = dict(kind="train", step="sharded", scene=s, camera=c, film=f,
                 depth=2, seed=3, spp=0,
                 target=torch.zeros((SIZE * SIZE, 3)))
    cases += [dict(train, mesh=(4, 1)), dict(train, mesh=(2, 1))]
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(dryrun.launch, WORLD, cases, "gloo", "cpu", TIMEOUT)
        ids = jnp.arange(SIZE * SIZE, dtype=jnp.int32)
        jax_out = {}
        for name, _, n, seed, spp, depth, with_jax in RENDERS:
            if with_jax:
                js_, jc_, jf_ = jrenders[name]
                jax_out[name] = np.asarray(j_pass(j_mesh(n), depth)(
                    js_, jc_, jf_, ids, seed, spp))
        jax_out["train"] = j_step(j_mesh(4), 2)(
            js, jc, jf, ids, 3, 0, jnp.zeros((SIZE * SIZE, 3), jnp.float32))
        results, _ = fut.result()
    one = _one_rank([dict(train, mesh=(1, 1))])[0]
    unsharded = {}
    for (name, _, n, seed, spp, depth, _), case in zip(RENDERS, cases):
        with torch.no_grad():
            img, good, m = render_sample(
                case["scene"], case["camera"], case["film"],
                torch.arange(SIZE * SIZE, dtype=torch.int32), seed, spp,
                depth, with_metrics=True)
        unsharded[name] = (img, good, m["lane_rays"], m["lane_shadow_rays"])
    return {"results": results, "jax": jax_out, "unsharded": unsharded,
            "one": one}


def _ranks(world, i):
    return [r[i] for r in world["results"] if r[i] is not None]


@pytest.mark.parametrize("i", range(len(RENDERS)),
                         ids=[r[0] for r in RENDERS])
def test_sharded_pass_equals_one_process(world, i):
    """Every rank holds the whole image, bit-equal with the port's
    one-process pass, and so are good_paths and the lane counters."""
    name, _, n, *_rest, with_jax = RENDERS[i]
    img, good, rays, shadows = world["unsharded"][name]
    ranks = _ranks(world, i)
    assert len(ranks) == n
    for r in ranks:
        p = r["passes"][0]
        assert torch.equal(p["L"], img), f"rank {r['rank']}"
        assert torch.equal(p["good"], good)
        assert torch.equal(p["lane_rays"], rays)
        assert torch.equal(p["lane_shadow_rays"], shadows)
        assert float(p["L"].sum()) > 0.0
        if with_jax:
            np.testing.assert_allclose(p["L"].numpy(), world["jax"][name],
                                       rtol=2e-5, atol=2e-5)


def test_sharded_train_step_matches_jax(world):
    """The loss and every float leaf's gradient against JAX's
    sharded_train_step on a mesh of 4."""
    jloss, jgrads = world["jax"]["train"]
    ranks = _ranks(world, len(RENDERS))
    assert len(ranks) == 4
    checked = 0
    for r in ranks:
        p = r["passes"][0]
        np.testing.assert_allclose(p["loss"], float(jloss), rtol=1e-5)
        for name, g in p["grads"].items():
            group, field = name.split(".")
            ref = np.asarray(getattr(getattr(jgrads, group), field))
            np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4, atol=1e-6,
                                       err_msg=name)
            checked += int((ref != 0).any())
    assert checked >= 4 * 5


def test_two_processes_match_one_process(world):
    """tests/test_multiprocess.py's counterpart: the two rank processes of
    a 2-rank mesh return the same loss and gradients, bit for bit, and
    they agree with a world of one process within the JAX test's bars."""
    a, b = _ranks(world, len(RENDERS) + 1)
    pa, pb, p1 = a["passes"][0], b["passes"][0], world["one"]["passes"][0]
    assert pa["loss"] == pb["loss"]
    for name in pa["grads"]:
        assert torch.equal(pa["grads"][name], pb["grads"][name]), name
    np.testing.assert_allclose(pa["loss"], p1["loss"], rtol=1e-5)
    for name in pa["grads"]:
        np.testing.assert_allclose(pa["grads"][name].numpy(),
                                   p1["grads"][name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    color = float(pa["grads"]["materials.color"].abs().sum())
    np.testing.assert_allclose(
        color, float(p1["grads"]["materials.color"].abs().sum()), rtol=1e-4)
    assert color > 0.0


def test_uneven_ray_split_raises():
    """A pixel count that does not split into equal blocks raises, as
    shard_map refuses it."""
    from craytracer_tpu_torch.parallel.sharded import Axis, ray_block

    with pytest.raises(ValueError, match="equal"):
        ray_block(torch.arange(10), Axis(None, 0, 4))
    assert torch.equal(ray_block(torch.arange(12), Axis(None, 2, 4)),
                       torch.tensor([6, 7, 8]))
