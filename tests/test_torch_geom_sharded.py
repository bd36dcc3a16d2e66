"""The port's geometry sharding (craytracer_tpu_torch/parallel/geom.py)
against the JAX package's (craytracer_tpu/parallel/geom.py): the cases of
tests/test_geom_sharded.py, on its scene, 16x16 film, depth 3 and seeds.

The port's ranks are one world of 4 gloo processes on the CPU
(parallel/dryrun.py `launch`), started once for the module and running
every case; the JAX side runs here on tests/conftest.py's 8 virtual
devices, on the same mesh shapes, while the ranks work. Scene, camera and
film are JAX's, carried over through interop, so both packages compute
on identical data. Every bar is the JAX test's: images within rtol 1e-5,
atol 1e-5 of JAX's sharded pass and of the port's unsharded pass, where
`good` and the ray and shadow-ray counters also agree on every lane; the
train step's loss within rtol 1e-5, its gradients within rtol 1e-4, atol
1e-6.

One case cuts shards into parts: scenes/parity_mesh_mid.txt (20,480
triangles) over 2 geometry shards with the port's part budget set in the
ranks (the case's "part_budget", never the JAX package's) to two fifths
of a shard's bvh4 table, so each shard's table is cut into parts, and the
ranks trace with the kernels' wrappers (on CPU tensors their plain
versions: the part sort and the per-part walks with the carried hit).
Its image is held to JAX's geometry-sharded pass on the same (1, 2) mesh,
and each shard's own hit ids and t on the camera rays are bit-equal with
its uncut table's.
"""

import concurrent.futures
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.camera import Film as JFilm, make_camera as j_camera
from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.parallel.geom import (
    geom_sharded_render_pass as j_pass, geom_sharded_train_step as j_step,
    make_geom_mesh as j_mesh, shard_scene_geometry as j_shard)
from craytracer_tpu.scene import SceneBuilder as JSceneBuilder
from craytracer_tpu_torch.integrator.wavefront import render_sample
from craytracer_tpu_torch.interop import (camera_from_numpy, film_from_numpy,
                                          numpy_leaves, scene_from_numpy)
from craytracer_tpu_torch.parallel import dryrun
from craytracer_tpu_torch.parallel.geom import shard_scene_geometry
from craytracer_tpu_torch.scene.build import SceneBuilder
from test_geom_sharded import _mesh_scene
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401

pytestmark = SAH_WARNING_IS_ERROR
WORLD, TIMEOUT = 4, 240.0
# (name, mesh, accel, seed, depth, extra case keys)
RENDERS = [("bvh4", (2, 2), "bvh4", 5, 3, {}),
           ("bvh", (2, 2), "bvh", 5, 3, {}),
           ("uneven", (1, 3), "bvh4", 9, 3, {}),
           ("shade_compact", (1, 2), "bvh4", 5, 3, {"compact_at": 2}),
           ("general_compact", (1, 2), "bvh4", 5, 3,
            {"compact_at": 2, "fast_shade": False}),
           ("general", (2, 2), "bvh4", 5, 3, {"fast_shade": False}),
           ("mesh_mid_parts", (1, 2), "mesh_mid", 5, 3,
            {"kernels": True, "first_hit": True})]
JAX_RENDERS = ("bvh4", "uneven", "mesh_mid_parts")
MESH_MID = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes", "parity_mesh_mid.txt")


def _port(js, jc, jf):
    return (scene_from_numpy(numpy_leaves(js), device="cpu"),
            camera_from_numpy(numpy_leaves(jc), device="cpu"),
            film_from_numpy(numpy_leaves(jf), device="cpu"))


@pytest.fixture(scope="module")
def world(jax_native):  # noqa: F811
    """Every case through the port's ranks, JAX's counterparts meanwhile,
    and the port's unsharded passes."""
    jc = j_camera((0, 6, 14), (0, 1, 0))
    jf = JFilm(fov=jnp.float32(np.radians(45.0)), width=16, height=16)
    jscenes = {a: _mesh_scene(a) for a in ("bvh4", "bvh")}
    cams = dict.fromkeys(jscenes, jc)
    jscenes["mesh_mid"], cams["mesh_mid"], _ = j_load(MESH_MID)
    ports = {a: _port(js, cams[a], jf) for a, js in jscenes.items()}
    # two fifths of a shard's uncut table: each shard cut into parts
    shard0, _ = shard_scene_geometry(ports["mesh_mid"][0], 2, 0)
    budget = shard0.tri_bvh.fat.numel() * 4 * 2 // 5
    n = jf.width * jf.height
    cases = []
    for name, mesh, accel, seed, depth, extra in RENDERS:
        s, c, f = ports[accel]
        if accel == "mesh_mid":
            accel, extra = "bvh4", dict(extra, part_budget=budget)
        cases.append(dict(kind="render", mesh=mesh, accel=accel, scene=s,
                          camera=c, film=f, depth=depth, seed=seed, spp=[0],
                          **extra))
    s, c, f = ports["bvh4"]
    cases.append(dict(kind="train", mesh=(2, 2), scene=s, camera=c, film=f,
                      depth=2, seed=5, spp=0, target=torch.zeros((n, 3))))

    def unsharded():
        out = {}
        for name, mesh, accel, seed, depth, extra in RENDERS:
            s, c, f = ports[accel]
            with torch.no_grad():
                img, good, m = render_sample(
                    s, c, f, torch.arange(n, dtype=torch.int32), seed, 0,
                    depth, general=not extra.get("fast_shade", True),
                    with_metrics=True)
            out[name] = (img, good, m["lane_rays"], m["lane_shadow_rays"])
        return out

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        fut = ex.submit(dryrun.launch, WORLD, cases, "gloo", "cpu", TIMEOUT)
        fut_one = ex.submit(unsharded)
        ids = jnp.arange(n, dtype=jnp.int32)
        jax_out = {}
        for name, mesh, accel, seed, depth, _ in RENDERS:
            if name in JAX_RENDERS:
                stk, bases = j_shard(jscenes[accel], mesh[1],
                                     accel=accel.replace("mesh_mid", "bvh4"))
                jax_out[name] = np.asarray(j_pass(j_mesh(*mesh), depth)(
                    stk, bases, cams[accel], jf, ids, jnp.int32(seed),
                    jnp.int32(0)))
        stk, bases = j_shard(jscenes["bvh4"], 2, accel="bvh4")
        jax_out["train"] = j_step(j_mesh(2, 2), 2)(
            stk, bases, jc, jf, ids, jnp.int32(5), jnp.int32(0),
            jnp.zeros((n, 3)))
        results, _ = fut.result()
        one = fut_one.result()
    return {"cases": cases, "results": results, "jax": jax_out,
            "unsharded": one, "jscenes": jscenes}


def _ranks(world, i):
    return [r[i] for r in world["results"] if r[i] is not None]


@pytest.mark.parametrize("i", range(len(RENDERS)),
                         ids=[r[0] for r in RENDERS])
def test_sharded_image_matches_unsharded(world, i):
    """Every rank's image of a sharded pass against the port's unsharded
    pass (and `good`, the ray and shadow-ray counts on every lane) and,
    for the (2, 2) bvh4 mesh and the uneven (1, 3) split, JAX's sharded
    pass on the same mesh shape (the bvh shards' tables are held to JAX's
    in test_shard_tables_match_jax)."""
    name = RENDERS[i][0]
    img, good, rays, shadows = world["unsharded"][name]
    ranks = _ranks(world, i)
    assert len(ranks) == np.prod(RENDERS[i][1])
    for r in ranks:
        p = r["passes"][0]
        np.testing.assert_allclose(p["L"].numpy(), img.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {r['rank']}")
        assert torch.equal(p["good"], good)
        assert torch.equal(p["lane_rays"], rays)
        assert torch.equal(p["lane_shadow_rays"], shadows)
        assert not torch.isnan(p["L"]).any()
        if name in JAX_RENDERS:
            np.testing.assert_allclose(p["L"].numpy(), world["jax"][name],
                                       rtol=1e-5, atol=1e-5)


def test_shards_take_one_route_and_count(world):
    """The padded shards have one triangle count; the tri_base of each is
    its block's first row."""
    for i, (name, mesh, *_rest) in enumerate(RENDERS):
        n = world["cases"][i]["scene"].triangles.mat_id.shape[0]
        blocks = np.array_split(np.arange(n), mesh[1])
        for r in _ranks(world, i):
            assert r["n_tris"] == max(b.size for b in blocks)
            assert r["tri_base"] == blocks[r["rank"] % mesh[1]][0]


def test_sharded_train_step_matches_jax(world):
    """Loss and every float leaf's gradient of every rank's shard against
    JAX's geom_sharded_train_step on the same (2, 2) mesh, shard for
    shard. JAX's convention gives each geometry rank its own gradient (the
    winner's fill takes G times the cotangent: a triangle row G times the
    unsharded gradient, a replicated leaf that reaches a fill, such as a
    rough material's alpha through the next bounce's ray, a different one
    on each rank), and the port's matches it; the mean over the geom axis
    is the unsharded gradient."""
    jloss, jgrads = world["jax"]["train"]
    ranks = _ranks(world, len(RENDERS))
    assert len(ranks) == 4
    checked = 0
    for r in ranks:
        p, g = r["passes"][0], r["rank"] % 2
        np.testing.assert_allclose(p["loss"], float(jloss), rtol=1e-5)
        for name, got in p["grads"].items():
            group, field = name.split(".")
            ref = np.asarray(getattr(getattr(jgrads, group), field))[g]
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                       atol=1e-6,
                                       err_msg=f"{name} rank {r['rank']}")
            checked += int((ref != 0).any())
    assert checked >= 4 * 8


@pytest.mark.parametrize("accel", ["bvh4", "bvh"])
def test_shard_tables_match_jax(world, accel):
    """Each shard's triangle rows, tri_base and triangle count equal JAX's
    stacked leaf k. Its table is bit-equal with JAX's build of those rows:
    for bvh, JAX's stacked leaf k over its own rows; for bvh4, JAX's
    build_bvh4 at the port's production settings (leaves of 2, SAH split,
    the table K3 and K4 walk), where JAX's geometry shards take
    build_bvh4's own defaults (leaves of 4, median split: ROADMAP's
    documented deviations)."""
    from craytracer_tpu.accel.bvh4 import build_bvh4 as j_build_bvh4

    js = world["jscenes"][accel]
    stk, bases = j_shard(js, 4, accel=accel)
    scene = scene_from_numpy(numpy_leaves(js), device="cpu")
    for k in range(4):
        shard, base = shard_scene_geometry(scene, 4, k, accel=accel)
        assert base == int(bases[k])
        assert shard.tri_bvh.n_tris == int(stk.tri_bvh.n_tris)
        for name in ("v0", "v1", "v2", "n0", "uv0", "mat_id"):
            np.testing.assert_array_equal(
                getattr(shard.triangles, name).numpy(),
                np.asarray(getattr(stk.triangles, name))[k])
        fat = shard.tri_bvh.fat.numpy()
        if accel == "bvh":
            ref = np.asarray(stk.tri_bvh.fat)[k]
            assert not ref[len(fat):].any()
            ref = ref[:len(fat)]
        else:
            v = [np.asarray(getattr(stk.triangles, n))[k]
                 for n in ("v0", "v1", "v2")]
            ref = np.asarray(j_build_bvh4(*v, leaf_size=2, split="sah").fat)
        np.testing.assert_array_equal(fat, ref)


def test_mesh_lights_rejected():
    """tests/test_geom_sharded.py's mesh-light scene, built by the port."""
    for build in (SceneBuilder, JSceneBuilder):
        b = build()
        b.add_matte("w", (0.5, 0.5, 0.5))
        b.add_emissive("l", (1, 1, 1), 5.0)
        b.add_triangles_array(np.array([[0, 0, 0]]), np.array([[1, 0, 0]]),
                              np.array([[0, 1, 0]]), "l")
        for i in range(8):
            b.add_triangle((i, 0, 0), (i + 1, 0, 0), (i, 1, 0), "w")
        if build is SceneBuilder:
            scene = b.build(accel="bvh4", light_power="principled",
                            device="cpu")
        else:
            scene = scene_from_numpy(numpy_leaves(b.build(
                accel="bvh4", light_power="principled")), device="cpu")
        with pytest.raises(ValueError, match="mesh lights"):
            shard_scene_geometry(scene, 2, 0)


def test_part_cut_shards_walk_their_parts(world):
    """The mesh_mid_parts case: each shard's bvh4 table is cut into at
    least 2 parts under the budget set in the ranks, the shard's own
    closest-hit t and triangle ids of the camera rays through its parts
    are bit-equal with its uncut table's, and the reduced bounce-0 hits
    are the unsharded search's."""
    from craytracer_tpu_torch.integrator.wavefront import (_closest_hit,
                                                           camera_rays,
                                                           film_jitter)

    i = [r[0] for r in RENDERS].index("mesh_mid_parts")
    ranks = _ranks(world, i)
    assert len(ranks) == 2
    for r in ranks:
        assert r["parts"] >= 2, r["parts"]
        (t_cut, id_cut), (t_whole, id_whole) = r["shard_hit"]
        assert torch.equal(id_cut, id_whole), f"rank {r['rank']}"
        assert torch.equal(t_cut, t_whole), f"rank {r['rank']}"
        assert (t_cut < 1e30).any()
    case = world["cases"][i]
    ids = torch.arange(case["film"].num_pixels, dtype=torch.int32)
    o, d = camera_rays(case["camera"], case["film"], ids, case["seed"], 0,
                       film_jitter(case["seed"], ids, 0))
    with torch.no_grad():
        hit = _closest_hit(case["scene"], o, d, False, None, 0)
    for r in ranks:
        assert torch.equal(r["first_hit"],
                           torch.stack([hit.group, hit.prim], dim=1))
