"""The partitioned BVH4 (craytracer_tpu_torch/accel/bvh4_parts.py) and the
plain version of K3 `_init` (accel/bvh4.py `bvh4_closest_hit_init`)
against the JAX package: `partition_bvh4`, `parts_closest_hit`,
`parts_any_hit`, the part sort of `pallas_parts_closest_hit`, and
`pallas_parts_closest_hit`, `pallas_parts_any_hit` and
`pallas_bvh4_closest_hit_init` in interpret mode.

Inputs: the JAX tests' mesh of 16 icospheres and their 700 rays
(tests/test_bvh4_parts.py:13-38), the table built by the port and handed
to the JAX functions as a BVH4Arrays of the same fat rows, so that the
comparison does not depend on the JAX package's native build; cut at a
fifth of the table's bytes (tests/test_bvh4_parts.py:47), which gives 11
parts.

Bars: the part tables (rows, their order, the renumbered and cut child
ids) and stack sizes bit-equal with JAX's, every triangle in exactly one
part; the part-sort keys and permutation equal; closest hits: ids equal
on >= 99.9% of lanes and t within rtol 1e-5 where they agree (the bar of
tests/test_torch_bvh4.py: XLA's CPU backend contracts multiply-adds
into FMAs, the port rounds each operation); any-hit verdicts equal on
every lane. The port's plain min-combine (`parts_closest_hit`) and its
kernel route on CPU tensors (`parts_closest_hit_kernel`: the part sort,
then the plain K3 `_init` part after part) are both held.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.accel import bvh4 as jb
from craytracer_tpu.accel import bvh4_parts as jp
from craytracer_tpu.accel.pallas_bvh4 import pallas_bvh4_closest_hit_init
from craytracer_tpu.ops.raysort import ray_key as j_ray_key
from craytracer_tpu_torch.accel import bvh4_parts as tp
from craytracer_tpu_torch.accel.bvh4 import (FAT_TRI0, TRI_COLS, build_bvh4,
                                             bvh4_closest_hit,
                                             bvh4_closest_hit_init)
from craytracer_tpu_torch.constants import TMAX
from craytracer_tpu_torch.ops.raysort import ray_key
from craytracer_tpu_torch.scene.city import icosphere

torch.set_num_threads(2)


def _mesh():
    """tests/test_bvh4_parts.py:13-29's 16 icospheres, built by the port."""
    v, f = icosphere(2)
    rng = np.random.default_rng(3)
    corners = ([], [], [])
    for _ in range(16):
        c = rng.normal(0, 8, 3)
        w = v * (0.5 + rng.random()) + c
        for k in range(3):
            corners[k].append(w[f[:, k]])
    return build_bvh4(*(np.concatenate(x) for x in corners))


def _jax_bvh(b):
    return jb.BVH4Arrays(fat=jnp.asarray(b.fat.numpy()), n_tris=b.n_tris,
                         leaf_size=b.leaf_size, stack_size=b.stack_size)


@pytest.fixture(scope="module")
def cut():
    ours = _mesh()
    budget = ours.fat.numel() * 4 // 5
    jbvh = _jax_bvh(ours)
    return (ours, jbvh, tp.partition_bvh4(ours, budget),
            jp.partition_bvh4(jbvh, budget), budget)


@pytest.fixture(scope="module")
def rays():
    """tests/test_bvh4_parts.py:32-38: 700 rays aimed near the cluster,
    and max_dist for the any hit (U(0.5, 20), every ninth lane 0)."""
    rng = np.random.default_rng(4)
    o = rng.uniform(-12, 12, (700, 3)).astype(np.float32)
    d = rng.normal(0, 5, (700, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    md = np.random.default_rng(6).uniform(0.5, 20.0, 700).astype(np.float32)
    md[::9] = 0.0
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(md)


@pytest.fixture(scope="module")
def jax_refs(cut, rays):
    """The JAX results, each computed once (the XLA ones under jit):
    {(kind, ref): out} for kind "closest" / "any", ref "xla" / "pallas"."""
    jparts = cut[3]
    jo, jd, jmd = (jnp.asarray(x.numpy()) for x in rays)
    fns = {
        ("closest", "xla"): lambda: jax.jit(jp.parts_closest_hit)(
            jparts, jo, jd),
        ("closest", "pallas"): lambda: jp.pallas_parts_closest_hit(
            jparts, jo, jd, interpret=True),
        ("any", "xla"): lambda: jax.jit(jp.parts_any_hit)(
            jparts, jo, jd, jmd),
        ("any", "pallas"): lambda: jp.pallas_parts_any_hit(
            jparts, jo, jd, jmd, interpret=True)}
    cache = {}

    def get(kind, ref):
        if (kind, ref) not in cache:
            cache[kind, ref] = fns[kind, ref]()
        return cache[kind, ref]
    return get


def _tri_ids(fat):
    ids = np.asarray(fat)[:, FAT_TRI0 + TRI_COLS - 1:
                          FAT_TRI0 + 8 * TRI_COLS:TRI_COLS]
    return np.sort(ids[ids >= 0].astype(np.int64))


def test_partition_bit_equal_to_jax(cut):
    ours, _, parts, jparts, budget = cut
    assert len(parts) == len(jparts) > 2
    for k, (p, q) in enumerate(zip(parts, jparts)):
        np.testing.assert_array_equal(p.fat.numpy(), np.asarray(q.fat),
                                      err_msg=f"part {k}")
        assert (p.stack_size, p.n_tris, p.leaf_size) == (
            q.stack_size, q.n_tris, q.leaf_size)
        assert p.fat.numel() * 4 <= budget
    # every triangle in exactly one part
    np.testing.assert_array_equal(
        _tri_ids(ours.fat.numpy()),
        np.sort(np.concatenate([_tri_ids(p.fat.numpy()) for p in parts])))
    # a table under budget stays whole
    whole = tp.partition_bvh4(ours)
    assert len(whole) == 1 and whole[0] is ours


def _check_closest(t, tri, t_ref, tri_ref, min_hits=30):
    t_ref, tri_ref = np.asarray(t_ref), np.asarray(tri_ref)
    t, tri = t.numpy(), tri.numpy()
    same = tri == tri_ref
    assert same.mean() >= 0.999
    hit = same & (t_ref < TMAX)
    assert hit.sum() > min_hits
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5)


@pytest.mark.parametrize("route", ["plain", "kernel_route"])
@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_parts_closest_hit_matches_jax(cut, rays, jax_refs, ref, route):
    parts = cut[2]
    o, d, _ = rays
    fn = (tp.parts_closest_hit if route == "plain"
          else tp.parts_closest_hit_kernel)
    _check_closest(*fn(parts, o, d), *jax_refs("closest", ref))


@pytest.mark.parametrize("route", ["plain", "kernel_route"])
@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_parts_any_hit_verdicts_match_jax(cut, rays, jax_refs, ref, route):
    parts = cut[2]
    o, d, md = rays
    fn = tp.parts_any_hit if route == "plain" else tp.parts_any_hit_kernel
    t = fn(parts, o, d, md).numpy()
    md = md.numpy()
    occ, occ_ref = t < md, np.asarray(jax_refs("any", ref)) < md
    np.testing.assert_array_equal(occ, occ_ref)
    assert occ.sum() > 20 and (~occ).sum() > 20


def test_part_sort_matches_jax(cut, rays):
    """pallas_parts_closest_hit's grouping (bvh4_parts.py:223-233): the
    first part each ray enters, above ray_key >> 5, stably sorted. The top
    part's root row keeps the boxes of its cut children, so a ray that
    enters the scene's box enters the top part first (or ties with it,
    and argmin keeps the lower part): the first part is 0 for such rays,
    in both packages."""
    _, _, parts, jparts, _ = cut
    o, d, _ = rays
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    entries = jnp.stack([jp._part_entry(p, jo, jd) for p in jparts], axis=0)
    first = jnp.argmin(entries, axis=0).astype(jnp.uint32)
    jkey = (first << jnp.uint32(27)) | (j_ray_key(jo, jd) >> jnp.uint32(5))
    ours = torch.stack([tp._part_entry(p, o, d) for p in parts])
    np.testing.assert_allclose(ours.numpy(), np.asarray(entries), rtol=1e-6)
    key, perm = tp.part_sort(parts, o, d)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jnp.argsort(jkey)))
    entered = np.asarray(entries).min(axis=0) < TMAX
    assert entered.sum() > 100 and (np.asarray(first)[entered] == 0).all()
    assert len(np.unique(key.numpy())) > 20


def test_part_sort_is_the_identity_in_route_order(cut, rays):
    """The kernel route hands the part sort rays already in ray_key order
    (raysort.sorted_traversal), and each ray's first part is the top part
    (test_part_sort_matches_jax), so the keys are already in order and
    the stable argsort leaves every ray in place."""
    _, _, parts, _, _ = cut
    o, d, _ = rays
    order = torch.argsort(ray_key(o, d), stable=True)
    key, perm = tp.part_sort(parts, o[order], d[order])
    assert bool((key[1:] >= key[:-1]).all())
    assert torch.equal(perm, torch.arange(o.shape[0]))


@pytest.mark.parametrize("table", ["monolithic", "parts"])
def test_closest_hit_init_matches_jax(cut, rays, table):
    """bvh4_closest_hit_init against pallas_bvh4_closest_hit_init with
    half the lanes carrying a hit at half their closest t under id 7777
    (tests/test_pallas_kernel.py:167-175): on the whole table, and on
    every part with the best hit of the parts before it carried."""
    ours, jbvh, parts, jparts, _ = cut
    o, d, _ = rays
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    n = o.shape[0]
    t_ref, _ = bvh4_closest_hit(ours, o, d)
    even = torch.arange(n) % 2 == 0
    t = torch.where(even & (t_ref < TMAX), t_ref * 0.5,
                    torch.full_like(t_ref, TMAX))
    tri = torch.where(t < TMAX, 7777, -1).to(torch.int32)
    tables = ([(ours, jbvh)] if table == "monolithic"
              else list(zip(parts, jparts)))
    kept = 0
    for p, q in tables:
        jt, jtri = pallas_bvh4_closest_hit_init(
            q, jo, jd, jnp.asarray(t.numpy()), jnp.asarray(tri.numpy()),
            interpret=True)
        t, tri = bvh4_closest_hit_init(p, o, d, t, tri)
        _check_closest(t, tri, jt, jtri, min_hits=15)
        kept = int((tri == 7777).sum())
    assert 0 < kept < n // 2
