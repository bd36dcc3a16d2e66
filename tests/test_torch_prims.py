"""Planes, disks and instanced shapes in the port (core/solvers.py,
core/aabb.py, scene/build.py, io/scenefile.py, ops/intersect.py) against
the JAX package on the same seeded inputs.

- `solve_quartic` and `cubic_one_root` on seeded quartics with four,
  two and no real roots; `ray_aabb` on seeded boxes.
- Every Scene leaf of scenes/parity_prims.txt (torus, box, disk, rects;
  the instanced tables, the env radius, the lights) and of the test
  scenes of torch_prim_scenes.py equal in dtype, shape and bits.
- Each new group's Hit fields against JAX `intersect_scene`, and
  `shadow_distance`, on seeded rays aimed at every_instance's shapes:
  plane, disk, a rotated and scaled box, open cylinders (each normal
  rule), a solid cylinder's caps, a clipped torus.

Bars, from measurements at these seeds: planes, disks, boxes and caps
keep group, prim and mat_id exact and t, point, normal, dpdu, uv within
1e-5 (the box and cap affines differ from XLA's einsum by FMA rounding:
max |dt| 4.8e-6); the open cylinder's normal, from the refined point,
within 1e-4 (measured 2.7e-5). A lane where two shapes' t lie within
that rounding may change winner: for every group the closest hit (group
and prim) must be equal on >= 99.9% of all lanes (measured: 1 lane of
12,000 off the plane, 1 off the torus). The f32 torus quartic is
ill-conditioned near grazing rays, so for the torus the bar is t within
rtol 1e-4 on >= 99% of the lanes where both hit it and within 1e-2 on
all (measured 99.18% within 1e-4, max 2.8e-4; on 20,000 other rays at a
canonical torus both packages err alike against float64 roots, median
1.2e-5, max 3.9e-2)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.core.aabb import ray_aabb as j_ray_aabb
from craytracer_tpu.core.solvers import cubic_one_root as j_cubic
from craytracer_tpu.core.solvers import solve_quartic as j_quartic
from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.ops.intersect import intersect_scene as j_intersect
from craytracer_tpu.ops.intersect import shadow_distance as j_shadow
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.core.aabb import ray_aabb
from craytracer_tpu_torch.core.solvers import cubic_one_root, solve_quartic
from craytracer_tpu_torch.integrator.gate import production_fast_shade
from craytracer_tpu_torch.interop import numpy_leaves
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.ops.intersect import intersect_scene, shadow_distance
from craytracer_tpu_torch.scene import types as T
from craytracer_tpu_torch.scene.build import SceneBuilder

import torch_prim_scenes as prim_scenes
from test_torch_scene import GROUPS, REPO, _assert_tree_equal

torch.set_num_threads(2)
PRIMS = f"{REPO}/scenes/parity_prims.txt"


def _quartics(seed, n=6000):
    """Monic quartic coefficients (b, c, d, e) from seeded roots: four
    real roots, two real and a complex pair, and two complex pairs."""
    r = np.random.default_rng(seed)
    roots = r.uniform(-3.0, 3.0, (n, 4))
    p = np.stack([np.poly(x) for x in roots])
    m = n // 3
    for k, rows in ((1, slice(m, 2 * m)), (2, slice(2 * m, n))):
        re, im = r.uniform(-2, 2, (n, 2)), r.uniform(0.2, 2, (n, 2))
        for i in np.arange(n)[rows]:
            z = list(roots[i, :4 - 2 * k])
            for j in range(k):
                z += [re[i, j] + 1j * im[i, j], re[i, j] - 1j * im[i, j]]
            p[i] = np.real(np.poly(z))
    return p[:, 1:].astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_quartic_matches_jax(seed):
    """Valid masks equal on >= 99.9% of lanes; valid roots within 1e-4
    relative (+ 1e-4 absolute) on >= 99.9% of them (measured: masks
    equal everywhere, roots to ~3e-6 but a few double-root lanes)."""
    co = _quartics(seed)
    j_roots, j_valid = j_quartic(*(jnp.asarray(co[:, i]) for i in range(4)))
    roots, valid = solve_quartic(*(torch.from_numpy(co[:, i])
                                   for i in range(4)))
    j_roots, j_valid = np.asarray(j_roots), np.asarray(j_valid)
    assert (valid.numpy() == j_valid).mean() >= 0.999
    both = valid.numpy() & j_valid
    err = np.abs(roots.numpy() - j_roots)[both]
    assert (err <= 1e-4 + 1e-4 * np.abs(j_roots[both])).mean() >= 0.999
    assert j_valid.any(axis=1).mean() > 0.5 and not j_valid.all()
    cu = np.random.default_rng(seed).normal(size=(4, 4096)).astype(np.float32)
    cu[0] = np.where(np.abs(cu[0]) < 0.1, 1.0, cu[0])
    j_c = np.asarray(j_cubic(*map(jnp.asarray, cu)))
    t_c = cubic_one_root(*map(torch.from_numpy, cu)).numpy()
    assert (np.abs(t_c - j_c) <= 1e-4 + 1e-4 * np.abs(j_c)).mean() >= 0.999


def test_ray_aabb_matches_jax():
    r = np.random.default_rng(3)
    o, d = (r.normal(size=(4096, 3)).astype(np.float32) for _ in range(2))
    lo = r.uniform(-1, 0, (4096, 3)).astype(np.float32)
    hi = lo + r.uniform(0.1, 1, (4096, 3)).astype(np.float32)
    inv = (1.0 / d).astype(np.float32)
    ref = j_ray_aabb(*map(jnp.asarray, (o, inv, lo, hi)))
    got = ray_aabb(*map(torch.from_numpy, (o, inv, lo, hi)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def prims():
    return j_load(PRIMS), load_scene_file(PRIMS, device="cpu")


@pytest.mark.parametrize("group", GROUPS)
def test_parity_prims_leaves_equal(prims, group):
    (js, _, _), (ts, _, _) = prims
    _assert_tree_equal(numpy_leaves(getattr(ts, group)),
                       numpy_leaves(getattr(js, group)), group)


def test_parity_prims_statics_and_route(prims):
    """The torus sends parity_prims to the "shade" route, as in the JAX
    gate; its Scene statics equal the JAX ones."""
    (js, jc, jf), (ts, tc, tf) = prims
    for name in ("accel", "mat_types_present", "light_types_present",
                 "matte_lambertian"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.instanced.kind.tolist() == [T.INST_TORUS, T.INST_AABOX]
    assert not ts.instanced_aabox_only
    assert production_fast_shade(ts, tc, tf) == "shade"
    _assert_tree_equal(numpy_leaves(tc), numpy_leaves(jc))


def _built(fn):
    jb, tb = JBuilder(), SceneBuilder()
    fn(jb)
    fn(tb)
    return jb.build(), tb.build(device="cpu")


@pytest.mark.parametrize("name", ["plane_disk", "aabox", "every_instance"])
def test_builder_scenes_equal(name):
    """Builder calls (planes, disks, boxes, cylinders, tori, with their
    affines and the instanced scene bounds) give the same Scene."""
    fn = getattr(prim_scenes, name)
    js, ts = _built(fn)
    for group in GROUPS:
        _assert_tree_equal(numpy_leaves(getattr(ts, group)),
                           numpy_leaves(getattr(js, group)), group)
    assert ts.instanced_aabox_only == (name != "every_instance")


@pytest.fixture(scope="module")
def instanced_hits():
    """every_instance through both packages' intersect_scene and
    shadow_distance on 12,000 seeded rays from a sphere of radius 7,
    aimed at points scattered around its shapes."""
    js, ts = _built(prim_scenes.every_instance)
    r = np.random.default_rng(7)
    n = 12_000
    o = r.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 7.0 + [0, 0.5, 0]
    aims = np.array([[-1.8, 0.2, 0.3], [-0.6, 1.6, -0.8], [0.6, 1.6, -0.8],
                     [1.8, 1.6, -0.8], [0.4, -0.4, 0.6], [1.6, -0.5, 0.8],
                     [2.2, 0.4, -1.0], [0.0, -1.5, 0.0]])
    d = aims[r.integers(0, len(aims), n)] + r.normal(size=(n, 3)) * 0.6 - o
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    j_hit = {k: np.asarray(v) for k, v in vars(j_intersect(js, jo, jd)).items()}
    t_hit = {k: v.numpy() for k, v in vars(intersect_scene(ts, to, td)).items()}
    return (js, j_hit, t_hit, np.asarray(j_shadow(js, jo, jd)),
            shadow_distance(ts, to, td).numpy())


# (group, instanced kind or None) -> the lanes JAX says hit it
KINDS = {"plane": (T.GROUP_PLANE, None), "disk": (T.GROUP_DISK, None),
         "box": (T.GROUP_INSTANCED, T.INST_AABOX),
         "open_cylinder": (T.GROUP_INSTANCED, T.INST_OPEN_CYLINDER),
         "cylinder_caps": (T.GROUP_INSTANCED, T.INST_DISK),
         "torus": (T.GROUP_INSTANCED, T.INST_TORUS)}


@pytest.mark.parametrize("name", sorted(KINDS))
def test_group_hits_match_jax(instanced_hits, name):
    js, jh, th, _, _ = instanced_hits
    group, kind = KINDS[name]
    inst_kind = np.asarray(js.instanced.kind)
    sel = jh["group"] == group
    if kind is not None:
        sel &= inst_kind[np.clip(jh["prim"], 0, len(inst_kind) - 1)] == kind
    assert sel.sum() >= 100, "the rays must reach the shape"
    same = sel & (th["group"] == jh["group"]) & (th["prim"] == jh["prim"])
    assert (sel & ~same).sum() <= 1e-3 * sel.shape[0]
    if name == "torus":
        rel = np.abs(th["t"] - jh["t"])[same] / jh["t"][same]
        assert (rel <= 1e-4).mean() >= 0.99 and rel.max() <= 1e-2
        return
    tol = 1e-4 if name == "open_cylinder" else 1e-5
    np.testing.assert_array_equal(th["mat_id"][same], jh["mat_id"][same])
    for key in ("t", "point", "normal", "dpdu", "uv"):
        np.testing.assert_allclose(th[key][same], jh[key][same], rtol=tol,
                                   atol=tol, err_msg=key)


def test_shadow_distance_matches_jax(instanced_hits):
    """The minimum over every group: hit masks equal on >= 99.9% of lanes,
    t within 1e-5 on >= 97% and within 1e-3 on >= 99.5% of the lanes
    where both hit (the torus and cylinder search t is not refined by the
    fill's Newton step; measured 98.26% and 99.85%)."""
    _, _, _, j_t, t_t = instanced_hits
    assert ((t_t < 3e38) == (j_t < 3e38)).mean() >= 0.999
    both = (t_t < 3e38) & (j_t < 3e38)
    rel = np.abs(t_t - j_t)[both] / j_t[both]
    assert (rel <= 1e-5).mean() >= 0.97 and both.mean() > 0.8
    assert (rel <= 1e-3).mean() >= 0.995
