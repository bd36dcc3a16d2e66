"""The port's mesh pass against the JAX package, and its golden.

`trace_paths` on scenes/parity_mesh.txt (320 triangles, bvh4) at 24x24
with per-lane spp (2 spp -> 1,152 lanes), depth 0, 2 and 5, the same
camera rays on both sides: the port's plain route (fast_shade=None) and
its kernel route on the CPU (fast_shade="shade": the wrappers take their
plain versions, behind the ray_key sorts) against the JAX XLA
trace_paths (fast_shade=False) and against its "shade" route with the
Pallas traversal, any-hit and shade kernels in interpret mode
(CRAYTRACER_PALLAS_TRAVERSAL=1, CRAYTRACER_PALLAS_ANYHIT=1,
CRAYTRACER_PALLAS_INTERPRET=1). The bars of tests/test_torch_pass.py:
at depth 0 good, rays and shadow_rays exact and L within 2e-5; at depth
2 and 5 >= 99.9% of lanes with equal good and L within 1e-4 (absolute +
relative), counters within 0.1%. Measured (seed 7): every lane equal at
every depth against both JAX routes, max |dL| 1.2e-6, counters identical
(1,152 / 2,174 / 2,290 rays, 0 / 686 / 788 shadow rays at depth
0 / 2 / 5); the port's two routes agree bit for bit.

The golden check renders parity_mesh through the port's CPU Renderer at
128x128 x 64 spp (spp_batch 16: four passes of 262,144 lanes through the
plain versions) and compares it with tests/goldens/golden_mesh.is by
tone-mapped 8x8 block means with the thresholds of
tests/test_reference_parity.py: about 40 s with two torch threads on an
x86 CPU (measured block dev max 0.0103).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.camera import generate_rays as j_generate_rays
from craytracer_tpu.integrator.wavefront import trace_paths as j_trace
from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.sampling.multijitter import stratified_jitter as j_strat
from craytracer_tpu_torch.camera import Film
from craytracer_tpu_torch.integrator.render import RenderConfig, Renderer
from craytracer_tpu_torch.integrator.wavefront import trace_paths
from craytracer_tpu_torch.io.imagestate import read_reference_is
from craytracer_tpu_torch.io.scenefile import load_scene_file

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(REPO, "scenes", "parity_mesh.txt")
GOLDEN = os.path.join(REPO, "tests", "goldens", "golden_mesh.is")
SIZE = 24
SEED = 7


@pytest.fixture(scope="module")
def rays():
    js, jc, jf = j_load(MESH)
    ts, _, _ = load_scene_file(MESH, device="cpu")
    jf = jf.replace(width=SIZE, height=SIZE)
    n = SIZE * SIZE
    pix = np.tile(np.arange(n, dtype=np.int32), 2)
    spp = np.repeat(np.arange(2, dtype=np.int32), n) + 3
    jo, jd = j_generate_rays(jc, jf, jnp.asarray(pix),
                             j_strat(SEED, jnp.asarray(pix), jnp.asarray(spp)))
    return js, ts, jo, jd, pix, spp


def _check(ours, ref, depth):
    L, good, m = ours
    Lr, goodr, mr = ref
    L, good, Lr, goodr = L.numpy(), good.numpy(), np.asarray(Lr), \
        np.asarray(goodr)
    rays, sh = int(m["rays"]), int(m["shadow_rays"])
    rays_r, sh_r = int(mr["rays"]), int(mr["shadow_rays"])
    assert rays_r > 0
    if depth == 0:
        np.testing.assert_array_equal(good, goodr)
        assert (rays, sh) == (rays_r, sh_r)
        np.testing.assert_allclose(L, Lr, rtol=2e-5, atol=2e-5)
        return
    same = good == goodr
    close = np.all(np.abs(L - Lr) <= 1e-4 + 1e-4 * np.abs(Lr), axis=1)
    assert (same & close).mean() >= 0.999, (same.mean(), close.mean())
    assert abs(rays - rays_r) <= 1e-3 * rays_r
    assert abs(sh - sh_r) <= 1e-3 * max(sh_r, 1)
    assert sh_r > 0


@pytest.mark.parametrize("jax_route", ["xla", "pallas"])
@pytest.mark.parametrize("depth", [0, 2, 5])
def test_mesh_pass_matches_jax(rays, monkeypatch, depth, jax_route):
    js, ts, jo, jd, pix, spp = rays
    if jax_route == "pallas":
        for var in ("CRAYTRACER_PALLAS_TRAVERSAL", "CRAYTRACER_PALLAS_ANYHIT",
                    "CRAYTRACER_PALLAS_INTERPRET"):
            monkeypatch.setenv(var, "1")
    ref = j_trace(js, jo, jd, SEED, jnp.asarray(pix), jnp.asarray(spp), depth,
                  with_metrics=True,
                  fast_shade="shade" if jax_route == "pallas" else False)
    o = torch.from_numpy(np.array(jo))
    d = torch.from_numpy(np.array(jd))
    args = (ts, o, d, SEED, torch.from_numpy(pix), torch.from_numpy(spp),
            depth)
    plain = trace_paths(*args, with_metrics=True)
    route = trace_paths(*args, with_metrics=True, fast_shade="shade")
    _check(plain, ref, depth)
    assert torch.equal(route[0], plain[0]) and torch.equal(route[1],
                                                           plain[1])
    np.testing.assert_array_equal(plain[2]["bounce_live"].numpy(),
                                  np.asarray(ref[2]["bounce_live"]))


def _tonemapped(img):
    return (1.0 - np.exp(-2.0 * np.clip(img, 0.0, None))) ** (1.0 / 2.2)


def _block_means(img, blocks=8):
    h, w, _ = img.shape
    tm = _tonemapped(img).mean(-1)
    return tm.reshape(blocks, h // blocks, blocks, w // blocks).mean(
        axis=(1, 3))


def test_renderer_matches_golden_mesh():
    scene, cam, film = load_scene_file(MESH, device="cpu")
    film = Film(fov=film.fov, width=128, height=128)
    r = Renderer(scene, cam, film, RenderConfig(num_samples=64, max_depth=5,
                                                spp_batch=16))
    r.render()
    assert r.passes == 4 and r.nan_count == 0
    ours = r.raw_mean()
    assert ours.shape == (128, 128, 3) and np.isfinite(ours).all()
    accum, spp, w, h = read_reference_is(GOLDEN)
    ref = (accum / spp).reshape(h, w, 3)
    full_r, full_o = _tonemapped(ref).mean(), _tonemapped(ours).mean()
    assert abs(full_o - full_r) < 0.02 * max(full_r, 0.05), (full_o, full_r)
    dev = np.abs(_block_means(ours) - _block_means(ref))
    assert dev.max() < 0.05, dev.max()
    assert (dev < 0.02).mean() > 0.9, dev
