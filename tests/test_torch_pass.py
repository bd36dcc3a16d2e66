"""K1's plain version (craytracer_tpu_torch/integrator/pass_kernel.py
`fused_pass_reference`, which the CPU wrapper runs) against the JAX
package on parity_cornell at 24x24 with per-lane spp (2 spp -> 1152
lanes): against the Pallas megakernel `fused_pass` run in interpret mode
and against the XLA `trace_paths` on the same camera rays.

Tolerances: at depth 0, good, rays and shadow_rays are exact and L agrees
to 2e-5. At depth 2 and 5, >= 99.9% of lanes have equal good and L
within 1e-4 (rtol and atol), and the counters agree within 0.1%: torch's
and XLA's CPU sin/cos may differ by an ulp and flip a rare Russian
roulette or edge lane. Measured at these settings (2 spp, seed 7): every
lane equal at every depth, max |dL| 2.2e-5 against the Pallas kernel
and 5.5e-6 against XLA at depth 5, counters identical. K1 itself is
held against this plain version by tests/test_torch_cuda.py (on the card)
and tests/test_torch_k1_host.py (its source built for the CPU)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.camera import generate_rays as j_generate_rays
from craytracer_tpu.integrator.pallas_shade import fused_pass as j_fused_pass
from craytracer_tpu.integrator.wavefront import render_sample as j_render
from craytracer_tpu.integrator.wavefront import trace_paths as j_trace
from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.sampling import uniforms as j_uniforms
from craytracer_tpu.sampling.multijitter import stratified_jitter as j_strat
from craytracer_tpu_torch.camera import Film
from craytracer_tpu_torch.integrator import pass_kernel as pk
from craytracer_tpu_torch.integrator.wavefront import render_sample
from craytracer_tpu_torch.io.scenefile import load_scene_file

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "parity_cornell.txt")
SIZE = 24
SEED = 7


@pytest.fixture(scope="module")
def scenes():
    js, jc, jf = j_load(CORNELL)
    ts, tc, tf = load_scene_file(CORNELL, device="cpu")
    jf = jf.replace(width=SIZE, height=SIZE)
    tf = Film(fov=tf.fov, width=SIZE, height=SIZE)
    n = SIZE * SIZE
    pix = np.tile(np.arange(n, dtype=np.int32), 2)
    spp = np.repeat(np.arange(2, dtype=np.int32), n) + 3
    return (js, jc, jf), (ts, tc, tf), pix, spp


def _jax_rays(jc, jf, pix, spp, raygen):
    p, s = jnp.asarray(pix), jnp.asarray(spp)
    if raygen == "strat":
        jit = j_strat(SEED, p, s)
    else:
        jit = j_uniforms(SEED, p, s, 0x7FFF, 2, 0)
    return j_generate_rays(jc, jf, p, jit)


def _check(ours, ref, depth):
    L, good, m = ours
    Lr, goodr, mr = (np.asarray(x) if not isinstance(x, dict) else x
                     for x in ref)
    L, good = L.numpy(), good.numpy()
    rays, sh = int(m["rays"]), int(m["shadow_rays"])
    rays_r, sh_r = int(mr["rays"]), int(mr["shadow_rays"])
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


@pytest.mark.parametrize("raygen", ["strat", "plain"])
@pytest.mark.parametrize("depth", [0, 2, 5])
def test_plain_version_matches_pallas_fused_pass(scenes, depth, raygen):
    (js, jc, jf), (ts, tc, tf), pix, spp = scenes
    ref = j_fused_pass(js, None, None, jnp.asarray(pix), jnp.asarray(spp),
                       SEED, depth, raygen=raygen, camera=jc, film=jf,
                       width=SIZE, interpret=True, block=pix.shape[0])
    ours = pk.fused_pass_reference(ts, tc, tf, torch.from_numpy(pix),
                                   torch.from_numpy(spp), SEED, depth,
                                   raygen=raygen)
    _check(ours, ref, depth)


@pytest.mark.parametrize("raygen", ["strat", "plain"])
@pytest.mark.parametrize("depth", [0, 2, 5])
def test_plain_version_matches_xla_trace_paths(scenes, depth, raygen):
    (js, jc, jf), (ts, tc, tf), pix, spp = scenes
    o, d = _jax_rays(jc, jf, pix, spp, raygen)
    ref = j_trace(js, o, d, SEED, jnp.asarray(pix), jnp.asarray(spp), depth,
                  with_metrics=True)
    ours = pk.fused_pass_reference(ts, tc, tf, torch.from_numpy(pix),
                                   torch.from_numpy(spp), SEED, depth,
                                   raygen=raygen)
    _check(ours, ref, depth)
    np.testing.assert_array_equal(ours[2]["bounce_live"].numpy(),
                                  np.asarray(ref[2]["bounce_live"]))


@pytest.mark.parametrize("estimator", ["reference", "physical"])
def test_render_sample_matches_jax(scenes, estimator):
    """The production pass (gate + fused_pass, stratified raygen) against
    the JAX render_sample's XLA path."""
    (js, jc, jf), (ts, tc, tf), pix, spp = scenes
    ref = np.asarray(j_render(js, jc, jf, jnp.asarray(pix), SEED,
                              jnp.asarray(spp), 5, estimator=estimator))
    got = render_sample(ts, tc, tf, torch.from_numpy(pix), SEED,
                        torch.from_numpy(spp), 5, estimator=estimator).numpy()
    close = np.all(np.abs(got - ref) <= 1e-4 + 1e-4 * np.abs(ref), axis=1)
    assert close.mean() >= 0.999


def test_wrapper_routes_cpu_tensors_to_the_plain_version(scenes):
    _, (ts, tc, tf), pix, spp = scenes
    args = (ts, tc, tf, torch.from_numpy(pix), torch.from_numpy(spp), SEED, 3)
    before = pk.KERNEL.launches
    L, good, m = pk.fused_pass(*args)
    Lr, goodr, mr = pk.fused_pass_reference(*args)
    assert pk.KERNEL.launches == before
    assert torch.equal(L, Lr) and torch.equal(good, goodr)
    assert int(m["rays"]) == int(mr["rays"])


def test_wrapper_refuses_grad_and_mixed_devices(scenes):
    import dataclasses

    _, (ts, tc, tf), pix, spp = scenes
    cam = dataclasses.replace(
        tc, position=tc.position.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="forward-only"):
        pk.fused_pass(ts, cam, tf, torch.from_numpy(pix), 0, SEED, 2)
    with pytest.raises(ValueError, match="raygen"):
        pk.fused_pass(ts, tc, tf, torch.from_numpy(pix), 0, SEED, 2,
                      raygen="thinlens")


def test_kernel_tables_layout(scenes):
    """The packed table K1 reads: camera, env, then 19-col material and
    light rows and 16-col prim rows in group order (rects, triangles)."""
    _, (ts, tc, tf), _, _ = scenes
    tab = pk.kernel_tables(ts, tc, tf)
    n_m, n_l = ts.materials.mat_type.shape[0], ts.lights.light_type.shape[0]
    assert tab.dtype == torch.float32
    assert tab.numel() == 24 + 19 * (n_m + n_l) + 16 * (8 + 20)
    prims = tab[24 + 19 * (n_m + n_l):].reshape(28, 16)
    assert torch.equal(prims[:8, 0:3], ts.rects.point)
    assert torch.equal(prims[8:, 3:6], ts.triangles.v1 - ts.triangles.v0)
    assert torch.equal(prims[8:, 13], ts.triangles.double_sided.float())
    lights = tab[24 + 19 * n_m:24 + 19 * (n_m + n_l)].reshape(n_l, 19)
    assert torch.equal(lights[:, 16], ts.lights.power_cdf)


def test_kernel_launch_refuses_cpu_tensors(scenes):
    """K1's launch checks its inputs before the foreign call: CPU tensors
    never reach the CUDA entry point (nor the nvcc build)."""
    _, (ts, tc, tf), pix, spp = scenes
    tab = pk.kernel_tables(ts, tc, tf)
    p = torch.from_numpy(pix)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pk.KERNEL.launch(tab, pk.table_counts(ts), p, torch.from_numpy(spp),
                         SEED, 5, True, SIZE, 0)
