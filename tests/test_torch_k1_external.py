"""K1's external-ray mode (craytracer_tpu_torch/integrator/pass_kernel.py
`fused_pass(..., raygen=None, rays=(o, d))`, csrc/pass_kernel.cu
`k1_pass_rays_launch`), the JAX kernel's raygen=None
(pallas_shade.py:806-808, `fused_pass` :1758-1768).

- Its plain version against the JAX `fused_pass(scene, o, d, ...,
  interpret=True)` on the camera rays of a multijittered table
  (16x16, 256 lanes) on parity_cornell and parity_mix at depth 5, with
  tests/test_torch_pass.py's bars for a deep pass (>= 99.9% of lanes,
  here every lane, with equal good and L within 1e-4, the counters
  within 0.1%; measured: every lane within 2e-5).
- Its CUDA source built for the CPU (tests/torch_cuda_host.py) against
  the plain version with tests/test_torch_k1_host.py's bars (good, the
  ray and shadow-ray counts and the alive mask equal on every lane, L
  within 2e-5, the live histogram equal), on parity_cornell (matte-only
  and full core), parity_mix, and the NaN scene of tests/test_nan_log.py,
  where K1's NaN lanes must be the plain version's: a lane count off the
  warp and the block, the outputs prefilled.
- `render_sample` with a table sampler on a "bounce" scene: K1's
  external-ray mode on the sampler's rays, against the JAX render_sample
  with the same table (XLA), L within 2e-5."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.camera import generate_rays as j_generate_rays
from craytracer_tpu.integrator.pallas_shade import fused_pass as j_fused_pass
from craytracer_tpu.integrator.wavefront import render_sample as j_render
from craytracer_tpu.sampling.tables import make_sample_table as j_table
from craytracer_tpu.sampling.tables import table_sample as j_table_sample
from craytracer_tpu_torch.integrator import pass_kernel as pk
from craytracer_tpu_torch.integrator import wavefront as wf
from craytracer_tpu_torch.sampling.tables import make_sample_table
from torch_cuda_host import host_build
from torch_slice_f import SEED, build_both, load_both, nan_scene, nan_view, t

torch.set_num_threads(2)
L_TOL = 2e-5


def _table_rays(jc, jf, spp_count=2, kind="multijittered"):
    """(o, d, pix, spp) numpy: the film's pixels at spp 3, 4, ... through
    the JAX raygen with a table's film jitter."""
    n = jf.width * jf.height
    pix = np.tile(np.arange(n, dtype=np.int32), spp_count)
    spp = np.repeat(np.arange(spp_count, dtype=np.int32), n) + 3
    table = j_table(kind, 16, 5, seed=2)
    jit = j_table_sample(table, SEED, jnp.asarray(pix), jnp.asarray(spp), 0)
    o, d = j_generate_rays(jc, jf, jnp.asarray(pix), jit)
    return np.array(o), np.array(d), pix, spp


def _check_jax(ours, ref):
    (L, good, m), (Lr, goodr, mr) = ours, ref
    L, good, Lr, goodr = L.numpy(), good.numpy(), np.asarray(Lr), \
        np.asarray(goodr)
    rays, sh = int(m["rays"]), int(m["shadow_rays"])
    rays_r, sh_r = int(mr["rays"]), int(mr["shadow_rays"])
    same = good == goodr
    close = np.all(np.abs(L - Lr) <= 1e-4 + 1e-4 * np.abs(Lr), axis=1)
    assert (same & close).mean() >= 0.999, (same.mean(), close.mean())
    assert abs(rays - rays_r) <= 1e-3 * rays_r
    assert abs(sh - sh_r) <= 1e-3 * max(sh_r, 1)


@pytest.mark.parametrize("name", ["parity_cornell", "parity_mix"])
def test_plain_external_rays_match_jax_kernel(name, depth=5):
    (js, jc, jf), (ts, tc, tf) = load_both(name, 16)
    o, d, pix, spp = _table_rays(jc, jf, 1)
    ref = j_fused_pass(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(pix),
                       jnp.asarray(spp), SEED, depth, interpret=True,
                       block=pix.shape[0])
    before = pk.RAYS_KERNEL.launches
    ours = pk.fused_pass(ts, tc, tf, t(pix), t(spp), SEED, depth,
                         raygen=None, rays=(t(o), t(d)))
    assert pk.RAYS_KERNEL.launches == before  # CPU: the plain version
    plain = pk.fused_pass_reference(ts, tc, tf, t(pix), t(spp), SEED, depth,
                                    raygen=None, rays=(t(o), t(d)))
    assert torch.equal(ours[0], plain[0]) and torch.equal(ours[1], plain[1])
    _check_jax(ours, ref)
    with pytest.raises(ValueError):
        pk.fused_pass(ts, tc, tf, t(pix), t(spp), SEED, depth, raygen=None)
    with pytest.raises(ValueError):
        pk.fused_pass(ts, tc, tf, t(pix), t(spp), SEED, depth,
                      rays=(t(o), t(d)))


@pytest.fixture(scope="module")
def k1_host(tmp_path_factory):
    so = host_build(tmp_path_factory, "pass_kernel", 1)
    pk._bind(so)
    return so


def _run_rays(so, scene, cam, film, pix, spp, o, d, seed, depth, full):
    """One launch through k1_pass_rays_launch, L and g prefilled."""
    tab = pk.kernel_tables(scene, cam, film)
    n = pix.shape[0]
    L = torch.full((n, 3), 7.0, dtype=torch.float32)
    g = torch.full((4, n), -1, dtype=torch.int32)
    next_path = torch.empty(1, dtype=torch.int32)
    o, d = o.contiguous(), d.contiguous()
    err = so.k1_pass_rays_launch(
        tab.data_ptr(), tab.numel(), pix.data_ptr(), spp.data_ptr(),
        o.data_ptr(), d.data_ptr(), n,
        (ctypes.c_int * 8)(*pk.table_counts(scene)), seed, depth,
        pk.RR_START, full, next_path.data_ptr(), L.data_ptr(), g.data_ptr(),
        None)
    assert err == 0
    assert int(next_path) >= n
    return L, g


def _check_host(out, ref, depth, nan_ok=False):
    (L, g), (Lr, goodr, mr) = out, ref
    assert torch.equal(g[0], goodr)
    assert torch.equal(g[1], mr["lane_rays"])
    assert torch.equal(g[2], mr["lane_shadow_rays"])
    assert torch.equal(g[3], (1 << mr["lane_rays"]) - 1)
    nan, nan_r = torch.isnan(L), torch.isnan(Lr)
    assert torch.equal(nan, nan_r) and (nan_ok or not bool(nan.any()))
    ok = ((L - Lr).abs() <= L_TOL + L_TOL * Lr.abs()) | (nan & nan_r)
    assert ok.all()
    bits = torch.arange(depth + 1, dtype=torch.int32)
    assert torch.equal(((g[3][:, None] >> bits) & 1).sum(dim=0),
                       mr["bounce_live"])


@pytest.mark.parametrize("name", ["parity_cornell", "parity_mix", "nan"])
def test_k1_rays_source_matches_plain_version(k1_host, name):
    if name == "nan":
        _, ts = build_both(nan_scene)
        _, (tc, tf) = nan_view(13)
        depth = 3
    else:
        _, (ts, tc, tf) = load_both(name, 13)
        depth = 5
    n = tf.num_pixels
    pix = torch.arange(n, dtype=torch.int32).repeat(2)  # 338 lanes
    spp = 3 + torch.arange(2, dtype=torch.int32).repeat_interleave(n)
    table = make_sample_table("multijittered", 16, 5, seed=2)
    o, d = wf.camera_rays(tc, tf, pix, SEED, spp,
                          wf.film_jitter(SEED, pix, spp, table))
    ref = pk.fused_pass_reference(ts, tc, tf, pix, spp, SEED, depth,
                                  raygen=None, rays=(o, d))
    for full in ((0, 1) if name == "parity_cornell" else (1,)):
        out = _run_rays(k1_host, ts, tc, tf, pix, spp, o, d, SEED, depth,
                        full)
        _check_host(out, ref, depth, nan_ok=name == "nan")
    if name == "nan":
        assert int(torch.isnan(ref[0]).any(dim=1).sum()) > 0


@pytest.mark.parametrize("estimator", ["reference", "physical"])
def test_render_sample_with_a_sampler_takes_k1_rays(monkeypatch, estimator):
    (js, jc, jf), (ts, tc, tf) = load_both("parity_cornell", 12)
    n = 12 * 12
    pix = np.tile(np.arange(n, dtype=np.int32), 2)
    spp = np.repeat(np.arange(2, dtype=np.int32), n) + 3
    jtab = j_table("hammersley", 16, 5, seed=2)
    ttab = make_sample_table("hammersley", 16, 5, seed=2)
    ref = np.asarray(j_render(js, jc, jf, jnp.asarray(pix), SEED,
                              jnp.asarray(spp), 5, estimator=estimator,
                              sampler=jtab))
    calls = []
    admitted = pk._admitted_pass

    def spy(*a, **k):
        calls.append(k.get("raygen"))
        return admitted(*a, **k)

    monkeypatch.setattr(pk, "_admitted_pass", spy)
    got = wf.render_sample(ts, tc, tf, t(pix), SEED, t(spp), 5,
                           estimator=estimator, sampler=ttab).numpy()
    assert calls == [None]
    np.testing.assert_allclose(got, ref, rtol=L_TOL, atol=L_TOL)
