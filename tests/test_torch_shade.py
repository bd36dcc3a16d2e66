"""K2's plain version (craytracer_tpu_torch/integrator/shade_kernel.py
`fused_shade_reference`, which the CPU wrapper runs) against the JAX
package's `fused_shade` (pallas_shade.py:1846) in interpret mode, on the
hit records of a plain pass over scenes/parity_mesh.txt at 24x24 with
per-lane spp (two samples per pixel, 1,152 lanes), at bounces 0, 2 and 5.
Both sides get the same hit record and path state. The same on
scenes/parity_mix.txt (Oren-Nayar, plastic, mirror, gold; 24x24) and on
the glass / transparent scene of tests/test_pallas_shade.py:259-267
(torch_sphere_scenes.py `glass_spheres`, 32x32 at 4 spp), where the JAX
kernel takes its has_* branches, with the bar of the JAX package's own
test of those materials (tests/test_pallas_shade.py:242-247): floats
within 5e-5, the int outputs equal on every lane.

Bars: every float output within 2e-5 (absolute + relative; the JAX
kernel's own bar against XLA, tests/test_pallas_shade.py); good_inc,
want_shadow, new_alive and new_prev_sg equal on every lane. Measured: the
float outputs agree to 2.5e-6 at bounce 0 (new_d, new_beta) and 4.8e-7
at bounces 2 and 5 (XLA's CPU backend contracts multiply-adds into FMAs;
the port rounds each operation on its own). The
CPU wrapper `fused_shade` takes the plain version and launches nothing.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.integrator.pallas_shade import fused_shade as j_shade
from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.ops.intersect import Hit as JHit
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.camera import Film, generate_rays, make_camera
from craytracer_tpu_torch.integrator import shade_kernel as sk
from craytracer_tpu_torch.integrator.wavefront import _bounce_step, _init_state
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.ops.intersect import intersect_scene
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter
from craytracer_tpu_torch.scene.build import SceneBuilder

import torch_sphere_scenes as sphere_scenes

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = os.path.join(REPO, "scenes", "parity_mesh.txt")
MIX = os.path.join(REPO, "scenes", "parity_mix.txt")
SEED = 9
DEPTH = 5
FLOATS = ("L_add", "shadow_o", "shadow_d", "dist_adj", "dist_adj_t",
          "contrib_cand", "new_o", "new_d", "new_beta")
INTS = ("good_inc", "want_shadow", "new_alive", "new_prev_sg")


def _pass_records(js, ts, cam, film, n_spp=2):
    """(port scene, JAX scene, {bounce: (path state, hit record)}, spp)
    of one plain pass with `n_spp` samples per pixel."""
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32).repeat(n_spp)
    spp = 3 + torch.arange(n_spp, dtype=torch.int32).repeat_interleave(n)
    o, d = generate_rays(cam, film, pix, stratified_jitter(SEED, pix, spp))
    state = _init_state(o, d, DEPTH, pix)
    out = {}
    for bounce in range(DEPTH + 1):
        out[bounce] = (state, intersect_scene(ts, state[0], state[1]))
        state = _bounce_step(ts, SEED, spp, DEPTH, bounce, state,
                             kernels=False)
    return ts, js, out, spp


@pytest.fixture(scope="module")
def records():
    js, _, _ = j_load(MESH)
    ts, cam, film = load_scene_file(MESH, device="cpu")
    return _pass_records(js, ts, cam, Film(fov=film.fov, width=24,
                                           height=24))


@pytest.fixture(scope="module", params=["parity_mix", "glass_spheres"])
def mixed_records(request):
    if request.param == "parity_mix":
        js, _, _ = j_load(MIX)
        ts, cam, film = load_scene_file(MIX, device="cpu")
        return _pass_records(js, ts, cam, Film(fov=film.fov, width=24,
                                               height=24))
    jb, tb = JBuilder(), SceneBuilder()
    eye, look, fov, _ = sphere_scenes.glass_spheres(jb)
    sphere_scenes.glass_spheres(tb)
    return _pass_records(jb.build(), tb.build(device="cpu"),
                         make_camera(eye, look, device="cpu"),
                         Film(fov=torch.tensor(fov), width=32, height=32),
                         n_spp=4)


def _j(x):
    return jnp.asarray(x.numpy())


def _against_pallas(records, bounce, tol):
    ts, js, recs, spp = records
    state, hit = recs[bounce]
    _, d, beta, _, _, alive, prev_sg, _, _, _, pix = state
    assert bool(alive.any())
    ours = sk.fused_shade_reference(ts, d, hit, beta, alive, prev_sg, pix,
                                    spp, SEED, bounce, DEPTH)
    jhit = JHit(t=_j(hit.t), group=_j(hit.group), prim=_j(hit.prim),
                point=_j(hit.point), normal=_j(hit.normal),
                dpdu=_j(hit.dpdu), uv=_j(hit.uv), mat_id=_j(hit.mat_id))
    ref = j_shade(js, _j(d), jhit, _j(beta), _j(alive), _j(prev_sg), _j(pix),
                  _j(spp), SEED, bounce, DEPTH, interpret=True)
    for key in FLOATS:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   rtol=tol, atol=tol, err_msg=key)
    for key in INTS:
        np.testing.assert_array_equal(
            ours[key].numpy().astype(np.int32),
            np.asarray(ref[key]).astype(np.int32), err_msg=key)
    if bounce < DEPTH:
        assert bool(ours["want_shadow"].any()) and bool(
            ours["new_alive"].any())
    return ours


@pytest.mark.parametrize("bounce", [0, 2, 5])
def test_plain_shade_matches_pallas_fused_shade(records, bounce):
    _against_pallas(records, bounce, 2e-5)


@pytest.mark.parametrize("bounce", [0, 2, 5])
def test_plain_shade_every_material_matches_pallas(mixed_records, bounce):
    ours = _against_pallas(mixed_records, bounce, 5e-5)
    if bounce < DEPTH:  # some lane leaves a specular or glossy lobe
        assert bool(ours["new_prev_sg"].any())


def test_cpu_wrapper_takes_the_plain_version(records):
    ts, _, recs, spp = records
    state, hit = recs[2]
    args = (ts, state[1], hit, state[2], state[5], state[6], state[10], spp,
            SEED, 2, DEPTH)
    before = sk.KERNEL.launches
    got = sk.fused_shade(*args)
    ref = sk.fused_shade_reference(*args)
    assert sk.KERNEL.launches == before
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    with pytest.raises(ValueError, match="forward-only"):
        sk.fused_shade(ts, state[1], hit, state[2].clone().requires_grad_(),
                       *args[4:])


def test_shade_tables_layout(records):
    """K2's table: env radiance and a pad, then 19-column material and
    light rows (the layouts of _meta_operands, pallas_shade.py:1613)."""
    ts = records[0]
    tab = sk.shade_tables(ts)
    n_m, n_l = ts.materials.mat_type.shape[0], ts.lights.light_type.shape[0]
    assert tab.dtype == torch.float32
    assert tab.numel() == 4 + 19 * (n_m + n_l)
    mt = tab[4:4 + 19 * n_m].reshape(n_m, 19)
    lt = tab[4 + 19 * n_m:].reshape(n_l, 19)
    assert torch.equal(mt[:, 1:4], ts.materials.color)
    assert torch.equal(lt[:, 16], ts.lights.power_cdf)
    assert torch.equal(lt[:, 17], ts.lights.power)
