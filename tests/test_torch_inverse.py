"""Inverse rendering through the port (craytracer_tpu_torch/inverse.py):
the counterparts of tests/test_inverse.py (recover an albedo, recover a
4x4 texture, InverseRenderer's bit-exact checkpoint/resume and its seed
check), the port's InverseRenderer against the JAX package's for 6 steps
on that file's scene at 8x8 (Adam and SGD, with and without the cosine
decay, the "mse" and "log1p" losses; params and losses within 1e-5), and
a step whose loss is not finite: skipped, the params, the optimizer's
state and the schedule's count unchanged.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from craytracer_tpu.camera import Film as JFilm
from craytracer_tpu.camera import make_camera as j_make_camera
from craytracer_tpu.integrator.wavefront import render_sample as j_render
from craytracer_tpu.inverse import InverseConfig as JConfig
from craytracer_tpu.inverse import InverseRenderer as JInverse
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.camera import Film, make_camera
from craytracer_tpu_torch.integrator.wavefront import render_sample
from craytracer_tpu_torch.interop import (camera_from_numpy, numpy_leaves,
                                          scene_from_numpy)
from craytracer_tpu_torch.inverse import (InverseConfig, InverseRenderer,
                                          cosine_decay)
from craytracer_tpu_torch.scene.build import SceneBuilder

torch.set_num_threads(2)


def _scene(b, albedo):
    b.add_matte("floor", (albedo, albedo * 0.8, albedo * 0.5))
    b.add_emissive("light", (1, 1, 1), 25.0)
    b.add_rect((-20, 0, -20), (40, 0, 0), (0, 0, 40), "floor")
    b.add_rect((-3, 20, -3), (6, 0, 0), (0, 0, 6), "light")
    return b.build(device="cpu") if isinstance(b, SceneBuilder) else b.build()


def _film(size, deg):
    return Film(fov=torch.tensor(np.float32(np.radians(deg))), width=size,
                height=size)


def _set_color(scene, row, p):
    m = scene.materials
    color = torch.index_put(m.color, (torch.tensor([row]),), p[None])
    return dataclasses.replace(scene, materials=dataclasses.replace(
        m, color=color))


def test_recover_albedo():
    """40 Adam steps at 0.05 from albedo 0.25 recover 0.7 (x (1, 0.8,
    0.5)) within 0.05, and the loss falls below 0.3 of its start."""
    cam = make_camera((0, 10, 25), (0, 0, 0))
    film = _film(16, 40.0)
    ids = torch.arange(film.num_pixels, dtype=torch.int32)

    def render(scene, spp_index):
        return render_sample(scene, cam, film, ids, 7, spp_index, 2,
                             estimator="physical")

    with torch.no_grad():
        target = render(_scene(SceneBuilder(), 0.7), 0)
    scene0 = _scene(SceneBuilder(), 0.25)
    params = scene0.materials.color[1].clone().requires_grad_(True)
    opt = torch.optim.Adam([params], lr=0.05, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for it in range(40):
        opt.zero_grad()
        diff = render(_set_color(scene0, 1, params), it % 4) - target
        loss = torch.mean(diff * diff)
        loss.backward()
        opt.step()
        with torch.no_grad():
            params.clamp_(0.0, 1.0)
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(params.detach().numpy(), [0.7, 0.56, 0.35],
                               atol=0.05)
    assert losses[-1] < losses[0] * 0.3


def test_recover_texture():
    """A 4x4 texture through the nearest-lookup gather: 60 Adam steps of 4
    spp from flat 0.5; the median texel error under 0.06 and three in
    four texels within 0.12."""
    target_tex = np.linspace(0.15, 0.85, 4 * 4 * 3,
                             dtype=np.float32).reshape(4, 4, 3)

    def build(tex):
        b = SceneBuilder()
        tid = b.add_texture("t", tex)
        b.add_matte("floor", (1, 1, 1), diffuse_tex=tid)
        b.add_emissive("light", (1, 1, 1), 25.0)
        b.add_rect((-20, 0, -20), (40, 0, 0), (0, 0, 40), "floor")
        b.add_rect((-3, 20, -3), (6, 0, 0), (0, 0, 6), "light")
        return b.build(device="cpu")

    cam = make_camera((0, 18, 20), (0, 0, 0))
    film = _film(24, 55.0)
    ids = torch.arange(film.num_pixels, dtype=torch.int32)

    def render(scene, spp_index):
        return render_sample(scene, cam, film, ids, 7, spp_index, 2,
                             estimator="physical")

    with torch.no_grad():
        scene_t = build(target_tex)
        target = torch.stack([render(scene_t, k) for k in range(4)]).mean(0)
    scene0 = build(np.full((4, 4, 3), 0.5, np.float32))
    params = scene0.textures.texels.clone().requires_grad_(True)
    opt = torch.optim.Adam([params], lr=0.05, betas=(0.9, 0.999), eps=1e-8)
    for it in range(60):
        opt.zero_grad()
        s = dataclasses.replace(scene0, textures=dataclasses.replace(
            scene0.textures, texels=params))
        img = torch.stack([render(s, (it % 4) * 4 + k)
                           for k in range(4)]).mean(0)
        diff = img - target
        torch.mean(diff * diff).backward()
        opt.step()
        with torch.no_grad():
            params.clamp_(0.0, 1.0)
    rec = params.detach().numpy().reshape(4, 4, 3)
    err = np.abs(rec - target_tex)
    assert np.median(err) < 0.06, np.median(err)
    assert (err < 0.12).mean() > 0.75, err.mean()


def _inverse_setup(device="cpu"):
    cam = make_camera((0, 10, 25), (0, 0, 0), device=device)
    film = Film(fov=torch.tensor(np.float32(np.radians(40.0)),
                                 device=device), width=8, height=8)
    ids = torch.arange(film.num_pixels, dtype=torch.int32, device=device)
    with torch.no_grad():
        target = render_sample(_scene(SceneBuilder(), 0.7).to(device), cam,
                               film, ids, 7, 0, 2, estimator="physical")
    scene0 = _scene(SceneBuilder(), 0.25).to(device)

    def apply_fn(scene, p):
        return _set_color(scene, 1, p)

    return scene0, cam, film, target, apply_fn


def test_inverse_renderer_checkpoint_resume(tmp_path):
    """3 steps + save + load + 3 steps equal 6 straight steps bit for bit
    (params and the optimizer's moments); the grad norms are finite; a
    checkpoint of another seed is refused."""
    scene0, cam, film, target, apply_fn = _inverse_setup()
    params0 = scene0.materials.color[1]
    cfg = InverseConfig(learning_rate=0.05, max_depth=2)

    def fresh(seed=7):
        return InverseRenderer(scene0, cam, film, target, params0, apply_fn,
                               cfg, seed=seed)

    a = fresh()
    for _ in range(6):
        a.step()
    b = fresh()
    for _ in range(3):
        b.step()
    ck = str(tmp_path / "inv.pt")
    b.save_state(ck)
    c = fresh().load_state(ck)
    assert c.step_idx == 3
    for _ in range(3):
        c.step()
    assert torch.equal(a.params, c.params)
    sa, sc = a.opt.state_dict()["state"], c.opt.state_dict()["state"]
    assert sa.keys() == sc.keys()
    for k in sa:
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[k][name], sc[k][name]), name
    assert a.history == c.history
    assert all(np.isfinite(g) for _, g in a.history)
    with pytest.raises(ValueError):
        fresh(seed=8).load_state(ck)


CASES = [(opt, decay, loss) for opt in ("adam", "sgd") for decay in (0, 4)
         for loss in ("mse", "log1p")]


@pytest.mark.parametrize("optimizer,decay,loss", CASES)
def test_inverse_renderer_matches_jax(optimizer, decay, loss):
    """6 steps of the port's InverseRenderer against the JAX package's on
    the same scene (carried by interop): every step's loss, grad norm and
    params within 1e-5."""
    b = JBuilder()
    js_t = _scene(b, 0.7)
    js0 = _scene(JBuilder(), 0.25)
    jc = j_make_camera((0, 10, 25), (0, 0, 0))
    jf = JFilm(fov=jnp.float32(np.radians(40.0)), width=8, height=8)
    ids = jnp.arange(64, dtype=jnp.int32)
    jtarget = j_render(js_t, jc, jf, ids, 7, 0, 2, estimator="physical")
    lr = 0.05 if optimizer == "adam" else 2.0
    kw = dict(learning_rate=lr, max_depth=2, optimizer=optimizer,
              decay_steps=decay, loss=loss)

    def j_apply(scene, p):
        return scene.replace(materials=scene.materials.replace(
            color=scene.materials.color.at[1].set(p)))

    jinv = JInverse(js0, jc, jf, jtarget, js0.materials.color[1], j_apply,
                    JConfig(**kw), seed=7)
    ts0 = scene_from_numpy(numpy_leaves(js0))
    tinv = InverseRenderer(
        ts0, camera_from_numpy(numpy_leaves(jc)), _film(8, 40.0),
        torch.from_numpy(np.array(jtarget)), ts0.materials.color[1],
        lambda s, p: _set_color(s, 1, p), InverseConfig(**kw), seed=7)
    for _ in range(6):
        jrec, trec = jinv.step(), tinv.step()
        np.testing.assert_allclose(trec, jrec, rtol=1e-5)
        np.testing.assert_allclose(tinv.params.detach().numpy(),
                                   np.asarray(jinv.params), rtol=1e-5,
                                   atol=1e-7)
    assert tinv.updates == 6 and tinv.nan_steps == 0


def test_nonfinite_step_is_skipped():
    """A step whose loss is NaN is skipped: counted in nan_steps and
    history, step_idx advances; the params, the optimizer's state and the
    update count (the schedule's clock) stay as they were, and the next
    step's rate is the schedule's at that count."""
    scene0, cam, film, target, apply_fn = _inverse_setup()
    cfg = InverseConfig(learning_rate=0.05, max_depth=2, decay_steps=5)
    inv = InverseRenderer(scene0, cam, film, target,
                          scene0.materials.color[1], apply_fn, cfg)
    for _ in range(2):
        inv.step()
    before = (inv.params.detach().clone(), inv.updates,
              {k: {n: v.clone() for n, v in s.items()}
               for k, s in inv.opt.state_dict()["state"].items()})
    inv.target = torch.full_like(target, float("nan"))
    loss, _ = inv.step()
    assert not np.isfinite(loss)
    assert inv.nan_steps == 1 and inv.step_idx == 3 and len(inv.history) == 3
    assert torch.equal(inv.params, before[0]) and inv.updates == before[1]
    for k, s in inv.opt.state_dict()["state"].items():
        for n, v in s.items():
            assert torch.equal(v, before[2][k][n]), n
    inv.target = target
    inv.step()
    assert inv.updates == 3
    assert inv.opt.param_groups[0]["lr"] == cosine_decay(0.05, 5, 2)
