"""Inverse rendering on a triangle mesh: recover a floor TEXTURE and a
mesh's MICROFACET ROUGHNESS (counterpart of examples/inverse_mesh_demo.py).

Scene: a GOLD icosphere(2) mesh (320 triangles, bvh4) on a 64x64
textured floor under an area lamp. Parameters: the whole 64x64x3 texel
block and the metal's alphax/alphay (12,289 numbers), from flat 0.4
texels and roughness 0.6 toward the true checker and 0.35, through the
InverseRenderer (MIS, depth 2, 8 spp per step, Adam at 0.02 with
cosine decay), with one save/load round trip mid-run.

    python -m craytracer_tpu_torch.examples.inverse_mesh_demo \\
        [--device cpu] [--steps 300] [--size 64] [--tex 64] [--out gallery]

writes <out>/inverse_mesh_recovery_torch.ppm (target | initial |
recovered | texture truth | texture recovered) and
<out>/inverse_mesh_curve_torch.json. `demo` builds the pieces for other
callers (chip_smoke.py, the tests).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from craytracer_tpu_torch.camera import Film, make_camera
from craytracer_tpu_torch.inverse import (CUBLAS_CONFIG, InverseConfig,
                                          InverseRenderer)
from craytracer_tpu_torch.scene.build import SceneBuilder
from craytracer_tpu_torch.scene.city import icosphere
from craytracer_tpu_torch.scene.types import resolve_device

EYE, LOOK, FOV_DEG = (0.0, 11.5, 5.0), (0.0, 0.2, -0.3), 42.0
ALPHA_TRUE, ALPHA0, TEXEL0 = 0.35, 0.6, 0.4
REF_SEED = 123  # the target's and the reference renders' seed


def checker(k: int) -> np.ndarray:
    """The floor's true [k, k, 3] texture: 8-texel checks."""
    y, x = np.mgrid[0:k, 0:k]
    c = ((x // 8 + y // 8) % 2).astype(np.float32)
    return np.stack([0.15 + 0.6 * c, 0.5 - 0.25 * c, 0.2 + 0.1 * c],
                    axis=-1).astype(np.float32)


def build(tex: np.ndarray, device=None):
    """(scene, the ball's material id): the floor framed to hold the whole
    texture (texels out of view get no gradient), the icosphere, the
    lamp."""
    b = SceneBuilder()
    tid = b.add_texture("floor_tex", tex)
    b.add_matte("floor", (1.0, 1.0, 1.0), diffuse_tex=tid)
    b.add_metal("ball", preset="GOLD", roughness=0.2)
    b.add_emissive("lamp", (1.0, 0.95, 0.85), 8.0)
    b.add_rect((-5, 0, -5), (10, 0, 0), (0, 0, 10), "floor")
    v, f = icosphere(2)
    c = np.array([0, 1.6, 0])
    b.add_triangles_array(1.5 * v[f[:, 0]] + c, 1.5 * v[f[:, 1]] + c,
                          1.5 * v[f[:, 2]] + c, "ball")
    b.add_rect((-1.5, 7, -1.5), (3, 0, 0), (0, 0, 3), "lamp")
    return b.build(accel="bvh4", device=device), b.material_id("ball")


def grafter(scene, ball_mid: int):
    """apply_fn(scene, params) for params {"texels": [K*K, 3], "alpha":
    scalar}: the texels over the floor texture's rows, alpha into the
    ball's alphax and alphay, out of place."""
    t0 = int(scene.textures.offset[0])

    def apply_fn(s, p):
        tx = s.textures.texels
        n = p["texels"].shape[0]
        texels = torch.cat([tx[:t0], p["texels"], tx[t0 + n:]])
        m = s.materials
        row = torch.arange(m.alphax.shape[0], device=m.alphax.device)
        mats = dataclasses.replace(
            m, alphax=torch.where(row == ball_mid, p["alpha"], m.alphax),
            alphay=torch.where(row == ball_mid, p["alpha"], m.alphay))
        return dataclasses.replace(s, materials=mats, textures=dataclasses
                                   .replace(s.textures, texels=texels))

    return apply_fn


def clip_fn(p):
    return {"texels": torch.clamp(p["texels"], 0.0, 1.0),
            "alpha": torch.clamp(p["alpha"], 1e-3, 1.0)}


def config(steps: int) -> InverseConfig:
    """The demo's InverseRenderer settings. MIS: its alpha gradient is correctly
    signed, where the physical estimator's glossy bounce-emissive hits
    carry a boundary term autograd cannot see."""
    return InverseConfig(learning_rate=0.02, max_depth=2, estimator="mis",
                         spp_per_step=8, spp_cycle=8, decay_steps=steps)


def render_ref(scene, cam, film, spp0: int, cfg: InverseConfig,
               grad: bool = False):
    """The mean of 8 passes at spp0..spp0+7, seed REF_SEED; under autograd
    only with `grad`."""
    from craytracer_tpu_torch.integrator.wavefront import render_sample

    ids = torch.arange(film.num_pixels, dtype=torch.int32,
                       device=scene.device)
    with torch.set_grad_enabled(grad):
        img = 0.0
        for k in range(8):
            img = img + render_sample(scene, cam, film, ids, REF_SEED,
                                      spp0 + k, cfg.max_depth,
                                      estimator=cfg.estimator)
        return img / 8


def demo(size: int = 64, tex: int = 64, steps: int = 300, device=None):
    """Everything InverseRenderer needs: {scene, scene_true, cam, film,
    ball_mid, apply_fn, params0, config, target}."""
    dev = resolve_device(device)
    scene, ball_mid = build(checker(tex), device=dev)
    apply_fn = grafter(scene, ball_mid)
    truth = {"texels": torch.from_numpy(checker(tex).reshape(-1, 3)).to(dev),
             "alpha": torch.tensor(ALPHA_TRUE, device=dev)}
    cam = make_camera(EYE, LOOK, device=dev)
    film = Film(fov=torch.tensor(np.radians(FOV_DEG), dtype=torch.float32,
                                 device=dev), width=size, height=size)
    cfg = config(steps)
    scene_true = apply_fn(scene, truth)
    params0 = {"texels": torch.full((tex * tex, 3), TEXEL0, device=dev),
               "alpha": torch.tensor(ALPHA0, device=dev)}
    return {"scene": scene, "scene_true": scene_true, "cam": cam,
            "film": film, "ball_mid": ball_mid, "apply_fn": apply_fn,
            "params0": params0, "truth": truth, "config": cfg,
            "target": render_ref(scene_true, cam, film, 0, cfg)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--tex", type=int, default=64)
    ap.add_argument("--out", default="gallery",
                    help="directory for the _torch panel and curve")
    args = ap.parse_args(argv)
    # before the first cuBLAS call, for a bit-exact resume (inverse.py)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_CONFIG)
    from craytracer_tpu_torch.io.image import write_ppm
    from craytracer_tpu_torch.utils.tonemap import tone_map

    d = demo(args.size, args.tex, args.steps, args.device)
    K, s = args.tex, args.size
    scene, cam, film, cfg = d["scene"], d["cam"], d["film"], d["config"]
    apply_fn, target = d["apply_fn"], d["target"]

    def fresh():
        return InverseRenderer(scene, cam, film, target, d["params0"],
                               apply_fn, config=cfg, clip_fn=clip_fn)

    inv = fresh()
    img0 = render_ref(apply_fn(scene, inv.params), cam, film, 40, cfg)
    half = max(args.steps // 2, 1)
    inv.run(half, log_every=10)
    # InverseRenderer's bit-exact checkpoint/resume, mid-run
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "inv_mesh_ckpt.pt")
        inv.save_state(ck)
        inv2 = fresh().load_state(ck)
    inv2.run(args.steps - half, log_every=10)

    rec = {k: v.detach() for k, v in inv2.params.items()}
    truth = d["truth"]
    tex_err = float((rec["texels"] - truth["texels"]).abs().mean())
    # constrained-texel MAE: the texels the image constrains (a nonzero
    # gradient at the truth); out-of-frame or occluded texels have no
    # signal in any inverse renderer
    at_truth = {k: v.clone().requires_grad_(True) for k, v in truth.items()}
    diff = render_ref(apply_fn(scene, at_truth), cam, film, 7, cfg,
                      grad=True) - target
    torch.mean(diff * diff).backward()
    vis = at_truth["texels"].grad.abs().sum(-1) > 0
    tex_err_vis = float((rec["texels"] - truth["texels"])[vis].abs().mean())
    nan = inv.nan_steps + inv2.nan_steps
    print(f"recovered alpha {float(rec['alpha']):.4f} (true {ALPHA_TRUE}), "
          f"texel MAE {tex_err:.4f} all / {tex_err_vis:.4f} over the "
          f"{int(vis.sum())}/{K * K} constrained texels, nan-skipped steps "
          f"{nan}")
    img1 = render_ref(apply_fn(scene, rec), cam, film, 80, cfg)

    os.makedirs(args.out, exist_ok=True)
    curve = os.path.join(args.out, "inverse_mesh_curve_torch.json")
    with open(curve, "w") as f:
        json.dump({"steps": args.steps, "tex": f"{K}x{K}x3",
                   "n_params": int(3 * K * K + 1), "alpha_true": ALPHA_TRUE,
                   "alpha_recovered": float(rec["alpha"]),
                   "texel_mae": tex_err,
                   "texel_mae_constrained": tex_err_vis,
                   "constrained_texels": int(vis.sum()),
                   "loss_curve": [h[0] for h in inv2.history]}, f, indent=1)

    def to8(x, k):
        a = tone_map(x.detach()).cpu().numpy().reshape(k, k, 3)
        return (np.clip(a, 0, 1) * 255).astype(np.uint8)

    panel = np.zeros((max(s, K), s * 3 + K * 2 + 16, 3), np.uint8)
    panel[:s, 0:s] = to8(target, s)
    panel[:s, s:2 * s] = to8(img0, s)
    panel[:s, 2 * s:3 * s] = to8(img1, s)
    panel[:K, 3 * s + 8:3 * s + 8 + K] = (checker(K) * 255).astype(np.uint8)
    panel[:K, 3 * s + K + 16:3 * s + 2 * K + 16] = (
        np.clip(rec["texels"].cpu().numpy().reshape(K, K, 3), 0, 1)
        * 255).astype(np.uint8)
    out = os.path.join(args.out, "inverse_mesh_recovery_torch.ppm")
    write_ppm(out, panel)
    print(f"wrote {out} and {curve}")
    return rec


if __name__ == "__main__":
    main()
