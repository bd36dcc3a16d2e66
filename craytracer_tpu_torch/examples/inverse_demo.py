"""Inverse rendering: recover the back wall's and the sphere's albedo from
a target image by gradient descent through the wavefront tracer, with
InverseRenderer (counterpart of examples/inverse_demo.py).

Scene: a floor, a back wall and a matte sphere under a rect lamp. The
target renders the wall at (0.15, 0.45, 0.72) and the sphere at (0.7,
0.25, 0.1); the guess starts both at 0.5 grey. Parameters: the two
colour rows (6 numbers), through InverseRenderer (physical estimator,
depth 3, Adam at 0.04, 4 spp a step, seed 7), each clipped to [0.02, 1]
after every update.

    python -m craytracer_tpu_torch.examples.inverse_demo \\
        [--device cpu] [--steps 60] [--size 32] \\
        [--out gallery/inverse_recovery_torch.png]

prints the loss every 10 steps and the recovered albedos beside the
targets, and writes target | init | recovered as a PNG (the port's own
writer), each panel scaled 4x. `demo` builds the pieces for other
callers (chip_smoke.py, the tests).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from craytracer_tpu_torch.camera import Film, make_camera
from craytracer_tpu_torch.inverse import InverseConfig, InverseRenderer
from craytracer_tpu_torch.scene.build import SceneBuilder
from craytracer_tpu_torch.scene.types import resolve_device

TARGET_BACK = (0.15, 0.45, 0.72)
TARGET_BALL = (0.7, 0.25, 0.1)
GUESS = (0.5, 0.5, 0.5)
EYE, LOOK, FOV_DEG = (0, 1.4, 4.5), (0, 0.9, 0), 42.0
SEED, DEPTH = 7, 3


def build(back_albedo, sphere_albedo, device=None):
    """(scene, the back wall's material row, the sphere's)."""
    b = SceneBuilder()
    b.add_matte("floor", (0.73, 0.73, 0.73))
    i_back = b.add_matte("back", tuple(back_albedo))
    i_ball = b.add_matte("ball", tuple(sphere_albedo))
    b.add_emissive("light", (1.0, 0.95, 0.85), 18.0)
    b.add_rect((-3, 0, -3), (6, 0, 0), (0, 0, 6), "floor")
    b.add_rect((-3, 0, -2), (6, 0, 0), (0, 3.5, 0), "back")
    b.add_sphere((0.0, 0.8, 0.3), 0.7, "ball")
    b.add_rect((-1, 3.2, -1), (2, 0, 0), (0, 0, 2), "light")
    return b.build(device=device), i_back, i_ball


def grafter(i_back: int, i_ball: int):
    """apply_fn(scene, (back, ball)): the two colour rows set, out of
    place."""

    def apply_fn(scene, p):
        back, ball = p
        m = scene.materials
        row = torch.arange(m.color.shape[0], device=m.color.device)[:, None]
        color = torch.where(row == i_back, back,
                            torch.where(row == i_ball, ball, m.color))
        return dataclasses.replace(scene, materials=dataclasses.replace(
            m, color=color))

    return apply_fn


def clip_fn(p):
    return tuple(torch.clamp(x, 0.02, 1.0) for x in p)


def config() -> InverseConfig:
    return InverseConfig(learning_rate=0.04, max_depth=DEPTH)


def render(scene, cam, film, spp: int, n_avg: int = 4):
    """The mean of `n_avg` physical passes at spp indices spp.., no
    autograd."""
    from craytracer_tpu_torch.integrator.wavefront import render_sample

    ids = torch.arange(film.num_pixels, dtype=torch.int32,
                       device=scene.device)
    with torch.no_grad():
        acc = 0.0
        for s in range(n_avg):
            acc = acc + render_sample(scene, cam, film, ids, SEED, spp + s,
                                      DEPTH, estimator="physical")
        return acc / n_avg


def demo(size: int = 32, device=None):
    """Everything the demo's InverseRenderer needs: {scene0, scene_t, cam,
    film, target, params0, apply_fn, config, rows}."""
    dev = resolve_device(device)
    scene_t, i_back, i_ball = build(TARGET_BACK, TARGET_BALL, device=dev)
    scene0, _, _ = build(GUESS, GUESS, device=dev)
    cam = make_camera(EYE, LOOK, device=dev)
    film = Film(fov=torch.tensor(np.radians(FOV_DEG), dtype=torch.float32,
                                 device=dev), width=size, height=size)
    m = scene0.materials
    return {"scene0": scene0, "scene_t": scene_t, "cam": cam, "film": film,
            "target": render(scene_t, cam, film, 0),
            "params0": (m.color[i_back], m.color[i_ball]),
            "apply_fn": grafter(i_back, i_ball), "config": config(),
            "rows": (i_back, i_ball)}


def renderer(d) -> InverseRenderer:
    return InverseRenderer(d["scene0"], d["cam"], d["film"], d["target"],
                           d["params0"], d["apply_fn"], d["config"],
                           seed=SEED, clip_fn=clip_fn)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--out", default="gallery/inverse_recovery_torch.png")
    args = ap.parse_args(argv)
    from craytracer_tpu_torch.io.image import write_png
    from craytracer_tpu_torch.utils.tonemap import tone_map

    d = demo(args.size, args.device)
    inv = renderer(d)
    inv.run(args.steps, log_every=10)
    back, ball = ([round(float(v), 3) for v in x.detach()]
                  for x in inv.params)
    print(f"recovered back wall {back} (target {list(TARGET_BACK)})")
    print(f"recovered sphere    {ball} (target {list(TARGET_BALL)})")

    def frame(scene):
        img = tone_map(render(scene, d["cam"], d["film"], 100)).cpu().numpy()
        return (np.clip(img, 0, 1) * 255).astype(np.uint8).reshape(
            args.size, args.size, 3)

    panel = np.concatenate(
        [frame(d["scene_t"]), frame(d["scene0"]),
         frame(d["apply_fn"](d["scene0"], inv.params))], axis=1)
    panel = np.repeat(np.repeat(panel, 4, axis=0), 4, axis=1)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_png(args.out, panel)
    print(f"wrote {args.out} (target | init | recovered)")
    return inv


if __name__ == "__main__":
    main()
