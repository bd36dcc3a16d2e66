"""Shared inputs of the slice-F port tests: a scene file loaded by both
packages at a small film, a scene built by both builders from one
function, the JAX camera rays of a film as numpy arrays, and the NaN
scene of tests/test_nan_log.py."""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import torch

from craytracer_tpu.camera import Film as JFilm
from craytracer_tpu.camera import generate_rays as j_generate_rays
from craytracer_tpu.camera import make_camera as j_make_camera
from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.sampling.multijitter import stratified_jitter as j_strat
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.camera import Film, make_camera
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.scene.build import SceneBuilder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
SEED = 7


def scene_path(name: str) -> str:
    return os.path.join(SCENES, name + ".txt")


def load_both(name: str, width: int, height: int = 0, accel="auto"):
    """((jax scene, camera, film), (port scene, camera, film)) of
    scenes/<name>.txt at a width x height film (square by default)."""
    height = height or width
    js, jc, jf = j_load(scene_path(name), accel=accel)
    ts, tc, tf = load_scene_file(scene_path(name), accel=accel,
                                 device="cpu")
    return ((js, jc, jf.replace(width=width, height=height)),
            (ts, tc, Film(fov=tf.fov, width=width, height=height)))


def build_both(fn, accel="auto"):
    """(jax scene, port scene) of `fn(builder)` run on each builder."""
    jb, tb = JBuilder(), SceneBuilder()
    fn(jb)
    fn(tb)
    return jb.build(accel=accel), tb.build(accel=accel, device="cpu")


def jax_rays(jc, jf, spp: int = 2):
    """(o, d, pix, spp) numpy: every pixel of the film at spp 3, 4, ...,
    through the JAX raygen with the stratified jitter."""
    n = jf.width * jf.height
    pix = np.tile(np.arange(n, dtype=np.int32), spp)
    spp_l = np.repeat(np.arange(spp, dtype=np.int32), n) + 3
    o, d = j_generate_rays(jc, jf, jnp.asarray(pix),
                           j_strat(SEED, jnp.asarray(pix),
                                   jnp.asarray(spp_l)))
    return np.array(o), np.array(d), pix, spp_l


def t(x):
    return torch.from_numpy(np.asarray(x))


def nan_scene(b):
    """tests/test_nan_log.py's scene: a NaN emissive sphere on a floor
    under a lamp, so every camera ray that hits the sphere adds NaN at
    bounce 0."""
    b.add_matte("floor", (0.7, 0.7, 0.7))
    b.add_emissive("bad", (float("nan"), 1.0, 1.0), intensity=5.0)
    b.add_emissive("lamp", (1.0, 0.95, 0.9), intensity=10.0)
    b.add_rect((-4, 0, -4), (8, 0, 0), (0, 0, 8), "floor")
    b.add_sphere((0.0, 0.8, 0.0), 0.6, "bad")
    b.add_rect((-1, 3, -1), (2, 0, 0), (0, 0, 2), "lamp")


def nan_view(size: int, device="cpu"):
    """((jax camera, film), (port camera, film)) of the NaN scene."""
    fov = np.radians(45.0)
    return ((j_make_camera((0, 2, 4), (0, 0.6, 0)),
             JFilm(fov=jnp.float32(fov), width=size, height=size)),
            (make_camera((0, 2, 4), (0, 0.6, 0), device=device),
             Film(fov=torch.tensor(fov, dtype=torch.float32, device=device),
                  width=size, height=size)))
