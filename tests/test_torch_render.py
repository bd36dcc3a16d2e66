"""The port's Renderer end to end on the CPU, against the reference
binary's goldens (tests/goldens/golden_cornell.is and golden_mix.is,
256x256 @ 256 spp) by tone-mapped 8x8 block means with the thresholds of
tests/test_reference_parity.py:143-154; plus the package's import hygiene
and its command line.

Each golden render runs 128x128 @ 64 spp, depth 5, with spp_batch=16,
i.e. four passes of 262,144 lanes through the plain version: about 25 s
(Cornell) and 20 s (parity_mix: spheres, Oren-Nayar, plastic, mirror,
gold) with two torch threads on an x86 CPU."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from craytracer_tpu_torch.camera import Film
from craytracer_tpu_torch.integrator.render import RenderConfig, Renderer
from craytracer_tpu_torch.io.image import read_ppm
from craytracer_tpu_torch.io.imagestate import read_reference_is
from craytracer_tpu_torch.io.scenefile import load_scene_file

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "parity_cornell.txt")
GOLDEN = os.path.join(REPO, "tests", "goldens", "golden_cornell.is")
MIX = os.path.join(REPO, "scenes", "parity_mix.txt")
GOLDEN_MIX = os.path.join(REPO, "tests", "goldens", "golden_mix.is")


def _tonemapped(img):
    return (1.0 - np.exp(-2.0 * np.clip(img, 0.0, None))) ** (1.0 / 2.2)


def _block_means(img, blocks=8):
    h, w, _ = img.shape
    tm = _tonemapped(img).mean(-1)
    return tm.reshape(blocks, h // blocks, blocks, w // blocks).mean(
        axis=(1, 3))


def _render_against_golden(scene_path, golden_path):
    scene, cam, film = load_scene_file(scene_path, device="cpu")
    film = Film(fov=film.fov, width=128, height=128)
    r = Renderer(scene, cam, film,
                 RenderConfig(num_samples=64, max_depth=5,
                              estimator="reference", spp_batch=16))
    img = r.render()
    assert r.passes == 4 and r.nan_count == 0
    assert img.shape == (128, 128, 3) and np.isfinite(img).all()
    ours = r.raw_mean()
    accum, spp, w, h = read_reference_is(golden_path)
    ref = (accum / spp).reshape(h, w, 3)
    full_r, full_o = _tonemapped(ref).mean(), _tonemapped(ours).mean()
    assert abs(full_o - full_r) < 0.02 * max(full_r, 0.05), (full_o, full_r)
    dev = np.abs(_block_means(ours) - _block_means(ref))
    assert dev.max() < 0.05, dev.max()
    assert (dev < 0.02).mean() > 0.9, dev


def test_renderer_matches_reference_golden():
    _render_against_golden(CORNELL, GOLDEN)


def test_renderer_matches_golden_mix():
    """parity_mix goes through the "bounce" route: the whole pass in K1's
    plain version on the CPU."""
    _render_against_golden(MIX, GOLDEN_MIX)


def test_spp_batching_and_morton_order_do_not_change_the_image():
    """B spp per pass and the Morton dispatch order are pure reorders of
    the same counter-RNG samples: the Renderer's image equals the mean of
    raster-order render_sample passes."""
    from craytracer_tpu_torch.integrator.wavefront import render_sample

    scene, cam, film = load_scene_file(CORNELL, device="cpu")
    film = Film(fov=film.fov, width=16, height=12)
    r = Renderer(scene, cam, film, RenderConfig(num_samples=3, max_depth=3,
                                                seed=5, spp_batch=3))
    r.render()
    pix = torch.arange(film.num_pixels, dtype=torch.int32)
    ref = sum(render_sample(scene, cam, film, pix, 5, s, 3)
              for s in range(3)) / 3
    np.testing.assert_allclose(r.raw_mean(), ref.reshape(12, 16, 3).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_import_leaves_jax_out():
    code = ("import sys, craytracer_tpu_torch.integrator.render, "
            "craytracer_tpu_torch.interop, craytracer_tpu_torch.__main__, "
            "craytracer_tpu_torch.io.scenefile, "
            "craytracer_tpu_torch.accel.bvh4_kernel, "
            "craytracer_tpu_torch.integrator.shade_kernel, "
            "craytracer_tpu_torch.integrator.pass_kernel, "
            "craytracer_tpu_torch.profile_render; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'craytracer_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_jax_import_statement_in_the_port():
    import re

    pat = re.compile(r"^\s*(import|from) (jax|flax|craytracer_tpu)\b")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO,
                                                  "craytracer_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pat.match(line), f"{path}:{i}: {line}"


def test_cli_writes_a_ppm(tmp_path):
    out = tmp_path / "cornell.ppm"
    res = subprocess.run(
        [sys.executable, "-m", "craytracer_tpu_torch", CORNELL, "--spp", "2",
         "--depth", "2", "--size", "16", "-o", str(out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "2 passes" in res.stdout
    img = read_ppm(str(out))
    assert img.shape == (16, 16, 3) and img.max() > 0


def test_renderer_refuses_scenes_outside_the_gate():
    """An accelerator the port lacks raises, naming its ROADMAP slice
    (the MIS estimator, refused before slice F, now renders)."""
    scene, cam, film = load_scene_file(CORNELL, device="cpu")
    r = Renderer(dataclasses.replace(scene, accel="grid"), cam,
                 Film(fov=film.fov, width=8, height=8),
                 RenderConfig(num_samples=1))
    with pytest.raises(NotImplementedError, match="slice I"):
        r.render()
