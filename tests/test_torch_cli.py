"""The port's command line (craytracer_tpu_torch/__main__.py) on the CPU
with root render.py's options: a config.txt in the reference grammar
(its scene_file resolved beside it, every key, a comment), --size WxH,
--tile, --stats, --probe, --aov and an .exr output of the linear mean,
the <stem>_state.npz checkpoint; then -s resume, bit-equal with a
straight render of the same spp; a --seed that differs from the
checkpoint's refused; a config's GRID refused on the CPU and an
accelerator of slice I refused, naming their ROADMAP item."""

import shutil

import numpy as np
import pytest
import torch

from craytracer_tpu_torch.__main__ import main
from craytracer_tpu_torch.io.exr import read_exr
from craytracer_tpu_torch.io.imagestate import load_image_state
from torch_slice_f import scene_path

torch.set_num_threads(2)


def _config(tmp_path, accel="BVH4", spp=2, name="parity_cornell"):
    shutil.copy(scene_path(name), tmp_path / "scene.txt")
    path = tmp_path / "config.txt"
    path.write_text(f"# a render\nscene_file scene.txt\nnum_samples {spp}\n"
                    f"num_sample_sets 5\nmax_depth 4\ntrace_type PATHTRACE\n"
                    f"accel_struct {accel}\nimage_save yes\ncaustic_map no\n")
    return str(path)


def test_cli_config_options_and_resume(tmp_path, capsys):
    cfg = _config(tmp_path, accel="NONE")
    out = str(tmp_path / "a.exr")
    common = ["--config", cfg, "--device", "cpu", "--size", "20x12"]
    assert main(common + ["--tile", "100", "--stats", "--probe", "3,4",
                          "--aov", "normal,depth,albedo,uv", "--seed", "5",
                          "-o", out]) == 0
    text = capsys.readouterr().out
    assert "rays: 240" in text and "tests 1920" in text  # 8 rects
    assert "probe (3,4): accum=" in text and "spp=2" in text
    assert "20x12 2 spp depth 4 on cpu, route bounce" in text
    assert "spp batch 1" in text and "6 passes" in text  # 3 tiles x 2
    accum, spp, seed = load_image_state(str(tmp_path / "a_state.npz"))
    assert (spp, seed) == (2, 5) and accum.shape == (240, 3)
    img = read_exr(out)
    assert img.shape == (12, 20, 3)
    np.testing.assert_array_equal(img.reshape(-1, 3),
                                  (accum / 2).astype(np.float32))
    for aov in ("normal", "depth", "albedo", "uv"):
        a = read_exr(str(tmp_path / f"a_{aov}.exr"))
        assert a.shape == (12, 20, 3) and np.isfinite(a).all()

    # resume 2 + 2 spp == 4 straight, bit for bit
    assert main(common + ["-s", str(tmp_path / "a_state.npz"), "-o",
                          str(tmp_path / "b.ppm")]) == 0
    assert "resumed from" in capsys.readouterr().out
    assert main(common + ["--spp", "4", "--seed", "5", "-o",
                          str(tmp_path / "c.ppm")]) == 0
    b, spp_b, seed_b = load_image_state(str(tmp_path / "b_state.npz"))
    c, spp_c, seed_c = load_image_state(str(tmp_path / "c_state.npz"))
    assert (spp_b, seed_b) == (spp_c, seed_c) == (4, 5)
    assert np.array_equal(b, c)
    assert (tmp_path / "b.ppm").read_bytes() == \
        (tmp_path / "c.ppm").read_bytes()

    # another seed into the same accumulator is refused
    assert main(common + ["-s", str(tmp_path / "a_state.npz"), "--seed",
                          "6", "-o", str(tmp_path / "d.ppm")]) == 1
    assert "differs from the checkpoint" in capsys.readouterr().err


def test_cli_refuses_what_the_port_lacks(tmp_path, capsys):
    cfg = _config(tmp_path, accel="GRID")
    with pytest.raises(NotImplementedError, match="slice I"):
        main(["--config", cfg, "--device", "cpu", "--size", "8"])
    with pytest.raises(NotImplementedError, match="slice I"):
        main([scene_path("parity_cornell"), "--device", "cpu", "--size",
              "8", "--accel", "bvh"])
    assert main(["--device", "cpu"]) == 1
    assert "--config" in capsys.readouterr().err
