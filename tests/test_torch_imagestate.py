"""Slice F's file formats against the JAX package: the `.npz` image state
(craytracer_tpu_torch/io/imagestate.py `save_image_state` /
`load_image_state`) written by either package and read by the other with
equal arrays, `write_reference_is` byte-equal, `ppm_to_image_state`
within 1e-6, and `parse_config` (io/config.py) field for field on a
config text with every key, a comment and a short line."""

import numpy as np
import pytest

from craytracer_tpu.io import config as j_config
from craytracer_tpu.io import imagestate as j_is
from craytracer_tpu.io.image import write_ppm as j_write_ppm
from craytracer_tpu_torch.io import config as t_config
from craytracer_tpu_torch.io import imagestate as t_is


def _accum(seed=0, n=12 * 10):
    return np.random.default_rng(seed).random((n, 3)).astype(np.float32) * 5


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_image_state_npz_reads_across_packages(tmp_path, writer):
    import torch

    acc = _accum(1)
    path = str(tmp_path / "state")
    if writer == "jax":
        j_is.save_image_state(path, acc, 37, 1234)
        got = t_is.load_image_state(path)
    else:
        t_is.save_image_state(path, torch.from_numpy(acc), 37, 1234)
        got = j_is.load_image_state(path + ".npz")
    a, spp, seed = got
    assert a.dtype == np.float32 and np.array_equal(a, acc)
    assert (spp, seed) == (37, 1234)
    d = np.load(path + ".npz")
    assert sorted(d.files) == ["accum", "seed", "spp"]
    assert d["spp"].dtype == np.int64 and d["seed"].dtype == np.int64


def test_write_reference_is_is_byte_equal(tmp_path):
    acc = _accum(2)
    j_is.write_reference_is(str(tmp_path / "j.is"), acc, 9, 12, 10)
    t_is.write_reference_is(str(tmp_path / "t.is"), acc, 9, 12, 10)
    jb = (tmp_path / "j.is").read_bytes()
    assert jb == (tmp_path / "t.is").read_bytes()
    a, spp, w, h = t_is.read_reference_is(str(tmp_path / "t.is"))
    assert np.array_equal(a, acc) and (spp, w, h) == (9, 12, 10)
    with pytest.raises(ValueError):
        t_is.write_reference_is(str(tmp_path / "x.is"), acc, 9, 12, 11)


def test_ppm_to_image_state_matches_jax(tmp_path):
    img = np.random.default_rng(3).random((10, 12, 3)).astype(np.float32)
    path = str(tmp_path / "img.ppm")
    j_write_ppm(path, img)
    ref = j_is.ppm_to_image_state(path, spp=16)
    got = t_is.ppm_to_image_state(path, spp=16)
    assert got.shape == ref.shape == (120, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


CONFIG = """# the reference's config.txt grammar
scene_file scenes/parity_cornell.txt
num_samples 64
num_sample_sets 17
max_depth 7
trace_type WHITTED
accel_struct BVH4
image_save yes
caustic_map TRUE
short
unknown_key 5
#num_samples 3
"""


def test_parse_config_matches_jax(tmp_path):
    path = tmp_path / "config.txt"
    path.write_text(CONFIG)
    ref = j_config.parse_config(str(path))
    got = t_config.parse_config(str(path))
    assert vars(got) == vars(ref)
    assert got.num_samples == 64 and got.caustic_map and got.image_save
    # an empty file keeps every default, the reference's too
    empty = tmp_path / "empty.txt"
    empty.write_text("\n")
    assert (vars(t_config.parse_config(str(empty)))
            == vars(j_config.parse_config(str(empty)))
            == vars(t_config.ConfigParams()))
