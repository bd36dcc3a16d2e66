"""The port's Renderer leftovers (craytracer_tpu_torch/integrator/render.py)
on the CPU, against themselves and against the JAX Renderer:

- `_probe`'s printout against the JAX Renderer's;
- tiled (tile_pixels not dividing the image) against untiled within
  1e-6, raster against Morton order bit-equal, a render resumed from its
  saved `.npz` (2 + 2 spp) bit-equal with 4 straight, one seed twice
  bit-equal and another seed different; each of them against the JAX
  Renderer's image of parity_cornell at 16x16 x 4 spp, depth 5, within
  the North star's radiance bar (2e-5, rtol and atol, every pixel);
- spp_batch=0: `auto_spp_batch` is a pure function of the device type,
  accel, triangle count and lanes per spp (1 on the CPU, 7 for a 512x512
  bvh4 scene of 20,480 triangles on the card), and a CPU Renderer
  resolves it to 1;
- a batched render (spp_batch=2) of parity_mesh_mid at depth 8, where
  both packages compact the stream after bounce 2, against the JAX
  Renderer's (2e-5), and bit-equal with the same render kept dense;
- the live views' fields refused, naming ROADMAP slice F, part 3."""

import numpy as np
import pytest
import torch

from craytracer_tpu.integrator import RenderConfig as JConfig
from craytracer_tpu.integrator import Renderer as JRenderer
from craytracer_tpu_torch.integrator import wavefront as wf
from craytracer_tpu_torch.integrator.render import (RenderConfig, Renderer,
                                                    auto_spp_batch)
from craytracer_tpu_torch.io.imagestate import (load_image_state,
                                                save_image_state)
from torch_jax_native import SAH_WARNING_IS_ERROR, jax_native  # noqa: F401
from torch_slice_f import load_both

torch.set_num_threads(2)
pytestmark = SAH_WARNING_IS_ERROR
BAR = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def cornell():
    (js, jc, jf), (ts, tc, tf) = load_both("parity_cornell", 16)
    jr = JRenderer(js, jc, jf, JConfig(num_samples=4, max_depth=5, seed=3))
    jr.render()
    return (ts, tc, tf), np.asarray(jr.raw_mean()), jr


def _render(scn, seed=3, **kw):
    r = Renderer(*scn, RenderConfig(num_samples=4, max_depth=5, seed=seed,
                                    **kw))
    r.render()
    return r


def test_renderer_options_against_each_other_and_jax(cornell, tmp_path):
    scn, ref, _ = cornell
    base = _render(scn)
    assert base.passes == 4 and base.spp_done == 4 and base.nan_count == 0
    np.testing.assert_allclose(base.raw_mean(), ref, **BAR)

    tiled = _render(scn, tile_pixels=100)
    assert tiled.passes == 4 * 3
    np.testing.assert_allclose(tiled.raw_mean(), base.raw_mean(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tiled.raw_mean(), ref, **BAR)

    raster = _render(scn, ray_order="raster")
    assert np.array_equal(raster.raw_mean(), base.raw_mean())

    half = Renderer(*scn, RenderConfig(num_samples=2, max_depth=5, seed=3))
    half.render()
    path = str(tmp_path / "half_state")
    save_image_state(path, half.accum, half.spp_done, 3)
    accum, spp, seed = load_image_state(path)
    resumed = Renderer(*scn, RenderConfig(num_samples=2, max_depth=5,
                                          seed=seed))
    resumed.resume_from(accum, spp)
    resumed.render()
    assert resumed.spp_done == 4
    assert np.array_equal(resumed.raw_mean(), base.raw_mean())
    assert np.array_equal(resumed.image(), base.image())

    assert np.array_equal(_render(scn).raw_mean(), base.raw_mean())
    assert not np.array_equal(_render(scn, seed=4).raw_mean(),
                              base.raw_mean())


def test_probe_matches_jax(cornell, capsys):
    """`_probe` prints a pixel's accumulator, mean and tone-mapped mean
    as the JAX Renderer's does: the same words, numbers within 2e-5."""
    import re

    scn, _, jr = cornell
    _render(scn)._probe(7, 5, 4)
    jr._probe(7, 5, 4)
    ours, ref = capsys.readouterr().out.splitlines()
    num = re.compile(r"-?\d+\.?\d*(?:e-?\d+)?")
    assert num.sub("#", ours) == num.sub("#", ref)
    np.testing.assert_allclose([float(x) for x in num.findall(ours)],
                               [float(x) for x in num.findall(ref)], **BAR)


def test_auto_spp_batch():
    assert auto_spp_batch("cuda", "bvh4", 20480, 512 * 512) == 7
    assert auto_spp_batch("cpu", "bvh4", 20480, 512 * 512) == 1
    assert auto_spp_batch("cuda", "none", 20480, 512 * 512) == 1
    assert auto_spp_batch("cuda", "bvh4", 4095, 512 * 512) == 1
    assert auto_spp_batch("cuda", "bvh4", 4096, 65536) == 16
    assert auto_spp_batch("cuda", "bvh4", 4096, 4_000_000) == 1
    _, (ts, tc, tf) = load_both("parity_mesh_mid", 8)
    r = Renderer(ts, tc, tf, RenderConfig(num_samples=3, max_depth=1,
                                          spp_batch=0))
    assert r.spp_batch == 1
    r.render()
    assert r.passes == 3


def test_batched_compacted_render_matches_jax_and_dense():
    (js, jc, jf), (ts, tc, tf) = load_both("parity_mesh_mid", 12)
    jr = JRenderer(js, jc, jf, JConfig(num_samples=4, max_depth=8,
                                       spp_batch=2))
    jr.render()
    before = wf.COMPACTION.traces
    r = Renderer(ts, tc, tf, RenderConfig(num_samples=4, max_depth=8,
                                          spp_batch=2))
    r.render()
    assert r.passes == 2 and wf.COMPACTION.traces == before + 2
    np.testing.assert_allclose(r.raw_mean(), np.asarray(jr.raw_mean()),
                               **BAR)
    dense = Renderer(ts, tc, tf, RenderConfig(num_samples=4, max_depth=8,
                                              spp_batch=2, compact_at=0))
    dense.render()
    assert wf.COMPACTION.traces == before + 2
    assert np.array_equal(dense.raw_mean(), r.raw_mean())


@pytest.mark.parametrize("field,value", [("preview_path", "x.png"),
                                         ("serve_port", 8080),
                                         ("ansi_every", 1),
                                         ("interactive", True)])
def test_live_views_are_refused(field, value):
    with pytest.raises(NotImplementedError, match="slice F, part 3"):
        RenderConfig(**{field: value})
