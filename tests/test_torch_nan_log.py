"""The NaN-log retrace (craytracer_tpu_torch/integrator/render.py
`_write_nan_log`, wavefront.py `trace_paths_logged`): the counterparts
of tests/test_nan_log.py's two tests on the port's Renderer (a NaN
emissive sphere poisons every sample that sees it at bounce 0: the log
is written with per-bounce records and a non-finite retraced L, and the
image stays finite), then the port's log against the JAX Renderer's on
the same scene and config: the same samples (pixels, spp, seed) in the
same order, the same lines with the same words, and every number equal
to 2e-5 relative (or both non-finite). Then `trace_paths_logged` against
the JAX one on parity_mix, and the logged general step's outputs
bit-equal with the unlogged step's."""

import re

import jax.numpy as jnp
import numpy as np
import torch

from craytracer_tpu.integrator import RenderConfig as JConfig
from craytracer_tpu.integrator import Renderer as JRenderer
from craytracer_tpu.integrator.wavefront import \
    trace_paths_logged as j_logged
from craytracer_tpu_torch.integrator import wavefront as wf
from craytracer_tpu_torch.integrator.render import RenderConfig, Renderer
from torch_slice_f import SEED, build_both, jax_rays, load_both, nan_scene, \
    nan_view, t

torch.set_num_threads(2)
NUM = re.compile(r"[-+]?(?:nan|inf|\d+\.?\d*(?:e[-+]?\d+)?)", re.I)


def _port(size, **kw):
    _, ts = build_both(nan_scene)
    _, (tc, tf) = nan_view(size)
    return Renderer(ts, tc, tf, RenderConfig(**kw))


def test_nan_retrace_log_and_finite_image(tmp_path):
    log_path = str(tmp_path / "trace_log.txt")
    r = _port(32, num_samples=2, max_depth=3, nan_log_path=log_path)
    r.render()
    assert r.nan_count > 0
    assert np.isfinite(r.raw_mean()).all()
    text = open(log_path).read()
    assert "NaN/Inf sample" in text
    assert "bounce 0:" in text and "beta=" in text and "new_pdf=" in text
    # the retrace reproduces the offending path: its L is non-finite
    assert "nan" in text.lower()
    assert text.count("NaN/Inf sample") == 2 * 8  # nan_log_max per pass


def test_nan_log_disabled(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    r = _port(16, num_samples=1, max_depth=2, nan_log_path="")
    r.render()
    assert r.nan_count > 0 and np.isfinite(r.raw_mean()).all()
    assert not (tmp_path / "trace_log.txt").exists()


def _numbers(line):
    return [float(x) for x in NUM.findall(line)]


def test_nan_log_matches_jax(tmp_path):
    kw = dict(num_samples=2, max_depth=3, nan_log_max=3)
    js, ts = build_both(nan_scene)
    (jc, jf), (tc, tf) = nan_view(16)
    jr = JRenderer(js, jc, jf, JConfig(nan_log_path=str(tmp_path / "j.txt"),
                                       **kw))
    jr.render()
    tr = Renderer(ts, tc, tf, RenderConfig(
        nan_log_path=str(tmp_path / "t.txt"), **kw))
    tr.render()
    assert tr.nan_count == jr.nan_count > 0
    np.testing.assert_allclose(tr.raw_mean(), np.asarray(jr.raw_mean()),
                               rtol=2e-5, atol=2e-5)
    ours = (tmp_path / "t.txt").read_text().splitlines()
    ref = (tmp_path / "j.txt").read_text().splitlines()
    assert len(ours) == len(ref) == 2 * 3 * (1 + 4 + 1)
    for a, b in zip(ours, ref):
        if a.startswith("NaN/Inf sample"):
            assert a == b  # pixel, id, spp, seed
        assert NUM.sub("#", a) == NUM.sub("#", b)
        x, y = np.array(_numbers(a)), np.array(_numbers(b))
        both_bad = ~np.isfinite(x) & ~np.isfinite(y)
        with np.errstate(invalid="ignore"):
            close = np.abs(x - y) <= 2e-5 * np.abs(y)
        assert (both_bad | close).all(), (a, b)
    assert any("L=(nan" in line for line in ours)


def test_trace_paths_logged_matches_jax():
    (js, jc, jf), (ts, _, _) = load_both("parity_mix", 8)
    o, d, pix, spp = jax_rays(jc, jf, 1)
    Lr, goodr, logr = j_logged(js, jnp.asarray(o), jnp.asarray(d), SEED,
                               jnp.asarray(pix), jnp.asarray(spp), 4)
    L, good, log = wf.trace_paths_logged(ts, t(o), t(d), SEED, t(pix),
                                         t(spp), 4)
    np.testing.assert_array_equal(good.numpy(), np.asarray(goodr))
    np.testing.assert_allclose(L.numpy(), np.asarray(Lr), rtol=2e-5,
                               atol=2e-5)
    assert set(log) == set(logr)
    for k in log:
        assert log[k].shape == logr[k].shape, k
        if k == "alive":
            np.testing.assert_array_equal(log[k].numpy(), np.asarray(logr[k]))
        else:
            np.testing.assert_allclose(log[k].numpy(), np.asarray(logr[k]),
                                       rtol=2e-5, atol=2e-5, err_msg=k)
    # asking for the log leaves the step's outputs bit-equal
    L2, good2, m = wf.trace_paths(ts, t(o), t(d), SEED, t(pix), t(spp), 4,
                                  with_metrics=True, general=True)
    assert torch.equal(L, L2) and torch.equal(good, good2)
