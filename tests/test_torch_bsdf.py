"""The port's local-frame BSDF helpers (craytracer_tpu_torch/bsdf/
microfacet.py and fresnel.py, which the plain shading calls and
csrc/shade_core.cuh repeats) against the JAX package: the component
helpers of integrator/pallas_shade.py :113-237, and the general
bsdf/microfacet.py, bsdf/fresnel.py, bsdf/bxdf.py and core/math.py
functions at ax == ay with DIST_BECKMANN.

Inputs: 4,096 seeded directions per argument (uniform on the sphere, so
half lie below the horizon, plus grazing ones with |z| down to 1e-8,
the poles and near-pole ones), alphas in [1e-5, 0.9] (below 1e-4 the
helpers clamp), the Oren-Nayar A/B of sigma 0-40 degrees, the metal
presets' eta/k (at cos in [0, 1], where the reflected half-vector puts
it) and dielectric IORs both ways round. Bar: rtol 1e-5 (atol 1e-6 for
values near 0): XLA:CPU contracts multiply-adds into FMAs and evaluates
exp and log with its own approximations, so the two packages agree to a
few ulps, not bit for bit. The sampled half-vector's x and y get atol
1e-5: sin_t = sqrt(1 - cos_t^2) turns an ulp of cos_t near 1 (small
alphas) into ~1e-6 of sin_t (measured: at most 4.3e-6 on 6 of 12,288
components)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import craytracer_tpu.integrator.pallas_shade as ps
from craytracer_tpu.bsdf import bxdf as jbxdf
from craytracer_tpu.bsdf import fresnel as jfr
from craytracer_tpu.bsdf import microfacet as jmf
from craytracer_tpu.core import math as jvm
from craytracer_tpu.scene.types import DIST_BECKMANN
from craytracer_tpu_torch.bsdf import fresnel as fr
from craytracer_tpu_torch.bsdf import microfacet as mf
from craytracer_tpu_torch.constants import METAL_PRESETS

torch.set_num_threads(2)
N = 4096
TOL = dict(rtol=1e-5, atol=1e-6)


def _dirs(rng):
    """[N, 3] unit f32 directions: random, grazing, poles, near-poles."""
    v = rng.normal(size=(N, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    k = 0
    for z in (0.0, 1e-8, -1e-8, 1e-6, -1e-6, 1e-4, -1e-4, 1e-3, -1e-3):
        for a in np.linspace(0.0, 2.0 * np.pi, 16, endpoint=False):
            s = math.sqrt(1.0 - z * z)
            v[k] = (s * math.cos(a), s * math.sin(a), z)
            k += 1
    for p in ((0, 0, 1), (0, 0, -1), (1e-7, 0, 1), (0, -1e-7, -1),
              (1e-4, 1e-4, 1)):
        v[k] = np.asarray(p) / np.linalg.norm(p)
        k += 1
    return v.astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2024)
    wi, wo, wh = _dirs(rng), _dirs(rng), _dirs(rng)
    ax = rng.uniform(0.001, 0.9, N).astype(np.float32)
    ax[:64] = rng.uniform(1e-5, 2e-4, 64)
    sig = np.radians(rng.uniform(0.0, 40.0, N)) ** 2
    on_a = (1.0 - sig / (2.0 * (sig + 0.33))).astype(np.float32)
    on_b = (0.45 * sig / (sig + 0.09)).astype(np.float32)
    u = rng.random((N, 2)).astype(np.float32)
    u[:32, 0] = 0.0  # log(0) is clamped at 1e-30
    cos_i = rng.uniform(-1.0, 1.0, N).astype(np.float32)
    ior = np.where(rng.random(N) < 0.5, 1.5, 1.0).astype(np.float32)
    presets = list(METAL_PRESETS.values())
    pick = rng.integers(0, len(presets), N)
    eta = np.array([presets[i][0] for i in pick], np.float32)
    k = np.array([presets[i][1] for i in pick], np.float32)
    return dict(wi=wi, wo=wo, wh=wh, ax=ax, on_a=on_a, on_b=on_b, u=u,
                cos_i=cos_i, ior=ior, eta=eta, k=k)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(x)


def _close(ours, ref, name):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), err_msg=name,
                               **TOL)


def _cols(v):
    return v[:, 0], v[:, 1], v[:, 2]


def test_frame_trig(data):
    w = data["wh"]
    x, y, z = (_t(c) for c in _cols(w))
    jx, jy, jz = (_j(c) for c in _cols(w))
    for ours, helper, general in (
            (mf.lf_sin_theta(z), ps._lf_sin_theta(jz), jvm.sin_theta(_j(w))),
            (mf.lf_cos_phi(x, z), ps._lf_cos_phi(jx, jz), jvm.cos_phi(_j(w))),
            (mf.lf_sin_phi(y, z), ps._lf_sin_phi(jy, jz),
             jvm.sin_phi(_j(w)))):
        _close(ours, helper, "helper")
        _close(ours, general, "general")


def test_oren_nayar_and_fresnel_blend_diffuse(data):
    wi, wo = data["wi"], data["wo"]
    a, b = data["on_a"], data["on_b"]
    ours = mf.on_scale(*(_t(c) for c in _cols(wi) + _cols(wo)), _t(a), _t(b))
    _close(ours, ps._on_scale(*(_j(c) for c in _cols(wi) + _cols(wo)),
                              _j(a), _j(b)), "on helper")
    ones = jnp.ones((N, 3), jnp.float32)
    _close(ours, jbxdf._oren_nayar_f(_j(wi), _j(wo), ones, _j(a), _j(b))[:, 0],
           "on general")
    fb = mf.fb_diffuse_scale(_t(wi[:, 2]), _t(wo[:, 2]))
    _close(fb, ps._fb_diffuse_scale(_j(wi[:, 2]), _j(wo[:, 2])), "fb helper")
    _close(fb, jbxdf._fb_diffuse_f(_j(wi), _j(wo), ones,
                                   jnp.zeros((N, 3), jnp.float32))[:, 0],
           "fb general")


def test_beckmann_d_and_lambda(data):
    w, ax = data["wh"], data["ax"]
    dist = jnp.full((N,), DIST_BECKMANN, jnp.int32)
    d = mf.d_beckmann(*(_t(c) for c in _cols(w)), _t(ax))
    _close(d, ps._d_beckmann(*(_j(c) for c in _cols(w)), _j(ax)), "D helper")
    _close(d, jmf.distribution_d(_j(w), _j(ax), _j(ax), dist), "D general")
    assert bool((d > 0).any()) and bool((d == 0).any())
    lam = mf.lambda_beckmann(*(_t(c) for c in _cols(w)), _t(ax))
    _close(lam, ps._lambda_beckmann(*(_j(c) for c in _cols(w)), _j(ax)),
           "Lambda helper")
    _close(lam, jmf.distribution_lambda(_j(w), _j(ax), _j(ax), dist),
           "Lambda general")
    assert bool((lam > 0).any()) and bool((lam == 0).any())


def test_beckmann_half_vector_sample(data):
    wo, u, ax = data["wo"], data["u"], data["ax"]
    ours = torch.stack(mf.sample_wh_beckmann(
        *(_t(c) for c in _cols(wo)), _t(u[:, 0]), _t(u[:, 1]), _t(ax)), 1)
    helper = jnp.stack(ps._sample_wh_beckmann(
        *(_j(c) for c in _cols(wo)), _j(u[:, 0]), _j(u[:, 1]), _j(ax)), 1)
    general = jmf.sample_wh(_j(wo), _j(u), _j(ax), _j(ax),
                            jnp.full((N,), DIST_BECKMANN, jnp.int32))
    for ref, name in ((helper, "wh helper"), (general, "wh general")):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # flipped to wo's side
    assert bool(((ours[:, 2] * _t(wo[:, 2])) >= 0).all())


def test_fresnel(data):
    c, ior = data["cos_i"], data["ior"]
    other = np.where(ior == 1.5, 1.0, 1.5).astype(np.float32)
    ours = fr.fr_dielectric(_t(c), _t(ior), _t(other))
    _close(ours, ps._fr_dielectric(_j(c), _j(ior), _j(other)), "diel helper")
    _close(ours, jfr.fr_dielectric(_j(c), _j(ior), _j(other)),
           "diel general")
    assert bool((ours == 1.0).any())  # total internal reflection
    eta, k = data["eta"], data["k"]
    c = np.abs(c)
    general = jfr.fr_conductor(_j(c), _j(eta), jnp.ones((N, 3), jnp.float32),
                               _j(k))
    for ch in range(3):
        ours = fr.fr_conductor(_t(c), _t(eta[:, ch]), _t(k[:, ch]))
        _close(ours, ps._fr_conductor_c(_j(c), _j(eta[:, ch]),
                                        _j(k[:, ch])), "cond helper")
        _close(ours, general[:, ch], "cond general")
