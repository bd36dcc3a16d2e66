"""The general route's lobes (craytracer_tpu_torch/bsdf/bxdf.py, the
general forms of bsdf/microfacet.py, bsdf/fresnel.py and the
core/math.py helpers they call) against the JAX package's
bsdf/bxdf.py, bsdf/microfacet.py, bsdf/fresnel.py and core/math.py.

Inputs: 4,096 seeded lanes of every material type (MATTE with sigma 0-40
degrees, MIRROR, TRANSPARENT, EMISSIVE, PLASTIC, GLASS, METAL with the
metal presets' eta/k), directions uniform on the sphere with grazing
ones and the poles (as tests/test_torch_bsdf.py makes them), alphas in
[1e-3, 0.9], IORs both ways round, uniforms with exact zeros and lanes
at u1 = 0.25 and 0.75, where the anisotropic half-vector sample's
tan(2 pi u1 + pi/2) passes its pole. Each case runs with every lane
Beckmann or Trowbridge-Reitz, at ax == ay or ax != ay; MATTE both as
Oren-Nayar and in the Lambertian specialization. Bar: rtol 1e-5, atol
1e-6, as tests/test_torch_bsdf.py; the sampled directions and the
values computed from them get atol 1e-5 there, for the reason that file
gives (sin_t = sqrt(1 - cos_t^2) near cos_t = 1). Measured: every lane
within those bars, the pole lanes included, but for the sampled f and
pdf of the seven lanes in STEEP_LANES (GLASS 300, 520, 2017 and 3554,
METAL 190, PLASTIC 2550 and 2581; small alphas): there the sampled wi
differs from JAX's by 4e-7 to 7e-6, within its bar, and D's slope turns
that into 1.2e-5 to 2.0e-4 relative (the most: lane 190, METAL,
Trowbridge-Reitz, ax 0.038); on those lanes f and pdf are held to rtol
2e-4."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from craytracer_tpu.bsdf import bxdf as jb
from craytracer_tpu.bsdf import fresnel as jfr
from craytracer_tpu.bsdf import microfacet as jmf
from craytracer_tpu.core import math as jvm
from craytracer_tpu.scene import SceneBuilder as JBuilder
from craytracer_tpu_torch.bsdf import bxdf as tb
from craytracer_tpu_torch.bsdf import fresnel as fr
from craytracer_tpu_torch.bsdf import microfacet as mf
from craytracer_tpu_torch.constants import METAL_PRESETS
from craytracer_tpu_torch.core import math as vm
from craytracer_tpu_torch.scene.build import SceneBuilder

from test_torch_bsdf import _dirs

torch.set_num_threads(2)
N = 4096
TOL = dict(rtol=1e-5, atol=1e-6)
SAMPLE_TOL = dict(rtol=1e-5, atol=1e-5)
FORMS = [("beckmann", "iso"), ("beckmann", "aniso"), ("tr", "iso"),
         ("tr", "aniso")]
ALL_TYPES = frozenset(range(1, 8))
STEEP_LANES = [190, 300, 520, 2017, 2550, 2581, 3554]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _close(ours, ref, name, tol=TOL):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), err_msg=name,
                               **tol)


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(909)
    wi, wo = _dirs(rng), _dirs(rng)
    u = rng.random((N, 3)).astype(np.float32)
    u[:32, 0] = 0.0
    u[32:64, 1] = 0.25
    u[64:96, 1] = 0.75
    u[96:128, 1] = np.nextafter(np.float32(0.25), np.float32(1.0))
    sig = np.radians(rng.uniform(0.0, 40.0, N)) ** 2
    presets = list(METAL_PRESETS.values())
    pick = rng.integers(0, len(presets), N)
    ior = np.where(rng.random(N) < 0.5, 1.5, 1.33).astype(np.float32)
    flip = rng.random(N) < 0.5
    return dict(
        wi=wi, wo=wo, u=u,
        mat_type=rng.integers(1, 8, N).astype(np.int32),
        color=rng.uniform(0.05, 1.0, (N, 3)).astype(np.float32),
        ks=rng.uniform(0.0, 0.6, (N, 3)).astype(np.float32),
        on_a=(1.0 - sig / (2.0 * (sig + 0.33))).astype(np.float32),
        on_b=(0.45 * sig / (sig + 0.09)).astype(np.float32),
        ior_in=np.where(flip, 1.0, ior).astype(np.float32),
        ior_out=np.where(flip, ior, 1.0).astype(np.float32),
        eta3=np.array([presets[i][0] for i in pick], np.float32),
        k3=np.array([presets[i][1] for i in pick], np.float32),
        ax=rng.uniform(1e-3, 0.9, N).astype(np.float32),
        ay=rng.uniform(1e-3, 0.9, N).astype(np.float32),
        intensity=rng.uniform(0.0, 5.0, N).astype(np.float32))


def _params(lanes, form, lambertian_only=False):
    """(JAX MatParams, port MatParams) of the lanes in `form`."""
    dist, iso = form
    ay = lanes["ax"] if iso == "iso" else lanes["ay"]
    distrib = np.full(N, 0 if dist == "beckmann" else 1, np.int32)
    kw = dict(mat_type=lanes["mat_type"], color=lanes["color"],
              ks=lanes["ks"], on_a=lanes["on_a"], on_b=lanes["on_b"],
              ior_in=lanes["ior_in"], ior_out=lanes["ior_out"],
              eta3=lanes["eta3"], k3=lanes["k3"], alphax=lanes["ax"],
              alphay=ay, distrib=distrib, intensity=lanes["intensity"])
    jmp = jb.MatParams(**{k: jnp.asarray(v) for k, v in kw.items()},
                       color_raw=jnp.asarray(lanes["color"]),
                       normal_tex=jnp.full((N,), -1, jnp.int32),
                       lambertian_only=lambertian_only)
    tmp = tb.MatParams(**{k: _t(v) for k, v in kw.items()},
                       lambertian_only=lambertian_only)
    return jmp, tmp


@pytest.mark.parametrize("form", FORMS, ids=["-".join(f) for f in FORMS])
def test_microfacet_general_forms(lanes, form):
    jmp, tmp = _params(lanes, form)
    wi, wo, u = lanes["wi"], lanes["wo"], lanes["u"][:, :2]
    a = (tmp.alphax, tmp.alphay, tmp.distrib)
    ja = (jmp.alphax, jmp.alphay, jmp.distrib)
    _close(mf.distribution_d(_t(wi), *a), jmf.distribution_d(
        jnp.asarray(wi), *ja), "D")
    _close(mf.distribution_lambda(_t(wi), *a), jmf.distribution_lambda(
        jnp.asarray(wi), *ja), "Lambda")
    _close(mf.distribution_g1(_t(wi), *a), jmf.distribution_g1(
        jnp.asarray(wi), *ja), "G1")
    _close(mf.distribution_g(_t(wo), _t(wi), *a), jmf.distribution_g(
        jnp.asarray(wo), jnp.asarray(wi), *ja), "G")
    _close(mf.distribution_pdf(_t(wo), _t(wi), *a), jmf.distribution_pdf(
        jnp.asarray(wo), jnp.asarray(wi), *ja), "pdf")
    wh = mf.sample_wh(_t(wo), _t(u), *a)
    _close(wh, jmf.sample_wh(jnp.asarray(wo), jnp.asarray(u), *ja),
           "sample_wh", SAMPLE_TOL)
    assert bool(((wh[:, 2] * _t(wo[:, 2])) >= 0).all())


LOBES = ["oren_nayar", "lambertian", "cos_pdf", "fb_diffuse",
         "fb_specular", "metal", "glass_refl", "glass_trans"]


@pytest.mark.parametrize("lobe", LOBES)
@pytest.mark.parametrize("form", FORMS, ids=["-".join(f) for f in FORMS])
def test_each_lobe(lanes, form, lobe):
    """Each lobe's f and pdf on every lane, whatever its material."""
    jmp, tmp = _params(lanes, form)
    wi, wo = lanes["wi"], lanes["wo"]
    jwi, jwo, twi, two = jnp.asarray(wi), jnp.asarray(wo), _t(wi), _t(wo)
    a = (tmp.alphax, tmp.alphay, tmp.distrib)
    ja = (jmp.alphax, jmp.alphay, jmp.distrib)
    pairs = {
        "oren_nayar": [(tb._oren_nayar_f(twi, two, tmp.color, tmp.on_a,
                                         tmp.on_b),
                        jb._oren_nayar_f(jwi, jwo, jmp.color, jmp.on_a,
                                         jmp.on_b))],
        "lambertian": [(tb._oren_nayar_f(twi, two, tmp.color, tmp.on_a,
                                         tmp.on_b, True),
                        jb._oren_nayar_f(jwi, jwo, jmp.color, jmp.on_a,
                                         jmp.on_b, True))],
        "cos_pdf": [(tb._cos_hemisphere_pdf(twi, two),
                     jb._cos_hemisphere_pdf(jwi, jwo))],
        "fb_diffuse": [(tb._fb_diffuse_f(twi, two, tmp.color, tmp.ks),
                        jb._fb_diffuse_f(jwi, jwo, jmp.color, jmp.ks))],
        "fb_specular": [(tb._fb_specular_f(twi, two, tmp.ks, *a),
                         jb._fb_specular_f(jwi, jwo, jmp.ks, *ja)),
                        (tb._fb_specular_pdf(twi, two, *a),
                         jb._fb_specular_pdf(jwi, jwo, *ja))],
        "metal": [(tb._metal_f(twi, two, tmp.color, tmp.eta3, tmp.k3, *a),
                   jb._metal_f(jwi, jwo, jmp.color, jmp.eta3, jmp.k3, *ja)),
                  (tb._metal_pdf(twi, two, *a), jb._metal_pdf(jwi, jwo,
                                                              *ja))],
        "glass_refl": [(tb._glass_refl_f(twi, two, tmp.color, tmp.ior_in,
                                         tmp.ior_out, *a),
                        jb._glass_refl_f(jwi, jwo, jmp.color, jmp.ior_in,
                                         jmp.ior_out, *ja))],
        "glass_trans": [(tb._glass_trans_f(twi, two, tmp.color, tmp.ior_in,
                                           tmp.ior_out, *a),
                         jb._glass_trans_f(jwi, jwo, jmp.color, jmp.ior_in,
                                           jmp.ior_out, *ja)),
                        (tb._glass_trans_pdf(twi, two, tmp.ior_in,
                                             tmp.ior_out, *a),
                         jb._glass_trans_pdf(jwi, jwo, jmp.ior_in,
                                             jmp.ior_out, *ja))],
    }[lobe]
    for k, (ours, ref) in enumerate(pairs):
        _close(ours, ref, f"{lobe} {k}")
        assert bool((ours != 0).any())


@pytest.mark.parametrize("lambertian_only", [False, True])
@pytest.mark.parametrize("form", FORMS, ids=["-".join(f) for f in FORMS])
def test_bsdf_eval_and_pdfs(lanes, form, lambertian_only):
    """bsdf_f_direct, bsdf_f_nodelta, bsdf_pdf and bsdf_pdf_balanced over
    lanes of all 7 material types."""
    jmp, tmp = _params(lanes, form, lambertian_only)
    wi, wo = lanes["wi"], lanes["wo"]
    for name in ("bsdf_f_direct", "bsdf_f_nodelta", "bsdf_pdf",
                 "bsdf_pdf_balanced"):
        ours = getattr(tb, name)(_t(wi), _t(wo), tmp, present=ALL_TYPES)
        _close(ours, getattr(jb, name)(jnp.asarray(wi), jnp.asarray(wo), jmp,
                                       present=ALL_TYPES), name)
        assert bool((ours != 0).any())


@pytest.mark.parametrize("balanced", [False, True])
@pytest.mark.parametrize("form", FORMS, ids=["-".join(f) for f in FORMS])
def test_bsdf_sample(lanes, form, balanced):
    """bsdf_sample's f, wi, pdf and lobe flags on every lane: all 7
    material types, Oren-Nayar MATTE."""
    jmp, tmp = _params(lanes, form)
    wo, u = lanes["wo"], lanes["u"]
    ours = tb.bsdf_sample(_t(u), _t(wo), tmp, balanced=balanced,
                          present=ALL_TYPES)
    ref = jb.bsdf_sample(jnp.asarray(u), jnp.asarray(wo), jmp,
                         balanced=balanced, present=ALL_TYPES)
    _close(ours[1], ref[1], "wi", SAMPLE_TOL)
    keep = np.ones(N, bool)
    keep[STEEP_LANES] = False
    for name, o, r in (("f", ours[0], ref[0]), ("pdf", ours[2], ref[2])):
        r = np.asarray(r)
        _close(o[keep], r[keep], name, SAMPLE_TOL)
        _close(o[~keep], r[~keep], f"{name} on STEEP_LANES",
               dict(rtol=2e-4, atol=1e-5))
    for name, o, r in zip(("is_specular", "is_glossy"), ours[3:], ref[3:]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r), name)
    for mt in range(1, 8):  # every type sampled somewhere
        m = lanes["mat_type"] == mt
        assert mt == 4 or bool((ours[2].numpy()[m] > 0).any()), mt


def test_math_helpers(lanes):
    wi, wo = lanes["wi"], lanes["wo"]
    jwi, jwo, twi, two = jnp.asarray(wi), jnp.asarray(wo), _t(wi), _t(wo)
    for name in ("max3", "length", "length_sq", "cos_theta", "cos2_theta",
                 "abs_cos_theta", "sin2_theta", "sin_theta", "tan_theta",
                 "tan2_theta", "cos_phi", "sin_phi", "cos2_phi", "sin2_phi"):
        _close(getattr(vm, name)(twi), getattr(jvm, name)(jwi), name)
    np.testing.assert_array_equal(vm.same_hemisphere(twi, two).numpy(),
                                  np.asarray(jvm.same_hemisphere(jwi, jwo)))
    _close(vm.reflect(two, twi), jvm.reflect(jwo, jwi), "reflect")
    eta = _t(lanes["ior_in"] / lanes["ior_out"])
    ok, wt = vm.refract(two, twi, eta)
    jok, jwt = jvm.refract(jwo, jwi, jnp.asarray(eta.numpy()))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    _close(wt, jwt, "refract")
    frame = vm.make_shading_frame(twi, two)
    jframe = jvm.make_shading_frame(jwi, jwo)
    for k in range(3):
        _close(frame[k], jframe[k], f"frame {k}")
    _close(vm.to_local(two, *frame), jvm.to_local(jwo, *jframe), "to_local")
    _close(vm.to_world(two, *frame), jvm.to_world(jwo, *jframe), "to_world")
    s, c, p = (_t(lanes["u"][:, k]) for k in range(3))
    _close(vm.spherical_direction(s, c, p * 6.0),
           jvm.spherical_direction(jnp.asarray(s.numpy()),
                                   jnp.asarray(c.numpy()),
                                   jnp.asarray(p.numpy() * 6.0)),
           "spherical_direction")
    cos = lanes["u"][:, 0] * 2.0 - 1.0
    _close(fr.schlick_fresnel(_t(cos), _t(lanes["ks"])),
           jfr.schlick_fresnel(jnp.asarray(cos), jnp.asarray(lanes["ks"])),
           "schlick")
    ones = np.ones((N, 3), np.float32)
    _close(fr.fr_conductor_rgb(_t(np.abs(cos)), _t(lanes["eta3"]), _t(ones),
                               _t(lanes["k3"])),
           jfr.fr_conductor(jnp.asarray(np.abs(cos)),
                            jnp.asarray(lanes["eta3"]), jnp.asarray(ones),
                            jnp.asarray(lanes["k3"])), "conductor")


def test_gather_params_matches_jax():
    """gather_params on both packages' tables: every material type, the
    1e-4 alpha floor, and miss lanes (-1) reading row 0."""
    jbld, tbld = JBuilder(), SceneBuilder()
    for b in (jbld, tbld):
        b.add_matte("m", (0.3, 0.4, 0.5), sigma=12.0)
        b.add_mirror("mi")
        b.add_transparent("t", 1.33)
        b.add_emissive("e", (1, 0.9, 0.8), 7.0)
        b.add_plastic("p", (0.2, 0.3, 0.4), (0.5, 0.4, 0.3), 0.2)
        b.add_glass("g", 0.3)
        b.add_metal("me", "COPPER", 0.15)
        b.add_rect((0, 0, 0), (1, 0, 0), (0, 0, 1), "e")
    js, ts = jbld.build(), tbld.build(device="cpu")
    mid = np.array([-1, 0, 1, 2, 3, 4, 5, 6, 7, 7, 3], np.int32)
    ref = jb.gather_params(js.materials, js.textures, jnp.asarray(mid),
                           jnp.zeros((mid.shape[0], 2), jnp.float32))
    ours = tb.gather_params(ts.materials, ts.textures, _t(mid),
                            torch.zeros((mid.shape[0], 2)))
    for name in ("mat_type", "color", "ks", "on_a", "on_b", "ior_in",
                 "ior_out", "eta3", "k3", "alphax", "alphay", "distrib",
                 "intensity"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert float(ours.alphax.min()) == np.float32(1e-4)
