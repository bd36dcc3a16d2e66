"""K2's launch path on the CPU: the per-Scene table cache and the
per-mask builds (craytracer_tpu_torch/integrator/shade_kernel.py).

`cached_shade_tables` returns the table it built for a Scene until a
tensor the table reads changes: an in-place change (the tensor's
version) or a new tensor. `fused_shade` on CPU tensors takes the plain
version and never touches the cache. `library(mask)` names one build per
feature mask, with the mask on nvcc's command line and in the library's
file name."""

import os

import pytest
import torch

from craytracer_tpu_torch.integrator import gate as G
from craytracer_tpu_torch.integrator import shade_kernel as sk
from craytracer_tpu_torch.integrator.wavefront import _init_state
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.ops.intersect import intersect_scene
from craytracer_tpu_torch.camera import Film, generate_rays
from craytracer_tpu_torch.sampling.multijitter import stratified_jitter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIX = os.path.join(REPO, "scenes", "parity_mix.txt")


@pytest.fixture
def mix():
    sk._TABLES.clear()
    return load_scene_file(MIX, device="cpu")


def test_second_call_returns_the_cached_table(mix):
    scene = mix[0]
    tab = sk.cached_shade_tables(scene)
    assert torch.equal(tab, sk.shade_tables(scene))
    assert sk.cached_shade_tables(scene) is tab


def test_in_place_material_change_rebuilds_the_table(mix):
    scene = mix[0]
    tab = sk.cached_shade_tables(scene)
    old = tab.clone()
    scene.materials.color[1, 0] += 0.25
    new = sk.cached_shade_tables(scene)
    assert new is not tab and torch.equal(new, sk.shade_tables(scene))
    assert not torch.equal(new, old)
    assert sk.cached_shade_tables(scene) is new


# every tensor the table reads
FIELDS = [("materials", f) for f in (
    "mat_type", "color", "on_a", "intensity", "on_b", "alphax", "ks", "eta",
    "k", "ior_in", "ior_out")] + [("lights", f) for f in (
        "p0", "v1", "v2", "normal", "color", "intensity", "radius",
        "power_cdf", "power", "light_type")] + [("env", "color"),
                                                ("env", "intensity")]


@pytest.mark.parametrize("group,field", FIELDS)
def test_every_table_tensor_keys_the_cache(mix, group, field):
    """A tensor bumped in place (its values unchanged) is a new key."""
    scene = mix[0]
    tab = sk.cached_shade_tables(scene)
    getattr(getattr(scene, group), field).add_(0)
    new = sk.cached_shade_tables(scene)
    assert new is not tab and torch.equal(new, tab)


def test_new_scene_gets_its_own_table(mix):
    scene = mix[0]
    tab = sk.cached_shade_tables(scene)
    other = load_scene_file(MIX, device="cpu")[0]
    other.materials.color.mul_(0.5)
    got = sk.cached_shade_tables(other)
    assert torch.equal(got, sk.shade_tables(other))
    assert not torch.equal(got, tab)
    assert sk.cached_shade_tables(scene) is tab


def test_cpu_fused_shade_never_touches_the_cache(mix, monkeypatch):
    scene, cam, f0 = mix
    film = Film(fov=f0.fov, width=8, height=8)
    pix = torch.arange(64, dtype=torch.int32)
    o, d = generate_rays(cam, film, pix, stratified_jitter(3, pix, 0))
    state = _init_state(o, d, 5, pix)
    hit = intersect_scene(scene, o, d)

    def refuse(_):
        raise AssertionError("the CPU path asked for K2's table")

    monkeypatch.setattr(sk, "cached_shade_tables", refuse)
    out = sk.fused_shade(scene, d, hit, state[2], state[5], state[6], pix, 0,
                         3, 0, 5)
    ref = sk.fused_shade_reference(scene, d, hit, state[2], state[5],
                                   state[6], pix, 0, 3, 0, 5)
    assert all(torch.equal(out[k], ref[k]) for k in ref)
    assert not sk._TABLES and sk.KERNEL.launches == 0


def test_one_build_per_feature_mask():
    mask = G.shade_features(load_scene_file(MIX, device="cpu")[0])
    assert mask != 0
    lib = sk.library(mask)
    assert sk.library(mask) is lib and sk.library(0) is not lib
    assert sk.variants()[mask] is lib
    assert f"-DK2_MASK={mask}" in lib.defines
    so = lib._paths()[0]
    assert so.name.startswith(f"libshade_kernel_k2_mask{mask}_")
    assert so != sk.library(0)._paths()[0]
    for bad in (-1, G.F_ALL + 1):
        with pytest.raises(ValueError):
            sk.library(bad)
