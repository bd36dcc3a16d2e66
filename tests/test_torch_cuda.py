"""K1 on the card: the CUDA kernel against its plain PyTorch version,
the launch count, and the wrapper's refusals. These cases carry the
`cuda` marker (pytest.ini) and need a CUDA card and nvcc; without a card
they skip. The file imports no JAX, so on a machine with the card (and
no JAX) it runs on its own, without tests/conftest.py (which imports
JAX):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import os

import pytest
import torch

from craytracer_tpu_torch.camera import Film
from craytracer_tpu_torch.integrator import pass_kernel as pk
from craytracer_tpu_torch.io.scenefile import load_scene_file

pytestmark = pytest.mark.cuda
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "parity_cornell.txt")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    return torch.device("cuda", 0)


def _cornell(dev, size=48):
    scene, cam, film = load_scene_file(CORNELL, device=dev)
    return scene, cam, Film(fov=film.fov, width=size, height=size)


@pytest.mark.parametrize("raygen", ["strat", "plain"])
@pytest.mark.parametrize("depth", [0, 2, 5])
def test_k1_matches_plain_version(cuda, depth, raygen):
    """>= 99.9% of lanes with equal good and L within 1e-4 (rtol and
    atol); rays and shadow_rays within 0.1%, exact at depth 0."""
    scene, cam, film = _cornell(cuda)
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32, device=cuda).repeat(2)
    spp = 3 + torch.arange(2, dtype=torch.int32,
                           device=cuda).repeat_interleave(n)
    args = (scene, cam, film, pix, spp, 7, depth)
    before = pk.KERNEL.launches
    L, good, m = pk.fused_pass(*args, raygen=raygen)
    assert pk.KERNEL.launches == before + 1
    Lr, goodr, mr = pk.fused_pass_reference(*args, raygen=raygen)
    same = good == goodr
    close = ((L - Lr).abs() <= 1e-4 + 1e-4 * Lr.abs()).all(dim=1)
    assert (same & close).double().mean().item() >= 0.999
    for key in ("rays", "shadow_rays"):
        a, b = int(m[key]), int(mr[key])
        assert a == b if depth == 0 else abs(a - b) <= 1e-3 * max(b, 1)
    assert torch.equal(m["bounce_live"].cpu(), mr["bounce_live"].cpu())


def test_k1_refuses_scenes_outside_its_gate(cuda):
    scene, cam, film = _cornell(cuda, 8)
    pix = torch.arange(64, dtype=torch.int32, device=cuda)
    oren = dataclasses.replace(scene, matte_lambertian=False)
    before = pk.KERNEL.launches
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pk.fused_pass(oren, cam, film, pix, 0, 0, 5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pk.fused_pass(scene, cam, film, pix, 0, 0, 31)
    assert pk.KERNEL.launches == before


def test_k1_refuses_mixed_devices(cuda):
    scene, cam, film = _cornell(cuda, 8)
    with pytest.raises(ValueError, match="pixel ids"):
        pk.fused_pass(scene, cam, film, torch.arange(64), 0, 0, 2)
