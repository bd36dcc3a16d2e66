"""K2's host builds and its bars, shared by tests/test_torch_k1_host.py and
tests/test_torch_bvh4_host.py.

`k2_lib(tmp_path_factory, mask)` builds csrc/shade_kernel.cu for one
feature mask (`gate.shade_features`, -DK2_MASK) through
tests/torch_cuda_host.py, once per mask and process. `run_k2` calls its C
entry point as `fused_shade` does, on CPU tensors, with the outputs
prefilled (NaN floats, -1 counts, flag bytes 0x55) so a lane the kernel
does not write fails. `check_k2` holds the outputs to K2's card bar:
floats within 1e-5 (absolute + relative) of fused_shade_reference, the
count and the flags equal on every lane (the flags byte for byte).
"""

import torch

from craytracer_tpu_torch.integrator import shade_kernel as sk

from torch_cuda_host import host_build

_BUILT = {}


def k2_lib(tmp_path_factory, mask: int):
    if mask not in _BUILT:
        lib = host_build(tmp_path_factory, "shade_kernel", 1,
                         defines={"K2_MASK": mask})
        sk._bind(lib)
        assert lib.k2_shade_mask() == mask
        _BUILT[mask] = lib
    return _BUILT[mask]


def run_k2(lib, scene, d, hit, beta, alive, prev_sg, pix, spp, seed, bounce,
           max_depth):
    """One launch of the host build: the dict of `fused_shade`. `spp` is a
    per-lane tensor or an int; the inputs are taken as they are (a test
    may hand in views off 16 bytes)."""
    n = d.shape[0]
    tab = sk.shade_tables(scene)
    f3 = torch.full((7, n, 3), float("nan"))
    f1 = torch.full((2, n), float("nan"))
    good = torch.full((n,), -1, dtype=torch.int32)
    flags = torch.full((3, n), 0x55, dtype=torch.uint8)
    per_lane = isinstance(spp, torch.Tensor)
    for x in (d, hit.point, hit.normal, hit.dpdu, beta, hit.t, hit.mat_id,
              alive, prev_sg, pix) + ((spp,) if per_lane else ()):
        assert x.is_contiguous()
    assert lib.k2_shade_launch(
        tab.data_ptr(), tab.numel(), scene.materials.mat_type.shape[0],
        scene.lights.light_type.shape[0], d.data_ptr(), hit.point.data_ptr(),
        hit.normal.data_ptr(), hit.dpdu.data_ptr(), beta.data_ptr(),
        hit.t.data_ptr(), hit.mat_id.data_ptr(), alive.data_ptr(),
        prev_sg.data_ptr(), pix.data_ptr(),
        spp.data_ptr() if per_lane else None, 0 if per_lane else spp, n,
        seed, bounce, max_depth, sk.RR_START, f3.data_ptr(), f1.data_ptr(),
        good.data_ptr(), flags.data_ptr(), None) == 0
    out = dict(zip(sk._F3, f3.unbind(0)))
    out.update(dist_adj=f1[0], dist_adj_t=f1[1], good_inc=good,
               want_shadow=flags[0], new_alive=flags[1], new_prev_sg=flags[2])
    return out


def check_k2(got, ref, what=""):
    for key, val in ref.items():
        if val.dtype == torch.float32:
            assert torch.allclose(got[key], val, rtol=1e-5, atol=1e-5), (
                what, key)
        elif val.dtype == torch.bool:
            assert torch.equal(got[key], val.to(torch.uint8)), (what, key)
        else:
            assert torch.equal(got[key], val), (what, key)
