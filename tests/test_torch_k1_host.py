"""K1's CUDA source, built for the CPU, against its plain PyTorch version.

A CUDA kernel has no interpret mode, but K1's per-lane code is plain C++
inside CUDA qualifiers. This test compiles csrc/pass_kernel.cu with the
host C++ compiler, a stub `cuda_runtime.h` (qualifiers as empty macros,
the shared table as a static array) and the `<<<...>>>` launch replaced
by a loop over lanes with one-lane blocks, then calls the same C entry
point the wrapper calls, through ctypes, on CPU tensors. It is held to
the card's bar: >= 99.9% of lanes with equal good and L within 1e-4
(rtol and atol), counters within 0.1% and exact at depth 0; at these
settings every lane agrees and the counters are identical. Built with
-ffp-contract=off, as the card build uses --fmad=false; the host libm's
sinf/cosf may differ from torch's by an ulp.

Skips when no C++ compiler is on the PATH."""

import ctypes
import os
import re
import shutil
import subprocess

import pytest
import torch

from craytracer_tpu_torch.camera import Film
from craytracer_tpu_torch.integrator import pass_kernel as pk
from craytracer_tpu_torch.io.scenefile import load_scene_file

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "scenes", "parity_cornell.txt")

STUB = """#pragma once
#include <math.h>
#include <stdint.h>
#include <algorithm>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
#define __restrict__
typedef void* cudaStream_t;
typedef int cudaError_t;
struct k1_dim3 { int x; };
static k1_dim3 threadIdx, blockIdx, blockDim;
static inline void __syncthreads() {}
static inline int cudaGetLastError() { return 0; }
static inline const char* cudaGetErrorString(int) { return "host build"; }
using std::min;
using std::max;
namespace { float tab[1 << 14]; }
#define K1_HOST_LAUNCH(blocks, threads) \\
  blockDim.x = 1; threadIdx.x = 0; \\
  for (blockIdx.x = 0; blockIdx.x < (blocks) * (threads); ++blockIdx.x)
"""


@pytest.fixture(scope="module")
def k1_host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build K1's source for the CPU")
    d = tmp_path_factory.mktemp("k1_host")
    (d / "cuda_runtime.h").write_text(STUB)
    src = pk.SOURCE.read_text()
    src, n_launch = re.subn(r"(\w+)<<<\s*(\w+),\s*(\w+)[^>]*>>>\(",
                            r"K1_HOST_LAUNCH(\2, \3) \1(", src)
    assert n_launch == 1
    (d / "k1_host.cpp").write_text(src)
    lib = d / "libk1_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", "-I", str(d),
                    "-I", str(pk.SOURCE.parent), "-o", str(lib),
                    str(d / "k1_host.cpp")], check=True,
                   capture_output=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    so.k1_pass_launch.argtypes = [vp, ci, vp, vp, ci, ci, ci, ci, ci,
                                  ctypes.c_uint, ci, ci, ci, ci, vp, vp, vp]
    so.k1_pass_launch.restype = ci
    return so


def _run_host(so, scene, cam, film, pix, spp, seed, depth, raygen):
    tab = pk.kernel_tables(scene, cam, film)
    n = pix.shape[0]
    L = torch.empty((n, 3), dtype=torch.float32)
    g = torch.empty((4, n), dtype=torch.int32)
    err = so.k1_pass_launch(
        tab.data_ptr(), tab.numel(), pix.data_ptr(), spp.data_ptr(), n,
        scene.materials.mat_type.shape[0], scene.lights.light_type.shape[0],
        scene.rects.mat_id.shape[0], scene.triangles.mat_id.shape[0], seed,
        depth, pk.RR_START, int(raygen == "strat"), film.width,
        L.data_ptr(), g.data_ptr(), None)
    assert err == 0
    return L, g


@pytest.mark.parametrize("raygen", ["strat", "plain"])
@pytest.mark.parametrize("depth", [0, 2, 5])
def test_k1_source_matches_plain_version(k1_host, depth, raygen):
    scene, cam, film = load_scene_file(CORNELL, device="cpu")
    film = Film(fov=film.fov, width=40, height=32)
    n = film.num_pixels
    pix = torch.arange(n, dtype=torch.int32).repeat(2)
    spp = (3 + torch.arange(2, dtype=torch.int32).repeat_interleave(n))
    L, g = _run_host(k1_host, scene, cam, film, pix, spp, 7, depth, raygen)
    Lr, goodr, mr = pk.fused_pass_reference(scene, cam, film, pix, spp, 7,
                                            depth, raygen=raygen)
    same = g[0] == goodr
    close = ((L - Lr).abs() <= 1e-4 + 1e-4 * Lr.abs()).all(dim=1)
    assert (same & close).double().mean().item() >= 0.999
    for row, key in ((1, "rays"), (2, "shadow_rays")):
        a, b = int(g[row].sum()), int(mr[key])
        assert a == b if depth == 0 else abs(a - b) <= 1e-3 * max(b, 1)
    bits = torch.arange(depth + 1, dtype=torch.int32)
    live = ((g[3][:, None] >> bits) & 1).sum(dim=0)
    assert torch.equal(live, mr["bounce_live"])
