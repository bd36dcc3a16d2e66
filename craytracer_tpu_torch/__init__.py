"""craytracer_tpu_torch — the PyTorch/CUDA port of `craytracer_tpu`.

The JAX package `craytracer_tpu/` is the reference this port is held
against; every module here names its JAX counterpart by file:line. The
port imports torch and numpy only (never jax, flax or craytracer_tpu).

Layout (same module names as the JAX package where that helps):
  constants.py, core/             numeric constants, [..., 3] vector ops,
                                  the quadratic and quartic solvers, the
                                  slab test
  sampling/                       counter RNG, stratified jitter, warps
  scene/                          tensor dataclasses, SceneBuilder, the
                                  procedural city (city.py)
  io/                             tokenizer, scene-file parser, OBJ, PPM, .is
  camera.py                       pinhole and thin-lens camera + film,
                                  raygen
  ops/                            brute-force intersection of every
                                  primitive group, the ray_key sort, K6
                                  (tri_kernel.py)
  accel/                          SAH BVH4, its plain traversal, K3, K3
                                  _init and K4, the partitioned tables
                                  (bvh4_parts.py), K5 (bvh4_split_kernel.py)
  bsdf/                           Beckmann, Oren-Nayar, FresnelBlend and
                                  Fresnel helpers of the shading
  integrator/wavefront.py         torch-op path tracer (plain version)
  integrator/gate.py              which scenes the port covers, by which
                                  kernels, and the shading feature mask
  integrator/pass_kernel.py       K1: the whole-pass kernel wrapper
  integrator/shade_kernel.py      K2: the per-bounce shading (plain + wrapper)
  integrator/render.py            progressive Renderer
  csrc/                           K1-K6 and P1 CUDA C++ sources (sm_90a)
  cuda_build.py, native.py        nvcc / g++ builds at first use, ctypes
  interop.py                      numpy leaves -> port objects
  profile_render.py               torch.profiler pass over the Renderer
  profiling/pop_probe.py          P1: K3's per-pop cost probe
"""

__version__ = "0.1.0"
