"""craytracer_tpu_torch — the PyTorch/CUDA port of `craytracer_tpu`.

The JAX package `craytracer_tpu/` is the reference this port is held
against; every module here names its JAX counterpart by file:line. The
port imports torch and numpy only (never jax, flax or craytracer_tpu).

Layout (same module names as the JAX package where that helps):
  constants.py, core/math.py      numeric constants, [..., 3] vector ops
  sampling/                       counter RNG, stratified jitter, warps
  scene/                          tensor dataclasses + SceneBuilder
  io/                             tokenizer, scene-file parser, PPM, .is
  camera.py                       pinhole camera + film, raygen
  ops/intersect.py                brute-force rect/triangle intersection
  bsdf/, lights/                  Lambertian/emissive BSDF, rect area lights
  integrator/wavefront.py         torch-op path tracer (plain version)
  integrator/gate.py              which scenes K1 (and the port) covers
  integrator/pass_kernel.py       K1: the whole-pass CUDA kernel wrapper
  integrator/render.py            progressive Renderer
  csrc/pass_kernel.cu             K1's CUDA C++ source (sm_90a)
  interop.py                      numpy leaves -> port objects
  profile_render.py               torch.profiler pass over the Renderer
"""

__version__ = "0.1.0"
