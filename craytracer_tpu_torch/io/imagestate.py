"""Progressive-render checkpoints (counterpart of
craytracer_tpu/io/imagestate.py: `save_image_state` :15,
`load_image_state` :20, `ppm_to_image_state` :25, `read_reference_is`
:41, `write_reference_is` :54).

The port's checkpoint is the JAX package's `.npz`: the f32 accumulator
`accum`, the int64 `spp` and the int64 `seed`, so either package resumes
from the other's file. A resumed render is bit-equal to a straight one:
the counter RNG keys every sample off (seed, pixel, spp, bounce, dim) and
needs no stream state. The reference's native `savestate.is` is ASCII
"spp\\n" "width height\\n" followed by width*height*3 raw f32
(imagestate.h:5-20); the goldens under tests/goldens/ are in it.
"""

from __future__ import annotations

import numpy as np


def save_image_state(path: str, accum, spp: int, seed: int):
    """Write `accum` ([H*W, 3], a tensor or an array), `spp` and `seed`
    to `path` (np.savez adds ".npz" when it is missing)."""
    if hasattr(accum, "detach"):
        accum = accum.detach().cpu().numpy()
    np.savez(path, accum=np.asarray(accum, np.float32), spp=np.int64(spp),
             seed=np.int64(seed))


def load_image_state(path: str):
    """(accum [H*W, 3] f32 numpy, spp, seed) of a `save_image_state` file."""
    d = np.load(path if path.endswith(".npz") else path + ".npz")
    return d["accum"], int(d["spp"]), int(d["seed"])


def ppm_to_image_state(ppm_path: str, spp: int = 1):
    """An accumulator from a tone-mapped PPM (ppmToImageState,
    main.cpp:169-184): the tone map r = (1 - exp(-2 L))^(1/2.2) inverted
    and scaled by spp. Lossy (the tone map clips), but it lets a render
    resume from an image whose raw state was lost."""
    from craytracer_tpu_torch.io.image import read_ppm

    img = read_ppm(ppm_path).astype(np.float32) / 255.0
    lin = np.clip(1.0 - np.power(img, 2.2), 1e-6, 1.0)
    radiance = -np.log(lin) / 2.0
    return (radiance.reshape(-1, 3) * spp).astype(np.float32)


def read_reference_is(path: str):
    """Returns (accum [H*W, 3] float32 SUM over spp, spp, width, height)."""
    with open(path, "rb") as f:
        data = f.read()
    nl1 = data.index(b"\n")
    nl2 = data.index(b"\n", nl1 + 1)
    spp = int(data[:nl1])
    width, height = (int(x) for x in data[nl1 + 1:nl2].split())
    accum = np.frombuffer(data[nl2 + 1:], np.float32,
                          count=width * height * 3).reshape(-1, 3)
    return accum.copy(), spp, width, height


def write_reference_is(path: str, accum, spp: int, width: int,
                       height: int):
    """Write the reference's `savestate.is`, so that a render made here can
    seed the reference binary's `-s` resume (main.cpp:195-254)."""
    if hasattr(accum, "detach"):
        accum = accum.detach().cpu().numpy()
    accum = np.ascontiguousarray(np.asarray(accum, np.float32).reshape(-1))
    if accum.size != width * height * 3:
        raise ValueError("accumulator size does not match dimensions")
    with open(path, "wb") as f:
        f.write(f"{spp}\n{width} {height}\n".encode())
        f.write(accum.tobytes())
