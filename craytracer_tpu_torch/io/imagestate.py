"""The reference's native image-state file (counterpart of
craytracer_tpu/io/imagestate.py:41 `read_reference_is`): ASCII "spp\n"
"width height\n" followed by width*height*3 raw f32 (imagestate.h:5-20).
The goldens under tests/goldens/ are in this format."""

from __future__ import annotations

import numpy as np


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
