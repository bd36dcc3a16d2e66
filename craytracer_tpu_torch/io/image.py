"""PPM image IO (counterpart of craytracer_tpu/io/image.py:8 `write_ppm`,
:19 `read_ppm`; PPM_write/PPM_read, imagefile.h:36-81). Framework-free,
carried over verbatim."""

from __future__ import annotations

import numpy as np


def write_ppm(path: str, image: np.ndarray):
    """image: [H, W, 3] float in [0,1] or uint8."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # Parse header tokens (magic, w, h, maxval), skipping comments.
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        start = i
        while i < len(data) and not data[i : i + 1].isspace():
            i += 1
        tokens.append(data[start:i])
    i += 1  # single whitespace after maxval
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic != b"P6":
        raise ValueError(f"unsupported PPM magic {magic!r}")
    img = np.frombuffer(data, np.uint8, count=w * h * 3, offset=i)
    return img.reshape(h, w, 3)
