"""PPM image IO (counterpart of craytracer_tpu/io/image.py:8 `write_ppm`,
:19 `read_ppm`; PPM_write/PPM_read, imagefile.h:36-81). Framework-free;
`read_ppm` also reads ASCII (P3) PPM, for textures (io/teximage.py)."""

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
    """[H, W, 3] uint8 of a binary (P6) or ASCII (P3) PPM with maxval 255,
    comments in the header skipped."""
    with open(path, "rb") as f:
        data = f.read()
    tokens, i = [], 0
    while len(tokens) < 4 and i < len(data):
        if data[i:i + 1].isspace():
            i += 1
        elif data[i:i + 1] == b"#":
            while i < len(data) and data[i:i + 1] != b"\n":
                i += 1
        else:
            start = i
            while i < len(data) and not data[i:i + 1].isspace():
                i += 1
            tokens.append(data[start:i])
    if len(tokens) < 4:
        raise ValueError(f"{path}: truncated PPM header")
    magic, w, h, maxval = (tokens[0], int(tokens[1]), int(tokens[2]),
                           int(tokens[3]))
    if magic not in (b"P6", b"P3"):
        raise ValueError(f"unsupported PPM magic {magic!r}")
    if maxval != 255:
        raise NotImplementedError(
            f"{path}: PPM with maxval {maxval}; P6 and P3 with maxval 255 "
            "are read")
    if magic == b"P6":
        # one whitespace byte ends the header
        img = np.frombuffer(data, np.uint8, count=w * h * 3, offset=i + 1)
    else:
        img = np.array(data[i:].split()[:w * h * 3], dtype=np.int64)
        if img.size < w * h * 3:
            raise ValueError(f"{path}: truncated PPM pixel data")
        img = img.astype(np.uint8)
    return img.reshape(h, w, 3)
