"""PPM image IO (counterpart of craytracer_tpu/io/image.py:8 `write_ppm`,
:19 `read_ppm`; PPM_write/PPM_read, imagefile.h:36-81), and an 8-bit RGB
PNG writer for the live views, where the JAX package calls PIL
(integrator/live.py:79-83, render.py:387-397): the card's machine has no
PIL. Framework-free; `read_ppm` reads every PNM variant through the C++
decoders of io/imgdecode.py, as the textures do (io/teximage.py, which
also reads PNG back: `read_png`)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

from craytracer_tpu_torch.io.imgdecode import decode


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
    """[H, W, 3] uint8 of a PNM file (P1-P6, any maxval, comments in the
    header skipped), decoded as PIL decodes it (io/imgdecode.py): the
    Renderer's own P6 files come back byte for byte."""
    with open(path, "rb") as f:
        return decode(f.read(), "pnm", path)


def _u8(image) -> np.ndarray:
    """[H, W, 3] uint8 of a uint8 image, or of a float one in [0, 1]
    truncated as the JAX live views do ((clip x 255).astype(uint8))."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    return np.ascontiguousarray(img)


def encode_png(image) -> bytes:
    """The PNG file bytes of an [H, W, 3] image (uint8, or float in [0,
    1]): 8-bit RGB, no interlace, every row filter 0 (None), the rows in
    one zlib stream."""
    img = _u8(image)
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = img.reshape(h, 3 * w)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, image):
    """Write `encode_png(image)` to `path`."""
    with open(path, "wb") as f:
        f.write(encode_png(image))
