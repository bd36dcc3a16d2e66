"""Texture and env-map image loading (the port's counterpart of
craytracer_tpu/io/teximage.py `load_texture_image` :21).

The JAX package reads LDR images through PIL (`Image.open(path)
.convert("RGB")`); the card's machine has no PIL, so the port decodes
them in C++ (csrc/imgdecode.cpp through io/imgdecode.py) to the same
texels: PNG of every bit depth, colour type and interlace; baseline,
extended and progressive Huffman JPEG; PNM P1-P6 at any maxval; BMP;
TGA; the first frame of a GIF. The format is told by the file's first
bytes, not its name, as PIL tells it. LDR texels are value / 255 in
float32. EXR goes through io/exr.py and keeps HDR values;
CRAY_TEX_FLOAT_DIV255=1 divides them by 255 as the reference's
getTexColor does for float texels (texture.cpp:78), which the textured
golden needs.

A file that is missing or that PIL would not read either gives None, as
in the JAX loader, and the caller drops the texture. A format PIL reads
and the port does not (TIFF, WebP, DDS, PSD, JPEG 2000, arithmetic-coded,
lossless or 12-bit JPEG, ...) raises NotImplementedError naming it: a
texture is never quietly left out because of its encoding.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from craytracer_tpu_torch.io.exr import read_exr
from craytracer_tpu_torch.io.imgdecode import decode

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# first bytes of the formats PIL reads that the port refuses
_REFUSED = ((b"II*\0", "TIFF"), (b"MM\0*", "TIFF"), (b"II+\0", "BigTIFF"),
            (b"MM\0+", "BigTIFF"), (b"DDS ", "DDS"), (b"8BPS", "PSD"),
            (b"\0\0\0\x0cjP  \r\n\x87\n", "JPEG 2000"),
            (b"\xff\x4f\xff\x51", "JPEG 2000"))


def _is_tga(head: bytes) -> bool:
    """The header checks of PIL's TgaImageFile._open (TGA has no magic)."""
    if len(head) < 18:
        return False
    w, h = struct.unpack_from("<HH", head, 12)
    return (head[1] in (0, 1) and w > 0 and h > 0
            and head[16] in (1, 8, 16, 24, 32)
            and head[2] in (1, 2, 3, 9, 10, 11))


def image_kind(head: bytes) -> str:
    """The decoder for a file starting with `head` (at least 18 bytes
    unless the file is shorter), in PIL's order of looking; raises
    NotImplementedError for a format the port does not decode."""
    if head.startswith(_PNG_SIGNATURE):
        return "png"
    if head.startswith(b"\xff\xd8\xff"):
        return "jpeg"
    if head.startswith(b"BM"):
        return "bmp"
    if head.startswith((b"GIF87a", b"GIF89a")):
        return "gif"
    if len(head) >= 2 and head[:1] == b"P" and head[1] in b"0123456fy":
        return "pnm"
    kind = next((k for magic, k in _REFUSED if head.startswith(magic)), None)
    if kind is None and head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        kind = "WebP"
    if kind is None and _is_tga(head):
        return "tga"
    raise NotImplementedError(
        f"{kind or f'an image starting {head[:4]!r}'} textures are not "
        "decoded by craytracer_tpu_torch (PNG, JPEG, PNM, BMP, TGA, GIF and "
        "EXR are)")


def decode_file(path: str) -> np.ndarray:
    """[H, W, 3] uint8 of an LDR image file, as PIL's convert("RGB")."""
    with open(path, "rb") as f:
        data = f.read()
    if not data:
        raise ValueError(f"{path} is empty")
    return decode(data, image_kind(data[:18]), path)


def read_png(path: str) -> np.ndarray:
    """[H, W, 3] uint8 of a PNG file of any bit depth, colour type and
    interlace."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    return decode(data, "png", path)


def load_texture_image(path: str):
    """[H, W, 3] float32, or None when the file is missing or cannot be
    read. LDR images are scaled to [0, 1]; EXR keeps HDR values."""
    try:
        if path.lower().endswith(".exr"):
            img = read_exr(path)
            if os.environ.get("CRAY_TEX_FLOAT_DIV255", "0") == "1":
                img = img / 255.0  # getTexColor's float quirk
            return img
        return np.asarray(decode_file(path), np.float32) / 255.0
    except (OSError, ValueError, IndexError, struct.error, zlib.error):
        return None
