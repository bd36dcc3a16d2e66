"""Texture and env-map image loading (the port's counterpart of
craytracer_tpu/io/teximage.py `load_texture_image` :21).

The JAX package reads LDR images through PIL; the port decodes the
formats the repo's scenes use by itself, with zlib and numpy only:
binary (P6) and ASCII (P3) PPM with maxval 255 (io/image.py), and 8-bit
non-interlaced PNG of colour type 2 (RGB) or 6 (RGBA, alpha dropped as
PIL's convert("RGB") drops it) with all five row filters. LDR texels
are value / 255 in float32. EXR goes through io/exr.py and keeps HDR
values; CRAY_TEX_FLOAT_DIV255=1 divides them by 255 as the reference's
getTexColor does for float texels (texture.cpp:78), which the textured
golden needs.

A file that is missing or cannot be read gives None, as in the JAX
loader, and the caller drops the texture. A format or PNG variant the
port does not decode raises NotImplementedError naming it: a texture is
never quietly left out because of its encoding.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from craytracer_tpu_torch.io.exr import read_exr
from craytracer_tpu_torch.io.image import read_ppm

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {2: 3, 6: 4}  # colour type -> samples per pixel


def _unfilter_row(ftype: int, row: bytearray, prior: bytes, bpp: int):
    """Undo one PNG row filter in place (PNG spec section 9)."""
    n = len(row)
    if ftype == 0:
        return
    if ftype == 1:  # Sub
        for i in range(bpp, n):
            row[i] = (row[i] + row[i - bpp]) & 0xFF
    elif ftype == 2:  # Up
        row[:] = ((np.frombuffer(row, np.uint8).astype(np.uint16)
                   + np.frombuffer(prior, np.uint8)) & 0xFF
                  ).astype(np.uint8).tobytes()
    elif ftype == 3:  # Average
        for i in range(n):
            left = row[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + ((left + prior[i]) >> 1)) & 0xFF
    elif ftype == 4:  # Paeth
        for i in range(n):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            row[i] = (row[i] + pred) & 0xFF
    else:
        raise ValueError(f"PNG row filter {ftype}")


def read_png(path: str) -> np.ndarray:
    """[H, W, 3] uint8 of an 8-bit non-interlaced RGB or RGBA PNG."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos = 8
    header = None
    idat = []
    while pos < len(buf):
        (length,) = struct.unpack_from(">I", buf, pos)
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise NotImplementedError(
            f"{path}: PNG of bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}; the port decodes 8-bit non-interlaced "
            "PNG of colour type 2 (RGB) or 6 (RGBA)")
    bpp = _PNG_CHANNELS[ctype]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    out = np.empty((height, stride), np.uint8)
    prior = bytes(stride)
    for y in range(height):
        start = y * (stride + 1)
        row = bytearray(raw[start + 1:start + 1 + stride])
        _unfilter_row(raw[start], row, prior, bpp)
        out[y] = np.frombuffer(row, np.uint8)
        prior = bytes(row)
    return out.reshape(height, width, bpp)[..., :3]


def _decode_ldr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _PNG_SIGNATURE:
        return read_png(path)
    if head[:2] in (b"P6", b"P3"):
        return read_ppm(path)
    kinds = {b"\xff\xd8": "JPEG", b"BM": "BMP", b"GI": "GIF", b"P5": "PGM",
             b"P2": "PGM", b"II": "TIFF", b"MM": "TIFF"}
    kind = kinds.get(head[:2], f"an image starting {head[:4]!r}")
    raise NotImplementedError(
        f"{path}: {kind} textures are not decoded by craytracer_tpu_torch "
        "(PNG, PPM and EXR are)")


def load_texture_image(path: str):
    """[H, W, 3] float32, or None when the file is missing or cannot be
    read. LDR images are scaled to [0, 1]; EXR keeps HDR values."""
    try:
        if path.lower().endswith(".exr"):
            img = read_exr(path)
            if os.environ.get("CRAY_TEX_FLOAT_DIV255", "0") == "1":
                img = img / 255.0  # getTexColor's float quirk
            return img
        return np.asarray(_decode_ldr(path), np.float32) / 255.0
    except (OSError, ValueError, IndexError, struct.error, zlib.error):
        return None
