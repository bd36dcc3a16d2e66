"""Texture and env-map image loading (the port's counterpart of
craytracer_tpu/io/teximage.py `load_texture_image` :21).

The JAX package reads LDR images through PIL (`Image.open(path)
.convert("RGB")`); the card's machine has no PIL, so the port decodes
them in C++ (csrc/imgdecode.cpp through io/imgdecode.py) to the same
texels: PNG of every bit depth, colour type and interlace; baseline,
extended, progressive (block-smoothed where scans leave coefficients
unrefined) and lossless Huffman JPEG and SOF9/SOF10 arithmetic JPEG;
PNM P1-P6 at any maxval and PIL's own Pf, P0CMYK, PyCMYK, PyRGBA and
PyP; BMP and DIB; TGA; the first frame of a GIF; TIFF and BigTIFF (the
first page, CCITT and old-style LZW included); DDS (BC1-BC7, the top
mip); lossless WebP (the first frame); PSD (the merged image); QOI; SGI;
PCX; IM; XBM; SPIDER; ICO and CUR; SUN, XPM, MSP, DCX, PIXAR, McIdas,
IMT, XVThumb, GBR, FITS, FTEX, BLP, ICNS, IPTC, FLI and PCD. The format is told by the file's bytes, not its name: PIL's
plugins are tried in `Image.open`'s order (io/imgopen.py). LDR texels are
value / 255 in float32. EXR goes through io/exr.py and keeps HDR values;
CRAY_TEX_FLOAT_DIV255=1 divides them by 255 as the reference's
getTexColor does for float texels (texture.cpp:78), which the textured
golden needs.

A file that is missing, that no PIL plugin opens, or that PIL opens and
cannot read gives None, as in the JAX loader, and the caller drops the
texture; so does an EXR file the JAX reader refuses (a tiled one, or a
compression other than NONE, ZIPS and ZIP). A format PIL reads and the
port does not (lossy WebP, JPEG 2000, AVIF, Lab TIFF and PSD, the TIFF
codecs LZMA, ZSTD, old-style JPEG, SGILog and ThunderScan) raises
NotImplementedError naming it: a texture is never quietly left out
because of its encoding.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from craytracer_tpu_torch.io.exr import read_exr_texture
from craytracer_tpu_torch.io.imgdecode import HandOn, decode
from craytracer_tpu_torch.io.imgopen import open_plugin

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# the JAX loader drops a texture on any error of its EXR reader or of
# PIL: a missing file, a short or malformed header or block, an unknown
# channel type. NotImplementedError is left out: an encoding the port does
# not decode raises
_UNREADABLE = (OSError, ValueError, KeyError, IndexError, TypeError,
               OverflowError, MemoryError, struct.error, zlib.error)


def _opened(data: bytes, skip=()):
    opened = open_plugin(data, skip)
    if opened is None:
        raise ValueError("no PIL plugin opens this file")
    if opened.kind is None:
        if not opened.readable:
            raise ValueError(f"PIL opens {opened.name} files and never "
                             "reads their pixels")
        raise NotImplementedError(
            f"{opened.name} textures are not decoded by craytracer_tpu_torch"
            " (PNG, JPEG, PNM, BMP, DIB, TGA, GIF, TIFF, DDS, lossless WebP,"
            " PSD, QOI, SGI, PCX, IM, XBM, SPIDER, ICO, CUR, SUN, XPM, MSP,"
            " DCX, PIXAR, McIdas, IMT, XVThumb, GBR, FITS, FTEX, BLP, ICNS,"
            " IPTC, FLI, PCD and EXR are)")
    return opened


def image_kind(data: bytes) -> str:
    """The decoder for a file of these bytes (its first bytes will do
    for most formats; PCD looks at offset 2048, SPIDER at 108 bytes, IM
    and XBM at their text headers): the plugin PIL's `Image.open` picks.
    Raises NotImplementedError for a format the port does not decode and
    ValueError where PIL opens nothing, or nothing it can read."""
    return _opened(data).kind


def decode_file(path: str) -> np.ndarray:
    """[H, W, 3] uint8 of an LDR image file, as PIL's convert("RGB")."""
    with open(path, "rb") as f:
        data = f.read()
    opened, skip = _opened(data), []
    while True:
        try:
            return decode(data, opened.kind, path)
        except HandOn:  # the plugin's _open failed: PIL tries the next
            skip.append(opened.plugin)
            opened = _opened(data, tuple(skip))


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
            img = read_exr_texture(path)
            if os.environ.get("CRAY_TEX_FLOAT_DIV255", "0") == "1":
                img = img / 255.0  # getTexColor's float quirk
            return img
        return np.asarray(decode_file(path), np.float32) / 255.0
    except _UNREADABLE:
        return None
