"""ctypes binding to the port's image decoders, csrc/imgdecode.cpp and the
per-format files it includes (PNG, JPEG, PNM, BMP, TGA, GIF, TIFF, DDS,
lossless WebP, PSD, DIB, ICO, CUR, QOI, SGI, PCX, IM, XBM, SPIDER, SUN,
XPM, MSP, DCX, PIXAR, McIdas, IMT, XVThumb, GBR, FITS, FTEX, BLP, ICNS,
IPTC, FLI and PCD to 8-bit RGB, each equal to PIL's
`Image.open(path).convert("RGB")`, which the JAX package's texture loader
calls).

The sources are built with g++ at first use, as one library, into
craytracer_tpu_torch/_build/ (`native.build_shared`: keyed by a hash of
the flags and of every source file the build reads, a temporary file
renamed into place). A failed build raises; there is no Python decoder to
fall back to.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from craytracer_tpu_torch import native

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "imgdecode.cpp"
# -ffp-contract=off: PNM's v / maxval * 255 rounds like Python's floats
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-ffp-contract=off")
KINDS = {"png": 1, "jpeg": 2, "pnm": 3, "bmp": 4, "tga": 5, "gif": 6,
         "tiff": 7, "dds": 8, "webp": 9, "psd": 10, "dib": 11, "ico": 12,
         "cur": 13, "qoi": 14, "sgi": 15, "pcx": 16, "im": 17, "xbm": 18,
         "spider": 19, "sun": 20, "xpm": 21, "msp": 22, "dcx": 23,
         "pixar": 24, "mcidas": 25, "imt": 26, "xvthumb": 27, "gbr": 28,
         "fits": 29, "ftex": 30, "blp": 31, "icns": 32, "iptc": 33,
         "fli": 34, "pcd": 35}

_LIB = None


class HandOn(Exception):
    """The file fails inside the plugin's `_open` with an error that makes
    PIL's `Image.open` try the next plugin (status 3)."""


def bind(so: Path) -> ctypes.CDLL:
    """The library file `so`, loaded, its C interface typed."""
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:  # not a file error of a texture: raise
        raise RuntimeError(f"loading {so} failed: {e}") from e
    c = ctypes
    lib.imgd_decode.restype = c.c_void_p
    lib.imgd_decode.argtypes = [c.c_int, c.c_char_p, c.c_int64]
    lib.imgd_status.restype = c.c_int
    lib.imgd_message.restype = c.c_char_p
    lib.imgd_width.restype = c.c_int64
    lib.imgd_height.restype = c.c_int64
    for f in (lib.imgd_status, lib.imgd_message, lib.imgd_width,
              lib.imgd_height, lib.imgd_free):
        f.argtypes = [c.c_void_p]
    lib.imgd_copy.argtypes = [c.c_void_p, c.c_void_p]
    return lib


def library() -> ctypes.CDLL:
    """The loaded decoder library (built on first use)."""
    global _LIB
    if _LIB is None:
        _LIB = bind(native.build_shared(SOURCE, "imgdecode", CXX_FLAGS))
    return _LIB


def decode(data: bytes, kind: str, name: str = "image") -> np.ndarray:
    """[H, W, 3] uint8 of a file's bytes in the format `kind` (a key of
    KINDS). Raises NotImplementedError for an encoding the decoder leaves
    out, ValueError for a file PIL would not read either, and HandOn where
    PIL's plugin hands the file to the next one."""
    lib = library()
    h = lib.imgd_decode(KINDS[kind], data, len(data))
    try:
        status = lib.imgd_status(h)
        if status:
            msg = f"{name}: {lib.imgd_message(h).decode()}"
            raise (NotImplementedError, ValueError, HandOn)[status - 1](msg)
        out = np.empty((lib.imgd_height(h), lib.imgd_width(h), 3), np.uint8)
        lib.imgd_copy(h, out.ctypes.data)
        return out
    finally:
        lib.imgd_free(h)
