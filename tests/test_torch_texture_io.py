"""The port's image decoders against the JAX package's and PIL's
(craytracer_tpu_torch/io/exr.py, io/teximage.py): `read_exr` bit-equal to
the JAX reader on the tracked EXRs and on files of every compression
(NONE, ZIPS, ZIP) and channel type (HALF, FLOAT) it reads; `write_exr`
byte-equal to the JAX writer and round-tripping through both readers;
the PPM and PNG decoders equal to PIL's array on the tracked textures, on
ASCII PPM, RGBA PNG and a PNG of each of the five row filters; formats
the port does not decode raise NotImplementedError, and a missing or
corrupt file gives None, as the JAX loader's."""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from craytracer_tpu.io import exr as jexr
from craytracer_tpu.io.teximage import load_texture_image as j_tex
from craytracer_tpu_torch.io import exr as texr
from craytracer_tpu_torch.io.image import read_ppm
from craytracer_tpu_torch.io.teximage import load_texture_image, read_png

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes")
TEXTURES = ["parity_tex_checker.ppm", "fullscene_checker.png",
            "fullscene_noise.png", "fullscene_normal.png"]


def _pil(path):
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


@pytest.mark.parametrize("name", ["parity_tex_env.exr", "fullscene_env.exr"])
def test_read_exr_matches_jax(name):
    path = os.path.join(SCENES, name)
    ours, ref = texr.read_exr(path), jexr.read_exr(path)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))


def _exr_bytes(img, compression, ptype, lines_raw=False):
    """A scanline EXR of R/G/B channels of one pixel type (1 HALF,
    2 FLOAT) and compression (0 NONE, 2 ZIPS, 3 ZIP)."""
    h, w = img.shape[:2]
    dt = np.float16 if ptype == 1 else np.float32

    def attr(name, atype, val):
        return name + b"\0" + atype + b"\0" + struct.pack("<i", len(val)) + val

    chans = b"".join(c + b"\0" + struct.pack("<iBBBBii", ptype, 0, 0, 0, 0,
                                              1, 1) for c in (b"B", b"G", b"R"))
    dw = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (attr(b"channels", b"chlist", chans + b"\0")
              + attr(b"compression", b"compression", bytes([compression]))
              + attr(b"dataWindow", b"box2i", dw) + b"\0")
    lines = 16 if compression == 3 else 1
    blocks = []
    for y0 in range(0, h, lines):
        raw = b"".join(img[y, :, c].astype(dt).tobytes()
                       for y in range(y0, min(y0 + lines, h))
                       for c in (2, 1, 0))
        if compression:
            comp = jexr._zip_block(raw)
            raw = comp if len(comp) < len(raw) else raw
        blocks.append(struct.pack("<ii", y0, len(raw)) + raw)
    return (struct.pack("<ii", jexr._MAGIC, 2) + header
            + b"\0" * 8 * len(blocks) + b"".join(blocks))


@pytest.mark.parametrize("compression", [0, 2, 3])
@pytest.mark.parametrize("ptype", [1, 2])
def test_read_exr_every_compression_and_type(tmp_path, compression, ptype):
    rng = np.random.default_rng(compression * 3 + ptype)
    img = (rng.standard_normal((37, 21, 3)) * 40).astype(np.float32)
    img[3:9] = 1.0  # runs that zip shrinks
    path = tmp_path / "t.exr"
    path.write_bytes(_exr_bytes(img, compression, ptype))
    ours, ref = texr.read_exr(str(path)), jexr.read_exr(str(path))
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))
    want = img.astype(np.float16).astype(np.float32) if ptype == 1 else img
    np.testing.assert_array_equal(ours, want)


def test_write_exr_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    img = (rng.random((40, 33, 3)) * 100).astype(np.float32)
    img[::7] = 0.0
    ours, ref = tmp_path / "ours.exr", tmp_path / "ref.exr"
    texr.write_exr(str(ours), img)
    jexr.write_exr(str(ref), img)
    assert ours.read_bytes() == ref.read_bytes()
    for reader in (texr.read_exr, jexr.read_exr):
        np.testing.assert_array_equal(reader(str(ours)), img)


def test_exr_unsupported_raises(tmp_path):
    data = bytearray(_exr_bytes(np.ones((2, 2, 3), np.float32), 3, 2))
    i = data.index(b"compression\0compression\0") + 28
    data[i] = 4  # PIZ
    p = tmp_path / "piz.exr"
    p.write_bytes(bytes(data))
    with pytest.raises(NotImplementedError, match="PIZ"):
        texr.read_exr(str(p))
    with pytest.raises(NotImplementedError, match="PIZ"):
        load_texture_image(str(p))


@pytest.mark.parametrize("name", TEXTURES)
def test_ldr_textures_match_pil(name):
    path = os.path.join(SCENES, name)
    ours = load_texture_image(path)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, _pil(path))
    np.testing.assert_array_equal(ours, j_tex(path))


def test_ascii_ppm_matches_pil(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    p = tmp_path / "a.ppm"
    p.write_text("P3\n# a comment\n7 5\n255\n"
                 + "\n".join(" ".join(map(str, r)) for r in img.reshape(
                     -1, 21)) + "\n")
    np.testing.assert_array_equal(read_ppm(str(p)), img)
    np.testing.assert_array_equal(load_texture_image(str(p)), _pil(str(p)))


def _png(path, img, filters, interlace=0):
    """An 8-bit RGB(A) PNG with the given filter type per row."""
    h, w, c = img.shape
    bpp = c
    rows = []
    prior = np.zeros(w * c, np.int64)
    for y, ft in zip(range(h), filters):
        x = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ft == 0:
            f = x
        elif ft == 1:
            f = x - left
        elif ft == 2:
            f = x - prior
        elif ft == 3:
            f = x - (left + prior) // 2
        else:
            p = left + prior - ul
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, ul))
            f = x - pred
        rows.append(bytes([ft]) + (f & 0xFF).astype(np.uint8).tobytes())
        prior = x

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0,
                       interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_every_filter_matches_pil(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (10, 9, channels), dtype=np.uint8)
    p = str(tmp_path / "f.png")
    _png(p, img, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0])
    np.testing.assert_array_equal(read_png(p), img[..., :3])
    np.testing.assert_array_equal(load_texture_image(p), _pil(p))
    # PIL's own RGBA writer, adaptive filters
    Image.fromarray(img if channels == 4 else img[..., :3]).save(p)
    np.testing.assert_array_equal(load_texture_image(p), _pil(p))


@pytest.mark.parametrize("kind", ["JPEG", "16-bit PNG", "interlaced PNG",
                                  "palette PNG", "PGM"])
def test_undecoded_formats_raise(tmp_path, kind):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    p = str(tmp_path / "x.img")
    if kind == "JPEG":
        Image.fromarray(img).save(p, format="JPEG")
    elif kind == "16-bit PNG":
        Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(
            p, format="PNG")
    elif kind == "interlaced PNG":
        _png(p, img, [0] * 8, interlace=1)
    elif kind == "palette PNG":
        Image.fromarray(img).convert("P").save(p, format="PNG")
    else:
        Image.fromarray(img[..., 0]).save(p, format="PPM")
    assert Image.open(p) is not None  # PIL reads it
    with pytest.raises(NotImplementedError):
        load_texture_image(p)


def test_missing_or_corrupt_file_is_none(tmp_path):
    assert load_texture_image(str(tmp_path / "none.png")) is None
    assert j_tex(str(tmp_path / "none.png")) is None
    p = tmp_path / "bad.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 30)
    assert load_texture_image(str(p)) is None
    assert j_tex(str(p)) is None
