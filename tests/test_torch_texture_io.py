"""The port's image decoders against the JAX package's and PIL's
(craytracer_tpu_torch/io/exr.py, io/teximage.py, csrc/imgdecode.cpp):
`read_exr` bit-equal to the JAX reader on the tracked EXRs and on files
of every compression (NONE, ZIPS, ZIP) and channel type (HALF, FLOAT) it
reads; `write_exr` byte-equal to the JAX writer and round-tripping
through both readers; every LDR format and variant the JAX loader reads
through PIL and the port decodes (PNG of each depth, colour type and
interlace; JPEG baseline and progressive at every sampling the files
carry, CMYK and YCCK; PNM P1-P6 at any maxval; BMP; TGA; GIF) equal to
the JAX loader's array texel for texel, each file written into tmp_path
at a small odd size from a seed (by PIL, or byte by byte through
tests/torch_image_files.py where PIL writes no such file); files PIL
refuses give None in both (a 12-bit JPEG, an EXR the JAX reader refuses);
formats the port does not decode raise NotImplementedError; the committed
fixtures of chip_smoke.py phases 55 and 56 against their manifest. TIFF,
DDS, lossless WebP, PSD and PIL's own PNM variants are held to the JAX
loader in tests/test_torch_texture_formats.py."""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import torch_image_files as F

from craytracer_tpu.io import exr as jexr
from craytracer_tpu.io.teximage import load_texture_image as j_tex
from craytracer_tpu_torch.io import exr as texr
from craytracer_tpu_torch.io.image import read_ppm
from craytracer_tpu_torch.io.teximage import (decode_file, image_kind,
                                               load_texture_image, read_png)

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
    # the texture loader gives None, as the JAX loader does
    assert load_texture_image(str(p)) is None and j_tex(str(p)) is None


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


def _same(path, readable=True):
    """The port's texels equal the JAX loader's (PIL's), both float32;
    with readable=False both give None."""
    ours, ref = load_texture_image(str(path)), j_tex(str(path))
    if not readable:
        assert ref is None and ours is None
        return
    assert ref is not None and ours is not None
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def _pil_bytes(img, fmt, **kw):
    bio = io.BytesIO()
    img.save(bio, format=fmt, **kw)
    return bio.getvalue()


def _smooth(rng, h, w, c=3):
    """A smooth image with noise: what JPEG is made for."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 5 + k) * np.cos(y / 7 - k)
                     for k in range(c)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, c)), 0, 255).astype(
        np.uint8)


# formats the port decodes since it has its C++ decoders; each case is
# written as the earlier "undecoded" test wrote it
@pytest.mark.parametrize("kind", ["JPEG", "16-bit PNG", "interlaced PNG",
                                  "palette PNG", "PGM", "TIFF", "DDS", "PSD",
                                  "PFM"])
def test_formerly_undecoded_formats_match_jax(tmp_path, kind):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    p = str(tmp_path / "x.img")
    if kind == "JPEG":
        Image.fromarray(img).save(p, format="JPEG")
    elif kind == "16-bit PNG":
        Image.fromarray(img[..., 0].astype(np.uint16) * 200).save(
            p, format="PNG")
    elif kind == "interlaced PNG":
        # Adam7 passes (the earlier case flagged interlace on rows that
        # were not, which PIL rejects too)
        with open(p, "wb") as f:
            f.write(F.png_bytes(img, 8, 2, interlace=1))
    elif kind == "palette PNG":
        Image.fromarray(img).convert("P").save(p, format="PNG")
    elif kind in ("TIFF", "DDS"):
        Image.fromarray(img).save(p, format=kind)
    elif kind == "PSD":
        with open(p, "wb") as f:
            f.write(_psd(img))
    elif kind == "PFM":
        with open(p, "wb") as f:
            f.write(b"Pf\n8 8\n-1.0\n" + rng.random(64).astype(
                "<f4").tobytes())
    else:
        Image.fromarray(img[..., 0]).save(p, format="PPM")
    _same(p)


PNG_MODES = [(ct, d) for ct, ds in {0: (1, 2, 4, 8, 16), 2: (8, 16),
                                    3: (1, 2, 4, 8), 4: (8, 16),
                                    6: (8, 16)}.items() for d in ds]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", PNG_MODES)
def test_png_every_mode_matches_jax(tmp_path, ctype, depth, interlace):
    """Every bit depth and colour type, Adam7 or not, all five filters:
    low-bit gray scaled, 16-bit samples' high byte, 16-bit gray clipped
    at 255 (PIL's I;16), a palette of fewer entries than the depth
    allows."""
    rng = np.random.default_rng(100 * ctype + depth + 7 * interlace)
    for h, w in ((21, 13), (33, 47)):
        s = rng.integers(0, 1 << depth, (h, w, F.PNG_CHANNELS[ctype]))
        pal = rng.integers(0, 256, ((1 << depth) - (depth == 8), 3)) \
            if ctype == 3 else None
        p = tmp_path / f"m{h}.png"
        p.write_bytes(F.png_bytes(s, depth, ctype, interlace, palette=pal))
        _same(p)


def _png_case(kind, rng):
    s = rng.integers(0, 256, (21, 13, 1))
    rgb = rng.integers(0, 256, (21, 13, 3))
    if kind == "palette index past PLTE":
        return F.png_bytes(s, 8, 3, palette=rng.integers(0, 256, (5, 3)))
    if kind == "palette tRNS":
        return F.png_bytes(s, 8, 3, palette=rng.integers(0, 256, (256, 3)),
                           trns=bytes(range(100)))
    if kind == "gray tRNS":
        return F.png_bytes(s, 8, 0, trns=b"\0\5")
    if kind.startswith("zlib level"):
        return F.png_bytes(rgb, 8, 2, level=int(kind[-1]), idat_chunks=5)
    if kind == "stored blocks past 64 KiB":
        big = rng.integers(0, 256, (300, 300, 3))
        big[100:200] = 7
        return F.png_bytes(big, 8, 2, level=0, idat_chunks=3)
    if kind == "16-bit gray low values":
        return F.png_bytes(rng.integers(0, 600, (21, 13, 1)), 16, 0)
    img = Image.fromarray(rgb.astype(np.uint8))
    mode, _, bits = kind.partition(" PIL ")[2].partition(" bits ")
    kw = {"bits": int(bits)} if bits else {}
    return _pil_bytes(img.convert(mode), "PNG", optimize=True, **kw)


@pytest.mark.parametrize("kind", [
    "palette index past PLTE", "palette tRNS", "gray tRNS", "zlib level 0",
    "zlib level 1", "zlib level 9", "stored blocks past 64 KiB",
    "16-bit gray low values", "written by PIL 1", "written by PIL L",
    "written by PIL LA", "written by PIL I;16", "written by PIL P bits 1",
    "written by PIL P bits 2", "written by PIL P bits 4",
    "written by PIL RGBA"])
def test_png_cases_match_jax(tmp_path, kind):
    p = tmp_path / "c.png"
    p.write_bytes(_png_case(kind, np.random.default_rng(len(kind))))
    _same(p)


def test_png_broken_is_none(tmp_path):
    """A bad CRC before the image data and a cut stream: None in both,
    as PIL refuses both."""
    rng = np.random.default_rng(3)
    data = bytearray(F.png_bytes(rng.integers(0, 256, (9, 9, 1)), 8, 0))
    data[29] ^= 1  # inside IHDR
    (tmp_path / "crc.png").write_bytes(bytes(data))
    _same(tmp_path / "crc.png", readable=False)
    data[29] ^= 1
    (tmp_path / "cut.png").write_bytes(bytes(data[:len(data) // 2]))
    _same(tmp_path / "cut.png", readable=False)


JPEG_PIL = {
    "444": dict(subsampling="4:4:4"), "422": dict(subsampling="4:2:2"),
    "420": dict(subsampling="4:2:0"),
    "444 progressive": dict(subsampling="4:4:4", progressive=True),
    "422 progressive": dict(subsampling="4:2:2", progressive=True),
    "420 progressive": dict(subsampling="4:2:0", progressive=True),
    "420 optimized": dict(subsampling="4:2:0", optimize=True),
    "420 progressive optimized": dict(progressive=True, optimize=True),
    "gray": dict(mode="L"), "gray progressive": dict(mode="L",
                                                     progressive=True),
    "restart every block": dict(restart_marker_blocks=1),
    "restart every row progressive": dict(restart_marker_rows=1,
                                          progressive=True),
    "Adobe RGB": dict(keep_rgb=True),
    "Adobe CMYK": dict(mode="CMYK"),
    "Adobe CMYK progressive": dict(mode="CMYK", progressive=True),
    "quality 1": dict(quality=1), "quality 100": dict(quality=100),
    "16-bit tables (SOF1)": dict(qtables=[[300] * 64, [700] * 64]),
}


@pytest.mark.parametrize("size", [(21, 13), (47, 33), (9, 17), (1, 1)])
@pytest.mark.parametrize("variant", list(JPEG_PIL))
def test_jpeg_written_by_pil_matches_jax(tmp_path, variant, size):
    """Bit-equal to libjpeg-turbo through PIL: ISLOW IDCT, fancy
    upsampling, jdcolor.c's tables, PIL's CMYK; sizes that are not
    multiples of the MCU."""
    kw = dict(JPEG_PIL[variant])
    mode = kw.pop("mode", "RGB")
    rng = np.random.default_rng(sum(map(ord, variant)) + size[0])
    img = Image.fromarray(_smooth(rng, *size)).convert(mode)
    p = tmp_path / "j.jpg"
    p.write_bytes(_pil_bytes(img, "JPEG", **kw))
    _same(p)


JPEG_FACTORS = {
    "440 (h1v2)": [(1, 2), (1, 1), (1, 1)],
    "411 (h4v1)": [(4, 1), (1, 1), (1, 1)],
    "h3v1": [(3, 1), (1, 1), (1, 1)], "h1v4": [(1, 4), (1, 1), (1, 1)],
    "Cr at h2v1 of h2v2": [(2, 2), (1, 1), (2, 1)],
    "chroma above luma": [(1, 1), (2, 2), (1, 1)],
    "h4v1 over h2v1": [(4, 1), (2, 1), (2, 1)],
}


@pytest.mark.parametrize("size", [(21, 13), (9, 40), (2, 3)])
@pytest.mark.parametrize("case", list(JPEG_FACTORS) + [
    "restart 4:2:0", "Adobe YCCK", "Adobe CMYK", "CMYK no Adobe",
    "Adobe RGB h2v1", "gray at h2v2"])
def test_jpeg_sampling_factors_match_jax(tmp_path, case, size):
    """Sampling factors PIL does not write (a baseline file made by
    tests/torch_image_files.py): h1v2 fancy and box upsampling of every
    integral factor; YCCK and plain CMYK."""
    rng = np.random.default_rng(len(case) + size[1])
    pl = _smooth(rng, *size, c=4)
    ch = [pl[..., i] for i in range(4)]
    if case in JPEG_FACTORS:
        data = F.jpeg_bytes(ch[:3], JPEG_FACTORS[case])
    elif case == "restart 4:2:0":
        data = F.jpeg_bytes(ch[:3], [(2, 2), (1, 1), (1, 1)], restart=2)
    elif case == "Adobe YCCK":
        data = F.jpeg_bytes(ch, [(1, 1)] * 4, adobe=2)
    elif case == "Adobe CMYK":
        data = F.jpeg_bytes(ch, [(2, 1), (1, 1), (1, 1), (2, 1)], adobe=0)
    elif case == "CMYK no Adobe":
        data = F.jpeg_bytes(ch, [(2, 2), (1, 1), (1, 1), (2, 2)])
    elif case == "Adobe RGB h2v1":
        data = F.jpeg_bytes(ch[:3], [(2, 1), (1, 1), (1, 1)], adobe=0)
    else:
        data = F.jpeg_bytes(ch[:1], [(2, 2)])
    p = tmp_path / "f.jpg"
    p.write_bytes(data)
    _same(p)


def test_jpeg_libjpeg_refuses_is_none(tmp_path):
    """An MCU of 11 blocks and fractional factors: libjpeg refuses both,
    so PIL and the port give None."""
    rng = np.random.default_rng(8)
    ch = [c for c in _smooth(rng, 21, 13).transpose(2, 0, 1)]
    (tmp_path / "a.jpg").write_bytes(F.jpeg_bytes(
        ch, [(4, 2), (2, 1), (1, 1)]))
    _same(tmp_path / "a.jpg", readable=False)
    data = bytearray(F.jpeg_bytes(ch, [(2, 1), (1, 1), (1, 1)]))
    k = data.index(b"\xff\xc0")
    data[k + 11], data[k + 14] = 0x31, 0x21  # Y h3, Cb h2
    (tmp_path / "b.jpg").write_bytes(bytes(data))
    _same(tmp_path / "b.jpg", readable=False)


PNM_CASES = [(1, 1), (4, 1)] + [(k, m) for k in (2, 3, 5, 6)
                                for m in (1, 2, 15, 100, 255, 256, 1000,
                                          65535)]


@pytest.mark.parametrize("kind,maxval", PNM_CASES)
def test_pnm_every_magic_and_maxval_matches_jax(tmp_path, kind, maxval):
    """P1-P6 at any maxval: round(v * 255 / maxval) half to even; gray
    past 255 opens as mode I and clips at 255; plain files carry a
    comment among the values."""
    rng = np.random.default_rng(kind * 70000 + maxval)
    shape = (21, 13, 3) if kind in (3, 6) else (21, 13)
    img = rng.integers(0, maxval + 1, shape)
    img.reshape(-1)[:3] = [0, maxval, maxval // 2]
    p = tmp_path / "x.pnm"
    p.write_bytes(F.pnm_bytes(kind, img, maxval))
    _same(p)


@pytest.mark.parametrize("name,data,readable", [
    ("raw past maxval", b"P5 4 1 15 " + bytes([0, 15, 16, 200]), True),
    ("plain past maxval", b"P2 2 1 15 3 16", False),
    ("comment inside a value", b"P3\n2 1\n255\n1#x\n2 3 4 5 6 7\n", True),
    ("P1 without spaces", b"P1\n3 2\n010110\n", True),
    ("P1 with junk", b"P1\n3 1\n0 1 0 x\n", False),
    ("header comments", b"P6\n#a\n3 #b\n2\n255\n" + bytes(range(18)), True),
    ("cut", b"P6\n3 2\n255\n" + bytes(10), False),
    ("extra data", b"P5\n3 1\n255\nabcextra", True),
    ("maxval 65535 P6", b"P6 1 1 65535 " + bytes([0, 255, 1, 0, 255, 255]),
     True)])
def test_pnm_cases_match_jax(tmp_path, name, data, readable):
    p = tmp_path / "x.pnm"
    p.write_bytes(data)
    _same(p, readable)


def _bmp_case(case, rng):
    h, w = 21, 13
    px = rng.integers(0, 256, (h, w, 4))
    gray = np.repeat(np.arange(256)[:, None], 3, 1)
    parts = case.split()
    if parts[0] == "indexed":
        bits, hdr, rows = int(parts[1]), int(parts[2]), parts[3]
        n = 1 << bits
        idx = rng.integers(0, n, (h, w))
        return F.bmp_bytes(F.bmp_rows(idx, bits, rows == "top-down"), w, h,
                           bits, palette=rng.integers(0, 256, (n, 3)),
                           header=hdr, top_down=rows == "top-down")
    if case == "palette shorter than indices":
        idx = rng.integers(0, 256, (h, w))
        return F.bmp_bytes(F.bmp_rows(idx, 8), w, h, 8,
                           palette=rng.integers(0, 256, (100, 3)))
    if case == "8-bit gray ramp":
        return F.bmp_bytes(F.bmp_rows(px[..., 0], 8), w, h, 8, palette=gray)
    if case == "8-bit gray ramp of 16":
        return F.bmp_bytes(F.bmp_rows(px[..., 0], 8), w, h, 8,
                           palette=gray[:16])
    if case == "1-bit black and white":
        return F.bmp_bytes(F.bmp_rows(px[..., 0] % 2, 1), w, h, 1,
                           palette=[[0, 0, 0], [255, 255, 255]])
    if case == "24-bit":
        return F.bmp_bytes(F.bmp_rows(px[..., :3], 24), w, h, 24)
    if case == "24-bit top-down":
        return F.bmp_bytes(F.bmp_rows(px[..., :3], 24, True), w, h, 24,
                           top_down=True)
    if case == "32-bit":
        return F.bmp_bytes(F.bmp_rows(px, 32), w, h, 32)
    v = np.arange(65536, dtype="<u2").reshape(256, 256).view(
        np.uint8).reshape(256, 256, 2)
    if case == "16-bit 555 every value":
        return F.bmp_bytes(F.bmp_rows(v, 16), 256, 256, 16)
    if case.startswith("16-bit bitfields"):
        m = (0xF800, 0x7E0, 0x1F) if "565" in case else (0x7C00, 0x3E0, 0x1F)
        return F.bmp_bytes(F.bmp_rows(v, 16), 256, 256, 16, compression=3,
                           masks=m, header=40 if "40" in case else 56)
    if case == "32-bit bitfields after a 40-byte header":
        return F.bmp_bytes(F.bmp_rows(px, 32), w, h, 32, compression=3,
                           masks=(0xFF0000, 0xFF00, 0xFF))
    if case.startswith("32-bit bitfields"):
        m = tuple(int(x, 16) for x in parts[-1].split(","))
        return F.bmp_bytes(F.bmp_rows(px, 32), w, h, 32, compression=3,
                           masks=m, header=124)
    if case == "24-bit bitfields":
        return F.bmp_bytes(F.bmp_rows(px[..., :3], 24), w, h, 24,
                           compression=3, masks=(0xFF0000, 0xFF00, 0xFF),
                           header=56)
    rle8 = bytes([3, 5, 0, 4, 1, 2, 3, 4, 0, 0, 2, 9, 0, 3, 7, 8, 9, 0, 0, 0,
                  9, 200, 0, 0, 0, 2, 9, 9, 3, 0, 4, 6, 0, 0, 0, 5, 1, 2, 3,
                  4, 5, 0, 2, 77, 0, 1])
    rle4 = bytes([5, 0x12, 0, 3, 0x34, 0x50, 0, 0, 0, 4, 0xAB, 0xCD, 3, 0x9F,
                  0, 0, 9, 0x12, 0, 0, 7, 0x33, 0, 0, 0, 6, 0x12, 0x34, 0x56,
                  0, 1, 0x70, 0, 1])
    p256, p16 = rng.integers(0, 256, (256, 3)), rng.integers(0, 256, (16, 3))
    if case == "RLE8":
        return F.bmp_bytes(rle8, 7, 5, 8, palette=p256, compression=1)
    if case == "RLE8 top-down":
        return F.bmp_bytes(rle8, 7, 5, 8, palette=p256, compression=1,
                           top_down=True)
    if case == "RLE8 gray ramp":
        return F.bmp_bytes(rle8, 7, 5, 8, palette=gray, compression=1)
    if case == "RLE8 ended early":
        return F.bmp_bytes(rle8[:-12] + bytes([0, 1]), 7, 5, 8, palette=p256,
                           compression=1)
    assert case == "RLE4"
    return F.bmp_bytes(rle4, 7, 5, 4, palette=p16, compression=2)


BMP_CASES = (
    [f"indexed {b} {hd} {r}" for b in (1, 4, 8) for hd in (12, 40, 108, 124)
     for r in ("bottom-up", "top-down") if not (hd == 12 and r == "top-down")]
    + ["palette shorter than indices", "8-bit gray ramp",
       "8-bit gray ramp of 16", "1-bit black and white", "24-bit",
       "24-bit top-down", "32-bit", "16-bit 555 every value",
       "16-bit bitfields 565 40", "16-bit bitfields 555 56",
       "24-bit bitfields", "32-bit bitfields after a 40-byte header"]
    + [f"32-bit bitfields {m}" for m in (
        "ff0000,ff00,ff,0", "ff000000,ff0000,ff00,0", "ff000000,ff00,ff,0",
        "ff000000,ff0000,ff00,ff", "ff,ff00,ff0000,ff000000",
        "ff0000,ff00,ff,ff000000", "ff000000,ff00,ff,ff0000", "0,0,0,0")]
    + ["RLE8", "RLE8 top-down", "RLE8 gray ramp", "RLE4"])


@pytest.mark.parametrize("case", BMP_CASES)
def test_bmp_matches_jax(tmp_path, case):
    """Every depth, header and row order, the BITFIELDS layouts PIL
    accepts, RLE8/RLE4 with encoded, absolute and delta packets (PIL's
    decoder byte for byte: a delta reads four bytes and uses the last
    two, an odd RLE4 absolute run loses its last pixel)."""
    p = tmp_path / "b.bmp"
    p.write_bytes(_bmp_case(case, np.random.default_rng(len(case))))
    _same(p)


@pytest.mark.parametrize("case", ["RLE8 ended early",
                                  "32-bit bitfields ff00,ff,ff0000,0"])
def test_bmp_pil_refuses_is_none(tmp_path, case):
    p = tmp_path / "b.bmp"
    p.write_bytes(_bmp_case(case, np.random.default_rng(1)))
    _same(p, readable=False)


TGA_CASES = [(it, dp) for it, dp in ((2, 24), (2, 32), (2, 16), (3, 8),
                                     (3, 16), (3, 1), (1, 8), (10, 24),
                                     (10, 32), (10, 16), (11, 8), (11, 16),
                                     (9, 8))]


@pytest.mark.parametrize("descriptor", [0, 0x10, 0x20, 0x30])
@pytest.mark.parametrize("itype,depth", TGA_CASES)
def test_tga_matches_jax(tmp_path, itype, depth, descriptor):
    """Raw and RLE (runs inside a row, literals across rows),
    colour-mapped, true-colour and gray, both origins and the
    right-to-left flag."""
    rng = np.random.default_rng(itype * 100 + depth)
    w, h = 7, 20
    cmap = rng.integers(0, 256, (200 * 3,)).astype(np.uint8).tobytes() \
        if itype & 7 == 1 else None
    if depth == 1:
        data = np.packbits(rng.integers(0, 2, (h, w)).astype(np.uint8),
                           axis=1).tobytes()
    else:
        bpp = depth // 8
        px = rng.integers(0, 256, (h * w * bpp,)).astype(np.uint8)
        data = F.tga_rle(px, bpp, (3, 128 + 2, 2, 11, 3)) if itype & 8 \
            else px.tobytes()
    p = tmp_path / "t.tga"
    p.write_bytes(F.tga_bytes(data, w, h, itype, depth, cmap=cmap,
                              descriptor=descriptor))
    _same(p)


@pytest.mark.parametrize("case,readable", [
    ("map 16-bit", True), ("map 24-bit from 5", True), ("map 32-bit", False),
    ("map 15-bit", False), ("gray through a 24-bit map", True),
    ("gray+alpha through a 16-bit map", True),
    ("true-colour with a map", False), ("1-bit with a map", False),
    ("run across rows", False), ("8-bit true-colour", False)])
def test_tga_cases_match_jax(tmp_path, case, readable):
    """Colour maps: PIL applies 16- and 24-bit ones to palette and gray
    images and refuses the rest; a run packet past its row is an error
    in PIL's decoder."""
    rng = np.random.default_rng(len(case))
    w, h = 7, 5
    px = rng.integers(0, 256, (h * w * 3,)).astype(np.uint8)
    md = {"16": 16, "24": 24, "32": 32, "15": 15}.get(
        case.split("-bit")[0][-2:], 24)
    cmap = rng.integers(0, 256, (100 * max(2, md // 8),)).astype(
        np.uint8).tobytes()
    if case.startswith("map"):
        data = F.tga_bytes(px[:35].tobytes(), w, h, 1, 8, cmap=cmap,
                           cmap_depth=md, cmap_start=5 if "from" in case
                           else 0)
    elif case.startswith("gray+alpha"):
        data = F.tga_bytes(px[:70].tobytes(), w, h, 3, 16, cmap=cmap,
                           cmap_depth=md)
    elif case.startswith("gray"):
        data = F.tga_bytes(px[:35].tobytes(), w, h, 3, 8, cmap=cmap,
                           cmap_depth=md)
    elif case == "true-colour with a map":
        data = F.tga_bytes(px.tobytes(), w, h, 2, 24, cmap=cmap)
    elif case == "1-bit with a map":
        data = F.tga_bytes(px[:5].tobytes(), w, h, 3, 1, cmap=cmap)
    elif case == "run across rows":
        run = np.repeat(px[:3][None], w * h, 0).reshape(-1)
        data = F.tga_bytes(F.tga_rle(run, 3, (128 + 10,)), w, h, 10, 24)
    else:
        data = F.tga_bytes(px[:35].tobytes(), w, h, 2, 8)
    p = tmp_path / "t.tga"
    p.write_bytes(data)
    _same(p, readable)


GIF_CASES = ["global", "local", "offset", "offset transparent", "no palette",
             "gray ramp palette", "clear codes", "frame past the screen"]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("case", GIF_CASES)
def test_gif_matches_jax(tmp_path, case, bits, interlace):
    """The first frame: LZW at every code size, global and local
    palettes, the frame at an offset on the logical screen (the rest
    index 0, or the transparent index), no palette or an identity one
    (PIL's mode L)."""
    rng = np.random.default_rng(bits * 10 + len(case))
    h, w = 21, 13
    n = 1 << bits
    idx = rng.integers(0, n, (h, w))
    gp = rng.integers(0, 256, (n, 3))
    kw = {"global_palette": gp, "interlace": interlace}
    if case == "local":
        kw["local_palette"] = gp[::-1]
    elif case.startswith("offset"):
        kw.update(screen=(w + 9, h + 4), offset=(3, 2))
        if "transparent" in case:
            kw["transparency"] = 1
    elif case == "no palette":
        del kw["global_palette"]
    elif case == "gray ramp palette":
        kw["global_palette"] = np.repeat(np.arange(n)[:, None], 3, 1)
    elif case == "clear codes":
        kw["clear_every"] = 7
    elif case == "frame past the screen":
        kw.update(screen=(w - 3, h - 5), offset=(2, 3))
    p = tmp_path / "g.gif"
    p.write_bytes(F.gif_bytes(idx, **kw))
    _same(p)


@pytest.mark.parametrize("case", [
    "index past the palette", "large", "long runs", "PIL P", "PIL L",
    "PIL P not interlaced"])
def test_gif_cases_match_jax(tmp_path, case):
    rng = np.random.default_rng(len(case))
    if case == "index past the palette":
        data = F.gif_bytes(rng.integers(0, 256, (21, 13)), bits=8,
                           global_palette=rng.integers(0, 256, (4, 3)))
    elif case == "large":
        data = F.gif_bytes(rng.integers(0, 256, (150, 150)),
                           global_palette=rng.integers(0, 256, (256, 3)))
    elif case == "long runs":
        sm = (np.add.outer(np.arange(120), np.arange(90)) // 7) % 256
        data = F.gif_bytes(sm, global_palette=rng.integers(0, 256, (256, 3)))
    else:
        img = Image.fromarray(rng.integers(0, 256, (21, 13, 3)).astype(
            np.uint8)).convert(case.split()[1])
        data = _pil_bytes(img, "GIF", interlace="not" not in case)
    p = tmp_path / "g.gif"
    p.write_bytes(data)
    _same(p)


def _psd(img):
    """A minimal PSD: RGB, 8 bits, raw planar image data."""
    h, w = img.shape[:2]
    return (b"8BPS" + struct.pack(">H6xHIIHH", 1, 3, h, w, 8, 3)
            + struct.pack(">III", 0, 0, 0) + struct.pack(">H", 0)
            + img.transpose(2, 0, 1).tobytes())


def _unrefined_progressive(img):
    """A progressive JPEG of PIL's without its refinement scans (Ah > 0):
    libjpeg block-smooths such a file."""
    data = _pil_bytes(Image.fromarray(img), "JPEG", progressive=True)
    out, p = bytearray(data[:2]), 2
    while p < len(data):
        m = data[p + 1]
        if m == 0xD9:
            out += data[p:p + 2]
            break
        q = p + 2 + struct.unpack(">H", data[p + 2:p + 4])[0]
        if m == 0xDA:
            while not (data[q] == 0xFF and data[q + 1] not in
                       (0, *range(0xD0, 0xD8))):
                q += 1
            ns = data[p + 4]
            if data[p + 4 + 1 + 2 * ns + 2] >> 4:  # Ah: a refinement scan
                p = q
                continue
        out += data[p:q]
        p = q
    return bytes(out)


@pytest.mark.parametrize("kind", ["lossy WebP", "JPEG 2000",
                                  "arithmetic JPEG (SOF9)",
                                  "unrefined progressive JPEG"])
def test_undecoded_formats_raise(tmp_path, kind):
    """Formats the JAX loader reads through PIL and the port does not:
    NotImplementedError naming them, never a quiet None."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    p = tmp_path / "x.img"
    if kind in ("lossy WebP", "JPEG 2000"):
        fmt = {"lossy WebP": "WEBP", "JPEG 2000": "JPEG2000"}[kind]
        p.write_bytes(_pil_bytes(Image.fromarray(img), fmt))
    elif kind.startswith("arithmetic"):
        data = bytearray(_pil_bytes(Image.fromarray(img), "JPEG"))
        data[data.index(b"\xff\xc0") + 1] = 0xC9
        p.write_bytes(bytes(data))
    else:
        p.write_bytes(_unrefined_progressive(img))
    assert j_tex(str(p)) is not None  # the JAX package renders it
    named = {"lossy WebP": "lossy WebP \\(VP8\\)", "JPEG 2000": "JPEG 2000",
             "arithmetic JPEG (SOF9)": "SOF9 \\(arithmetic",
             "unrefined progressive JPEG": "unrefined"}[kind]
    with pytest.raises(NotImplementedError, match=named):
        load_texture_image(str(p))


def test_twelve_bit_jpeg_is_none(tmp_path):
    """A 12-bit JPEG: libjpeg's 8-bit interface, which PIL calls, refuses
    it, so the JAX loader gives None, and so does the port."""
    rng = np.random.default_rng(4)
    data = bytearray(F.jpeg_bytes([_smooth(rng, 9, 9)[..., 0]], [(1, 1)]))
    data[data.index(b"\xff\xc0") + 4] = 12
    (tmp_path / "x.jpg").write_bytes(bytes(data))
    _same(tmp_path / "x.jpg", readable=False)


FIXTURES = os.path.join(os.path.dirname(SCENES), "craytracer_tpu_torch",
                        "testdata", "textures")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_manifest_matches_pil_and_port(name):
    """The committed fixtures chip_smoke.py phase 55 decodes on the card:
    the manifest's hash is PIL's decode of the file and the port's."""
    path = os.path.join(FIXTURES, name)
    want = MANIFEST[name]
    pil = np.asarray(Image.open(path).convert("RGB"))
    assert list(pil.shape) == want["shape"]
    assert hashlib.sha256(pil.tobytes()).hexdigest() == want["sha256"]
    ours = decode_file(path)
    assert hashlib.sha256(ours.tobytes()).hexdigest() == want["sha256"]


def test_checker_variants_equal_the_ppm():
    """The lossless re-encodings of parity_textured's checker that phase
    55 renders hold exactly the PPM's texels."""
    ppm = read_ppm(os.path.join(SCENES, "parity_tex_checker.ppm"))
    for name in ("checker_palette.png", "checker_interlaced.png",
                 "checker_rgb16.png", "checker_24.bmp", "checker_rle.tga",
                 "checker.gif"):
        np.testing.assert_array_equal(
            decode_file(os.path.join(FIXTURES, name)), ppm, err_msg=name)


def test_image_kind_by_magic_not_name(tmp_path):
    """The decoder is chosen by the file's first bytes: a PNG named .jpg
    loads as PNG, as PIL loads it."""
    rng = np.random.default_rng(6)
    p = tmp_path / "looks.jpg"
    p.write_bytes(F.png_bytes(rng.integers(0, 256, (5, 4, 3)), 8, 2))
    assert image_kind(p.read_bytes()[:18]) == "png"
    _same(p)


def test_missing_or_corrupt_file_is_none(tmp_path):
    assert load_texture_image(str(tmp_path / "none.png")) is None
    assert j_tex(str(tmp_path / "none.png")) is None
    p = tmp_path / "bad.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 30)
    assert load_texture_image(str(p)) is None
    assert j_tex(str(p)) is None


def test_empty_file_is_none(tmp_path):
    """An empty texture file: PIL cannot identify it, the JAX loader
    gives None, and so does the port (no format to refuse)."""
    p = tmp_path / "empty.png"
    p.write_bytes(b"")
    _same(p, readable=False)


def test_decoders_run_in_threads(tmp_path):
    """ctypes calls run without the GIL: eight threads decoding PNG and
    JPEG at once (the decoders' constant tables built on first use) give
    the single-threaded texels."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(9)
    img = Image.fromarray(_smooth(rng, 64, 48))
    paths = [tmp_path / "t.jpg", tmp_path / "t.png"]
    paths[0].write_bytes(_pil_bytes(img, "JPEG", progressive=True))
    paths[1].write_bytes(_pil_bytes(img, "PNG"))
    want = [decode_file(str(p)) for p in paths]
    with ThreadPoolExecutor(8) as ex:
        futs = [ex.submit(decode_file, str(paths[i % 2])) for i in range(64)]
        got = [f.result(timeout=60) for f in futs]
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g, want[i % 2])
