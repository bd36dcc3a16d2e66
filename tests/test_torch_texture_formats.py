"""The port's TIFF, DDS, lossless WebP, PSD and PIL-own PNM decoders
(craytracer_tpu_torch/csrc/imgdecode_*.h, imgdecode.cpp) against the JAX
package's texture loader, which reads them through PIL: every file is
written into tmp_path at a small size from a seed (by PIL, or byte by byte
through tests/torch_tiff_files.py where PIL writes no such file), and
`load_texture_image` of both packages gives equal texels
(assert_array_equal) or both give None. Also: the EXR files the JAX reader
refuses give None through both loaders; formats PIL reads and the port
does not raise NotImplementedError naming them; native.build_shared
rebuilds when a file the source includes changes."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image
from PIL.TiffImagePlugin import II, OPEN_INFO

import torch_tiff_files as T

from craytracer_tpu.io.teximage import load_texture_image as j_tex
from craytracer_tpu_torch import native
from craytracer_tpu_torch.io.teximage import image_kind, load_texture_image


def _same(path, readable=True):
    """The port's texels equal the JAX loader's, both float32; with
    readable=False both give None. Every case states which it expects, so
    no case passes by comparing two Nones where PIL should have read it."""
    ours, ref = load_texture_image(str(path)), j_tex(str(path))
    if not readable:
        assert ref is None and ours is None
        return
    assert ref is not None and ours is not None
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def _cases(rows):
    """pytest params whose last value, the expected readability, is left
    out of the test id."""
    return [pytest.param(*r, id="-".join(
        v.decode() if isinstance(v, bytes) else str(v) for v in r[:-1]))
        for r in rows]


def _write(tmp_path, data, name="x.img"):
    p = tmp_path / name
    p.write_bytes(data)
    return p


def _smooth(rng, h, w, c=3):
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 5 + k) * np.cos(y / 7 - k)
                     for k in range(c)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, c)), 0, 255).astype(
        np.uint8)


def _pil(img, fmt, **kw):
    bio = io.BytesIO()
    img.save(bio, format=fmt, **kw)
    return bio.getvalue()


# ------------------------------------------------------------------ TIFF

_KEYS = [k for k, (m, _) in OPEN_INFO.items() if m != "LAB"]


def _key_id(k):
    o, ph, sf, fo, bps, ex = k
    return (f"{'II' if o == II else 'MM'}-p{ph}-s{sf[0]}-f{fo}-"
            f"b{'x'.join(map(str, bps))}-e{''.join(map(str, ex)) or 'none'}")


# OPEN_INFO rawmodes PIL's own unpacker (uncompressed files) lacks
_NO_UNPACKER = {"L;IR", "P;1R", "P;2R", "P;4R"}


def _pil_fails(key, comp, planar):
    """Where PIL fails on a layout and encoding, so the JAX loader gives
    None: an uncompressed file whose rawmode PIL cannot unpack; through
    libtiff, single-sample YCbCr, and planar files whose rawmode pads
    extra samples (X), which PIL's planar read refuses (decoder error)."""
    ph, bps, raw = key[1], key[4], OPEN_INFO[key][1]
    if comp == 1:
        return raw in _NO_UNPACKER
    return (ph == 6 and len(bps) == 1) or (planar == 2 and "X" in raw)


@pytest.mark.parametrize("key", _KEYS, ids=[_key_id(k) for k in _KEYS])
def test_tiff_every_pil_layout(tmp_path, key):
    """Each (byte order, photometric, sample format, fill order, depth,
    extra samples) PIL opens, uncompressed in strips and tiles, LZW,
    Deflate with the predictor its samples allow, PackBits tiles and
    planar LZW: the port gives PIL's texels, and None where _pil_fails
    names PIL's failure."""
    o, ph, sf, fo, bps, ex = key
    rng = np.random.default_rng(zlib.crc32(_key_id(key).encode()))
    spp, b = len(bps), bps[0]
    h, w = 7, 11
    if sf[0] == 3:
        s = (rng.standard_normal((h, w, spp)) * 100).astype(np.float32)
        s[0, :4, 0] = [0.5, 1.5, 300, -2]
    else:
        s = rng.integers(0, 1 << b, (h, w, spp))
        if sf[0] == 2:
            s -= 1 << (b - 1)
    cmap = rng.integers(0, 65536, (1 << b, 3)) if ph == 3 else None
    pred = 3 if sf[0] == 3 else 2 if b in (8, 16, 32) else 1
    for comp, p, tile, planar in ((1, 1, None, 1), (1, 1, (16, 16), 1),
                                  (5, 1, None, 1), (8, pred, None, 1),
                                  (32773, 1, (16, 16), 1),
                                  (5, 1, None, 2 if spp > 1 else 1)):
        data = T.tiff_bytes(s, b, ph, order="<" if o == II else ">",
                            sample_format=sf[0], extra=ex, compression=comp,
                            predictor=p, tile=tile, planar=planar,
                            fill_order=fo, colormap=cmap, rows_per_strip=3)
        _same(_write(tmp_path, data, f"c{comp}_p{planar}_t{bool(tile)}.tif"),
              not _pil_fails(key, comp, planar))


PIL_TIFF = [(c, m) for c in ("tiff_lzw", "tiff_adobe_deflate", "packbits",
                             "raw")
            for m in ("RGB", "L", "CMYK", "RGBA", "LA", "P", "1", "I;16", "I",
                      "F")] + [("jpeg", m) for m in
                               ("RGB", "L", "CMYK", "RGBA", "LA")]


@pytest.mark.parametrize("compression,mode", PIL_TIFF)
def test_tiff_written_by_pil(tmp_path, compression, mode):
    rng = np.random.default_rng(len(compression) * 7 + len(mode))
    img = _smooth(rng, 37, 29)
    im = (Image.fromarray(img).convert(mode) if mode not in ("I;16", "I", "F")
          else Image.fromarray(img[..., 0].astype(np.int32) * 3).convert(mode))
    _same(_write(tmp_path, _pil(im, "TIFF", compression=compression)))


def _jpeg_split(data):
    """A JPEG split as libtiff writes one: (the tables, DQT and DHT between
    SOI and EOI; the stream without them)."""
    tables, rest, p = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while p < len(data):
        m = data[p + 1]
        if m == 0xDA:
            rest += data[p:]
            break
        q = p + 2 + struct.unpack(">H", data[p + 2:p + 4])[0]
        (tables if m in (0xDB, 0xC4) else rest).extend(data[p:q])
        p = q
    return bytes(tables + b"\xff\xd9"), bytes(rest)


@pytest.mark.parametrize("layout", ["strips16", "strip", "tiles", "tables"])
@pytest.mark.parametrize("ss,sub", [("4:2:0", (2, 2)), ("4:2:2", (2, 1)),
                                    ("4:4:4", (1, 1))])
def test_tiff_ycbcr_jpeg(tmp_path, layout, ss, sub):
    """JPEG-compressed YCbCr (libtiff's JPEGCOLORMODE_RGB: the JPEG
    decoder's colour path and fancy upsampling per strip or tile), with the
    tables in each segment or in JPEGTables."""
    rng = np.random.default_rng(11)
    img = _smooth(rng, 37, 29)
    tables = []

    def jpeg(seg):
        data = _pil(Image.fromarray(seg.astype(np.uint8)), "JPEG",
                    subsampling=ss)
        if layout == "tables":
            tab, data = _jpeg_split(data)
            tables.append(tab)
        return data

    kw = dict(compression=7, jpeg=jpeg, extra_tags=[(530, 3, list(sub))])
    if layout == "tiles":
        kw["tile"] = (16, 16)
    else:
        kw["rows_per_strip"] = 37 if layout == "strip" else 16
    data = T.tiff_bytes(img, 8, 6, **kw)
    if layout == "tables":  # the same tables for every strip
        data = T.tiff_bytes(img, 8, 6, jpeg_tables=list(tables[0]), **kw)
    _same(_write(tmp_path, data))


def _ycc_tiff(y, cb, cr, ssh, ssv, comp, ref=None):
    """A one-strip YCbCr TIFF of subsampling blocks (ssh x ssv luma
    samples, then Cb and Cr) under `comp`."""
    h, w = y.shape
    raw = bytearray()
    for by in range(0, h, ssv):
        for bx in range(0, w, ssh):
            for yy in range(ssv):
                for xx in range(ssh):
                    raw.append(int(y[by + yy, bx + xx])
                               if by + yy < h and bx + xx < w else 0)
            raw += bytes([int(cb[by // ssv, bx // ssh]),
                          int(cr[by // ssv, bx // ssh])])
    blob = (T.lzw_tiff(bytes(raw)) if comp == 5 else zlib.compress(bytes(raw))
            if comp == 8 else T.packbits(bytes(raw)))
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]),
            (259, 3, [comp]), (262, 3, [6]), (273, 4, [8]), (277, 3, [3]),
            (278, 3, [h]), (279, 4, [len(blob)]), (530, 3, [ssh, ssv])]
    if ref is not None:
        tags.append((532, 5, ref))
    tags.sort()
    base = 8 + len(blob) + (len(blob) & 1)
    extra_at = base + 2 + 12 * len(tags) + 4
    ifd, tail = struct.pack("<H", len(tags)), b""
    for t, ty, v in tags:
        p = struct.pack("<" + ("H" if ty == 3 else "I") * len(v), *v)
        n = len(v) // 2 if ty == 5 else len(v)
        if len(p) <= 4:
            ifd += struct.pack("<HHI", t, ty, n) + p.ljust(4, b"\0")
        else:
            ifd += struct.pack("<HHII", t, ty, n, extra_at + len(tail))
            tail += p
    return (b"II*\0" + struct.pack("<I", base) + blob
            + b"\0" * (len(blob) & 1) + ifd + b"\0\0\0\0" + tail)


@pytest.mark.parametrize("comp", [5, 8, 32773])
@pytest.mark.parametrize("ssh,ssv", [(1, 1), (2, 1), (2, 2), (4, 2),
                                     (1, 2), (4, 1), (4, 4), (1, 4),
                                     (2, 4)])
def test_tiff_ycbcr_subsampled(tmp_path, comp, ssh, ssv):
    """YCbCr outside JPEG: libtiff's RGBA reader (each block's chroma
    shared, TIFFYCbCrtoRGB; a strip read at TIFFScanlineSize a row, so
    4x4's last block row loses its chroma); 2x2 also under a
    ReferenceBlackWhite; 1x4 and 2x4, which libtiff has no routine for,
    give None."""
    rng = np.random.default_rng(ssh * 10 + ssv + comp)
    for h, w in ((13, 10), (5, 17)):
        y = rng.integers(0, 256, (h, w))
        cb = rng.integers(0, 256, ((h + ssv - 1) // ssv,
                                   (w + ssh - 1) // ssh))
        cr = rng.integers(0, 256, cb.shape)
        ref = ([16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1]
               if (ssh, ssv) == (2, 2) else None)
        _same(_write(tmp_path, _ycc_tiff(y, cb, cr, ssh, ssv, comp, ref)),
              readable=ssv != 4 or ssh == 4)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation(tmp_path, orientation):
    """PIL applies the Orientation tag on load (exif_transpose)."""
    rng = np.random.default_rng(orientation)
    img = rng.integers(0, 256, (5, 7, 3))
    for comp in (1, 5):
        _same(_write(tmp_path, T.tiff_bytes(img, 8, 2, compression=comp,
                                            orientation=orientation)))


@pytest.mark.parametrize("case,readable", _cases([
    ("bigtiff", True), ("bigtiff MM", False), ("invalid II", True),
    ("invalid MM", True), ("truncated strip", False),
    ("truncated LZW", False), ("no width", False), ("no offsets", False),
    ("second page", True)]))
def test_tiff_cases(tmp_path, case, readable):
    """BigTIFF (PIL misreads the big-endian one: None), the headers PIL
    also accepts, and files PIL fails on."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (9, 6, 3))
    if case.startswith("bigtiff"):
        data = T.tiff_bytes(img, 8, 2, big=True, compression=5,
                            order=">" if "MM" in case else "<")
    elif case.startswith("invalid"):
        data = bytearray(T.tiff_bytes(img, 8, 2, order="<" if "II" in case
                                      else ">"))
        data[2:4] = data[3:1:-1]  # "II\0*" / "MM*\0"
        data = bytes(data)
    elif case == "truncated strip":
        data = T.tiff_bytes(img, 8, 2, rows_per_strip=4)
        data = data[:20] + data[-300:]  # the IFD keeps its offsets
    elif case == "truncated LZW":
        data = bytearray(T.tiff_bytes(img, 8, 2, compression=5))
        data[8:40] = bytes(32)
        data = bytes(data)
    elif case == "no width":
        data = T.tiff_bytes(img, 8, 2, tag_order=lambda t: t)
        data = data.replace(struct.pack("<HHI", 256, 4, 1),
                            struct.pack("<HHI", 999, 4, 1))
    elif case == "no offsets":
        data = T.tiff_bytes(img, 8, 2)
        data = data.replace(struct.pack("<HHI", 273, 4, 1),
                            struct.pack("<HHI", 998, 4, 1))
    else:  # two pages: the first is the texture
        im = Image.fromarray(img.astype(np.uint8))
        data = _pil(im, "TIFF", save_all=True,
                    append_images=[im.transpose(Image.Transpose.ROTATE_90)])
    _same(_write(tmp_path, data), readable)


@pytest.mark.parametrize("kind", ["group4", "tiff_ccitt", "group3", "lzma",
                                  "zstd", "old-style LZW", "Lab"])
def test_tiff_refused_compressions_raise(tmp_path, kind):
    """What PIL reads and the port does not: NotImplementedError naming
    it, never a quiet None."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    named = {"group4": "Group 4", "tiff_ccitt": "CCITT RLE", "group3":
             "Group 3", "lzma": "LZMA", "zstd": "ZSTD"}.get(kind, kind)
    if kind == "old-style LZW":
        data = bytearray(T.tiff_bytes(img, 8, 2, compression=5))
        data[8:10] = b"\x00\x01"  # the first bytes of an LSB-first stream
        p = _write(tmp_path, bytes(data))
    elif kind == "Lab":
        p = _write(tmp_path, _pil(Image.fromarray(img).convert("LAB"),
                                  "TIFF"))
        assert j_tex(str(p)) is not None
    else:
        im = Image.fromarray(img)
        if kind in ("group4", "tiff_ccitt", "group3"):
            im = im.convert("1")
        p = _write(tmp_path, _pil(im, "TIFF", compression=kind))
        assert j_tex(str(p)) is not None  # the JAX package renders it
    with pytest.raises(NotImplementedError, match=named):
        load_texture_image(str(p))


# ------------------------------------------------------------------- DDS

# what PIL refuses: signed BC4 by FourCC, BC1_UNORM_SRGB (72),
# BC4_SNORM (81) and BC6H_TYPELESS (94)
_DDS_REFUSED = {"BC4S", "DXGI72", "DXGI81", "DXGI94"}
_BLOCK_FORMATS = (
    [(n, dict(fourcc=n.encode()), 8 if n in ("DXT1", "ATI1", "BC4U", "BC4S")
      else 16) for n in ("DXT1", "DXT3", "DXT5", "ATI1", "BC4U", "BC4S",
                         "ATI2", "BC5U", "BC5S")]
    + [(f"DXGI{f}", dict(dxgi=f), 8 if f in (70, 71, 72, 79, 80, 81) else 16)
       for f in (70, 71, 72, 73, 74, 76, 77, 79, 80, 81, 82, 83, 84, 94, 95,
                 96, 97, 98, 99)])


@pytest.mark.parametrize("name,kw,bsize", _BLOCK_FORMATS,
                         ids=[f[0] for f in _BLOCK_FORMATS])
def test_dds_random_blocks(tmp_path, name, kw, bsize):
    """Random bytes as the blocks of each FourCC and DXGI format (every BC6H
    and BC7 mode, partition and rounding rule met), at sizes that are and
    are not multiples of 4; formats PIL refuses (BC4 signed, the sRGB and
    typeless variants it does not list: _DDS_REFUSED) give None."""
    rng = np.random.default_rng(sum(map(ord, name)))
    for w, h in ((64, 32), (13, 10), (1, 1)):
        nb = ((w + 3) // 4) * ((h + 3) // 4)
        data = T.dds_bytes(w, h, rng.integers(0, 256, nb * bsize).astype(
            np.uint8).tobytes(), **kw)
        _same(_write(tmp_path, data, f"{w}x{h}.dds"),
              name not in _DDS_REFUSED)


@pytest.mark.parametrize("mode,fmt", [("RGB", None), ("RGBA", None),
                                      ("L", None), ("LA", None),
                                      ("RGBA", "DXT1"), ("RGBA", "DXT3"),
                                      ("RGBA", "DXT5"), ("RGBA", "BC2"),
                                      ("RGBA", "BC3")])
def test_dds_written_by_pil(tmp_path, mode, fmt):
    rng = np.random.default_rng(7)
    im = Image.fromarray(_smooth(rng, 21, 14, 4)).convert(mode)
    kw = {"pixel_format": fmt} if fmt else {}
    _same(_write(tmp_path, _pil(im, "DDS", **kw)))


# name, bit count, RGBA masks, pixel-format flags, and what a full and a
# half-length file give: "img", or None where PIL fails
_MASKS = [("BGR24", 24, (0xFF0000, 0xFF00, 0xFF, 0), 0x40, "img", "img"),
          ("RGBA32", 32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000), 0x41, "img",
           "img"),
          ("A1X7R8G8B8", 32, (0xFF0000, 0xFF00, 0xFF, 0x80000000), 0x41,
           "img", "img"),
          ("R1X15G8B8", 32, (0x80000000, 0xFF00, 0xFF, 0), 0x40, "img",
           "img"),
          ("R5G6B5", 16, (0xF800, 0x7E0, 0x1F, 0), 0x40, "img", "img"),
          ("A1R5G5B5", 16, (0x7C00, 0x3E0, 0x1F, 0x8000), 0x41, "img",
           "img"),
          ("A4R4G4B4", 16, (0xF00, 0xF0, 0xF, 0xF000), 0x41, "img", "img"),
          ("R3G3B2", 8, (0xE0, 0x1C, 0x3, 0), 0x40, "img", "img"),
          ("L8", 8, (0xFF, 0, 0, 0), 0x20000, "img", None),
          ("A8L8", 16, (0xFF, 0, 0, 0xFF00), 0x20001, "img", None),
          ("L16", 16, (0xFFFF, 0, 0, 0), 0x20000, None, None),
          ("A8", 8, (0, 0, 0, 0xFF), 0x2, None, None),
          ("P8", 8, (0, 0, 0, 0), 0x20, "img", None)]


@pytest.mark.parametrize("name,bits,masks,flags,full,half", _MASKS,
                         ids=[m[0] for m in _MASKS])
def test_dds_uncompressed_layouts(tmp_path, name, bits, masks, flags, full,
                                  half):
    """Channel masks through PIL's DdsRgbDecoder (a mask of the top bit
    alone included), luminance, palette; the layouts PIL refuses (16-bit
    luminance, A8) give None, and a short file gives what PIL gives (zeros
    for the masks, None for raw)."""
    rng = np.random.default_rng(bits + flags)
    n = 13 * 10 * bits // 8 + (1024 if flags == 0x20 else 0)
    payload = rng.integers(0, 256, n).astype(np.uint8).tobytes()
    for cut, want in ((len(payload), full), (len(payload) // 2, half)):
        _same(_write(tmp_path, T.dds_bytes(13, 10, payload[:cut],
                                           pfflags=flags, bitcount=bits,
                                           masks=masks)), want == "img")


def test_dds_r8g8b8a8_and_mips(tmp_path):
    rng = np.random.default_rng(8)
    for f in (27, 28, 29):
        data = T.dds_bytes(13, 10, rng.integers(0, 256, 13 * 10 * 4 + 99)
                           .astype(np.uint8).tobytes(), dxgi=f, mips=3)
        _same(_write(tmp_path, data))
    _same(_write(tmp_path, b"DDS " + bytes(60)), readable=False)


# ------------------------------------------------------------------ WebP

@pytest.mark.parametrize("kind", ["smooth", "noise", "pal2", "pal4", "pal16",
                                  "pal200", "rgba", "gray", "flat"])
@pytest.mark.parametrize("size", [(1, 1), (5, 3), (37, 29), (44, 61)])
def test_webp_lossless(tmp_path, kind, size):
    """libwebp's lossless encoder at several methods and qualities: every
    transform (the palette ones bundle 8, 4 or 2 pixels per byte), the
    colour cache, meta prefix codes, simple and normal codes."""
    rng = np.random.default_rng(len(kind) * 100 + size[0])
    h, w = size
    if kind == "smooth":
        a = _smooth(rng, h, w)
    elif kind == "noise":
        a = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    elif kind.startswith("pal"):
        k = int(kind[3:])
        a = rng.integers(0, 256, (k, 3))[rng.integers(0, k, (h, w))].astype(
            np.uint8)
    elif kind == "rgba":
        a = np.concatenate([_smooth(rng, h, w), rng.integers(
            0, 256, (h, w, 1)).astype(np.uint8)], -1)
    elif kind == "gray":
        a = np.repeat(_smooth(rng, h, w, 1), 3, -1)
    else:
        a = np.full((h, w, 3), 77, np.uint8)
    for q, m, exact in ((0, 0, False), (100, 6, True), (50, 3, False),
                        (100, 4, True)):
        _same(_write(tmp_path, _pil(Image.fromarray(a), "WEBP", lossless=True,
                                    quality=q, method=m, exact=exact)))


def _riff(chunks):
    body = b"WEBP" + b"".join(
        tag + struct.pack("<I", len(d)) + d + b"\0" * (len(d) & 1)
        for tag, d in chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _vp8l(img):
    """The VP8L chunk payload of a lossless encode of `img`."""
    data = _pil(Image.fromarray(img), "WEBP", lossless=True)
    assert data[12:16] == b"VP8L"
    return data[20:20 + struct.unpack("<I", data[16:20])[0]]


def _u24(v):
    return struct.pack("<I", v)[:3]


@pytest.mark.parametrize("case,readable", _cases([
    ("animation", True), ("offset frame", True), ("vp8x still", True),
    ("vp8x alpha", True), ("size mismatch", False), ("truncated", False),
    ("bad signature", False)]))
def test_webp_containers(tmp_path, case, readable):
    """VP8X stills, and the first frame of an animation composed on a
    transparent canvas at its offset, as libwebp's animation decoder
    composes it for PIL."""
    rng = np.random.default_rng(9)
    if case == "animation":
        frames = [Image.fromarray(_smooth(rng, 20, 30)) for _ in range(2)]
        data = _pil(frames[0], "WEBP", save_all=True,
                    append_images=frames[1:], lossless=True)
    elif case == "offset frame":
        fr = _vp8l(_smooth(rng, 9, 7))
        anmf = (_u24(3) + _u24(2) + _u24(6) + _u24(8) + _u24(100)
                + b"\0" + b"VP8L" + struct.pack("<I", len(fr)) + fr
                + b"\0" * (len(fr) & 1))
        vp8x = bytes([0x02, 0, 0, 0]) + _u24(29) + _u24(19)
        data = _riff([(b"VP8X", vp8x), (b"ANIM", bytes(6)),
                      (b"ANMF", anmf)])
    elif case.startswith("vp8x") or case == "size mismatch":
        img = _smooth(rng, 12, 17, 4 if "alpha" in case else 3)
        fr = _vp8l(img)
        cw = 17 if case != "size mismatch" else 18
        vp8x = bytes([0x10 if "alpha" in case else 0, 0, 0, 0]) + _u24(
            cw - 1) + _u24(11)
        data = _riff([(b"VP8X", vp8x), (b"VP8L", fr)])
    else:
        data = _pil(Image.fromarray(_smooth(rng, 20, 30)), "WEBP",
                    lossless=True)
        data = (data[:len(data) * 2 // 3] if case == "truncated" else
                data[:20] + b"\x30" + data[21:])
    _same(_write(tmp_path, data), readable)


# ------------------------------------------------------------------- PSD

# colour mode, depth, channels, and whether PIL opens it (not 16-bit, not
# RGB with too few channels)
_PSD = [(3, 8, 3, True), (3, 8, 4, True), (3, 8, 5, True), (1, 8, 1, True),
        (1, 8, 2, True), (0, 8, 1, True), (7, 8, 2, True), (8, 8, 1, True),
        (2, 8, 1, True), (4, 8, 4, True), (4, 8, 5, True), (0, 1, 1, True),
        (3, 16, 3, False), (3, 8, 2, False)]


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("mode,bits,channels,readable", _cases(_PSD))
def test_psd_modes(tmp_path, mode, bits, channels, readable, rle):
    """Every colour mode and depth PIL opens, raw or PackBits, PIL's
    reading of extra channels included; 16-bit and too few channels give
    None."""
    rng = np.random.default_rng(mode * 100 + channels)
    for h, w in ((9, 13), (1, 1), (30, 200)):
        ch = rng.integers(0, 256, (channels, h, (w + 7) // 8 if bits == 1
                                   else w))
        ch[..., :min(w, 3)] = 5  # runs for PackBits
        cd = (rng.integers(0, 256, 768).astype(np.uint8).tobytes()
              if mode == 2 else b"")
        _same(_write(tmp_path, T.psd_bytes(ch, mode, bits, rle=rle,
                                           color_data=cd)), readable)


@pytest.mark.parametrize("case,readable", _cases([
    ("resources", True), ("odd resource name", True), ("layers", True),
    ("short palette", True), ("truncated", False), ("truncated rle", False),
    ("zip", False)]))
def test_psd_cases(tmp_path, case, readable):
    rng = np.random.default_rng(4)
    ch = rng.integers(0, 256, (3, 9, 13))
    if case == "resources":
        data = T.psd_bytes(ch, 3, resources=b"8BIM" + struct.pack(
            ">H", 1039) + b"\x03abc" + struct.pack(">I", 5) + b"hello\0")
    elif case == "odd resource name":
        data = T.psd_bytes(ch, 3, resources=b"8BIM" + struct.pack(">H", 1)
                           + b"\x02ab\0" + struct.pack(">I", 4) + b"abcd")
    elif case == "layers":
        data = T.psd_bytes(ch, 3, layers=struct.pack(">I", 4) + bytes(8))
    elif case == "short palette":
        data = T.psd_bytes(ch[:1], 2, color_data=bytes(700))
    elif case == "truncated":
        data = T.psd_bytes(ch, 3)[:-10]
    elif case == "truncated rle":
        data = T.psd_bytes(ch, 3, rle=True)[:-10]
    else:
        data = bytearray(T.psd_bytes(ch, 3))
        data[-(3 * 9 * 13) - 2:-(3 * 9 * 13)] = b"\0\2"
        data = bytes(data)
    _same(_write(tmp_path, data), readable)


def test_psd_lab_raises(tmp_path):
    ch = np.random.default_rng(1).integers(0, 256, (3, 4, 5))
    p = _write(tmp_path, T.psd_bytes(ch, 9))
    assert j_tex(str(p)) is not None
    with pytest.raises(NotImplementedError, match="Lab PSD"):
        load_texture_image(str(p))


# ------------------------------------------------------- PIL's own PNM

@pytest.mark.parametrize("maxval", [255, 100, 1000, 65535])
@pytest.mark.parametrize("magic,bands", [(b"P0CMYK", 4), (b"PyCMYK", 4),
                                         (b"PyRGBA", 4), (b"PyP", 1)])
def test_pnm_pil_own_modes(tmp_path, magic, bands, maxval):
    rng = np.random.default_rng(maxval + bands)
    h, w = 9, 13
    v = rng.integers(0, maxval + 1, (h, w, bands))
    body = (v.astype(">u2") if maxval > 255 else v.astype(np.uint8)).tobytes()
    data = magic + b"\n%d %d\n%d\n" % (w, h, maxval) + body
    _same(_write(tmp_path, data))
    _same(_write(tmp_path, data[:-3]), readable=False)


@pytest.mark.parametrize("scale,readable", _cases([
    (b"-1.0", True), (b"1.0", True), (b"-2.5", True), (b"3e2", True),
    (b"1_0", True), (b"0", False), (b"inf", False), (b"nan", False),
    (b"x", False)]))
def test_pfm_gray(tmp_path, scale, readable):
    """Pf: the scale's sign picks the byte order, rows run bottom-up, and
    F -> L truncates ([0, 1) gives 0); a zero or non-finite scale, a bad
    token or a short file gives None."""
    rng = np.random.default_rng(len(scale))
    h, w = 9, 13
    f = (rng.standard_normal((h, w)) * 100).astype(np.float32)
    f[0, :6] = [0.5, 0.999, 1.0, 254.9, 255.5, np.nan]
    body = f.astype("<f4" if scale.startswith(b"-") else ">f4").tobytes()
    p = _write(tmp_path, b"Pf\n%d %d\n" % (w, h) + scale + b"\n" + body)
    _same(p, readable)
    _same(_write(tmp_path, b"Pf\n2 2\n-1\n" + bytes(12)), readable=False)


def test_colour_pfm_is_none(tmp_path):
    """PF (colour float) is no file PIL opens: None in both loaders."""
    p = _write(tmp_path, b"PF\n2 2\n-1.0\n" + bytes(48))
    _same(p, readable=False)


# ------------------------------------------------------------------- EXR

def _exr(version_flags=0, compression=0):
    def attr(name, atype, val):
        return name + b"\0" + atype + b"\0" + struct.pack("<i", len(val)) + val

    chans = b"".join(c + b"\0" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
                     for c in (b"B", b"G", b"R"))
    header = (attr(b"channels", b"chlist", chans + b"\0")
              + attr(b"compression", b"compression", bytes([compression]))
              + attr(b"dataWindow", b"box2i", struct.pack("<iiii", 0, 0, 2, 1))
              + b"\0")
    rows = b"".join(struct.pack("<ii", y, 36) + np.full(9, y + 0.5, "<f4")
                    .tobytes() for y in range(2))
    return (struct.pack("<ii", 20000630, 2 | version_flags) + header
            + bytes(16) + rows)


@pytest.mark.parametrize("flags,readable", _cases([
    (0x200, False), (0x800, True), (0x1000, True), (0x1800, True)]))
def test_exr_version_flags_match_jax(tmp_path, flags, readable):
    """The tiled flag gives None through both loaders; the JAX reader
    parses on past the deep and multi-part flags, and so does the
    port."""
    p = _write(tmp_path, _exr(flags), "t.exr")
    _same(p, readable)


@pytest.mark.parametrize("compression", [1, 4, 5, 6, 7, 8, 9])
def test_exr_refused_compressions_are_none(tmp_path, compression):
    """RLE, PIZ, PXR24, B44, B44A, DWAA and DWAB: the JAX reader raises,
    its loader gives None, and so does the port's."""
    p = _write(tmp_path, _exr(0, compression), "t.exr")
    _same(p, readable=False)


# ------------------------------------------------------- kinds and build

def test_image_kind_new_formats():
    assert image_kind(b"II*\0" + bytes(14)) == "tiff"
    assert image_kind(b"MM\0+" + bytes(14)) == "tiff"
    assert image_kind(b"MM*\0" + bytes(14)) == "tiff"
    assert image_kind(b"DDS " + bytes(14)) == "dds"
    assert image_kind(b"8BPS" + bytes(14)) == "psd"
    assert image_kind(b"RIFF\0\0\0\0WEBPVP8L" + bytes(2)) == "webp"
    assert image_kind(b"Pf\n1 1\n-1\n" + bytes(8)) == "pnm"
    with pytest.raises(ValueError):
        image_kind(b"PF\n1 1\n-1\n" + bytes(8))


def test_build_shared_rebuilds_on_included_header(tmp_path, monkeypatch):
    """native.build_shared hashes every file a source includes: an edit to
    an included header builds a new library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    src, hdr = tmp_path / "lib.cpp", tmp_path / "value.h"
    hdr.write_text("inline int value() { return 1; }\n")
    src.write_text('#include "value.h"\nextern "C" int get() '
                   "{ return value(); }\n")
    flags = ("-O0", "-fPIC", "-shared")
    first = native.build_shared(src, "scratch", flags)
    assert native.build_shared(src, "scratch", flags) == first
    hdr.write_text("inline int value() { return 2; }\n")
    second = native.build_shared(src, "scratch", flags)
    assert second != first and second.exists()
    import ctypes
    assert ctypes.CDLL(str(second)).get() == 2


def test_checker_variants_m_equal_the_ppm():
    """The lossless re-encodings of parity_textured's checker that phase
    56 renders hold exactly the PPM's texels."""
    import os

    from craytracer_tpu_torch.io.image import read_ppm
    from craytracer_tpu_torch.io.teximage import decode_file

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fx = os.path.join(repo, "craytracer_tpu_torch", "testdata", "textures")
    ppm = read_ppm(os.path.join(repo, "scenes", "parity_tex_checker.ppm"))
    for name in ("checker_lzw_pred.tif", "checker_deflate_tiled.tif",
                 "checker.dds", "checker_lossless.webp", "checker_rle.psd"):
        np.testing.assert_array_equal(
            decode_file(os.path.join(fx, name)), ppm, err_msg=name)
