"""Write the texture fixtures the card checks the port's decoders on
(chip_smoke.py phases 55, 56, 57 and 58), which has no PIL: one small file per
format and variant (tests/torch_image_files.py and tests/torch_tiff_files.py
write those PIL cannot; tests/torch_plugin_files.py those of slice O),
the parity_textured checker re-encoded losslessly in many formats and as
a 4:2:0 JPEG, and for timing a 2048x2048 4:2:0
JPEG, a 2048x2048 LZW TIFF with the horizontal predictor and a 2048x2048
lossless WebP (an 8-level posterized sinusoid, so that they stay small),
and a 256x256 BC7 DDS that phase 56 tiles to 2048x2048, into
craytracer_tpu_torch/testdata/textures/ with manifest.json: for each file
the SHA-256 of PIL's Image.open(path).convert("RGB") bytes and its shape.

    python tests/make_texture_fixtures.py

tests/test_torch_texture_io.py holds the manifest to PIL's decode of each
file and to the port's; run this again (and commit the files) after a
change to the set. Made from fixed seeds: the bytes do not change between
runs with the same Pillow.
"""

from __future__ import annotations

import functools
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_image_files as F  # noqa: E402
import torch_plugin_files as P  # noqa: E402
import torch_tiff_files as T  # noqa: E402

OUT = os.path.join(REPO, "craytracer_tpu_torch", "testdata", "textures")
CHECKER = os.path.join(REPO, "scenes", "parity_tex_checker.ppm")


def _pil(img: Image.Image, fmt: str, **kw) -> bytes:
    bio = io.BytesIO()
    img.save(bio, format=fmt, **kw)
    return bio.getvalue()


def _smooth(rng, h, w, c=3):
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 5 + k) * np.cos(y / 7 - k)
                     for k in range(c)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, c)), 0, 255).astype(
        np.uint8)


def checker_variants(checker: np.ndarray) -> dict:
    """The checker [H, W, 3] uint8 in six lossless encodings and a 4:2:0
    JPEG: file name -> bytes."""
    h, w = checker.shape[:2]
    colors, idx = np.unique(checker.reshape(-1, 3), axis=0,
                            return_inverse=True)
    idx = idx.reshape(h, w)
    bgr = checker[..., ::-1]
    img = Image.fromarray(checker)
    return {
        "checker_palette.png": F.png_bytes(idx, 8, 3, palette=colors),
        "checker_interlaced.png": F.png_bytes(checker, 8, 2, interlace=1),
        "checker_rgb16.png": F.png_bytes(checker.astype(np.int64) * 257, 16,
                                         2),
        "checker_24.bmp": F.bmp_bytes(F.bmp_rows(bgr, 24), w, h, 24),
        "checker_rle.tga": F.tga_bytes(
            F.tga_rle_exact(bgr[::-1], 3, w), w, h, 10, 24),
        "checker.gif": F.gif_bytes(idx, global_palette=colors),
        "checker_420.jpg": _pil(img, "JPEG", subsampling="4:2:0"),
    }


def checker_variants_m(checker: np.ndarray) -> dict:
    """The checker in the lossless encodings of phase 56: TIFF (LZW with
    the horizontal predictor; Deflate in tiles), uncompressed DDS, lossless
    WebP and PackBits PSD."""
    h, w = checker.shape[:2]
    return {
        "checker_lzw_pred.tif": T.tiff_bytes(checker, 8, 2, compression=5,
                                             predictor=2, rows_per_strip=3),
        "checker_deflate_tiled.tif": T.tiff_bytes(checker, 8, 2,
                                                  compression=8,
                                                  tile=(16, 16)),
        "checker.dds": T.dds_bytes(w, h, checker[..., ::-1].tobytes(),
                                   pfflags=0x40, bitcount=24,
                                   masks=(0xFF0000, 0xFF00, 0xFF, 0)),
        "checker_lossless.webp": _pil(Image.fromarray(checker), "WEBP",
                                      lossless=True),
        "checker_rle.psd": T.psd_bytes(checker.transpose(2, 0, 1), 3,
                                       rle=True),
    }


def checker_variants_n(checker: np.ndarray) -> dict:
    """The checker in the colour-lossless encodings of phase 57: QOI, RLE
    SGI, PCX (three planes), IM, an ICO holding a BMP, and a lossless
    JPEG (no JFIF or Adobe marker: libjpeg-turbo reads it as RGB)."""
    img = Image.fromarray(checker)
    h, w = checker.shape[:2]
    return {
        "checker.qoi": _pil(img, "QOI"),
        "checker_rle.sgi": F.sgi_bytes(checker.transpose(2, 0, 1), 1, True),
        "checker.pcx": _pil(img, "PCX"),
        "checker.im": _pil(img, "IM"),
        "checker_bmp.ico": _pil(img, "ICO", sizes=[(w, h)],
                                bitmap_format="bmp"),
        "checker_lossless.jpg": F.jpeg_lossless_bytes(
            [checker[..., c] for c in range(3)], predictor=1),
    }


def checker_variants_o(checker: np.ndarray) -> dict:
    """The checker in phase 58's encodings: SUN, PIXAR, DCX, BLP2 palette
    and XPM keep its colours exactly; an ICNS RLE icon holds it at 16x16
    beside a PPM of the same; a baseline Huffman JPEG of its RGB planes
    (Adobe transform 0) has SOF9 and SOF10 arithmetic twins of the same
    coefficients."""
    h, w = checker.shape[:2]
    img = Image.fromarray(checker)
    colors, idx = np.unique(checker.reshape(-1, 3), axis=0,
                            return_inverse=True)
    idx = idx.reshape(h, w)
    bgra = np.concatenate([colors[:, ::-1], np.full((len(colors), 1), 255)],
                          1).astype(np.uint8).tobytes()
    x2 = checker.repeat(2, 0).repeat(2, 1)
    planes = [checker[..., c] for c in range(3)]
    keys = [chr(ord("a") + i) for i in range(len(colors))]
    return {
        "checker.ras": P.sun_bytes([bytes(r[:, ::-1].reshape(-1))
                                    for r in checker], w, h, 24),
        "checker.pxr": P.pixar_bytes(checker),
        "checker.dcx": struct.pack("<III", 0x3ADE68B1, 12, 0) + _pil(
            img, "PCX"),
        "checker_palette.blp": P.blp2_bytes(
            w, h, 1, 0, 0, idx.astype(np.uint8).tobytes(), palette=bgra),
        "checker.xpm": P.xpm_bytes(idx, [tuple(int(v) for v in c)
                                         for c in colors], keys),
        "checker_x2.ppm": F.pnm_bytes(6, x2),
        "checker_x2_rle.icns": P.icns_bytes([(b"is32", b"".join(
            P.icns_rle(x2[..., c].tobytes()) for c in range(3)))]),
        "checker_huffman.jpg": F.jpeg_bytes(planes, [(1, 1)] * 3, adobe=0),
        "checker_arith_sof9.jpg": F.jpeg_arith_bytes(
            planes, [(1, 1)] * 3, adobe=0, restart=1,
            dac=[(0, 0x41), (16, 3)]),
        "checker_arith_sof10.jpg": F.jpeg_arith_bytes(
            planes, [(1, 1)] * 3, adobe=0, scans=[
                ([0, 1, 2], 0, 0, 0, 1), ([0], 1, 63, 0, 1), ([1], 1, 63, 0, 1),
                ([2], 1, 63, 0, 1), ([0, 1, 2], 0, 0, 1, 0),
                ([0], 1, 63, 1, 0), ([1], 1, 63, 1, 0), ([2], 1, 63, 1, 0)]),
    }


def _drop_scans(data, keep):
    """A progressive JPEG with only the scans keep(Ss, Se, Ah, Al)
    allows."""
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
            o = p + 5 + 2 * data[p + 4]
            if not keep(data[o], data[o + 1], data[o + 2] >> 4,
                        data[o + 2] & 15):
                p = q
                continue
        out += data[p:q]
        p = q
    return bytes(out)


def big_2048_gray() -> np.ndarray:
    """The 2048x2048 grey image of phase 58's timing files: a slow
    sinusoid with a finer ripple, so that AC coefficients stay."""
    y, x = np.mgrid[0:2048, 0:2048]
    return (127 + 100 * np.sin(x / 60) * np.cos(y / 80)
            + 20 * np.sin(x / 7.0 + y / 11.0) * np.cos(y / 23.0)).clip(
                0, 255).astype(np.uint8)


@functools.lru_cache(None)
def slice_o_files() -> dict:
    """Phase 58's fixtures: arithmetic-coded JPEG (twins, a re-marked
    file, a smoothed one), block-smoothed progressive JPEG, one or more
    small files per plugin of csrc/imgdecode_plugins.h, and for timing a
    2048x2048 grey baseline Huffman JPEG with its arithmetic progressive
    twin (each scan under 60 KB, so that padding can give each a read of
    PIL's own) and a 2048x2048 progressive JPEG of PIL's."""
    rng = np.random.default_rng(58)
    files = {}
    h, w = 21, 29
    planes = [_smooth(rng, h, w, 1)[..., 0] for _ in range(4)]
    sub = [(2, 2), (1, 1), (1, 1)]
    files["arith_sof9_420_restart_dac.jpg"] = F.jpeg_arith_bytes(
        planes[:3], sub, restart=2, dac=[(0, 0x52), (16, 2)])
    files["arith_sof9_cmyk.jpg"] = F.jpeg_arith_bytes(planes, [(1, 1)] * 4,
                                                      adobe=0)
    files["arith_sof10_gray_spectral.jpg"] = F.jpeg_arith_bytes(
        planes[:1], [(1, 1)], scans=[([0], 0, 0, 0, 0), ([0], 1, 9, 0, 0),
                                     ([0], 10, 63, 0, 0)])
    files["arith_sof10_422_approx.jpg"] = F.jpeg_arith_bytes(
        planes[:3], [(2, 1), (1, 1), (1, 1)], restart=3, scans=[
            ([0, 1, 2], 0, 0, 0, 1)] + [([c], 1, 63, 0, 1) for c in range(3)]
        + [([0, 1, 2], 0, 0, 1, 0)] + [([c], 1, 63, 1, 0) for c in range(3)])
    files["arith_sof10_smoothed.jpg"] = F.jpeg_arith_bytes(
        planes[:3], sub, q=4, scans=[([0, 1, 2], 0, 0, 0, 0)] + [
            ([c], 1, 5, 0, 2) for c in range(3)] + [
            ([c], 6, 63, 0, 0) for c in range(3)])
    remarked = bytearray(_pil(Image.fromarray(_smooth(rng, 40, 33)), "JPEG",
                              progressive=True, restart_marker_blocks=2))
    remarked[remarked.index(b"\xff\xc2") + 1] = 0xCA
    files["arith_remarked_prog.jpg"] = bytes(remarked)
    prog = _pil(Image.fromarray(_smooth(rng, 45, 61)), "JPEG",
                progressive=True, subsampling="4:2:0")
    files["jpeg_prog_unrefined_420.jpg"] = _drop_scans(
        prog, lambda ss, se, ah, al: ah == 0)
    files["jpeg_prog_dc_only.jpg"] = _drop_scans(
        prog, lambda ss, se, ah, al: ss == 0)
    # the plugins
    img = _smooth(rng, 11, 14)
    blk = _blocks(rng, 11, 14, 3, 4)
    idx = blk[..., 0] % 16
    pal16 = [tuple(int(v) for v in rng.integers(0, 256, 3))
             for _ in range(16)]
    files["sun_8_palette.ras"] = P.sun_bytes(
        [bytes(r) for r in idx.astype(np.uint8)], 14, 11, 8, 1, pal16)
    files["sun_24_rle.ras"] = P.sun_bytes(
        [bytes(r[:, ::-1].reshape(-1)) for r in blk[..., :3]], 14, 11, 24, 2)
    files["sun_1.ras"] = P.sun_bytes(
        [P.pack_bits(r % 2, 1) for r in blk[..., 1]], 14, 11, 1)
    keys = [chr(ord("A") + i) for i in range(16)]
    files["xpm_16.xpm"] = P.xpm_bytes(idx, pal16, keys, none_key="-")
    keys3 = []
    for i in range(300):
        keys3.append(chr(35 + i % 40) + chr(35 + i // 40) + "x")
    cols = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in keys3]
    files["xpm_rgb_300.xpm"] = P.xpm_bytes(
        rng.integers(0, 300, (7, 9)), cols, keys3)
    bits = (blk[..., 2] % 2).astype(np.uint8)
    files["msp_v1.msp"] = _pil(Image.fromarray(bits * 255).convert("1"),
                               "MSP")
    files["msp_v2.msp"] = P.msp_v2_bytes(bits)
    files["dcx_p.dcx"] = struct.pack("<III", 0x3ADE68B1, 12, 0) + _pil(
        Image.fromarray(img).convert("P"), "PCX")
    files["pixar.pxr"] = P.pixar_bytes(img)
    vals = rng.integers(0, 400, (6, 9))
    files["mcidas_i16.area"] = P.mcidas_bytes(b"".join(
        b"\0\1" + vals[y].astype(">u2").tobytes() for y in range(6)), 9, 6,
        2, prefix=2)
    files["imt.imt"] = P.imt_bytes(img[..., 0])
    files["xvthumb.xv"] = P.xvthumb_bytes(img[..., 1])
    files["gbr_v1_l.gbr"] = P.gbr_bytes(img[..., 0], 1)
    files["gbr_v2_rgba.gbr"] = P.gbr_bytes(blk, 2)
    files["fits_16.fits"] = P.fits_bytes(
        rng.integers(0, 600, (7, 9)).astype(">u2").tobytes(), 9, 7, 16)
    files["fits_f32.fits"] = P.fits_bytes(
        rng.normal(100, 120, (7, 9)).astype(">f4").tobytes(), 9, 7, -32)
    files["fits_gzip.fits"] = P.fits_gzip_bytes(
        rng.integers(0, 2**32, 12 * 9, dtype=np.uint64).astype(np.uint32),
        12, 9, 16)
    files["ftex_bc1.ftc"] = P.ftex_bytes(P.bc1_blocks(rng, 14, 11, True),
                                         14, 11, 0)
    files["ftex_rgb.ftu"] = P.ftex_bytes(img.tobytes(), 14, 11, 1)
    jpeg = _pil(Image.fromarray(img), "JPEG", quality=90)
    sos = jpeg.index(b"\xff\xda")
    files["blp1_jpeg.blp"] = P.blp1_bytes(14, 11, 0, jpeg[sos:],
                                          jpeg_header=jpeg[:sos])
    bpal = rng.integers(0, 256, 1024).astype(np.uint8).tobytes()
    pix = blk[..., 3].tobytes()
    files["blp1_palette.blp"] = P.blp1_bytes(14, 11, 1, pix, palette=bpal)
    files["blp2_palette_a4.blp"] = P.blp2_bytes(14, 11, 1, 4, 0, pix,
                                                palette=bpal)
    for name, ae in (("dxt1", 0), ("dxt3", 1), ("dxt5", 7)):
        payload = (P.bc1_blocks(rng, 14, 11, True) if ae == 0 else
                   rng.integers(0, 256, 16 * 4 * 3).astype(np.uint8).tobytes())
        files[f"blp2_{name}.blp"] = P.blp2_bytes(14, 11, 2, 8, ae, payload)
    icon = Image.fromarray(_blocks(rng, 32, 32, 4, 4), "RGBA")
    files["icns_png.icns"] = P.icns_bytes([
        (b"icp4", _pil(icon.resize((16, 16)), "PNG")),
        (b"icp5", _pil(icon, "PNG"))])
    icon = _blocks(rng, 128, 128, 16)
    files["icns_it32.icns"] = P.icns_bytes([
        (b"it32", b"\0\0\0\0" + b"".join(
            P.icns_rle(icon[..., c].tobytes()) for c in range(3)))])
    icon = _blocks(rng, 32, 32, 3)
    files["icns_il32_mask.icns"] = P.icns_bytes([
        (b"il32", b"".join(P.icns_rle(icon[..., c].tobytes())
                           for c in range(3))),
        (b"l8mk", rng.integers(0, 256, 32 * 32).astype(np.uint8).tobytes())])
    files["iptc_l.iptc"] = P.iptc_bytes(img[..., 0].tobytes(), 14, 11,
                                        chunks=2)
    files["iptc_rgb_band2.iptc"] = P.iptc_bytes(img[..., 1].tobytes(), 14, 11,
                                                layers=3, component=1, band=2)
    fimg = _blocks(rng, 11, 23, 3, 1)[..., 0]
    files["fli_brun_color256.flc"] = P.fli_bytes(23, 11, [P.fli_frame([
        P.fli_color([(0, [tuple(rng.integers(0, 256, 3)) for _ in range(256)])]),
        P.fli_brun(fimg)])])
    files["fli_copy_ss2.flc"] = P.fli_bytes(23, 11, [P.fli_frame([
        P.fli_chunk(16, fimg.tobytes()),
        P.fli_ss2([[("packets", [(1, "copy", [1, 2, 3, 4]),
                                 (0, "run", (7, 8, 2))])],
                   [("skip", 2), ("last", 77),
                    ("packets", [(0, "copy", [9, 9])])]])])])
    files["fli_black_lc_color64.fli"] = P.fli_bytes(23, 11, [P.fli_frame([
        P.fli_color([(0, [tuple(rng.integers(0, 64, 3)) for _ in range(256)])],
                    kind=11), P.fli_chunk(13, b""),
        P.fli_lc(2, [[(1, "copy", [5, 6, 7]), (2, "run", (9, 3))],
                     [(0, "run", (200, 2))]])])], magic=0xAF11)
    # timing files
    big = big_2048_gray()
    files["big_2048_huffman.jpg"] = F.jpeg_bytes([big], [(1, 1)], q=12)
    files["big_2048_arith.jpg"] = F.jpeg_arith_bytes(
        [big], [(1, 1)], q=12, scans=[([0], 0, 0, 0, 0), ([0], 1, 2, 0, 0),
                                      ([0], 3, 9, 0, 0), ([0], 10, 63, 0, 0)])
    files["big_2048_prog.jpg"] = _pil(Image.fromarray(big), "JPEG",
                                      progressive=True, quality=60)
    return files


# phase 58's timing file that PIL cannot read as it stands (its scans run
# past PIL's first 65536-byte read): chip_smoke.pad_arith_scans makes it
# readable, and tests/test_torch_texture_formats_o.py holds that
UNREAD_BY_PIL = {"big_2048_arith.jpg"}


def _blocks(rng, h, w, cell, c=3):
    a = rng.integers(0, 256, (-(-h // cell), -(-w // cell), c))
    return np.repeat(np.repeat(a, cell, 0), cell, 1)[:h, :w].astype(np.uint8)


def _text_page(rng, h, w):
    """A bilevel page of text-like lines of glyph noise (1 black)."""
    page = np.zeros((h, w), np.uint8)
    for y0 in range(96, h - 96, 44):
        x = 128
        while x < w - 160:
            n = int(rng.integers(3, 11)) * 18
            g = rng.random((14, n // 3)) < 0.35
            glyphs = np.repeat(np.repeat(g, 2, 0), 3, 1)[:, :w - x]
            page[y0:y0 + 28, x:x + glyphs.shape[1]] = glyphs
            x += n + 20
    return page


def slice_n_files() -> dict:
    """Phase 57's fixtures: one small file per new decoder and variant
    (QOI, SGI, PCX, DIB, IM, XBM, SPIDER, ICO, CUR, lossless JPEG, CCITT
    and old-style LZW TIFF), and for timing a 2048x2048 QOI of 256-pixel
    blocks and a 2048x2048 Group 4 page of text-like lines."""
    rng = np.random.default_rng(57)
    files = {}
    h, w = 13, 21
    px = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    blk = _blocks(rng, h, w, 3, 4)
    files["qoi_rgba.qoi"] = _pil(Image.fromarray(blk, "RGBA"), "QOI")
    files["qoi_rgb.qoi"] = _pil(Image.fromarray(px[..., :3]), "QOI")
    files["sgi_l_raw.sgi"] = _pil(Image.fromarray(px[..., 0]), "SGI")
    files["sgi_rgb_rle.sgi"] = F.sgi_bytes(blk[..., :3].transpose(2, 0, 1),
                                           1, True)
    files["sgi_rgba16_rle.sgi"] = F.sgi_bytes(
        blk.transpose(2, 0, 1).astype(np.int64) * 257 + 5, 2, True)
    for mode in ("1", "P", "RGB"):
        files[f"pcx_{mode.lower()}.pcx"] = _pil(
            Image.fromarray(blk[..., :3]).convert(mode), "PCX")
    files["pcx_p4l.pcx"] = F.pcx_bytes(
        rng.integers(0, 256, (h, 4 * 4)), w, h, 1, 4,
        palette=rng.integers(0, 256, (16, 3)), stride=4)
    for mode in ("1", "P", "RGBA"):
        files[f"dib_{mode.lower()}.dib"] = _pil(
            Image.fromarray(px[..., :3]).convert(mode), "DIB")
    for mode in ("P", "LA", "I", "F", "RGB", "CMYK", "YCbCr"):
        files[f"im_{mode.lower()}.im"] = _pil(
            Image.fromarray(px[..., :3]).convert(mode), "IM")
    hdr = b"Image type: L*12 image\r\nImage size (x*y): 7*5\r\n"
    body = rng.integers(0, 256, 80).astype(np.uint8)
    body[1::2] = 0
    files["im_bits12.im"] = hdr.ljust(511, b"\0") + b"\x1a" + body.tobytes()
    files["xbm_hotspot.xbm"] = _pil(
        Image.fromarray(px[..., 0]).convert("1"), "XBM", hotspot=(3, 4))
    f = rng.normal(100, 150, (9, 11)).astype(np.float32)
    files["spider_be.spi"] = F.spider_bytes(f, True)
    files["spider_le_stack.spi"] = F.spider_bytes(f, False, stack=True)
    small = Image.fromarray(px[:8, :8, :3])
    big = Image.fromarray(rng.integers(0, 256, (16, 16, 3)).astype(np.uint8))
    files["ico_png.ico"] = _pil(big, "ICO", sizes=[(8, 8), (16, 16)])
    files["ico_bmp1.ico"] = F.icon_bytes([(16, 16, 2, 1, 1, F.dib_frame(
        _pil(big.convert("1"), "DIB")))])
    files["cur_two.cur"] = F.icon_bytes([
        (8, 8, 0, 1, 1, F.dib_frame(_pil(small, "DIB"))),
        (16, 16, 0, 2, 2, F.dib_frame(_pil(big.convert("P"), "DIB")))],
        cursor=True)
    planes = [px[..., c].astype(np.int64) for c in range(4)]
    for p in range(1, 8):
        files[f"jpeg_lossless_p{p}.jpg"] = F.jpeg_lossless_bytes(
            planes[:3], predictor=p)
    files["jpeg_lossless_gray_pt2.jpg"] = F.jpeg_lossless_bytes(
        planes[:1], pt=2, markers="jfif")
    files["jpeg_lossless_cmyk.jpg"] = F.jpeg_lossless_bytes(planes)
    files["jpeg_lossless_sub_restart.jpg"] = F.jpeg_lossless_bytes(
        planes[:3], predictor=6, restart_rows=2,
        factors=[(2, 2), (1, 1), (1, 1)])
    bits = (rng.random((h, 37)) < 0.4).astype(np.uint8)
    for name, comp, fax in (("rle", 2, {}), ("rlew", 32771, {}),
                            ("g3_1d", 3, {}), ("g4", 4, {}),
                            ("g3_2d", 3, dict(t4options=1, two_d=[
                                y % 3 != 0 for y in range(h)]))):
        extra = [(292, 4, [1])] if name == "g3_2d" else []
        files[f"tiff_{name}.tif"] = T.tiff_bytes(
            bits[..., None], 1, 0, compression=comp, fax=fax,
            extra_tags=extra)
    files["tiff_g4_fo2_white1.tif"] = T.tiff_bytes(
        bits[..., None], 1, 1, compression=4, fill_order=2)
    runs, c = [], 0
    for k in list(range(64)) + list(range(64, 2561, 64)) + [2623, 1793]:
        runs += [c] * k
        c ^= 1
    runs += [c] * ((-len(runs)) % 2640)
    files["tiff_g4_makeup.tif"] = T.tiff_bytes(
        np.array(runs, np.uint8).reshape(-1, 2640)[..., None], 1, 0,
        compression=4)
    files["tiff_old_lzw.tif"] = T.tiff_bytes(blk[..., :3], 8, 2,
                                             compression=5, old_lzw=True,
                                             predictor=2, rows_per_strip=5)
    # timing files
    files["big_2048_blocks.qoi"] = _pil(
        Image.fromarray(_blocks(rng, 2048, 2048, 256)), "QOI")
    files["big_2048_g4.tif"] = _pil(
        Image.fromarray((1 - _text_page(rng, 2048, 2048)) * 255).convert(
            "1"), "TIFF", compression="group4")
    return files


def _jpeg_tiff(img, ss, sub):
    def jpeg(seg):
        return _pil(Image.fromarray(seg.astype(np.uint8)), "JPEG",
                    subsampling=ss)
    return T.tiff_bytes(img, 8, 6, compression=7, jpeg=jpeg,
                        rows_per_strip=16, extra_tags=[(530, 3, list(sub))])


def _ycc_lzw(rng, h, w):
    """A YCbCr 2x2 TIFF strip of blocks under LZW."""
    raw = bytearray()
    for _ in range(((h + 1) // 2) * ((w + 1) // 2)):
        raw += rng.integers(0, 256, 6).astype(np.uint8).tobytes()
    blob = T.lzw_tiff(bytes(raw))
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]), (259, 3, [5]),
            (262, 3, [6]), (273, 4, [8]), (277, 3, [3]), (278, 3, [h]),
            (279, 4, [len(blob)]), (530, 3, [2, 2])]
    base = 8 + len(blob) + (len(blob) & 1)
    ifd, tail = struct.pack("<H", len(tags)), b""
    extra_at = base + 2 + 12 * len(tags) + 4
    for t, ty, v in tags:
        p = struct.pack("<" + ("H" if ty == 3 else "I") * len(v), *v)
        if len(p) <= 4:
            ifd += struct.pack("<HHI", t, ty, len(v)) + p.ljust(4, b"\0")
        else:
            ifd += struct.pack("<HHII", t, ty, len(v), extra_at + len(tail))
            tail += p
    return (b"II*\0" + struct.pack("<I", base) + blob
            + b"\0" * (len(blob) & 1) + ifd + b"\0\0\0\0" + tail)


def slice_m_files() -> dict:
    """TIFF, DDS, lossless WebP, PSD and PIL's own PNM variants, one small
    file per variant, and the timing files of phase 56."""
    rng = np.random.default_rng(2026)
    files = {}
    h, w = 21, 13
    img = _smooth(rng, h, w)
    px = rng.integers(0, 256, (h, w, 4))
    # TIFF
    files["tiff_rgb_lzw_pred.tif"] = T.tiff_bytes(img, 8, 2, compression=5,
                                                  predictor=2,
                                                  rows_per_strip=4)
    files["tiff_rgb_deflate_tiles.tif"] = T.tiff_bytes(
        img, 8, 2, compression=32946, tile=(16, 16))
    files["tiff_rgb_mm_packbits.tif"] = T.tiff_bytes(
        img, 8, 2, compression=32773, order=">")
    files["tiff_raw_strips.tif"] = T.tiff_bytes(img, 8, 2, rows_per_strip=5)
    files["tiff_gray16_deflate_pred.tif"] = T.tiff_bytes(
        px[..., :1] * 257, 16, 1, compression=8, predictor=2)
    files["tiff_float_pred3.tif"] = T.tiff_bytes(
        (rng.standard_normal((h, w, 1)) * 100).astype(np.float32), 32, 1,
        sample_format=3, compression=8, predictor=3)
    files["tiff_palette4.tif"] = T.tiff_bytes(
        px[..., :1] % 16, 4, 3, compression=5,
        colormap=rng.integers(0, 65536, (16, 3)))
    files["tiff_bilevel_fill2.tif"] = T.tiff_bytes(
        px[..., :1] % 2, 1, 0, compression=32773, fill_order=2)
    files["tiff_cmyk_planar.tif"] = T.tiff_bytes(px, 8, 5, compression=5,
                                                 planar=2)
    files["tiff_rgba_assoc.tif"] = T.tiff_bytes(px, 8, 2, compression=5,
                                                extra=(1,))
    files["tiff_bigtiff.tif"] = T.tiff_bytes(img, 8, 2, big=True,
                                             compression=5)
    files["tiff_orientation6.tif"] = T.tiff_bytes(img, 8, 2, compression=5,
                                                  orientation=6)
    files["tiff_ycbcr_jpeg.tif"] = _jpeg_tiff(_smooth(rng, 37, 29), "4:2:0",
                                              (2, 2))
    files["tiff_ycbcr_lzw22.tif"] = _ycc_lzw(rng, 13, 10)
    files["tiff_jpeg_rgb.tif"] = _pil(Image.fromarray(img), "TIFF",
                                      compression="jpeg")
    # DDS
    im4 = Image.fromarray(_smooth(rng, h, w, 4))
    for pf in ("DXT1", "DXT3", "DXT5"):
        files[f"dds_{pf.lower()}.dds"] = _pil(im4, "DDS", pixel_format=pf)
    nb = ((w + 3) // 4) * ((h + 3) // 4)
    for name, kw, bs in (("bc4", dict(fourcc=b"ATI1"), 8),
                         ("bc5u", dict(fourcc=b"ATI2"), 16),
                         ("bc5s", dict(fourcc=b"BC5S"), 16),
                         ("bc6h_uf16", dict(dxgi=95), 16),
                         ("bc6h_sf16", dict(dxgi=96), 16),
                         ("bc7", dict(dxgi=98), 16)):
        files[f"dds_{name}.dds"] = T.dds_bytes(
            w, h, rng.integers(0, 256, nb * bs).astype(np.uint8).tobytes(),
            **kw)
    for name, bits, masks, flags in (
            ("r5g6b5", 16, (0xF800, 0x7E0, 0x1F, 0), 0x40),
            ("a1r5g5b5", 16, (0x7C00, 0x3E0, 0x1F, 0x8000), 0x41),
            ("l8", 8, (0xFF, 0, 0, 0), 0x20000),
            ("a8l8", 16, (0xFF, 0, 0, 0xFF00), 0x20001)):
        files[f"dds_{name}.dds"] = T.dds_bytes(
            w, h, rng.integers(0, 256, h * w * bits // 8).astype(
                np.uint8).tobytes(), pfflags=flags, bitcount=bits,
            masks=masks)
    files["dds_p8.dds"] = T.dds_bytes(
        w, h, rng.integers(0, 256, 1024 + h * w).astype(np.uint8).tobytes(),
        pfflags=0x20, bitcount=8)
    files["dds_r8g8b8a8.dds"] = T.dds_bytes(
        w, h, px.astype(np.uint8).tobytes(), dxgi=28)
    # lossless WebP
    files["webp_lossless.webp"] = _pil(Image.fromarray(img), "WEBP",
                                       lossless=True)
    pal = rng.integers(0, 256, (4, 3))
    files["webp_palette4.webp"] = _pil(Image.fromarray(
        pal[px[..., 0] % 4].astype(np.uint8)), "WEBP", lossless=True)
    files["webp_rgba_exact.webp"] = _pil(im4, "WEBP", lossless=True,
                                         exact=True)
    frames = [Image.fromarray(_smooth(rng, h, w)) for _ in range(2)]
    files["webp_animation.webp"] = _pil(frames[0], "WEBP", save_all=True,
                                        append_images=frames[1:],
                                        lossless=True)
    # PSD
    planes = px.transpose(2, 0, 1)
    files["psd_rgb_raw.psd"] = T.psd_bytes(planes[:3], 3)
    files["psd_rgb_rle.psd"] = T.psd_bytes(planes[:3], 3, rle=True)
    files["psd_rgba_rle.psd"] = T.psd_bytes(planes, 3, rle=True)
    files["psd_cmyk_rle.psd"] = T.psd_bytes(planes, 4, rle=True)
    files["psd_gray.psd"] = T.psd_bytes(planes[:1], 1)
    files["psd_bitmap.psd"] = T.psd_bytes(planes[:1, :, :2], 0, bits=1)
    files["psd_indexed.psd"] = T.psd_bytes(
        planes[:1], 2, color_data=rng.integers(0, 256, 768).astype(
            np.uint8).tobytes())
    # PIL's own PNM variants
    f = (rng.standard_normal((h, w)) * 100).astype("<f4")
    files["pnm_pf.pfm"] = b"Pf\n%d %d\n-1.0\n" % (w, h) + f.tobytes()
    files["pnm_p0cmyk.pnm"] = b"P0CMYK\n%d %d\n255\n" % (w, h) + px.astype(
        np.uint8).tobytes()
    files["pnm_pyrgba.pnm"] = b"PyRGBA\n%d %d\n255\n" % (w, h) + px.astype(
        np.uint8).tobytes()
    files["pnm_pycmyk_1000.pnm"] = (b"PyCMYK\n%d %d\n1000\n" % (w, h)
                                    + (px * 3).astype(">u2").tobytes())
    files["pnm_pyp.pnm"] = b"PyP\n%d %d\n255\n" % (w, h) + px[..., 0].astype(
        np.uint8).tobytes()
    # timing files: an 8-level posterized sinusoid
    y, x = np.mgrid[0:2048, 0:2048]
    base = np.stack([127 + 120 * np.sin(x / (60 + 20 * k)) *
                     np.cos(y / (80 - 15 * k)) for k in range(3)], -1)
    post = (np.floor(base / 256 * 8) * 36).astype(np.uint8)
    files["big_2048_lzw_pred.tif"] = _pil(Image.fromarray(post), "TIFF",
                                          compression="tiff_lzw",
                                          tiffinfo={317: 2})
    files["big_2048_lossless.webp"] = _pil(Image.fromarray(post), "WEBP",
                                           lossless=True, quality=50,
                                           method=2)
    files["bc7_256.dds"] = T.dds_bytes(
        256, 256, rng.integers(0, 256, 64 * 64 * 16).astype(
            np.uint8).tobytes(), dxgi=98)
    return files


def fixture_files() -> dict:
    """File name -> bytes of the whole set."""
    rng = np.random.default_rng(2024)
    files = {}
    h, w = 21, 13
    for ct, depths in {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
                       4: (8, 16), 6: (8, 16)}.items():
        for depth in depths:
            for il in (0, 1):
                s = rng.integers(0, 1 << depth,
                                 (h, w, F.PNG_CHANNELS[ct]))
                pal = rng.integers(0, 256, (1 << min(depth, 7), 3)) \
                    if ct == 3 else None
                files[f"png_c{ct}_d{depth}_i{il}.png"] = F.png_bytes(
                    s, depth, ct, il, palette=pal)
    im = Image.fromarray(_smooth(rng, 47, 33))
    for ss in ("4:4:4", "4:2:2", "4:2:0"):
        for prog in (False, True):
            files[f"jpeg_{ss.replace(':', '')}_{'prog' if prog else 'base'}"
                  ".jpg"] = _pil(im, "JPEG", subsampling=ss, progressive=prog)
    files["jpeg_gray.jpg"] = _pil(im.convert("L"), "JPEG")
    files["jpeg_gray_prog.jpg"] = _pil(im.convert("L"), "JPEG",
                                       progressive=True)
    files["jpeg_optimize.jpg"] = _pil(im, "JPEG", optimize=True)
    files["jpeg_restart.jpg"] = _pil(im, "JPEG", restart_marker_blocks=3)
    files["jpeg_keep_rgb.jpg"] = _pil(im, "JPEG", keep_rgb=True)
    files["jpeg_cmyk.jpg"] = _pil(im.convert("CMYK"), "JPEG")
    files["jpeg_qt16.jpg"] = _pil(im, "JPEG", qtables=[[300] * 64] * 2)
    planes = _smooth(rng, 21, 13, 4)
    for name, fac in (("440", [(1, 2), (1, 1), (1, 1)]),
                      ("411", [(4, 1), (1, 1), (1, 1)]),
                      ("31", [(3, 1), (1, 1), (1, 1)])):
        files[f"jpeg_{name}.jpg"] = F.jpeg_bytes(
            [planes[..., i] for i in range(3)], fac)
    files["jpeg_ycck.jpg"] = F.jpeg_bytes([planes[..., i] for i in range(4)],
                                          [(1, 1)] * 4, adobe=2)
    for kind in (1, 2, 3, 4, 5, 6):
        for mv in ((None,) if kind in (1, 4) else (15, 255, 1000, 65535)):
            shape = (h, w, 3) if kind in (3, 6) else (h, w)
            img = rng.integers(0, (mv or 1) + 1, shape)
            files[f"pnm_p{kind}_{mv or 1}.pnm"] = F.pnm_bytes(kind, img,
                                                             mv or 1)
    px = rng.integers(0, 256, (h, w, 4))
    for bits in (1, 4, 8):
        pal = rng.integers(0, 256, (1 << bits, 3))
        idx = rng.integers(0, 1 << bits, (h, w))
        files[f"bmp_{bits}.bmp"] = F.bmp_bytes(F.bmp_rows(idx, bits), w, h,
                                               bits, palette=pal)
    files["bmp_24_topdown.bmp"] = F.bmp_bytes(
        F.bmp_rows(px[..., :3], 24, True), w, h, 24, top_down=True)
    files["bmp_32_bitfields.bmp"] = F.bmp_bytes(
        F.bmp_rows(px, 32), w, h, 32, compression=3, header=124,
        masks=(0xFF000000, 0xFF0000, 0xFF00, 0))
    files["bmp_16_565.bmp"] = F.bmp_bytes(
        F.bmp_rows(px[..., :2], 16), w, h, 16, compression=3,
        masks=(0xF800, 0x7E0, 0x1F))
    files["bmp_os2_8.bmp"] = F.bmp_bytes(
        F.bmp_rows(px[..., 0], 8), w, h, 8, header=12,
        palette=rng.integers(0, 256, (256, 3)))
    files["bmp_rle8.bmp"] = F.bmp_bytes(
        bytes([3, 5, 0, 4, 1, 2, 3, 4, 0, 0, 2, 9, 0, 3, 7, 8, 9, 0, 0, 0, 9,
               200, 0, 0, 0, 2, 9, 9, 3, 0, 4, 6, 0, 0, 0, 5, 1, 2, 3, 4, 5, 0,
               2, 77, 0, 1]), 7, 5, 8,
        palette=rng.integers(0, 256, (256, 3)), compression=1)
    files["bmp_rle4.bmp"] = F.bmp_bytes(
        bytes([5, 0x12, 0, 3, 0x34, 0x50, 0, 0, 0, 4, 0xAB, 0xCD, 3, 0x9F, 0,
               0, 9, 0x12, 0, 0, 7, 0x33, 0, 0, 0, 6, 0x12, 0x34, 0x56, 0, 1,
               0x70, 0, 1]), 7, 5, 4,
        palette=rng.integers(0, 256, (16, 3)), compression=2)
    tpx = rng.integers(0, 256, (20 * 7 * 4,)).astype(np.uint8)
    for it, dp in ((2, 24), (2, 32), (2, 16), (3, 8), (10, 24), (11, 8)):
        bpp = dp // 8
        data = tpx[:20 * 7 * bpp]
        payload = F.tga_rle(data, bpp, (3, 128 + 2, 2)) if it & 8 else \
            data.tobytes()
        files[f"tga_t{it}_d{dp}.tga"] = F.tga_bytes(payload, 7, 20, it, dp,
                                                    descriptor=0x20)
    files["tga_cmap.tga"] = F.tga_bytes(
        tpx[:140].tobytes(), 7, 20, 1, 8,
        cmap=rng.integers(0, 256, (256 * 3,)).astype(np.uint8).tobytes())
    files["tga_mirror.tga"] = F.tga_bytes(tpx[:420].tobytes(), 7, 20, 2, 24,
                                          descriptor=0x10)
    gidx = rng.integers(0, 16, (h, w))
    gpal = rng.integers(0, 256, (16, 3))
    files["gif_global.gif"] = F.gif_bytes(gidx, global_palette=gpal)
    files["gif_interlaced_local.gif"] = F.gif_bytes(
        gidx, global_palette=gpal, local_palette=gpal[::-1], interlace=True)
    files["gif_offset_transparent.gif"] = F.gif_bytes(
        gidx, global_palette=gpal, screen=(w + 5, h + 3), offset=(2, 1),
        transparency=3)
    checker = np.asarray(Image.open(CHECKER).convert("RGB"))
    files.update(checker_variants(checker))
    files.update(checker_variants_m(checker))
    files.update(slice_m_files())
    files.update(checker_variants_n(checker))
    files.update(slice_n_files())
    files.update(checker_variants_o(checker))
    files.update(slice_o_files())
    y, x = np.mgrid[0:2048, 0:2048]
    big = np.stack([127 + 120 * np.sin(x / (60 + 20 * k)) *
                    np.cos(y / (80 - 15 * k)) for k in range(3)], -1)
    files["big_2048_420.jpg"] = _pil(Image.fromarray(big.astype(np.uint8)),
                                     "JPEG", subsampling="4:2:0", quality=80)
    return files


def main() -> None:
    os.makedirs(OUT, exist_ok=True)
    for f in os.listdir(OUT):
        os.remove(os.path.join(OUT, f))
    manifest = {}
    phase56 = set(checker_variants_m(
        np.asarray(Image.open(CHECKER).convert("RGB"))))
    phase56 |= set(slice_m_files())
    phase57 = set(checker_variants_n(
        np.asarray(Image.open(CHECKER).convert("RGB"))))
    phase57 |= set(slice_n_files())
    files = fixture_files()
    phase58 = set(checker_variants_o(
        np.asarray(Image.open(CHECKER).convert("RGB"))))
    phase58 |= set(slice_o_files())
    for name, data in sorted(files.items()):
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        if name in UNREAD_BY_PIL:
            continue
        rgb = np.asarray(Image.open(path).convert("RGB"))
        manifest[name] = {"sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
                          "shape": list(rgb.shape)}
        if name in phase56:  # checked by phase 56 rather than 55
            manifest[name]["phase"] = 56
        if name in phase57:
            manifest[name]["phase"] = 57
        if name in phase58:
            manifest[name]["phase"] = 58
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"{len(manifest)} files, {total} bytes in {OUT}")


if __name__ == "__main__":
    main()
