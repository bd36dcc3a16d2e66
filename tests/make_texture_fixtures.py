"""Write the texture fixtures the card checks the port's decoders on
(chip_smoke.py phase 55), which has no PIL: one small file per format and
variant (tests/torch_image_files.py writes those PIL cannot), the
parity_textured checker re-encoded losslessly in six formats and as a
4:2:0 JPEG, and a 2048x2048 4:2:0 JPEG for timing, into
craytracer_tpu_torch/testdata/textures/ with manifest.json: for each file
the SHA-256 of PIL's Image.open(path).convert("RGB") bytes and its shape.

    python tests/make_texture_fixtures.py

tests/test_torch_texture_io.py holds the manifest to PIL's decode of each
file and to the port's; run this again (and commit the files) after a
change to the set. Made from fixed seeds: the bytes do not change between
runs with the same Pillow.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_image_files as F  # noqa: E402

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
    for name, data in sorted(fixture_files().items()):
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        rgb = np.asarray(Image.open(path).convert("RGB"))
        manifest[name] = {"sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
                          "shape": list(rgb.shape)}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, f)) for f in os.listdir(OUT))
    print(f"{len(manifest)} files, {total} bytes in {OUT}")


if __name__ == "__main__":
    main()
