"""Slice N of the port's image loading against the JAX package's loader,
which reads every image through PIL's `Image.open(path).convert("RGB")`:

- which plugin opens a file (io/imgopen.py transcribes `Image.open`'s
  search): files no plugin opens, and files a later plugin takes when an
  earlier one hands them on, give what the JAX loader gives;
- every other plugin PIL registers here: NotImplementedError naming it
  where the JAX loader reads the file, None where it does not (the
  sixteen decoded since slice O are held to the JAX loader);
- the decoders of this slice (csrc/imgdecode_small.h, _ccitt.h, the
  lossless JPEG of imgdecode.cpp, old-style LZW in _tiff.h): QOI, SGI,
  PCX, DIB, IM, XBM, SPIDER, ICO, CUR, lossless JPEG, CCITT and old-style
  LZW TIFF, each file written into tmp_path from a seed by PIL or by
  tests/torch_image_files.py / torch_tiff_files.py, held to the JAX
  loader with assert_array_equal, or both None where the case says PIL's
  libraries fail;
- the JPEG processes and TIFF tags libjpeg-turbo and libtiff always
  refuse: both None;
- a textured scene with a texture of this slice, built by the JAX
  package and carried through interop.scene_from_numpy, equal to the
  port's own build of it."""

import io
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import torch_image_files as F
import torch_tiff_files as T

from craytracer_tpu.io.scenefile import load_scene_file as j_load
from craytracer_tpu.io.teximage import load_texture_image as j_tex
from craytracer_tpu_torch.interop import numpy_leaves, scene_from_numpy
from craytracer_tpu_torch.io.image import read_ppm
from craytracer_tpu_torch.io.scenefile import load_scene_file
from craytracer_tpu_torch.io.teximage import decode_file, load_texture_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "scenes")
FIXTURES = os.path.join(REPO, "craytracer_tpu_torch", "testdata", "textures")


def _same(path, readable=True):
    """The port's texels equal the JAX loader's; with readable=False both
    give None. Every case states which it expects."""
    ours, ref = load_texture_image(str(path)), j_tex(str(path))
    if not readable:
        assert ref is None and ours is None
        return
    assert ref is not None and ours is not None
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


def _write(tmp_path, data, name="x.img"):
    p = tmp_path / name
    p.write_bytes(data)
    return p


def _pil(img, fmt, **kw):
    bio = io.BytesIO()
    img.save(bio, format=fmt, **kw)
    return bio.getvalue()


def _rand(seed, *shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


def _blocks(seed, h, w, c=3, cell=3):
    """A random image of cell x cell blocks: runs for the RLE coders."""
    a = _rand(seed, -(-h // cell), -(-w // cell), c)
    return np.repeat(np.repeat(a, cell, 0), cell, 1)[:h, :w]


def _retag(data, tag, value):
    """A little-endian TIFF of tiff_bytes with one SHORT tag changed."""
    d = bytearray(data)
    at = d.index(struct.pack("<HHI", tag, 3, 1))
    struct.pack_into("<H", d, at + 8, value)
    return bytes(d)


# ------------------------------------------------- which plugin opens it

def _no_plugin(kind):
    if kind == "text named .png":
        return b"hello, this is not an image\n"
    if kind == "EXR named .png":
        with open(os.path.join(SCENES, "parity_tex_env.exr"), "rb") as f:
            return f.read()
    if kind == "PF header":  # PIL's PPM plugin does not accept "PF"
        return b"PF\n1 1\n-1\n" + bytes(12)
    if kind == "BMP of width 0":  # handed on by BMP, opened by no other
        d = bytearray(_pil(Image.new("RGB", (4, 4), (1, 2, 3)), "BMP"))
        struct.pack_into("<I", d, 18, 0)
        return bytes(d)
    return b"\0\1"  # "three bytes"


@pytest.mark.parametrize("kind", ["text named .png", "EXR named .png",
                                  "PF header", "BMP of width 0",
                                  "two bytes"])
def test_no_plugin_opens_it_is_none(tmp_path, kind):
    """A file no plugin of PIL's opens: the JAX loader gives None, and so
    does the port (no format to refuse)."""
    _same(_write(tmp_path, _no_plugin(kind), "x.png"), readable=False)


def test_tiff_prefix_taken_by_im_first(tmp_path):
    """IM comes before TIFF in PIL's order: a text IM header that starts
    with a TIFF prefix is read as IM."""
    p = _write(tmp_path, b"II*\0: tiff-looking\r\nImage size (x*y): 4*3\r\n"
               b"Image type: Greyscale image\r\n\x1a" + bytes(range(12)))
    assert Image.open(p).format == "IM"
    _same(p)


def test_ico_frame_failing_hands_the_file_on(tmp_path):
    """An ICO whose DIB frame has a width of 0: the ICO plugin's _open
    fails with a SyntaxError, PIL tries the next plugins, TGA opens the
    file and fails to load it: None from both loaders."""
    dib = bytearray(_pil(Image.new("L", (4, 4), 7), "DIB"))
    struct.pack_into("<I", dib, 4, 0)
    data = (b"\0\0\1\0\1\0" + struct.pack("<BBBBHHII", 4, 4, 0, 0, 1, 8,
                                           0x00080028, 22) + bytes(dib))
    p = _write(tmp_path, data, "x.ico")
    assert Image.open(p).format == "TGA"
    _same(p, readable=False)


# ------------------------------------- plugins the port does not decode

def _fits():
    cards = [f"{k:8}= {v:>20}" for k, v in (
        ("SIMPLE", "T"), ("BITPIX", 8), ("NAXIS", 2), ("NAXIS1", 4),
        ("NAXIS2", 3))] + ["END"]
    head = b"".join(c.ljust(80).encode() for c in cards).ljust(2880, b" ")
    return head + bytes(range(0, 240, 20)).ljust(2880, b"\0")


def _fli():
    h = bytearray(128)
    struct.pack_into("<IHHHHHH", h, 0, 0, 0xAF12, 1, 4, 3, 8, 0)
    return bytes(h) + struct.pack("<IHH", 26, 0xF1FA, 1) + bytes(8) + \
        struct.pack("<IH", 10, 13) + bytes(4)  # one BLACK chunk


def _ftex():
    return (b"FTEX" + struct.pack("<i2i2i2i", 0, 4, 3, 1, 1, 1, 32)
            + struct.pack("<i", 36) + bytes(range(36)))


def _gbr():
    return struct.pack(">5I", 26, 1, 4, 3, 1) + b"brush\0" + bytes(
        range(10, 130, 10))


def _iptc():
    def field(rec, ds, data):
        return bytes([0x1C, rec, ds]) + struct.pack(">H", len(data)) + data
    return (field(3, 60, b"\1\0") + field(3, 20, b"\0\4")
            + field(3, 30, b"\0\3") + field(3, 120, b"\1")
            + field(8, 10, bytes(range(12))))


def _mcidas():
    w = [0] * 65  # PIL's numbering: w[1] is the first word
    w[2], w[9], w[10], w[11], w[14], w[34] = 4, 3, 4, 1, 1, 256
    return struct.pack("!64i", *w[1:]) + bytes(range(12))


def _pcd():
    d = bytearray(96 * 2048 + 768 * 512 * 3 // 2)
    d[2048:2052] = b"PCD_"
    d[96 * 2048:] = _rand(1, len(d) - 96 * 2048).tobytes()
    return bytes(d)


def _pixar():
    h = bytearray(1024)
    h[:4] = b"\x80\xe8\0\0"
    struct.pack_into("<HH", h, 416, 3, 4)
    struct.pack_into("<HH", h, 424, 14, 2)
    return bytes(h) + bytes(range(36))


def _sun():
    row = bytes(range(12))
    return struct.pack(">8I", 0x59A66A95, 4, 3, 24, 36, 1, 0, 0) + row * 3


def _dcx():
    pcx = _pil(Image.new("L", (4, 3), 90), "PCX")
    return struct.pack("<III", 0x3ADE68B1, 12, 0) + pcx


_G = Image.fromarray(_rand(0, 8, 8, 3))
# plugin -> (file bytes, the name the port's NotImplementedError gives,
# or None where the JAX loader gives None)
PLUGINS = {
    "AVIF": (lambda: _pil(_G, "AVIF"), "AVIF"),
    "BLP": (lambda: _pil(_G.convert("P"), "BLP"), "BLP"),
    "BUFR": (lambda: b"BUFR" + bytes(40), None),
    "DCX": (_dcx, "DCX"),
    "EPS": (lambda: _pil(_G, "EPS"), None),  # no Ghostscript here
    "FITS": (_fits, "FITS"),
    "FLI": (_fli, "FLI"),
    "FTEX": (_ftex, "FTEX"),
    "GBR": (_gbr, "GBR"),
    "GRIB": (lambda: b"GRIB\0\0\0\1" + bytes(40), None),
    "HDF5": (lambda: b"\x89HDF\r\n\x1a\n" + bytes(40), None),
    "JPEG2000": (lambda: _pil(_G, "JPEG2000"), "JPEG 2000"),
    "ICNS": (lambda: _pil(_G.resize((16, 16)), "ICNS", sizes=[(16, 16)]),
             "ICNS"),
    "IMT": (lambda: b"width 5\nheight 3\npixel n8\n\x0c" + bytes(range(15)),
            "IMT"),
    "IPTC": (_iptc, "IPTC"),
    "MCIDAS": (_mcidas, "McIdas"),
    "MPEG": (lambda: b"\0\0\1\xb3\0\x40\3" + bytes(20), None),
    "MSP": (lambda: _pil(_G.convert("1"), "MSP"), "MSP"),
    "PCD": (_pcd, "PCD"),
    "PIXAR": (_pixar, "PIXAR"),
    "SUN": (_sun, "SUN"),
    "WMF": (lambda: b"\xd7\xcd\xc6\x9a\0\0" + bytes(60), None),
    "XPM": (lambda: b'/* XPM */\nstatic char *x[] = {\n"3 2 2 1",\n'
            b'"a c #FF0000",\n"b c #00FF00",\n"aba",\n"bab"\n};\n', "XPM"),
    "XVTHUMB": (lambda: b"P7 332\n#XVVERSION\n#END_OF_COMMENTS\n3 2 255\n"
                + bytes([0, 255, 28, 224, 3, 100]), "XV thumbnail"),
}


# the plugins decoded since slice O (csrc/imgdecode_plugins.h)
DECODED_SINCE_O = {"BLP", "DCX", "FITS", "FLI", "FTEX", "GBR", "ICNS",
                   "IMT", "IPTC", "MCIDAS", "MSP", "PCD", "PIXAR", "SUN",
                   "XPM", "XVTHUMB"}


@pytest.mark.parametrize("plugin", sorted(PLUGINS))
def test_plugins_without_a_decoder(tmp_path, plugin):
    """Each plugin PIL registers here that the port has no decoder for:
    where the JAX loader reads the file, NotImplementedError naming the
    format; where PIL opens it and never produces texels (stubs, EPS
    without Ghostscript, a WMF PIL cannot size, MPEG), None. The sixteen
    plugins of DECODED_SINCE_O are decoded since slice O: their cases
    hold the port to the JAX loader."""
    make, name = PLUGINS[plugin]
    p = _write(tmp_path, make())
    if name is None:
        _same(p, readable=False)
        return
    assert j_tex(str(p)) is not None  # the JAX package renders it
    if plugin in DECODED_SINCE_O:
        _same(p)
        return
    with pytest.raises(NotImplementedError, match=name):
        load_texture_image(str(p))


# ---------------------------------------------------------------- JPEG

@pytest.mark.parametrize("marker", [0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF])
def test_jpeg_hierarchical_is_none(tmp_path, marker):
    """A baseline JPEG re-marked as a hierarchical process: libjpeg-turbo
    refuses it, the JAX loader gives None, and so does the port."""
    data = bytearray(_pil(Image.fromarray(_rand(2, 8, 8, 3)), "JPEG"))
    data[data.index(b"\xff\xc0") + 1] = marker
    _same(_write(tmp_path, bytes(data)), readable=False)


_LOSSLESS = (
    [(f"p{p}-{src}", dict(predictor=p), src, True)
     for p in range(1, 8) for src in ("rand", "blocks")]
    + [(f"pt{pt}", dict(predictor=4, pt=pt), "rand", True)
       for pt in (1, 3, 7)]
    + [(f"restart{r}", dict(predictor=7, restart_rows=r), "rand", True)
       for r in (1, 2)]
    + [("restart-sub", dict(predictor=6, restart_rows=2,
                            factors=[(2, 2), (1, 1), (1, 1)]), "rand", True),
       ("scans", dict(predictor=5, scans=[[0], [1, 2]]), "rand", True),
       ("scans-restart", dict(predictor=6, scans=[[2], [0], [1]],
                              restart_rows=2), "rand", True),
       ("sub21", dict(factors=[(2, 1), (1, 1), (1, 1)]), "blocks", True),
       ("sub12", dict(factors=[(1, 2), (1, 1), (1, 1)]), "blocks", True),
       ("sub-chroma", dict(factors=[(1, 1), (2, 2), (1, 1)]), "blocks", True),
       ("sub31", dict(factors=[(3, 1), (1, 1), (1, 1)]), "blocks", True),
       ("adobe0", dict(markers="adobe"), "rand", True),
       ("rgb-ids", dict(ids=[82, 71, 66]), "rand", True),
       ("other-ids", dict(ids=[5, 6, 7]), "rand", True),
       ("gray", dict(markers="jfif", planes=1), "rand", True),
       ("cmyk", dict(planes=4), "rand", True),
       ("cmyk-adobe0", dict(planes=4, markers="adobe"), "rand", True),
       # libjpeg-turbo converts no colour space of lossless data
       ("jfif", dict(markers="jfif"), "rand", False),
       ("adobe1", dict(markers="adobe", transform=1), "rand", False),
       ("ycck", dict(planes=4, markers="adobe", transform=2), "rand", False),
       # an MCU of 11 samples; 12-bit samples (PIL's SyntaxError)
       ("mcu11", dict(factors=[(4, 2), (2, 1), (1, 1)]), "blocks", False),
       ("12bit", dict(precision=12), "rand", False)])


@pytest.mark.parametrize("kw,src,readable",
                         [pytest.param(*c[1:], id=c[0]) for c in _LOSSLESS])
def test_jpeg_lossless(tmp_path, kw, src, readable):
    """Lossless (SOF3) JPEG: every predictor, point transforms, restart
    intervals, several scans, subsampled components (replicated, as
    libjpeg upsamples lossless data), 1, 3 and 4 components; None where
    libjpeg-turbo fails (a colour conversion, an MCU of more than 10
    samples, precision other than 8)."""
    kw = dict(kw)
    nplanes = kw.pop("planes", 3)
    transform = kw.pop("transform", None)
    img = (_rand(5, 11, 13, 4) if src == "rand" else
           _blocks(5, 11, 13, 4)).astype(np.int64)
    if kw.get("precision") == 12:
        img = img * 16
    data = F.jpeg_lossless_bytes([img[..., c] for c in range(nplanes)],
                                 **kw)
    if transform is not None:
        data = bytearray(data)
        data[data.index(b"Adobe") + 11] = transform
        data = bytes(data)
    _same(_write(tmp_path, data), readable)


def test_jpeg_lossless_truncated_is_none(tmp_path):
    data = F.jpeg_lossless_bytes([_rand(6, 9, 11)])
    _same(_write(tmp_path, data[:len(data) // 2]), readable=False)


# ---------------------------------------------------------------- TIFF

@pytest.mark.parametrize("compression", [50001, 34676, 34677, 32809, 2, 3,
                                         4, 32771])
def test_tiff_retagged_is_none(tmp_path, compression):
    """An 8-bit RGB TIFF re-tagged with a compression whose setup libtiff
    fails on it (WebP, not built in here; SGILog, which wants a LogLuv
    photometric; ThunderScan, 4-bit samples only; CCITT, 1-bit only):
    None from both loaders."""
    data = T.tiff_bytes(_rand(3, 8, 8, 3), 8, 2)
    _same(_write(tmp_path, _retag(data, 259, compression)), readable=False)


def _bilevel(seed, h, w, wide_runs=False):
    rng = np.random.default_rng(seed)
    if not wide_runs:
        return (rng.random((h, w)) < 0.4).astype(np.uint8)
    rows = []
    for _ in range(h):
        r, c = [], 0
        while len(r) < w:
            k = int(rng.integers(0, w)) if rng.random() < 0.3 else int(
                rng.integers(0, 70))
            r += [c] * k
            c ^= 1
        rows.append(r[:w])
    return np.array(rows, np.uint8)


def _every_run(w=2640):
    """Rows holding every run length T.4 codes, white and black: 0-63,
    each make-up step to 2560, and runs past it."""
    r, c = [], 0
    for k in list(range(64)) + list(range(64, 2561, 64)) + [2623, 1793,
                                                            2600, 5]:
        r += [c] * k
        c ^= 1
    r += [c] * ((-len(r)) % w)
    return np.array(r, np.uint8).reshape(-1, w)


_CCITT = [
    ("rle", 2, {}), ("rlew", 32771, {}), ("g3-1d", 3, {}),
    ("g3-2d", 3, dict(t4options=1, two_d="alternate")),
    ("g3-2d-all", 3, dict(t4options=1, two_d="all")),
    ("g3-fill", 3, dict(t4options=4, fill_eol=True)),
    ("g3-2d-fill", 3, dict(t4options=5, two_d="alternate", fill_eol=True)),
    ("g4", 4, {})]


def _fax_tiff(bits, compression, fax, **kw):
    fax = dict(fax)
    t4 = fax.get("t4options", 0)
    if fax.get("two_d") == "alternate":
        fax["two_d"] = [y % 3 != 0 for y in range(len(bits))]
    elif fax.get("two_d") == "all":
        fax["two_d"] = [True] * len(bits)
    extra = [(292, 4, [t4])] if compression == 3 and t4 else []
    if compression != 3:
        fax.pop("t4options", None)
    return T.tiff_bytes(bits[..., None], 1, kw.pop("photometric", 0),
                        compression=compression, fax=fax,
                        extra_tags=extra, **kw)


@pytest.mark.parametrize("name,compression,fax", _CCITT,
                         ids=[c[0] for c in _CCITT])
@pytest.mark.parametrize("photometric", [0, 1])
def test_tiff_ccitt(tmp_path, name, compression, fax, photometric):
    """CCITT RLE, Group 3 1D and 2D (with and without byte-aligned EOLs),
    Group 4 and RLEW of random bilevel rows, both photometrics."""
    bits = _bilevel(7, 13, 37)
    _same(_write(tmp_path, _fax_tiff(bits, compression, fax,
                                     photometric=photometric)))


@pytest.mark.parametrize("name,compression,fax", _CCITT,
                         ids=[c[0] for c in _CCITT])
def test_tiff_ccitt_make_up_codes(tmp_path, name, compression, fax):
    """Rows wide enough for every make-up and extended make-up code (RLEW
    rows this long meet libtiff's word alignment, which drops the bits
    it has read ahead: the port reads them as libtiff does)."""
    bits = np.concatenate([_every_run(), _bilevel(8, 3, 2640, True)])
    _same(_write(tmp_path, _fax_tiff(bits, compression, fax)))


@pytest.mark.parametrize("layout", ["fill order 2", "strips", "tiles",
                                    "rlew strips"])
def test_tiff_ccitt_layouts(tmp_path, layout):
    """Group 4 with FillOrder 2 and in tiles, Group 3 in several strips
    (each strip starting afresh), RLEW in strips."""
    bits = _bilevel(9, 21, 40)
    kw = {"fill order 2": dict(fill_order=2), "strips":
          dict(rows_per_strip=5), "tiles": dict(tile=(32, 16)),
          "rlew strips": dict(rows_per_strip=2)}[layout]
    compression = {"strips": 3, "rlew strips": 32771}.get(layout, 4)
    _same(_write(tmp_path, _fax_tiff(bits, compression, {}, **kw)))


@pytest.mark.parametrize("compression", ["group3", "group4", "tiff_ccitt"])
@pytest.mark.parametrize("kind", ["random", "wide runs"])
def test_tiff_ccitt_written_by_pil(tmp_path, compression, kind):
    """The CCITT files libtiff itself writes."""
    bits = (_bilevel(10, 9, 29) if kind == "random" else
            _bilevel(11, 4, 2700, True))
    im = Image.fromarray(bits * 255).convert("1")
    _same(_write(tmp_path, _pil(im, "TIFF", compression=compression)))


@pytest.mark.parametrize("case", ["rgb", "gray", "16-bit", "predictor",
                                  "blocks", "large"])
def test_tiff_old_style_lzw(tmp_path, case):
    """Old-style LZW (LSB-first codes, libtiff's LZWDecodeCompat): 8-bit
    RGB and gray, 16-bit, the horizontal predictor in strips, long runs,
    and a strip long enough for 12-bit codes and a clear code."""
    img = _rand(12, 19, 23, 3)
    kw = dict(bps=8, photometric=2)
    if case == "gray":
        img, kw["photometric"] = img[..., :1], 1
    elif case == "16-bit":
        img, kw["bps"] = img.astype(np.uint16) * 257 + 3, 16
    elif case == "predictor":
        kw.update(predictor=2, rows_per_strip=4)
    elif case == "blocks":
        img = _blocks(12, 19, 23)
    elif case == "large":
        img = _rand(13, 90, 120, 3) // 64 * 64
    bps, photo = kw.pop("bps"), kw.pop("photometric")
    _same(_write(tmp_path, T.tiff_bytes(img, bps, photo, compression=5,
                                        old_lzw=True, **kw)))


# ----------------------------------------------------- the small formats

@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("src", ["rand", "blocks"])
def test_qoi(tmp_path, mode, src):
    img = _rand(14, 13, 21, 4) if src == "rand" else _blocks(14, 13, 21, 4)
    _same(_write(tmp_path, _pil(Image.fromarray(img).convert(mode), "QOI")))


@pytest.mark.parametrize("bands", [1, 3, 4])
@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("rle", [False, True])
def test_sgi(tmp_path, bands, bpc, rle):
    """SGI raw and RLE, 8 and 16 bits a channel, 1, 3 and 4 bands."""
    planes = _blocks(15, 9, 14, 4).transpose(2, 0, 1)[:bands].astype(
        np.int64)
    if bpc == 2:
        planes = planes * 257 + _rand(16, *planes.shape)
    _same(_write(tmp_path, F.sgi_bytes(planes, bpc, rle)))


@pytest.mark.parametrize("case", ["pil L", "pil RGB", "rows shuffled",
                                  "dimension 1", "short row",
                                  "unterminated row", "run past the row"])
def test_sgi_cases(tmp_path, case):
    """PIL's own (raw) SGI; RLE rows stored out of order; a 1-D image; a
    row filling part of its width (the rest keeps the row before's
    values, as PIL's buffer does); a row whose last chunk is not a 0
    (PIL stops there without an error); a run past the width (None)."""
    img = _blocks(17, 6, 9, 3)
    if case.startswith("pil"):
        data = _pil(Image.fromarray(img).convert(case[4:]), "SGI")
        _same(_write(tmp_path, data))
        return
    if case == "rows shuffled":
        data = F.sgi_bytes(img.transpose(2, 0, 1), 1, True,
                           row_order=list(range(18))[::-1])
    elif case == "dimension 1":
        data = F.sgi_bytes(img[:1, :, :1].transpose(2, 0, 1), 1, True,
                           dimension=1)
    else:
        data = bytearray(F.sgi_bytes(img[..., :1].transpose(2, 0, 1), 1,
                                     True))
        n = 6
        offs = struct.unpack_from(f">{n}I", data, 512)
        lens = list(struct.unpack_from(f">{n}I", data, 512 + 4 * n))
        if case == "short row":  # row 2: a run of 4, then the end
            data[offs[2]:offs[2] + 3] = bytes([4, 77, 0])
        elif case == "unterminated row":
            lens[3] = 1  # one chunk allowed, and it is not the end
        else:
            data[offs[1]] = 0x7F  # a run of 127 in a row of 9
        struct.pack_into(f">{n}I", data, 512 + 4 * n, *lens)
        data = bytes(data)
    _same(_write(tmp_path, data), readable=case != "run past the row")


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
@pytest.mark.parametrize("src", ["rand", "blocks"])
def test_pcx_pil(tmp_path, mode, src):
    img = _rand(18, 7, 11, 3) if src == "rand" else _blocks(18, 7, 11)
    _same(_write(tmp_path, _pil(Image.fromarray(img).convert(mode), "PCX")))


_PCX = ([(f"planes{p}-w{w}-s{s}", 1, p, w, s, None) for p in (2, 4)
         for w in (5, 16, 17) for s in ("packed", "even", "padded")]
        + [(f"bilevel-w{w}-s{s}", 1, 1, w, s, None) for w in (1, 3, 9)
           for s in ("packed", "padded")]
        + [(f"rgb-w{w}-s{s}", 8, 3, w, s, None) for w in (5, 9)
           for s in ("packed", "padded", "double")]
        + [(f"{t}-w6", 8, 1, 6, "padded", t) for t in ("palette", "ramp")])


@pytest.mark.parametrize("bits,planes,w,stride,trailer",
                         [pytest.param(*c[1:], id=c[0]) for c in _PCX])
def test_pcx_layouts(tmp_path, bits, planes, w, stride, trailer):
    """PCX layouts PIL does not write: 2 and 4 bit planes (P;2L, P;4L),
    strides padded past the row (PIL's repacking of the planes), 8-bit
    with a colour trailer palette (mode P) or the gray ramp (mode L)."""
    rng = np.random.default_rng(19)
    s = (w * bits + 7) // 8
    st = {"packed": s, "even": s + s % 2, "padded": s + 3,
          "double": 2 * s + 1}[stride]
    lines = rng.integers(0, 256, (4, planes * st))
    tail = None
    if trailer:
        pal = (rng.integers(0, 256, 768) if trailer == "palette" else
               np.repeat(np.arange(256), 3))
        tail = bytes([12]) + pal.astype(np.uint8).tobytes()
    _same(_write(tmp_path, F.pcx_bytes(
        lines, w, 4, bits, planes, palette=rng.integers(0, 256, (16, 3)),
        stride=st, trailer=tail)))


def test_pcx_palette_trailer(tmp_path):
    """An 8-bit PCX whose trailer palette is not the gray ramp: mode P."""
    rng = np.random.default_rng(20)
    trailer = bytes([12]) + rng.integers(0, 256, 768).astype(
        np.uint8).tobytes()
    _same(_write(tmp_path, F.pcx_bytes(rng.integers(0, 256, (4, 8)), 7, 4,
                                       8, 1, trailer=trailer)))


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_dib(tmp_path, mode):
    img = Image.fromarray(_rand(21, 9, 13, 3)).convert(mode)
    _same(_write(tmp_path, _pil(img, "DIB")))


_IM_TYPES = ["0 1 image", "L 1 image", "Greyscale image", "Grayscale image",
             "RGB image", "RLB image", "B1 image", "B2 image", "B4 image",
             "X 24 image", "L 32 S image", "L 32 F image", "RGB3 image",
             "RYB3 image", "LA image", "PA image", "RGBA image", "RGBX image",
             "CMYK image", "YCC image", "L 8 image", "L 8S image",
             "L 16 image", "L 16S image", "L 32 image", "L 32F image",
             "L 16L image", "L 16B image", "L 32S image", "L*12 image",
             "L*3 image", "L*24 image", "L", "P", "RGB"]
# the types PIL opens and cannot load (no raw mode for the pair)
_IM_NONE = {"RLB image", "PA image", "RGB"}


@pytest.mark.parametrize("lut", ["none", "colour"])
@pytest.mark.parametrize("image_type", _IM_TYPES)
def test_im_types(tmp_path, image_type, lut):
    """Every image type ImImagePlugin names (and PIL modes given as
    such), with no LUT or a colour one (L and P become P, LA becomes PA
    with the LUT as palette), on random bytes: IM rows run bottom-up."""
    hdr = (f"Image type: {image_type}\r\nImage size (x*y): 7*5\r\n"
           + ("Lut: 1\r\n" if lut != "none" else "")).encode()
    body = _rand(22, 7 * 5 * 16)
    if image_type.startswith("L*") and int(image_type[2:4].strip()) > 8:
        body[1::2] = 0  # values below 255 in the wide bit depths
    data = hdr.ljust(511, b"\0") + b"\x1a" + (
        _rand(23, 768).tobytes() if lut != "none" else b"") + body.tobytes()
    _same(_write(tmp_path, data),
          readable=image_type not in _IM_NONE or (
              image_type == "PA image" and lut == "colour"))


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "PA", "I", "F",
                                  "RGB", "RGBA", "RGBX", "CMYK", "YCbCr"])
def test_im_written_by_pil(tmp_path, mode):
    img = Image.fromarray(_rand(24, 9, 11, 3)).convert(mode)
    _same(_write(tmp_path, _pil(img, "IM")))


@pytest.mark.parametrize("case", ["grey LUT", "ramp LUT", "short LUT",
                                  "one-number size", "float size",
                                  "bad number", "no tags", "no data"])
def test_im_header_cases(tmp_path, case):
    """IM headers: a gray (but not linear) and a ramp LUT keep L; a short
    LUT hands the file on (None); a size of one number hands it on; a
    float size opens and fails to load; a value int() and float() reject
    ends the search; a header of no known tag and one never reaching its
    data hand the file on."""
    size = {"one-number size": "7", "float size": "7.0*5"}.get(case, "7*5")
    key = "Scale (x,y)" if case == "bad number" else "Name"
    hdr = (f"Image type: Greyscale image\r\nImage size (x*y): {size}\r\n"
           f"{key}: {'x1' if case == 'bad number' else 'n'}\r\n")
    if case == "no tags":
        hdr = "Foo: 1\r\nBar: 2\r\n"
    if case.endswith("LUT"):
        hdr += "Lut: 1\r\n"
    lut = {"grey LUT": _rand(25, 256).tobytes() * 3,
           "ramp LUT": bytes(range(256)) * 3,
           "short LUT": bytes(range(256)) * 2}.get(case, b"")
    data = hdr.encode().ljust(511, b"\0")
    if case != "no data":
        data += b"\x1a" + lut + _rand(26, 35).tobytes()
    _same(_write(tmp_path, data), readable=case in ("grey LUT", "ramp LUT"))


@pytest.mark.parametrize("case", ["pil", "hotspot", "names", "x in name",
                                  "truncated"])
def test_xbm(tmp_path, case):
    """XBM as PIL writes it (with and without a hotspot), with other
    names and spacing, an 'x' in the array's name (XbmDecode takes the
    two characters after any 'x'), and data ending early (None)."""
    bits = _bilevel(27, 5, 13)
    im = Image.fromarray(bits * 255).convert("1")
    if case in ("pil", "hotspot", "truncated"):
        data = _pil(im, "XBM", **({"hotspot": (1, 2)} if case == "hotspot"
                                  else {}))
        if case == "truncated":
            data = data[:len(data) - 20]
    else:
        packed = np.packbits(bits, axis=1, bitorder="little")
        vals = ",".join(f"0x{v:02x}" for v in packed.reshape(-1))
        name = "box" if case == "x in name" else "texture_a"
        data = (f"  #define {name}_width 13\n#define {name}_height 5\n"
                f"static unsigned char {name}_bits[] = {{\n  {vals} }};\n"
                ).encode()
    _same(_write(tmp_path, data), readable=case != "truncated")


@pytest.mark.parametrize("big", [True, False])
@pytest.mark.parametrize("stack", [False, True])
def test_spider(tmp_path, big, stack):
    """SPIDER in both byte orders, alone and as a stack's first image:
    float32 to L truncating and clipping (NaN to 0)."""
    f = np.random.default_rng(28).normal(100, 150, (7, 9)).astype(np.float32)
    f[0, :5] = [np.nan, np.inf, -np.inf, 254.99, 0.5]
    _same(_write(tmp_path, F.spider_bytes(f, big, stack)))


def test_spider_written_by_pil(tmp_path):
    f = np.random.default_rng(29).normal(90, 80, (6, 10)).astype(np.float32)
    _same(_write(tmp_path, _pil(Image.fromarray(f, "F"), "SPIDER")))


def _dib(img):
    return _pil(img, "DIB")


@pytest.mark.parametrize("mode", ["1", "P", "RGB", "RGBA"])
@pytest.mark.parametrize("cursor", [False, True])
def test_icon_bmp_frames(tmp_path, mode, cursor):
    """ICO and CUR of one DIB frame (its height doubled, the AND mask
    after it) of each bit depth."""
    img = Image.fromarray(_rand(30, 16, 16, 3))
    img = img.convert("P", colors=16) if mode == "P" else img.convert(mode)
    bpp = {"1": 1, "P": 8, "RGB": 24, "RGBA": 32}[mode]
    data = F.icon_bytes([(16, 16, 0, 1, 2 if cursor else bpp,
                          F.dib_frame(_dib(img)))], cursor=cursor)
    _same(_write(tmp_path, data))


@pytest.mark.parametrize("case", ["pil png", "pil bmp", "largest first",
                                  "depth tie", "cursor choice",
                                  "cursor first larger", "no mask",
                                  "no alpha"])
def test_icon_cases(tmp_path, case):
    """PIL's ICO (PNG and BMP frames); the entry PIL picks (the largest,
    then the smallest colour depth; a cursor's first entry unless a later
    one is larger in both sides); a frame without its AND mask (PIL reads
    the mask from the frame's last bytes) and a 32-bit entry whose alpha
    the frame is too short for (None: PIL cannot build the mask)."""
    rng = np.random.default_rng(31)
    small = Image.fromarray(rng.integers(0, 256, (16, 16, 3), np.uint8))
    big = Image.fromarray(rng.integers(0, 256, (32, 32, 3), np.uint8))
    readable = True
    if case == "pil png":
        data = _pil(big, "ICO", sizes=[(16, 16), (32, 32)])
    elif case == "pil bmp":
        data = _pil(big, "ICO", sizes=[(16, 16), (32, 32)],
                    bitmap_format="bmp")
    elif case == "largest first":
        data = F.icon_bytes([
            (16, 16, 0, 1, 24, F.dib_frame(_dib(small))),
            (32, 32, 0, 1, 32, _pil(big, "PNG")),
            (32, 32, 0, 1, 8, F.dib_frame(_dib(big.convert("P"))))])
    elif case == "depth tie":
        data = F.icon_bytes([
            (32, 32, 0, 1, 32, _pil(big, "PNG")),
            (32, 32, 16, 1, 0, F.dib_frame(_dib(big.convert(
                "P", colors=16))))])
    elif case.startswith("cursor"):
        frames = [(16, 16, 0, 1, 1, F.dib_frame(_dib(small))),
                  (32, 32, 0, 2, 2, F.dib_frame(_dib(big)))]
        if case == "cursor first larger":
            frames = frames[::-1]
        data = F.icon_bytes(frames, cursor=True)
    else:
        # without its mask a frame's last bytes stand in for it; a 32-bit
        # entry's alpha must span the 24-bit frame's four bytes a pixel
        readable = case == "no mask"
        data = F.icon_bytes([(16, 16, 0, 1, 32 if case == "no alpha" else
                              24, F.dib_frame(_dib(small), mask=False))])
    _same(_write(tmp_path, data), readable)


# --------------------------------------------------------- scenes, fixtures

def test_textured_scene_through_interop_equals_the_ports_build(tmp_path):
    """parity_textured with its checker as a QOI file: the JAX package's
    scene, carried through interop.scene_from_numpy, holds the port's own
    build of it: the texture pack equal, texel for texel."""
    import shutil

    for f in ("parity_tex_quad.obj", "parity_tex_env.exr"):
        shutil.copy(os.path.join(SCENES, f), tmp_path)
    ppm = read_ppm(os.path.join(SCENES, "parity_tex_checker.ppm"))
    (tmp_path / "checker.qoi").write_bytes(_pil(Image.fromarray(ppm), "QOI"))
    with open(os.path.join(SCENES, "parity_textured.txt")) as f:
        text = f.read().replace("parity_tex_checker.ppm", "checker.qoi")
    path = tmp_path / "parity_textured.txt"
    path.write_text(text)
    js = j_load(str(path))[0]
    ts = load_scene_file(str(path), device="cpu")[0]
    got = scene_from_numpy(numpy_leaves(js), device="cpu")
    assert got.textures.texels.shape[0] > 0
    for name in ("texels", "tex_offset", "tex_width", "tex_height"):
        a, b = getattr(got.textures, name, None), getattr(ts.textures, name,
                                                          None)
        if a is not None:
            assert torch.equal(a, b), name
    want = np.asarray(ppm, np.float32) / 255.0
    pack = ts.textures.texels.reshape(-1, 3)[:want.size // 3].numpy()
    np.testing.assert_array_equal(pack, want.reshape(-1, 3))


def test_checker_variants_n_equal_the_ppm():
    """The re-encodings of parity_textured's checker that chip_smoke.py
    phase 57 renders hold exactly the PPM's texels."""
    ppm = read_ppm(os.path.join(SCENES, "parity_tex_checker.ppm"))
    for name in ("checker.qoi", "checker_rle.sgi", "checker.pcx",
                 "checker.im", "checker_bmp.ico", "checker_lossless.jpg"):
        np.testing.assert_array_equal(
            decode_file(os.path.join(FIXTURES, name)), ppm, err_msg=name)
