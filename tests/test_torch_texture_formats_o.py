"""Slice O of the port's image loading against the JAX package's loader,
which reads every image through PIL's `Image.open(path).convert("RGB")`:

- arithmetic-coded JPEG (csrc/imgdecode_arith.h): SOF9 and SOF10 twins
  of tests/torch_image_files.py's Huffman files (the same quantized
  coefficients), which must give their Huffman file's texels; Huffman
  files re-marked as SOF9 / SOF10, which libjpeg decodes as arithmetic
  data (its corrupt-data path: every later MCU of the scan zero up to the
  next restart); SOF11, which libjpeg-turbo does not decode; PIL's reads
  of 65536 bytes, which an arithmetic scan cannot run past; the port's
  T.81 Table D.2 against the one in PIL's bundled libjpeg;
- block smoothing of progressive JPEG (csrc/imgdecode_jsmooth.h): files
  whose scans leave some of coefficients 1-9 unrefined, Huffman and
  arithmetic, every sampling, DC only;
- the sixteen plugins of csrc/imgdecode_plugins.h, on files PIL writes
  or tests/torch_plugin_files.py writes byte by byte.

Every case holds the port to the JAX loader with assert_array_equal, or
both to None where the case names PIL's failure."""

import ctypes
import glob
import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import torch_image_files as F
import torch_plugin_files as P

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
        return ref
    assert ref is not None and ours is not None
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    return ref


def _write(tmp_path, data, name="x.img"):
    p = tmp_path / name
    p.write_bytes(data)
    return p


def _pil(img, fmt, **kw):
    bio = io.BytesIO()
    img.save(bio, format=fmt, **kw)
    return bio.getvalue()


def _smooth(rng, h, w, c=3):
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 5 + k) * np.cos(y / 7 - k)
                     for k in range(c)], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, c)), 0, 255).astype(
        np.uint8)


# ------------------------------------------------ arithmetic coding

def test_aritab_is_libjpegs():
    """The port's T.81 Table D.2 (Qe, Next_Index_LPS, Next_Index_MPS,
    Switch_MPS) row for row against jpeg_aritab in PIL's bundled
    libjpeg-turbo, unpacked by jaricom.c's V(): Qe << 16 | NMPS << 8 |
    SWITCH << 7 | NLPS."""
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                  "pillow.libs", "libjpeg*.so*"))
    assert libs, "PIL's bundled libjpeg"
    table = (ctypes.c_long * 114).in_dll(ctypes.CDLL(libs[0]), "jpeg_aritab")
    theirs = [(v >> 16, v & 0x7F, (v >> 8) & 0xFF, (v >> 7) & 1)
              for v in table]
    ours = F._aritab()
    assert len(ours) == 114 and theirs[0] == (0x5A1D, 1, 1, 1)
    assert ours == theirs


LAYOUTS = {
    "gray": ([(1, 1)], None),
    "444": ([(1, 1)] * 3, None),
    "422": ([(2, 1), (1, 1), (1, 1)], None),
    "420": ([(2, 2), (1, 1), (1, 1)], None),
    "440": ([(1, 2), (1, 1), (1, 1)], None),
    "411": ([(4, 1), (1, 1), (1, 1)], None),
    "cmyk": ([(1, 1)] * 4, 0),
    "ycck": ([(2, 2), (1, 1), (1, 1), (2, 2)], 2),
}


def _script(n, kind):
    """A progressive script over n components that refines every
    coefficient fully: spectral selection only, or successive
    approximation as libjpeg's jpeg_simple_progression orders it."""
    every = list(range(n))
    if kind == "spectral":
        return ([(every, 0, 0, 0, 0)] + [([c], 1, 5, 0, 0) for c in every]
                + [([c], 6, 20, 0, 0) for c in every]
                + [([c], 21, 63, 0, 0) for c in every])
    return ([(every, 0, 0, 0, 1)] + [([c], 1, 5, 0, 2) for c in every]
            + [([c], 6, 63, 0, 2) for c in every]
            + [([c], 1, 63, 2, 1) for c in every] + [(every, 0, 0, 1, 0)]
            + [([c], 1, 63, 1, 0) for c in every])


CODINGS = {
    "sof9": dict(),
    "sof9 restart dac": dict(restart=3, dac=[(0, 0x52), (16, 2)]),
    "sof9 dac L=U=0 K=63": dict(dac=[(0, 0x00), (16, 63)]),
    "sof10 spectral": dict(scans="spectral"),
    "sof10 approximation restart": dict(scans="approx", restart=2),
    "sof10 approximation dac": dict(scans="approx",
                                    dac=[(0, 0x31), (16, 9)]),
}


@pytest.mark.parametrize("coding", list(CODINGS))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_arithmetic_twin(tmp_path, layout, coding):
    """An arithmetic-coded JPEG and the baseline Huffman JPEG of the same
    quantized coefficients: the port's texels equal the JAX loader's,
    and both equal the Huffman file's."""
    factors, adobe = LAYOUTS[layout]
    rng = np.random.default_rng(zlib.crc32(f"{layout} {coding}".encode()))
    planes = [_smooth(rng, 27, 37, 1)[..., 0] for _ in factors]
    kw = dict(CODINGS[coding])
    if "scans" in kw:
        kw["scans"] = _script(len(factors), kw["scans"])
    huff = F.jpeg_bytes(planes, factors, adobe=adobe,
                        restart=kw.get("restart", 0))
    arith = F.jpeg_arith_bytes(planes, factors, adobe=adobe, **kw)
    want = j_tex(str(_write(tmp_path, huff, "h.jpg")))
    got = _same(_write(tmp_path, arith, "a.jpg"))
    np.testing.assert_array_equal(got, want)


def _remarked(seed):
    """A seeded JPEG of PIL's, baseline or progressive, re-marked SOF9 or
    SOF10: libjpeg decodes its Huffman data as arithmetic data."""
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(1, 72, 2))
    mode = ("RGB", "L", "CMYK")[seed % 3]
    img = Image.fromarray(_smooth(rng, h, w)).convert(mode)
    kw = dict(quality=int(rng.integers(5, 96)), progressive=bool(seed % 2))
    if mode != "L":
        kw["subsampling"] = seed // 3 % 3
    if seed % 5 == 0:
        kw["restart_marker_blocks"] = 1 + seed % 3
    data = bytearray(_pil(img, "JPEG", **kw))
    sof = data.index(b"\xff\xc2" if kw["progressive"] else b"\xff\xc0")
    data[sof + 1] = 0xCA if kw["progressive"] else 0xC9
    return bytes(data)


@pytest.mark.parametrize("seed", range(48))
def test_remarked_huffman_as_arithmetic(tmp_path, seed):
    """48 Huffman files re-marked as arithmetic: libjpeg reads past
    magnitude overflows and runs past Se (its JWRN_ARITH_BAD_CODE, a
    warning PIL ignores, after which the scan decodes as zeros up to the
    next restart), and the statistics walk much of Table D.2. The port
    gives the JAX loader's texels."""
    _same(_write(tmp_path, _remarked(seed)))


@pytest.mark.parametrize("predictor", [1, 6])
def test_sof11_lossless_arithmetic_is_none(tmp_path, predictor):
    """A lossless JPEG re-marked SOF11: libjpeg-turbo has no lossless
    arithmetic decoder (JERR_ARITH_NOTIMPL, "broken data stream" in PIL),
    so the JAX loader gives None, and so does the port."""
    rng = np.random.default_rng(predictor)
    data = bytearray(F.jpeg_lossless_bytes(
        [rng.integers(0, 256, (9, 11)) for _ in range(3)],
        predictor=predictor))
    data[data.index(b"\xff\xc3") + 1] = 0xCB
    _same(_write(tmp_path, bytes(data)), readable=False)


def _pad_before_scan(data, k, start):
    """`data` with APP15 padding before its k-th SOS, so that the scan's
    entropy-coded data starts at file offset `start`."""
    sos = [i for i in range(len(data) - 1)
           if data[i] == 0xFF and data[i + 1] == 0xDA][k]
    head = struct.unpack(">H", data[sos + 2:sos + 4])[0] + 2
    need = start - sos - head
    pad = b""
    while need:
        m = min(need, 65537)
        if 0 < need - m < 4:
            m -= 4
        pad += b"\xff\xef" + struct.pack(">H", m - 2) + bytes(m - 4)
        need -= m
    return data[:sos] + pad + data[sos:]


@pytest.mark.parametrize("start,readable", [(65530, False), (65535, False),
                                            (65536, False), (65537, True),
                                            (70000, True), (131073, True)])
def test_arithmetic_scan_and_pils_reads(tmp_path, start, readable):
    """PIL hands libjpeg the file 65536 bytes at a time and reads more
    only when libjpeg suspends, which its arithmetic decoder cannot do: a
    scan whose data starts at `start` decodes only if it lies within the
    read that holds its SOS marker's end. The port gives None where the
    JAX loader does, and its texels where it reads the file."""
    rng = np.random.default_rng(start)
    planes = [_smooth(rng, 40, 48, 1)[..., 0] for _ in range(3)]
    data = F.jpeg_arith_bytes(planes, [(1, 1)] * 3,
                              scans=_script(3, "spectral"))
    _same(_write(tmp_path, _pad_before_scan(data, 1, start)), readable)


def test_arithmetic_sequential_past_one_read_is_none(tmp_path):
    """An SOF9 file whose one scan starts a few bytes before the end of
    PIL's first read: libjpeg cannot suspend inside it, PIL fails
    ("broken data stream"), the JAX loader gives None, and so does the
    port; its Huffman twin, padded alike, decodes."""
    rng = np.random.default_rng(11)
    planes = [_smooth(rng, 30, 40, 1)[..., 0] for _ in range(3)]
    arith = F.jpeg_arith_bytes(planes, [(1, 1)] * 3)
    _same(_write(tmp_path, _pad_before_scan(arith, 0, 65520)),
          readable=False)
    huff = F.jpeg_bytes(planes, [(1, 1)] * 3)
    _same(_write(tmp_path, _pad_before_scan(huff, 0, 65520), "h.jpg"))


def test_arithmetic_restart_resync(tmp_path):
    """Restart markers out of order inside an arithmetic scan: libjpeg's
    jpeg_resync_to_restart decides, per marker, to skip it, to stop at it
    (the interval decodes as zeros) or to scan on; the port follows."""
    rng = np.random.default_rng(5)
    planes = [_smooth(rng, 48, 64, 1)[..., 0] for _ in range(3)]
    data = bytearray(F.jpeg_arith_bytes(planes, [(1, 1)] * 3, restart=2))
    rst = [i for i in range(len(data) - 1)
           if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    data[rst[2] + 1] = 0xD6  # two ahead of what the decoder expects
    data[rst[5] + 1] = 0xD1  # one behind
    data[rst[8] + 1] = 0xD4  # four ahead: skipped
    _same(_write(tmp_path, bytes(data)))


# -------------------------------------------------------- block smoothing

def _drop_scans(data, keep):
    """A progressive JPEG with only the scans `keep(Ss, Se, Ah, Al, i)`
    allows (i counts the scans)."""
    out, p, i = bytearray(data[:2]), 2, 0
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
            o = p + 5 + 2 * ns
            ok = keep(data[o], data[o + 1], data[o + 2] >> 4,
                      data[o + 2] & 15, i)
            i += 1
            if not ok:
                p = q
                continue
        out += data[p:q]
        p = q
    return bytes(out)


SIZES = [(1, 1), (8, 8), (17, 9), (64, 48)]
SAMPLINGS = ["gray", "4:4:4", "4:2:2", "4:2:0"]


@pytest.mark.parametrize("sampling", SAMPLINGS)
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_smoothed_progressive_unrefined(tmp_path, size, sampling):
    """A progressive JPEG of PIL's without its refinement scans (Ah > 0):
    libjpeg block-smooths coefficients 1-9 from the 5x5 DC neighbourhood,
    each component on its own block grid; the port gives the JAX loader's
    texels."""
    rng = np.random.default_rng(size[0] * 100 + size[1])
    img = Image.fromarray(_smooth(rng, *size))
    kw = dict(progressive=True, quality=75)
    if sampling == "gray":
        img = img.convert("L")
    else:
        kw["subsampling"] = sampling
    data = _drop_scans(_pil(img, "JPEG", **kw), lambda s, e, ah, al, i: ah == 0)
    _same(_write(tmp_path, data))


@pytest.mark.parametrize("case", ["dc only", "dc first only", "luma ac only",
                                  "chroma refined only", "no dc refinement"])
def test_smoothed_progressive_huffman_scans(tmp_path, case):
    """PIL's progressive script with chosen scans dropped: DC alone
    (libjpeg interpolates DC too, change_dc), the first DC scan alone
    (Al = 1), AC of luma only, and mixtures that leave some components
    or bits unrefined."""
    rng = np.random.default_rng(len(case))
    data = _pil(Image.fromarray(_smooth(rng, 45, 61)), "JPEG",
                progressive=True, quality=85, subsampling="4:2:0")
    keep = {
        "dc only": lambda s, e, ah, al, i: s == 0,
        "dc first only": lambda s, e, ah, al, i: s == 0 and ah == 0,
        "luma ac only": lambda s, e, ah, al, i: s == 0 or i in (1, 4, 5, 9),
        "chroma refined only": lambda s, e, ah, al, i: i != 9,
        "no dc refinement": lambda s, e, ah, al, i: not (s == 0 and ah),
    }[case]
    _same(_write(tmp_path, _drop_scans(data, keep)))


@pytest.mark.parametrize("al", [1, 2, 3])
@pytest.mark.parametrize("cut", [1, 4, 9])
@pytest.mark.parametrize("layout", ["gray", "420", "422", "440", "411"])
def test_smoothed_chosen_coefficients(tmp_path, layout, cut, al):
    """Arithmetic progressive files whose scans send coefficients 1..cut
    with their low `al` bits missing and the rest in full: smoothing
    predicts only those, each prediction limited to what `al` bits can
    hold."""
    factors, _ = LAYOUTS[layout]
    n = len(factors)
    rng = np.random.default_rng(cut * 10 + al)
    planes = [_smooth(rng, 30, 44, 1)[..., 0] for _ in range(n)]
    scans = ([(list(range(n)), 0, 0, 0, 0)]
             + [([c], 1, cut, 0, al) for c in range(n)]
             + ([([c], cut + 1, 63, 0, 0) for c in range(n)]
                if cut < 63 else []))
    data = F.jpeg_arith_bytes(planes, factors, q=4, scans=scans)
    _same(_write(tmp_path, data))


@pytest.mark.parametrize("restart", [0, 1])
def test_smoothed_arithmetic_dc_only(tmp_path, restart):
    """An arithmetic progressive file of DC scans only (the first with
    Al = 2, two refinements): every AC coefficient unknown, so libjpeg
    interpolates DC and predicts coefficients 1-9 without a limit."""
    rng = np.random.default_rng(restart)
    planes = [_smooth(rng, 33, 41, 1)[..., 0] for _ in range(3)]
    scans = [([0, 1, 2], 0, 0, 0, 2), ([0, 1, 2], 0, 0, 2, 1),
             ([0, 1, 2], 0, 0, 1, 0)]
    data = F.jpeg_arith_bytes(planes, [(2, 2), (1, 1), (1, 1)], scans=scans,
                              restart=restart)
    _same(_write(tmp_path, data))


def test_smoothed_short_last_scan(tmp_path):
    """A smoothed file whose last scan runs into a marker early: libjpeg
    smooths the iMCU rows past the last one decoded with data in hand by
    the coefficient bits from before that scan."""
    rng = np.random.default_rng(8)
    data = _drop_scans(_pil(Image.fromarray(_smooth(rng, 70, 50)), "JPEG",
                            progressive=True, quality=90),
                       lambda s, e, ah, al, i: ah == 0)
    last = data.rindex(b"\xff\xda")
    start = last + 2 + struct.unpack(">H", data[last + 2:last + 4])[0]
    cut = start + (len(data) - 2 - start) // 3
    _same(_write(tmp_path, data[:cut] + b"\xff\xd9"))


# --------------------------------------------------------------- plugins

def _rng(seed):
    return np.random.default_rng(seed)


def _sun(depth, ftype, palette, seed):
    rng = _rng(seed)
    w, h = 13 + seed % 5, 9 + seed % 4
    if depth == 1:
        rows = [P.pack_bits(rng.integers(0, 2, w), 1) for _ in range(h)]
    elif depth == 4:
        rows = [P.pack_bits(rng.integers(0, 16, w), 4) for _ in range(h)]
    else:
        b = P.blocks(rng, h, w, depth // 8)
        rows = [bytes(r.reshape(-1)) for r in b]
    pal = None
    if palette:
        pal = [tuple(int(v) for v in rng.integers(0, 256, 3))
               for _ in range(palette)]
    return P.sun_bytes(rows, w, h, depth, ftype, pal)


SUN_CASES = {
    "1 bit": (1, 1, 0, True), "1 bit rle": (1, 2, 0, True),
    "4 bit": (4, 1, 0, True), "4 bit palette": (4, 1, 16, True),
    "4 bit rle palette": (4, 2, 16, True), "8 bit": (8, 0, 0, True),
    "8 bit palette": (8, 1, 200, True), "8 bit rle": (8, 2, 0, True),
    "8 bit palette rle": (8, 2, 256, True), "24 bit BGR": (24, 1, 0, True),
    "24 bit RGB type 3": (24, 3, 0, True), "24 bit rle": (24, 2, 0, True),
    "24 bit type 4": (24, 4, 0, True), "32 bit BGRX": (32, 1, 0, True),
    "32 bit RGBX": (32, 3, 0, True), "32 bit rle type 5": (32, 5, 0, True),
    # PIL puts a palette on a 1-bit or RGB image: "unrecognized image mode"
    "1 bit palette": (1, 1, 2, False), "24 bit palette": (24, 1, 16, False),
}


@pytest.mark.parametrize("case", list(SUN_CASES))
def test_sun(tmp_path, case):
    depth, ftype, palette, readable = SUN_CASES[case]
    _same(_write(tmp_path, _sun(depth, ftype, palette, len(case))), readable)


@pytest.mark.parametrize("case", ["run across rows", "run past the end",
                                  "literal 0x80", "cut inside a run",
                                  "cut short"])
def test_sun_rle_cases(tmp_path, case):
    """SunRleDecode.c: rows are not padded; a run longer than the rest of
    a row fills whole rows after it; 0x80 0x00 is one 0x80 byte; data that
    ends before the image is full gives None (PIL: "image file is
    truncated")."""
    rng = _rng(3)
    body = bytes(rng.integers(0, 256, 120).astype(np.uint8))
    rle = {"run across rows": b"\x80\x13\x07" + P.sun_rle(body[:40]),
           "run past the end": P.sun_rle(body[:20]) + b"\x80\xff\x21",
           "literal 0x80": b"\x80\x00" * 20 + P.sun_rle(body[:20]),
           "cut inside a run": P.sun_rle(body[:30]) + b"\x80\x05",
           "cut short": P.sun_rle(body[:30])}[case]
    readable = not case.startswith("cut")
    _same(_write(tmp_path, P.sun_bytes([], 7, 5, 8, 2, rle_data=rle)),
          readable)


def _xpm_keys(rng, n, bpp):
    chars = [chr(c) for c in range(35, 127) if chr(c) not in '"\\']
    keys = []
    while len(keys) < n:
        k = "".join(rng.choice(chars, bpp))
        if k not in keys:
            keys.append(k)
    return keys


XPM_CASES = {"2 colours": (2, 1), "16 colours": (16, 1),
             "256 colours 2 chars": (256, 2), "257 colours (RGB)": (257, 2),
             "300 colours 3 chars": (300, 3)}


@pytest.mark.parametrize("extras", ["plain", "keys s m, None, comments"])
@pytest.mark.parametrize("case", list(XPM_CASES))
def test_xpm(tmp_path, case, extras):
    """XpmDecoder: P up to 256 colours (palette in key order), RGB past
    that; 's' and 'm' keys before 'c', an unused None colour, comment
    lines."""
    n, bpp = XPM_CASES[case]
    rng = _rng(n + len(extras))
    w, h = 11, 7
    keys = _xpm_keys(rng, n, bpp)
    cols = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in keys]
    idx = rng.integers(0, n, (h, w))
    more = extras != "plain"
    data = P.xpm_bytes(idx, cols, keys, comment=more, other_keys=more,
                       none_key="~" * bpp if more else None)
    _same(_write(tmp_path, data))


@pytest.mark.parametrize("case", ["pixel of colour None", "unknown key",
                                  "named colour", "too few pixels",
                                  "stream across lines", "lower-case hex"])
def test_xpm_cases(tmp_path, case):
    """A pixel whose key has no colour (None, or no line at all) fails in
    PIL's decoder; a colour by name is not read; pixels run as one stream
    over the lines; hex digits of either case."""
    keys, cols = ["a", "b", "c"], [(255, 0, 0), (0, 255, 0), (1, 2, 3)]
    idx = np.array([[0, 1, 2, 1], [2, 1, 0, 0]])
    data = P.xpm_bytes(idx, cols, keys, none_key="n")
    readable = True
    if case == "pixel of colour None":
        data = data.replace(b'"abcb"', b'"nbcb"')
        readable = False
    elif case == "unknown key":
        data = data.replace(b'"abcb"', b'"zbcb"')
        readable = False
    elif case == "named colour":
        data = data.replace(b"c #010203", b"c red")
        readable = False
    elif case == "too few pixels":
        data = data.replace(b'"cbaa"', b'"cb"')
        readable = False
    elif case == "stream across lines":
        data = data.replace(b'"abcb",\n"cbaa"', b'"abcbcb",\n"aa"')
    else:
        data = data.replace(b"#00FF00", b"#00ff00")
    _same(_write(tmp_path, data), readable)


@pytest.mark.parametrize("seed", range(4))
def test_msp(tmp_path, seed):
    """MSP v1 as PIL writes it (raw "1") and v2 (a row map, runs and
    literals, all-white rows of length 0)."""
    rng = _rng(seed)
    w, h = (int(v) for v in rng.integers(9, 60, 2))
    bits = P.blocks(rng, h, w, 1, cell=4, levels=2)[..., 0]
    bits[::3] = 1
    _same(_write(tmp_path, P.msp_v2_bytes(bits), "v2.msp"))
    _same(_write(tmp_path, _pil(Image.fromarray(bits * 255).convert("1"),
                                "MSP"), "v1.msp"))


def test_msp_v2_short_row_map_is_none(tmp_path):
    data = P.msp_v2_bytes(np.ones((40, 16), np.uint8))
    _same(_write(tmp_path, data[:32 + 30]), readable=False)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
def test_dcx(tmp_path, mode):
    """DCX: the first page, a PCX of PIL's, through the port's PCX (its
    256-colour palette read from the end of the whole file)."""
    img = Image.fromarray(_rng(4).integers(0, 256, (9, 13, 3)).astype(
        np.uint8)).convert(mode)
    pages = [_pil(img, "PCX"), _pil(img.rotate(90, expand=True), "PCX")]
    table = struct.pack("<I", 0x3ADE68B1)
    off = 4 + 4 * 3
    for pg in pages:
        table += struct.pack("<I", off)
        off += len(pg)
    data = table + struct.pack("<I", 0) + b"".join(pages)
    _same(_write(tmp_path, data))


@pytest.mark.parametrize("w,h", [(1, 1), (7, 5), (30, 2)])
def test_pixar(tmp_path, w, h):
    _same(_write(tmp_path, P.pixar_bytes(_rng(w).integers(0, 256,
                                                          (h, w, 3)))))


@pytest.mark.parametrize("bpp", [1, 2, 4])
@pytest.mark.parametrize("prefix", [0, 3])
def test_mcidas(tmp_path, bpp, prefix):
    """McIdas areas: L, I;16B (clipped to 255) and I;32B (clipped to 0-255)
    with a row prefix; L and I;16B are memory-mapped by PIL."""
    rng = _rng(bpp * 10 + prefix)
    w, h = 9, 6
    vals = rng.integers(-40 if bpp == 4 else 0, 256 if bpp == 1 else 400,
                        (h, w))
    dt = {1: ">u1", 2: ">u2", 4: ">i4"}[bpp]
    rows = b"".join(bytes(range(prefix)) + vals[y].astype(dt).tobytes()
                    for y in range(h))
    _same(_write(tmp_path, P.mcidas_bytes(rows, w, h, bpp, prefix=prefix)))
    # one byte short of the last row: PIL's read fails
    _same(_write(tmp_path, P.mcidas_bytes(rows[:-1], w, h, bpp,
                                          prefix=prefix), "s.img"),
          readable=False)


@pytest.mark.parametrize("comment", [False, True])
def test_imt(tmp_path, comment):
    img = _rng(2).integers(0, 256, (5, 7))
    _same(_write(tmp_path, P.imt_bytes(img, comment)))
    _same(_write(tmp_path, P.imt_bytes(img, comment)[:-3], "s.img"),
          readable=False)


@pytest.mark.parametrize("comments", [0, 3])
def test_xvthumb(tmp_path, comments):
    """XV thumbnails: P through the 3-3-2 palette."""
    idx = _rng(comments).integers(0, 256, (6, 9))
    _same(_write(tmp_path, P.xvthumb_bytes(idx, comments)))


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("depth", [1, 4])
def test_gbr(tmp_path, version, depth):
    rng = _rng(version * depth)
    img = rng.integers(0, 256, (5, 6) if depth == 1 else (5, 6, 4))
    _same(_write(tmp_path, P.gbr_bytes(img, version)))


def test_gbr_v2_short_header_is_none(tmp_path):
    """A v2 brush whose header size is under 28: the comment read of a
    negative size takes the rest of the file, no pixels are left."""
    data = bytearray(P.gbr_bytes(np.zeros((3, 3), np.uint8), 2))
    struct.pack_into(">I", data, 0, 24)
    _same(_write(tmp_path, bytes(data)), readable=False)


FITS_CASES = {"8": (8, ">u1"), "16": (16, ">u2"), "32": (32, ">i4"),
              "-32": (-32, ">f4"), "-64": (-64, ">f8")}


@pytest.mark.parametrize("naxis", [1, 2])
@pytest.mark.parametrize("bitpix", list(FITS_CASES))
def test_fits(tmp_path, bitpix, naxis):
    """FITS as PIL reads it: raw rows bottom-up, I;16 and I and F in the
    machine's (little-endian) order though the file is big-endian, F of
    BITPIX -64 four bytes a pixel; BZERO and BSCALE not applied."""
    bp, dt = FITS_CASES[bitpix]
    rng = _rng(abs(bp) + naxis)
    w, h = 7, 5
    if bp < 0:
        vals = rng.normal(100, 120, (h, w))
    else:
        vals = rng.integers(0, 256 if bp == 8 else 2**15, (h, w))
    data = vals.astype(dt).tobytes()
    _same(_write(tmp_path, P.fits_bytes(data, w, h, bp, naxis=naxis,
                                        extra=[("BZERO", 32768),
                                               ("BSCALE", 2)])))


@pytest.mark.parametrize("zbitpix", [8, 16, 32])
def test_fits_gzip(tmp_path, zbitpix):
    """fits_gzip: the BINTABLE's image gunzipped, each pixel the last
    BITPIX // 8 bytes of a 4-byte word, rows bottom-up."""
    rng = _rng(zbitpix)
    w, h = 12, 9
    words = rng.integers(0, 2**32, w * h, dtype=np.uint64).astype(np.uint32)
    _same(_write(tmp_path, P.fits_gzip_bytes(words, w, h, zbitpix)))


@pytest.mark.parametrize("case", ["BITPIX -32 (no bytes a pixel)",
                                  "corrupt gzip", "no image (NAXIS 0)",
                                  "truncated"])
def test_fits_none(tmp_path, case):
    """fits_gzip of BITPIX -32 takes no bytes (min(-32 // 8, 4) is -4):
    "not enough image data"; a bad gzip CRC; an HDU without an image
    ("No image data"); raw data cut short. All None."""
    rng = _rng(9)
    w, h = 12, 9
    words = rng.integers(0, 2**32, w * h, dtype=np.uint64).astype(np.uint32)
    if case.startswith("BITPIX"):
        data = P.fits_gzip_bytes(words, w, h, -32)
    elif case == "corrupt gzip":
        data = bytearray(P.fits_gzip_bytes(words, w, h, 8))
        data[-8] ^= 0x55
        data = bytes(data)
    elif case.startswith("no image"):
        data = P.fits_bytes(b"", 0, 0, 8, naxis=0)
    else:
        data = P.fits_bytes(bytes(400), 20, 20, 8)[:2880 + 100]
    _same(_write(tmp_path, data), readable=False)


def test_fits_data_shorter_than_a_card(tmp_path):
    """Fewer than 80 bytes after the header: FitsImagePlugin takes the
    data's offset from the end of its short read, 80 bytes back, so the
    image is read from the header's padding. The port reads the same."""
    data = P.fits_bytes(bytes(range(35)), 7, 5, 8)[:2880 + 20]
    _same(_write(tmp_path, data))


@pytest.mark.parametrize("fmt", ["raw RGB", "BC1", "BC1 three-colour"])
@pytest.mark.parametrize("w,h", [(4, 4), (9, 6)])
def test_ftex(tmp_path, fmt, w, h):
    """FTEX: raw RGB, or BC1 as PIL's bcn decoder (the port's DDS BC1)."""
    rng = _rng(w * h + len(fmt))
    if fmt == "raw RGB":
        data = P.ftex_bytes(rng.integers(0, 256, (h, w, 3)).astype(
            np.uint8).tobytes(), w, h, 1)
    else:
        data = P.ftex_bytes(P.bc1_blocks(rng, w, h, "three" in fmt), w, h, 0)
    _same(_write(tmp_path, data))


@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
@pytest.mark.parametrize("src", ["P", "P quantized"])
def test_blp_written_by_pil(tmp_path, version, src):
    """PIL writes BLP from P images only: palette content."""
    rng = _rng(len(src))
    img = Image.fromarray(P.blocks(rng, 13, 22, 3))
    img = img.quantize(37) if "quantized" in src else img.convert("P")
    _same(_write(tmp_path, _pil(img, "BLP", blp_version=version)))


@pytest.mark.parametrize("alpha", [0, 1])
@pytest.mark.parametrize("enc", ["DXT1", "DXT3", "DXT5"])
@pytest.mark.parametrize("w,h", [(8, 4), (13, 6)])
def test_blp2_dxt(tmp_path, enc, alpha, w, h):
    """BLP2 DXT through BlpImagePlugin's own Python decoders: rows of whole
    blocks taken as one stream (a width not a multiple of 4 shears the
    rows), DXT3/5 four bytes a pixel even in an RGB image."""
    rng = _rng(w + h + alpha)
    ae = {"DXT1": 0, "DXT3": 1, "DXT5": 7}[enc]
    nb = -(-w // 4) * -(-h // 4)
    payload = (P.bc1_blocks(rng, w, h, True) if ae == 0 else
               bytes(rng.integers(0, 256, nb * 16).astype(np.uint8)))
    _same(_write(tmp_path, P.blp2_bytes(w, h, 2, 8 * alpha, ae, payload)))


@pytest.mark.parametrize("alpha_depth", [0, 1, 4, 8])
def test_blp_palette(tmp_path, alpha_depth):
    """BLP1 and BLP2 palette images, BGRA entries, alpha depths 0-8 (PIL
    takes alpha from the palette and drops it in convert)."""
    rng = _rng(alpha_depth)
    w, h = 11, 7
    pal = bytes(rng.integers(0, 256, 1024).astype(np.uint8))
    idx = bytes(rng.integers(0, 256, w * h).astype(np.uint8))
    _same(_write(tmp_path, P.blp2_bytes(w, h, 1, alpha_depth, 0, idx,
                                        palette=pal), "b2.blp"))
    _same(_write(tmp_path, P.blp1_bytes(w, h, alpha_depth, idx,
                                        palette=pal), "b1.blp"))


@pytest.mark.parametrize("mode", ["RGB", "L", "CMYK"])
def test_blp1_jpeg(tmp_path, mode):
    """BLP1 JPEG content: the stored header prepended to the mip's data,
    the decode read back as BGR (red and blue swapped), four layers taken
    as CMYK, never YCCK."""
    rng = _rng(len(mode))
    w, h = 21, 14
    jpeg = _pil(Image.fromarray(_smooth(rng, h, w)).convert(mode), "JPEG",
                quality=85)
    sos = jpeg.index(b"\xff\xda")
    _same(_write(tmp_path, P.blp1_bytes(w, h, 1, jpeg[sos:],
                                        jpeg_header=jpeg[:sos])))


@pytest.mark.parametrize("case", ["unknown encoding", "short palette",
                                  "short pixels"])
def test_blp_none(tmp_path, case):
    """BLPFormatError (a NotImplementedError in PIL, which the JAX loader
    catches like any error) and short reads: both None."""
    w, h = 5, 4
    idx = bytes(20)
    if case == "unknown encoding":
        data = P.blp2_bytes(w, h, 9, 0, 0, idx)
    elif case == "short palette":
        data = P.blp2_bytes(w, h, 1, 0, 0, b"")[:148 + 500]
    else:
        data = P.blp2_bytes(w, h, 1, 0, 0, idx)[:-5]
    _same(_write(tmp_path, data), readable=False)


def _icns_rle_icon(rng, code, size, raw=False):
    img = P.blocks(rng, size, size, 3, cell=int(rng.integers(1, 6)))
    payload = img.tobytes() if raw else b"".join(
        P.icns_rle(img[..., c].tobytes()) for c in range(3))
    return (b"\0\0\0\0" + payload) if code == b"it32" else payload


ICNS_SLOTS = {"is32": (b"is32", b"s8mk", 16), "il32": (b"il32", b"l8mk", 32),
              "ih32": (b"ih32", b"h8mk", 48), "it32": (b"it32", b"t8mk", 128)}


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("slot", list(ICNS_SLOTS))
def test_icns_rle(tmp_path, slot, raw, mask):
    """read_32 / read_32t: runs per band (or the raw RGB of exactly 3 x
    size^2 bytes), the mask read_mk adds (dropped by convert)."""
    code, mk, size = ICNS_SLOTS[slot]
    rng = _rng(size + raw + 2 * mask)
    blocks_ = [(code, _icns_rle_icon(rng, code, size, raw))]
    if mask:
        blocks_.append((mk, bytes(rng.integers(0, 256, size * size).astype(
            np.uint8))))
    _same(_write(tmp_path, P.icns_bytes(blocks_)))


@pytest.mark.parametrize("sizes", [[(16, 16)], [(16, 16), (32, 32)],
                                   [(16, 16), (64, 64), (128, 128)]])
def test_icns_written_by_pil(tmp_path, sizes):
    """PIL's ICNS: PNG icons; the largest size is read."""
    img = Image.fromarray(P.blocks(_rng(len(sizes)), 128, 128, 4), "RGBA")
    _same(_write(tmp_path, _pil(img, "ICNS", sizes=sizes)))


@pytest.mark.parametrize("case", ["best of two sizes", "png of half size",
                                  "png of another size", "mask alone",
                                  "bad run", "it32 signature"])
def test_icns_cases(tmp_path, case):
    """IcnsFile's choice of the largest (w, h, scale); a PNG of half its
    slot's size (allowed) or of a size no slot allows (None); a mask with
    no RGB icon (None); runs that do not end on the band (None); it32
    without its zero signature (None)."""
    rng = _rng(len(case))
    small = (b"is32", _icns_rle_icon(rng, b"is32", 16))
    readable = True
    if case == "best of two sizes":
        blocks_ = [small, (b"il32", _icns_rle_icon(rng, b"il32", 32))]
    elif case.startswith("png"):
        side = 8 if "half" in case else 11
        png = _pil(Image.fromarray(rng.integers(0, 256, (side, side, 3)).astype(
            np.uint8)), "PNG")
        blocks_ = [(b"icp4", png)]
        readable = "half" in case
    elif case == "mask alone":
        blocks_ = [(b"s8mk", bytes(256))]
        readable = False
    elif case == "bad run":
        blocks_ = [(b"is32", P.icns_rle(bytes(250)) * 3)]
        readable = False
    else:
        blocks_ = [(b"it32", b"\1\0\0\0" + _icns_rle_icon(rng, b"il32", 128))]
        readable = False
    _same(_write(tmp_path, P.icns_bytes(blocks_)), readable)


def test_icns_jpeg2000_raises(tmp_path):
    """ICNS holding JPEG 2000: the JAX loader renders it, the port raises
    NotImplementedError naming JPEG 2000 (ROADMAP queue 1 item 9)."""
    img = Image.fromarray(P.blocks(_rng(1), 32, 32, 3))
    j2k = _pil(img, "JPEG2000")
    p = _write(tmp_path, P.icns_bytes([(b"icp5", j2k)]))
    assert j_tex(str(p)) is not None
    with pytest.raises(NotImplementedError, match="JPEG 2000"):
        load_texture_image(str(p))


IPTC_CASES = {"L": dict(), "L in three fields": dict(chunks=3),
              "RGB band 1": dict(layers=3, component=1),
              "RGB band 3": dict(layers=3, component=1, band=3),
              "CMYK band 2": dict(layers=4, component=1, band=2)}


@pytest.mark.parametrize("case", list(IPTC_CASES))
def test_iptc(tmp_path, case):
    """IPTC: the (8, 10) fields behind the P5 header the plugin prepends;
    an RGB or CMYK image is one band, the others 0."""
    rng = _rng(len(case))
    w, h = 9, 7
    data = rng.integers(0, 256, w * h).astype(np.uint8).tobytes()
    _same(_write(tmp_path, P.iptc_bytes(data, w, h, **IPTC_CASES[case])))


@pytest.mark.parametrize("chunks", [1, 2])
def test_iptc_jpeg(tmp_path, chunks):
    """IPTC compression 5: the fields hold a JPEG."""
    rng = _rng(chunks)
    jpeg = _pil(Image.fromarray(_smooth(rng, 20, 24)), "JPEG")
    _same(_write(tmp_path, P.iptc_bytes(jpeg, 24, 20, compression=5,
                                        chunks=chunks)))


def test_iptc_short_data_is_none(tmp_path):
    data = bytes(range(40))
    _same(_write(tmp_path, P.iptc_bytes(data, 9, 7)), readable=False)


def _fli_image(rng, h, w):
    return P.blocks(rng, h, w, 1, cell=3)[..., 0]


FLI_CASES = ["BRUN", "COPY", "BLACK then LC", "BRUN then SS2",
             "COLOR_256 and BRUN", "COLOR_64 and COPY", "FLI magic AF11"]


@pytest.mark.parametrize("case", FLI_CASES)
def test_fli(tmp_path, case):
    """FliDecode.c on the first frame: its chunks in order on a zeroed
    image, the palette of the first COLOR chunk (a grey ramp without)."""
    rng = _rng(len(case))
    w, h = 23, 11
    img = _fli_image(rng, h, w)
    chunks = []
    if case.startswith("COLOR"):
        top = 64 if "64" in case else 256
        chunks.append(P.fli_color(
            [(0, [tuple(rng.integers(0, top, 3)) for _ in range(200)]),
             (3, [tuple(rng.integers(0, top, 3)) for _ in range(53)])],
            kind=11 if top == 64 else 4))
    if "BRUN" in case or "AF11" in case:
        chunks.append(P.fli_brun(img))
    if "COPY" in case:
        chunks.append(P.fli_chunk(16, img.tobytes()))
    if "LC" in case:
        chunks.append(P.fli_chunk(13, b""))
        chunks.append(P.fli_lc(2, [[(1, "copy", [5, 6, 7]), (2, "run", (9, 3))],
                                   [(0, "run", (200, 2))], []]))
    if "SS2" in case:
        chunks.append(P.fli_ss2([
            [("packets", [(1, "copy", [1, 2, 3, 4]), (0, "run", (7, 8, 2))])],
            [("skip", 2), ("last", 77), ("packets", [(0, "copy", [9, 9])])]]))
    magic = 0xAF11 if "AF11" in case else 0xAF12
    second = P.fli_frame([P.fli_chunk(13, b"")])  # a second frame, not read
    _same(_write(tmp_path, P.fli_bytes(w, h, [P.fli_frame(chunks), second],
                                       magic)))


@pytest.mark.parametrize("case", ["unknown chunk", "BRUN line short",
                                  "frame cut short", "prefix chunk"])
def test_fli_none(tmp_path, case):
    """An unknown chunk type, a BRUN line that does not fill its row, a
    frame shorter than its size, and a file with a prefix chunk (PIL's
    decoder then reads the prefix as the frame): None."""
    rng = _rng(len(case))
    w, h = 8, 4
    img = _fli_image(rng, h, w)
    if case == "unknown chunk":
        data = P.fli_bytes(w, h, [P.fli_frame([P.fli_chunk(99, b"xx")])])
    elif case == "BRUN line short":
        data = P.fli_bytes(w, h, [P.fli_frame([P.fli_chunk(
            15, b"\0\3\1" * h)])])
    elif case == "frame cut short":
        data = P.fli_bytes(w, h, [P.fli_frame([P.fli_brun(img)])])[:-3]
    else:
        frame = P.fli_frame([P.fli_brun(img)])
        prefix = struct.pack("<IH", 16, 0xF100) + bytes(10)
        data = P.fli_bytes(w, h, [prefix + frame])
    _same(_write(tmp_path, data), readable=False)


@pytest.mark.parametrize("orientation", [0, 1, 2, 3])
def test_pcd(tmp_path, orientation):
    """PhotoCD's 768x512 base image: PcdDecode.c's line pairs sharing
    chroma, UnpackYCC.c's PhotoYCC tables, the orientation's rotation
    (1: 90, 3: 270 degrees)."""
    data = P.pcd_bytes(orientation, seed=b"test %d" % orientation)
    _same(_write(tmp_path, data))


def test_pcd_of_the_smoke(tmp_path):
    """chip_smoke.py phase 58 writes its PhotoCD file from SHA-256 in
    counter mode (the card's machine has no PIL): the same bytes as
    tests/torch_plugin_files.py's, and PCD_SHA256 is PIL's decode of it
    and the port's."""
    import hashlib
    import sys

    sys.path.insert(0, REPO)
    from chip_smoke import PCD_SHA256, pcd_bytes

    data = pcd_bytes()
    assert data == P.pcd_bytes()
    p = _write(tmp_path, data)
    pil = np.asarray(Image.open(p).convert("RGB"))
    assert hashlib.sha256(pil.tobytes()).hexdigest() == PCD_SHA256
    assert hashlib.sha256(decode_file(str(p)).tobytes()).hexdigest() == \
        PCD_SHA256


def test_pcd_truncated_is_none(tmp_path):
    _same(_write(tmp_path, P.pcd_bytes(0)[:-100]), readable=False)


# --------------------------------------------------------- scenes, fixtures

def test_arithmetic_checker_scene_through_interop(tmp_path):
    """parity_textured with its checker as an arithmetic-coded JPEG: the
    JAX package's scene, carried through interop.scene_from_numpy, holds
    the port's own build of it, texel for texel."""
    import shutil

    for f in ("parity_tex_quad.obj", "parity_tex_env.exr"):
        shutil.copy(os.path.join(SCENES, f), tmp_path)
    ppm = read_ppm(os.path.join(SCENES, "parity_tex_checker.ppm"))
    (tmp_path / "checker.jpg").write_bytes(F.jpeg_arith_bytes(
        [ppm[..., c] for c in range(3)], [(1, 1)] * 3, adobe=0,
        scans=_script(3, "approx")))
    with open(os.path.join(SCENES, "parity_textured.txt")) as f:
        text = f.read().replace("parity_tex_checker.ppm", "checker.jpg")
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


def test_checker_variants_o_equal_the_ppm():
    """The re-encodings of parity_textured's checker that chip_smoke.py
    phase 58 renders: the colour-exact ones hold the PPM's texels (the
    ICNS RLE icon the 16x16 checker's), the arithmetic twins their
    Huffman file's."""
    ppm = read_ppm(os.path.join(SCENES, "parity_tex_checker.ppm"))
    for name in ("checker.ras", "checker.pxr", "checker.dcx",
                 "checker_palette.blp", "checker.xpm"):
        np.testing.assert_array_equal(
            decode_file(os.path.join(FIXTURES, name)), ppm, err_msg=name)
    np.testing.assert_array_equal(
        decode_file(os.path.join(FIXTURES, "checker_x2_rle.icns")),
        decode_file(os.path.join(FIXTURES, "checker_x2.ppm")))
    huff = decode_file(os.path.join(FIXTURES, "checker_huffman.jpg"))
    for name in ("checker_arith_sof9.jpg", "checker_arith_sof10.jpg"):
        np.testing.assert_array_equal(
            decode_file(os.path.join(FIXTURES, name)), huff, err_msg=name)


def test_big_arithmetic_fixture_padded_for_pil(tmp_path):
    """The 2048x2048 arithmetic progressive fixture phase 58 times: as
    committed its scans run past PIL's first read (both None); with each
    scan moved into a read of its own (chip_smoke.pad_arith_scans) PIL
    reads it, and both loaders give its Huffman twin's texels."""
    import sys

    sys.path.insert(0, REPO)
    from chip_smoke import pad_arith_scans

    with open(os.path.join(FIXTURES, "big_2048_arith.jpg"), "rb") as f:
        data = f.read()
    _same(_write(tmp_path, data), readable=False)
    got = _same(_write(tmp_path, pad_arith_scans(data), "p.jpg"))
    want = decode_file(os.path.join(FIXTURES, "big_2048_huffman.jpg"))
    np.testing.assert_array_equal(got, np.asarray(want, np.float32) / 255.0)
