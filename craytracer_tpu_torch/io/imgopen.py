"""Which of PIL's image plugins opens a file: `Image.open`'s search, as
PIL 12.1 makes it, transcribed so that the port picks the same decoder
for the same bytes without importing PIL.

`Image.open` reads the first 16 bytes and tries the plugins in
`Image.ID` order: first the six that `preinit()` registers, then, if
none of them opened the file, every other plugin `init()` registers, in
its order of registration. A plugin is tried when its `_accept(prefix)`
holds, or always where it has none (IM, IMT, IPTC, PCD, SPIDER, TGA). A
plugin whose `_open` raises SyntaxError, IndexError, TypeError, KeyError,
EOFError or struct.error, or leaves a size of 0 or no mode, hands the
file to the next one; any other error ends the search, and the JAX
loader, which catches every exception, gives None.

`open_plugin(data)` follows that search over a file's bytes. The
openers below transcribe each plugin's `_open` as far as it decides
those outcomes; where the plugin's decoder would fail later on, the
port's C++ decoder fails the same way (status 2, None).
"""

from __future__ import annotations

import io
import math
import re
import struct

# Image.MAX_IMAGE_PIXELS: _decompression_bomb_check refuses twice this
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3

# what _open may raise for the search to go on (ImageFile.__init__ turns
# the rest of these into SyntaxError)
_NEXT = (SyntaxError, IndexError, TypeError, KeyError, EOFError,
         struct.error)


class Opened:
    """The outcome of a plugin's _open: `kind` is the port's decoder (a
    key of io/imgdecode.py KINDS), or None with `name` set where PIL
    reads the format and the port does not (`readable`) or where PIL
    opens it and never produces texels (not `readable`)."""

    def __init__(self, plugin, kind=None, name=None, readable=True,
                 size=(1, 1)):
        self.plugin, self.kind, self.name = plugin, kind, name
        self.readable, self.size = readable, size


def _u16(b, o=0):
    return struct.unpack_from("<H", b, o)[0]


def _u32(b, o=0):
    return struct.unpack_from("<I", b, o)[0]


def _b16(b, o=0):
    return struct.unpack_from(">H", b, o)[0]


def _b32(b, o=0):
    return struct.unpack_from(">I", b, o)[0]


def _safe_read(fp, size):
    """ImageFile._safe_read: OSError on a short read."""
    if size <= 0:
        return b""
    data = fp.read(size)
    if len(data) < size:
        raise OSError("Truncated File Read")
    return data


# ------------------------------------------------------- the preinit six

_BIT2MODE = {1: "P", 4: "P", 8: "P", 16: "RGB", 24: "RGB", 32: "RGB"}
_BMP_MASKS = {32: [(0xFF0000, 0xFF00, 0xFF, 0x0),
                   (0xFF000000, 0xFF0000, 0xFF00, 0x0),
                   (0xFF000000, 0xFF00, 0xFF, 0x0),
                   (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                   (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                   (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                   (0xFF000000, 0xFF00, 0xFF, 0xFF0000),
                   (0x0, 0x0, 0x0, 0x0)],
              24: [(0xFF0000, 0xFF00, 0xFF)],
              16: [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)]}


def _bitmap(fp, header=0):
    """BmpImageFile._bitmap's checks: the (width, height) it sets."""
    if header:
        fp.seek(header)
    hs = _u32(fp.read(4))
    hd = _safe_read(fp, hs - 4)
    if hs == 12:
        w, h, bits, comp = _u16(hd, 0), _u16(hd, 2), _u16(hd, 6), 0
        colors = 0
    elif hs in (40, 52, 56, 64, 108, 124):
        flip = hd[7] == 0xFF
        w = _u32(hd, 0)
        h = 2**32 - _u32(hd, 4) if flip else _u32(hd, 4)
        bits, comp, colors = _u16(hd, 10), _u32(hd, 12), _u32(hd, 28)
        if comp == 3:
            if len(hd) >= 48:
                n = 4 if len(hd) >= 52 else 3
                masks = [_u32(hd, 36 + 4 * i) for i in range(n)]
                masks += [0] * (4 - n)
            else:
                masks = [_u32(fp.read(4)) for _ in range(3)] + [0]
    else:
        raise OSError("Unsupported BMP header type")
    colors = colors or (1 << bits)
    if bits not in _BIT2MODE:
        raise OSError("Unsupported BMP pixel depth")
    if comp == 3:
        ok = (bits == 32 and tuple(masks) in _BMP_MASKS[32]) or (
            bits in (24, 16) and tuple(masks[:3]) in _BMP_MASKS[bits])
        if not ok:
            raise OSError("Unsupported BMP bitfields layout")
    elif comp not in (0, 1, 2):
        raise OSError("Unsupported BMP compression")
    if _BIT2MODE[bits] == "P" and not 0 < colors <= 65536:
        raise OSError("Unsupported BMP Palette size")
    return w, h


def _bmp(fp, prefix):
    head = fp.read(14)
    if not head.startswith(b"BM"):
        raise SyntaxError("Not a BMP file")
    _u32(head, 10)
    return Opened("BMP", "bmp", size=_bitmap(fp))


def _dib(fp, prefix):
    return Opened("DIB", "dib", size=_bitmap(fp))


def _gif(fp, prefix):
    s = fp.read(13)
    if not s.startswith((b"GIF87a", b"GIF89a")):
        raise SyntaxError("not a GIF file")
    size = [_u16(s, 6), _u16(s, 8)]
    flags = s[10]
    if flags & 128:
        fp.read(3 << ((flags & 7) + 1))

    def data():
        c = fp.read(1)
        return fp.read(c[0]) if c and c[0] else None

    s = fp.read(1)
    if not s or s == b";":
        raise EOFError("no more images in GIF file")
    found = False
    while True:  # GifImageFile._seek(0) up to the first image descriptor
        if not s:
            s = fp.read(1)
        if not s or s == b";":
            break
        if s == b"!":
            s = fp.read(1)
            block = data()
            if s[0] == 249 and block is not None:
                if block[0] & 1:
                    block[3]
                _u16(block, 1)
            elif s[0] == 254:
                while block:
                    block = data()
                s = b""
                continue
            elif s[0] == 255 and block is not None:
                if block.startswith(b"NETSCAPE2.0"):
                    block = data()
                    if block and len(block) >= 3 and block[0] == 1:
                        _u16(block, 1)
            while data():
                pass
        elif s == b",":
            s = fp.read(9)
            x0, y0 = _u16(s, 0), _u16(s, 2)
            x1, y1 = x0 + _u16(s, 4), y0 + _u16(s, 6)
            if x1 > size[0] or y1 > size[1]:
                size = [max(x1, size[0]), max(y1, size[1])]
                _bomb_check(size)
            if s[8] & 128:
                fp.read(3 << ((s[8] & 7) + 1))
            fp.read(1)[0]
            found = True
            break
        s = b""
    if not found:
        raise EOFError("image not found in GIF frame")
    return Opened("GIF", "gif", size=tuple(size))


def _jpeg(fp, prefix):
    # every failure of a JPEG file past its magic ends in None: no later
    # plugin opens a file starting FF D8 FF
    return Opened("JPEG", "jpeg")


_PPM_MODES = {b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"P0CMYK", b"Pf",
              b"PyP", b"PyRGBA", b"PyCMYK"}
_WS = b"\x20\x09\x0a\x0b\x0c\x0d"


def _ppm(fp, prefix):
    magic = b""
    for _ in range(6):
        c = fp.read(1)
        if not c or c in _WS:
            break
        magic += c
    if magic not in _PPM_MODES:
        raise SyntaxError("not a PPM file")

    def token():
        t = b""
        while len(t) <= 10:
            c = fp.read(1)
            if not c:
                break
            if c in _WS:
                if not t:
                    continue
                break
            if c == b"#":
                while fp.read(1) not in b"\r\n":
                    pass
                continue
            t += c
        if not t or len(t) > 10:
            raise ValueError("bad PPM header token")
        return t

    size = int(token()), int(token())
    if magic == b"Pf":
        scale = float(token())
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("scale must be finite and non-zero")
    elif magic not in (b"P1", b"P4"):
        if not 0 < int(token()) < 65536:
            raise ValueError("bad maxval")
    return Opened("PPM", "pnm", size=size)


def _png(fp, prefix):
    return Opened("PNG", "png")  # as JPEG: nothing later opens its magic


# ------------------------------------------------------ the init() rest

def _avif(fp, prefix):
    return Opened("AVIF", name="AVIF")


def _blp(fp, prefix):
    magic = fp.read(4)
    struct.unpack("<i", fp.read(4))
    if magic == b"BLP1":
        struct.unpack("<I", fp.read(4))
    else:
        struct.unpack("<bbb", fp.read(3))
        fp.read(1)
    size = struct.unpack("<II", fp.read(8))
    if magic == b"BLP1":
        struct.unpack("<i", fp.read(4))
    return Opened("BLP", "blp", size=size)


def _stub(name):
    def opener(fp, prefix):  # the stub's loader is never registered
        return Opened(name, name=name, readable=False)
    return opener


def _cur(fp, prefix):
    s = fp.read(6)
    m = b""
    for _ in range(_u16(s, 4)):
        s = fp.read(16)
        if not m:
            m = s
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise TypeError("No cursors were found")
    w, h = _bitmap(fp, _u32(m, 12))
    return Opened("CUR", "cur", size=(w, h // 2))


def _pcx_header(fp):
    s = fp.read(68)
    if not (len(s) >= 2 and s[0] == 10 and s[1] in (0, 2, 3, 5)):
        raise SyntaxError("not a PCX file")
    bbox = _u16(s, 4), _u16(s, 6), _u16(s, 8) + 1, _u16(s, 10) + 1
    if bbox[2] <= bbox[0] or bbox[3] <= bbox[1]:
        raise SyntaxError("bad PCX image size")
    version, bits, planes = s[1], s[3], s[65]
    _u16(s, 66), _u16(s, 12), _u16(s, 14)
    if not ((bits == 1 and planes in (1, 2, 4))
            or (version == 5 and bits == 8 and planes in (1, 3))):
        raise OSError("unknown PCX mode")
    if version == 5 and bits == 8 and planes == 1:
        fp.seek(-769, io.SEEK_END)
    return bbox[2] - bbox[0], bbox[3] - bbox[1]


def _pcx(fp, prefix):
    return Opened("PCX", "pcx", size=_pcx_header(fp))


def _dcx(fp, prefix):
    fp.read(4)
    offsets = []
    for _ in range(1024):
        off = _u32(fp.read(4))
        if not off:
            break
        offsets.append(off)
    fp.seek(offsets[0])
    return Opened("DCX", "dcx", size=_pcx_header(fp))


def _dds(fp, prefix):
    return Opened("DDS", "dds")


def _fits(fp, prefix):
    header = fp.read(80)
    value = header[8:].split(b"/")[0].strip()
    if value.startswith(b"="):
        value = value[1:].strip()
    if header[:8].strip() != b"SIMPLE" or value != b"T":
        raise SyntaxError("Not a FITS file")
    return Opened("FITS", "fits")


def _fli(fp, prefix):
    s = fp.read(128)
    if not (s[20:22] == b"\0\0" and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise SyntaxError("not an FLI/FLC file")
    return Opened("FLI", "fli", size=(_u16(s, 8), _u16(s, 10)))


def _ftex(fp, prefix):
    fp.read(4)
    struct.unpack("<i", fp.read(4))
    size = struct.unpack("<2i", fp.read(8))
    _, nformats = struct.unpack("<2i", fp.read(8))
    if nformats != 1:
        raise AssertionError("FTEX with more than one format")
    fmt, where = struct.unpack("<2i", fp.read(8))
    fp.seek(where)
    struct.unpack("<i", fp.read(4))
    if fmt not in (0, 1):
        raise ValueError("Invalid texture compression format")
    return Opened("FTEX", "ftex", size=size)


def _gbr(fp, prefix):
    hsize = _b32(fp.read(4))
    if hsize < 20:
        raise SyntaxError("not a GIMP brush")
    version = _b32(fp.read(4))
    if version not in (1, 2):
        raise SyntaxError("Unsupported GIMP brush version")
    w, h, depth = _b32(fp.read(4)), _b32(fp.read(4)), _b32(fp.read(4))
    if w == 0 or h == 0 or depth not in (1, 4):
        raise SyntaxError("not a GIMP brush")
    if version == 2 and fp.read(4) != b"GIMP":
        raise SyntaxError("not a GIMP brush, bad magic number")
    _bomb_check((w, h))
    return Opened("GBR", "gbr", size=(w, h))


def _jpeg2000(fp, prefix):
    return Opened("JPEG2000", name="JPEG 2000")


# every code of IcnsFile.SIZES: a size counts where any of its codes is
# there, a mask alone included
_ICNS_SIGS = {b"ic10", b"ic09", b"ic14", b"ic08", b"ic13", b"ic07", b"it32",
              b"t8mk", b"icp6", b"ic12", b"ih32", b"h8mk", b"icp5", b"il32",
              b"l8mk", b"ic11", b"icp4", b"is32", b"s8mk"}


def _icns(fp, prefix):
    _, filesize = struct.unpack(">4sI", fp.read(8))
    i, sigs = 8, set()
    while i < filesize:
        sig, blocksize = struct.unpack(">4sI", fp.read(8))
        if blocksize <= 0:
            raise SyntaxError("invalid block header")
        i += 8
        blocksize -= 8
        sigs.add(sig)
        if blocksize == 0:
            continue
        fp.seek(blocksize, io.SEEK_CUR)
        i += blocksize
    if not sigs & _ICNS_SIGS:
        raise SyntaxError("No 32bit icon resources found")
    return Opened("ICNS", "icns")


def _ico(fp, prefix):
    s = fp.read(6)
    count = _u16(s, 4)
    for _ in range(count):  # IcoFile's directory: a short entry hands on
        s = fp.read(16)
        s[2], _u32(s, 12)
    if not count:
        raise IndexError("ICO without entries")
    # IcoImageFile._open loads the chosen frame; its outcomes are the C++
    # decoder's (a frame that fails with one of _NEXT hands the file on:
    # the decoder reports that as status 3)
    return Opened("ICO", "ico")


_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = {"Comment", "Date", "Digitalization equipment",
            "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type"}


def _number(s):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _im(fp, prefix):
    if b"\n" not in fp.read(100):
        raise SyntaxError("not an IM file")
    fp.seek(0)
    n = 0
    info = {"Image size (x*y)": (512, 512)}
    while True:
        s = fp.read(1)
        if s == b"\r":
            continue
        if not s or s == b"\0" or s == b"\x1a":
            break
        s = s + fp.readline()
        if len(s) > 100:
            raise SyntaxError("not an IM file")
        if s.endswith(b"\r\n"):
            s = s[:-2]
        elif s.endswith(b"\n"):
            s = s[:-1]
        m = _IM_SPLIT.match(s)
        if not m:
            raise SyntaxError("Syntax error in IM header")
        k, v = (x.decode("latin-1", "replace") for x in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)",
                 "Image size (x*y)"):
            v = tuple(map(_number, v.replace("*", ",").split(",")))
            if len(v) == 1:
                v = v[0]
        info[k] = v
        if k in _IM_TAGS:
            n += 1
    if not n:
        raise SyntaxError("Not an IM file")
    size = info["Image size (x*y)"]
    while s and not s.startswith(b"\x1a"):
        s = fp.read(1)
    if not s:
        raise SyntaxError("File truncated")
    # a mode PIL does not know is read as such, and fails in load
    w, h = size  # a size of one number is a TypeError: the search goes on
    return Opened("IM", "im", size=(w, h))


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt(fp, prefix):
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    xsize = ysize = 0
    mode = ""
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = fp.read(1)
        if not s or s == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            xsize = int(v)
        elif k == b"height":
            ysize = int(v)
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode:
        raise SyntaxError("no mode")
    return Opened("IMT", "imt", size=(xsize, ysize))


def _iptc(fp, prefix):
    info = {}

    def field():
        s = fp.read(5)
        if not s.strip(b"\0"):
            return None, 0
        tag = s[1], s[2]
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            raise SyntaxError("invalid IPTC/NAA file")
        size = s[3]
        if size > 132:
            raise OSError("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            size = _b32((bytes(4) + fp.read(size - 128))[-4:])
        else:
            size = _b16(s, 3)
        return tag, size

    while True:
        tag, size = field()
        if not tag or tag == (8, 10):
            break
        info[tag] = fp.read(size) if size else None
    layers, component = info[(3, 60)][0], info[(3, 60)][1]

    def getint(key):
        return _b32((bytes(4) + info[key])[-4:])

    size = getint((3, 20)), getint((3, 30))
    if getint((3, 120)) not in (1, 5):
        raise OSError("Unknown IPTC image compression")
    if not (layers == 1 and not component) and not (
            layers in (3, 4) and component):
        raise SyntaxError("no mode")
    return Opened("IPTC", "iptc", size=size)


def _mcidas(fp, prefix):
    s = fp.read(256)
    if len(s) != 256:
        raise SyntaxError("not an McIdas area file")
    w = (0,) + struct.unpack("!64i", s)
    if w[11] not in (1, 2, 4):
        raise SyntaxError("unsupported McIdas format")
    return Opened("MCIDAS", "mcidas", size=(w[10], w[9]))


def _mpeg(fp, prefix):
    s = fp.read(7)
    size = (s[4] << 4 | s[5] >> 4), ((s[5] & 15) << 8 | s[6])
    return Opened("MPEG", name="MPEG", readable=False, size=size)


def _tiff(fp, prefix):
    # as JPEG: nothing later opens a file with a TIFF prefix
    return Opened("TIFF", "tiff")


def _msp(fp, prefix):
    s = fp.read(32)
    checksum = 0
    for i in range(0, 32, 2):
        checksum ^= _u16(s, i)
    if checksum:
        raise SyntaxError("bad MSP checksum")
    return Opened("MSP", "msp", size=(_u16(s, 4), _u16(s, 6)))


def _pcd(fp, prefix):
    fp.seek(2048)
    s = fp.read(1539)
    if not s.startswith(b"PCD_"):
        raise SyntaxError("not a PCD file")
    s[1538]
    return Opened("PCD", "pcd")


def _pixar(fp, prefix):
    s = fp.read(512)
    size = _u16(s, 418), _u16(s, 416)
    if (_u16(s, 424), _u16(s, 426)) != (14, 2):
        raise SyntaxError("no mode")
    return Opened("PIXAR", "pixar", size=size)


def _psd(fp, prefix):
    return Opened("PSD", "psd")


def _qoi(fp, prefix):
    fp.read(4)
    size = _b32(fp.read(4)), _b32(fp.read(4))
    fp.read(1)[0]
    return Opened("QOI", "qoi", size=size)


def _sgi(fp, prefix):
    return Opened("SGI", "sgi")  # its _open raises ValueError, not SyntaxError


def _spider_header(t):
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        try:
            if h[i] - int(h[i]) != 0:
                return 0
        except (ValueError, OverflowError):
            return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labbyt = int(h[22])
    if labbyt != int(h[13]) * int(h[23]):
        return 0
    return labbyt


def _spider(fp, prefix):
    f = fp.read(27 * 4)
    t = struct.unpack(">27f", f)
    if not _spider_header(t):
        t = struct.unpack("<27f", f)
        if not _spider_header(t):
            raise SyntaxError("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber > 0:
        raise AttributeError("stkoffset")  # PIL reads an unset attribute
    if istack < 0 or imgnumber < 0 or (istack > 0 and imgnumber > 0):
        raise SyntaxError("inconsistent stack header values")
    return Opened("SPIDER", "spider", size=(int(h[12]), int(h[2])))


def _sun(fp, prefix):
    s = fp.read(32)
    size = _b32(s, 4), _b32(s, 8)
    depth, ftype = _b32(s, 12), _b32(s, 20)
    ptype, plen = _b32(s, 24), _b32(s, 28)
    if depth not in (1, 4, 8, 24, 32):
        raise SyntaxError("Unsupported Mode/Bit Depth")
    if plen:
        if plen > 1024:
            raise SyntaxError("Unsupported Color Palette Length")
        if ptype != 1:
            raise SyntaxError("Unsupported Palette Type")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise SyntaxError("Unsupported Sun Raster file type")
    return Opened("SUN", "sun", size=size)


def _tga(fp, prefix):
    s = fp.read(18)
    cmtype, itype, depth, flags = s[1], s[2], s[16], s[17]
    size = _u16(s, 12), _u16(s, 14)
    if (cmtype not in (0, 1) or size[0] <= 0 or size[1] <= 0
            or depth not in (1, 8, 16, 24, 32)):
        raise SyntaxError("not a TGA file")
    if itype not in (1, 2, 3, 9, 10, 11):
        raise SyntaxError("unknown TGA mode")
    del flags  # every orientation of the two bits is known
    if s[0]:
        fp.read(s[0])
    if cmtype and s[7] not in (16, 24, 32):
        raise SyntaxError("unknown TGA map depth")
    return Opened("TGA", "tga", size=size)


def _webp(fp, prefix):
    return Opened("WEBP", "webp")


def _xbm(fp, prefix):
    m = re.match(
        rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
        rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
        rb"(?P<hotspot>"
        rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
        rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
        rb")?"
        rb"[\000-\377]*_bits\[]", fp.read(512))
    if not m:
        raise SyntaxError("not a XBM file")
    return Opened("XBM", "xbm",
                  size=(int(m.group("width")), int(m.group("height"))))


_XPM_HEAD = re.compile(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _xpm(fp, prefix):
    fp.read(9)
    while True:
        line = fp.readline()
        if not line:
            raise SyntaxError("broken XPM file")
        m = _XPM_HEAD.match(line)
        if m:
            break
    size = int(m.group(1)), int(m.group(2))
    int(m.group(3)), int(m.group(4))
    return Opened("XPM", "xpm", size=size)


def _xvthumb(fp, prefix):
    fp.read(6)
    fp.readline()
    while True:
        s = fp.readline()
        if not s:
            raise SyntaxError("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    w, h = s.strip().split(maxsplit=2)[:2]
    return Opened("XVTHUMB", "xvthumb", size=(int(w), int(h)))


def _eps_accept(p):
    return p.startswith(b"%!PS") or (len(p) >= 4 and _u32(p) == 0xC6D3D0C5)


# (name, _accept or None, opener) in Image.ID order: preinit()'s six,
# then init()'s registrations
PREINIT = (
    ("BMP", lambda p: p.startswith(b"BM"), _bmp),
    ("DIB", lambda p: _u32(p) in (12, 40, 52, 56, 64, 108, 124), _dib),
    ("GIF", lambda p: p.startswith((b"GIF87a", b"GIF89a")), _gif),
    ("JPEG", lambda p: p.startswith(b"\xff\xd8\xff"), _jpeg),
    ("PPM", lambda p: len(p) >= 2 and p.startswith(b"P")
     and p[1] in b"0123456fy", _ppm),
    ("PNG", lambda p: p.startswith(b"\x89PNG\r\n\x1a\n"), _png),
)
INIT = (
    ("AVIF", lambda p: p[4:8] == b"ftyp"
     and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1"), _avif),
    ("BLP", lambda p: p.startswith((b"BLP1", b"BLP2")), _blp),
    ("BUFR", lambda p: p.startswith((b"BUFR", b"ZCZC")), _stub("BUFR")),
    ("CUR", lambda p: p.startswith(b"\0\0\2\0"), _cur),
    ("PCX", lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5),
     _pcx),
    ("DCX", lambda p: len(p) >= 4 and _u32(p) == 0x3ADE68B1, _dcx),
    ("DDS", lambda p: p.startswith(b"DDS "), _dds),
    ("EPS", _eps_accept, _stub("EPS (no Ghostscript)")),
    ("FITS", lambda p: p.startswith(b"SIMPLE"), _fits),
    ("FLI", lambda p: len(p) >= 16 and _u16(p, 4) in (0xAF11, 0xAF12)
     and _u16(p, 14) in (0, 3), _fli),
    ("FTEX", lambda p: p.startswith(b"FTEX"), _ftex),
    ("GBR", lambda p: len(p) >= 8 and _b32(p, 0) >= 20
     and _b32(p, 4) in (1, 2), _gbr),
    ("GRIB", lambda p: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1,
     _stub("GRIB")),
    ("HDF5", lambda p: p.startswith(b"\x89HDF\r\n\x1a\n"), _stub("HDF5")),
    ("JPEG2000", lambda p: p.startswith(
        (b"\xff\x4f\xff\x51", b"\0\0\0\x0cjP  \r\n\x87\n")), _jpeg2000),
    ("ICNS", lambda p: p.startswith(b"icns"), _icns),
    ("ICO", lambda p: p.startswith(b"\0\0\1\0"), _ico),
    ("IM", None, _im),
    ("IMT", None, _imt),
    ("IPTC", None, _iptc),
    ("MCIDAS", lambda p: p.startswith(b"\0\0\0\0\0\0\0\4"), _mcidas),
    ("MPEG", lambda p: p.startswith(b"\0\0\1\xb3"), _mpeg),
    ("TIFF", lambda p: p.startswith((b"MM\0*", b"II*\0", b"MM\0+", b"II+\0",
                                     b"MM*\0", b"II\0*")), _tiff),
    ("MSP", lambda p: p.startswith((b"DanM", b"LinS")), _msp),
    ("PCD", None, _pcd),
    ("PIXAR", lambda p: p.startswith(b"\x80\xe8\0\0"), _pixar),
    ("PSD", lambda p: p.startswith(b"8BPS"), _psd),
    ("QOI", lambda p: p.startswith(b"qoif"), _qoi),
    ("SGI", lambda p: len(p) >= 2 and _b16(p) == 474, _sgi),
    ("SPIDER", None, _spider),
    ("SUN", lambda p: len(p) >= 4 and _b32(p) == 0x59A66A95, _sun),
    ("TGA", None, _tga),
    ("WEBP", lambda p: p.startswith(b"RIFF") and p[8:12] == b"WEBP"
     and p[12:16] in (b"VP8 ", b"VP8X", b"VP8L"), _webp),
    ("WMF", lambda p: p.startswith((b"\xd7\xcd\xc6\x9a\0\0",
                                    b"\1\0\0\0")), _stub("WMF")),
    ("XBM", lambda p: p.lstrip().startswith(b"#define"), _xbm),
    ("XPM", lambda p: p.startswith(b"/* XPM */"), _xpm),
    ("XVTHUMB", lambda p: p.startswith(b"P7 332"), _xvthumb),
)


def _bomb_check(size):
    if max(1, size[0]) * max(1, size[1]) > 2 * MAX_IMAGE_PIXELS:
        raise ValueError("image larger than PIL opens")


def open_plugin(data: bytes, skip=()):
    """The plugin that opens a file of these bytes (an Opened), or None
    where PIL's search would end without one or with an error. `skip`
    names plugins to pass over: one whose decoder found the file, past
    its header checks, to be one that PIL's plugin hands on."""
    prefix = data[:16]
    for plugins in (PREINIT, INIT):
        for name, accept, opener in plugins:
            if name in skip:
                continue
            try:
                if accept is not None and not accept(prefix):
                    continue
                opened = opener(io.BytesIO(data), prefix)
                if opened.size[0] <= 0 or opened.size[1] <= 0:
                    continue  # PIL: a size of 0 hands the file on
                _bomb_check(opened.size)
                return opened
            except _NEXT:
                continue
            except Exception:
                return None
    return None
