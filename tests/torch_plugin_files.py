"""Files of PIL's smaller plugins, written byte by byte from a seed for the
port's decoders of them (craytracer_tpu_torch/csrc/imgdecode_plugins.h):
SUN raster (raw and RLE), XPM, MSP v2, PIXAR, McIdas, IMT, XV thumbnail,
GIMP brush, FITS (raw and gzip), FTEX, BLP, ICNS, IPTC, FLI/FLC and
PhotoCD. numpy and the standard library only: the tests hold each file
to PIL's decode of it."""

from __future__ import annotations

import gzip
import hashlib
import struct

import numpy as np


def blocks(rng, h, w, c, cell=3, levels=256):
    """A random image of cell x cell blocks: runs for the RLE coders."""
    a = rng.integers(0, levels, (-(-h // cell), -(-w // cell), c))
    return np.repeat(np.repeat(a, cell, 0), cell, 1)[:h, :w].astype(np.uint8)


# ---------------------------------------------------------------- SUN

def sun_rle(data: bytes) -> bytes:
    """SUN's byte RLE: runs of 3 or more as 0x80 count-1 value, a single
    0x80 as 0x80 0x00, other bytes as they are."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 256 and data[j] == data[i]:
            j += 1
        run = j - i
        if run >= 3:
            out += bytes([0x80, run - 1, data[i]])
        elif data[i] == 0x80:
            out += b"\x80\x00" * run
        else:
            out += data[i:j]
        i = j
    return bytes(out)


def sun_bytes(rows, w, h, depth, ftype=1, palette=None, rle_data=None):
    """A Sun raster: `rows` the unpadded row bytes (list), padded to 16
    bits unless `ftype` is 2 (RLE of the unpadded rows, or of
    `rle_data`'s bytes where given); `palette` a list of (r, g, b)."""
    cmap = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)
        cmap = p[:, 0].tobytes() + p[:, 1].tobytes() + p[:, 2].tobytes()
    if ftype == 2:
        body = rle_data if rle_data is not None else sun_rle(b"".join(rows))
    else:
        stride = (w * depth + 15) // 16 * 2
        body = b"".join(r.ljust(stride, b"\0") for r in rows)
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype,
                       1 if cmap else 0, len(cmap)) + cmap + body


def pack_bits(idx, bits):
    """One row of small ints packed MSB first at `bits` bits."""
    idx = np.asarray(idx, np.int64)
    per = 8 // bits
    pad = (-len(idx)) % per
    v = np.concatenate([idx, np.zeros(pad, np.int64)]).reshape(-1, per)
    shifts = bits * np.arange(per - 1, -1, -1)
    return (v << shifts).sum(1).astype(np.uint8).tobytes()


# ---------------------------------------------------------------- XPM

def xpm_bytes(idx, colours, keys, comment=True, none_key=None,
              other_keys=False):
    """An XPM of palette indices `idx` ([h, w]) with `colours` (r, g, b)
    under `keys` (strings of one length); `none_key` adds a key of colour
    None; `other_keys` adds "s" and "m" keys before "c"."""
    h, w = idx.shape
    bpp = len(keys[0])
    n = len(keys) + (none_key is not None)
    out = [b"/* XPM */", b"static char *image[] = {"]
    if comment:
        out.append(b"/* columns rows colors chars-per-pixel */")
    out.append(b'"%d %d %d %d",' % (w, h, n, bpp))
    for k, (r, g, b) in zip(keys, colours):
        extra = b"s name m #000000 " if other_keys else b""
        out.append(b'"%s %sc #%02X%02X%02X",' % (k.encode(), extra, r, g, b))
    if none_key is not None:
        out.append(b'"%s c None",' % none_key.encode())
    if comment:
        out.append(b"/* pixels */")
    for y in range(h):
        line = "".join(keys[i] for i in idx[y]).encode()
        out.append(b'"%s"%s' % (line, b"," if y < h - 1 else b""))
    out.append(b"};")
    return b"\n".join(out) + b"\n"


# ---------------------------------------------------------------- MSP

def msp_v2_bytes(bits):
    """An MSP v2 ("LinS") of a [h, w] 0/1 array: a row map, then each row
    as runs (type 0) and literals, an all-white row as length 0."""
    h, w = bits.shape
    rows = []
    for y in range(h):
        data = pack_bits(bits[y], 1)
        if all(b == 0xFF for b in data) and y % 2:
            rows.append(b"")
            continue
        out, i = bytearray(), 0
        while i < len(data):
            j = i
            while j < len(data) and j - i < 255 and data[j] == data[i]:
                j += 1
            if j - i >= 3:
                out += bytes([0, j - i, data[i]])
                i = j
            else:
                k = min(len(data), i + 2)
                out += bytes([k - i]) + data[i:k]
                i = k
        rows.append(bytes(out))
    head = [0] * 16
    head[0], head[1] = struct.unpack("<HH", b"LinS")
    head[2], head[3] = w, h
    head[12] = 0
    for v in head[:12]:
        head[12] ^= v
    return (struct.pack("<16H", *head) + struct.pack(f"<{h}H", *map(len, rows))
            + b"".join(rows))


# ------------------------------------------------- PIXAR, McIdas, IMT, ...

def pixar_bytes(img):
    h, w = img.shape[:2]
    hd = bytearray(1024)
    hd[:4] = b"\x80\xe8\0\0"
    struct.pack_into("<HH", hd, 416, h, w)
    struct.pack_into("<HH", hd, 424, 14, 2)
    return bytes(hd) + img.astype(np.uint8).tobytes()


def mcidas_bytes(data, w, h, bpp, prefix=0, bands=1, offset=256):
    """An McIdas area: `data` the rows (prefix bytes, then w * bpp *
    bands), big-endian words, the data at `offset`."""
    word = [0] * 65
    word[2], word[9], word[10], word[11] = 4, h, w, bpp
    word[14], word[15], word[34] = bands, prefix, offset
    head = struct.pack("!64i", *word[1:])
    return head + bytes(max(0, offset - 256)) + data


def imt_bytes(img, comment=True):
    h, w = img.shape
    head = b"* IM tools\n" if comment else b""
    head += b"width %d\nheight %d\npixel n8\n\x0c" % (w, h)
    return head + img.astype(np.uint8).tobytes()


def xvthumb_bytes(idx, comments=2):
    h, w = idx.shape
    head = b"P7 332\n" + b"#XVVERSION:Version 2.28\n" * comments
    head += b"#END_OF_COMMENTS\n%d %d 255\n" % (w, h)
    return head + idx.astype(np.uint8).tobytes()


def gbr_bytes(img, version=2, comment=b"brush"):
    """A GIMP brush of an [h, w] (L) or [h, w, 4] (RGBA) image."""
    h, w = img.shape[:2]
    depth = 1 if img.ndim == 2 else 4
    name = comment + b"\0"
    if version == 1:
        head = struct.pack(">5I", 20 + len(name), 1, w, h, depth)
    else:
        head = struct.pack(">5I", 28 + len(name), 2, w, h, depth)
        head += b"GIMP" + struct.pack(">I", 25)
    return head + name + img.astype(np.uint8).tobytes()


# ---------------------------------------------------------------- FITS

def _cards(pairs):
    cards = []
    for k, v in pairs:
        if isinstance(v, bool):
            v = "T" if v else "F"
        cards.append(f"{k:8}= {v:>20}".ljust(80).encode())
    cards.append(b"END".ljust(80))
    head = b"".join(cards)
    return head.ljust(-(-len(head) // 2880) * 2880, b" ")


def fits_bytes(data, w, h, bitpix, naxis=2, extra=()):
    """A FITS primary HDU of the raw `data` (bytes, as the file holds
    them) with BITPIX and NAXIS1/2 given, padded to 2880."""
    pairs = [("SIMPLE", True), ("BITPIX", bitpix), ("NAXIS", naxis)]
    if naxis >= 1:
        pairs.append(("NAXIS1", w if naxis > 1 else h))
    if naxis >= 2:
        pairs.append(("NAXIS2", h))
    pairs += list(extra)
    body = data.ljust(-(-max(len(data), 1) // 2880) * 2880, b"\0")
    return _cards(pairs) + body


def fits_gzip_bytes(words, w, h, zbitpix, table=(8, 1)):
    """A tile-compressed FITS whose image is one gzip member of 4-byte
    big-endian words (FitsGzipDecoder takes each pixel's last bytes):
    an empty primary HDU, then a BINTABLE extension with ZIMAGE."""
    prim = _cards([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0)])
    ext = _cards([("XTENSION", "'BINTABLE'"), ("BITPIX", 8), ("NAXIS", 2),
                  ("NAXIS1", table[0]), ("NAXIS2", table[1]),
                  ("ZIMAGE", True), ("ZCMPTYPE", "'GZIP_1  '"),
                  ("ZBITPIX", zbitpix), ("ZNAXIS", 2), ("ZNAXIS1", w),
                  ("ZNAXIS2", h)])
    payload = bytes(table[0] * table[1]) + gzip.compress(
        np.asarray(words, ">u4").tobytes(), mtime=0)
    return prim + ext + payload


# ---------------------------------------------------------------- FTEX

def ftex_bytes(payload, w, h, fmt):
    return (b"FTEX" + struct.pack("<i2i2i2i", 0, w, h, 1, 1, fmt, 32)
            + struct.pack("<i", len(payload)) + payload)


def bc1_blocks(rng, w, h, transparent=False):
    """Random BC1 blocks for a w x h texture; with `transparent` half the
    blocks have color0 <= color1 (the 3-colour mode)."""
    out = bytearray()
    for i in range(-(-w // 4) * -(-h // 4)):
        c0, c1 = (int(v) for v in rng.integers(0, 65536, 2))
        if transparent and i % 2:
            c0, c1 = min(c0, c1), max(c0, c1)
        elif c0 == c1:
            c1 ^= 1
        out += struct.pack("<HHI", c0, c1, int(rng.integers(0, 2**32)))
    return bytes(out)


# ---------------------------------------------------------------- BLP

def blp2_bytes(w, h, encoding, alpha_depth, alpha_encoding, payload,
               palette=b""):
    """A BLP2 of one mip: header, offsets and lengths, the 1024-byte
    palette, then `payload` at offsets[0]."""
    offsets = [148 + 1024] + [0] * 15
    lengths = [len(payload)] + [0] * 15
    return (b"BLP2" + struct.pack("<i", 1)
            + struct.pack("<bbbb", encoding, alpha_depth, alpha_encoding, 0)
            + struct.pack("<II", w, h) + struct.pack("<16I", *offsets)
            + struct.pack("<16I", *lengths) + palette.ljust(1024, b"\0")
            + payload)


def blp1_bytes(w, h, alpha, payload, palette=b"", jpeg_header=None):
    """A BLP1 of one mip: palette content (encoding 4) or, with
    `jpeg_header`, JPEG content (the header stored once, the mip's data
    at offsets[0])."""
    if jpeg_header is not None:
        head_len = 156 + 4 + len(jpeg_header)
        offsets = [head_len + 3] + [0] * 15  # three bytes to skip first
        lengths = [len(payload)] + [0] * 15
        return (b"BLP1" + struct.pack("<iI", 0, alpha)
                + struct.pack("<II", w, h) + struct.pack("<ii", 5, 0)
                + struct.pack("<16I", *offsets) + struct.pack("<16I", *lengths)
                + struct.pack("<I", len(jpeg_header)) + jpeg_header
                + b"\xaa\xbb\xcc" + payload)
    lengths = [len(payload)] + [0] * 15
    return (b"BLP1" + struct.pack("<iI", 1, alpha) + struct.pack("<II", w, h)
            + struct.pack("<ii", 4, 0) + struct.pack("<16I", *[0] * 16)
            + struct.pack("<16I", *lengths) + palette.ljust(1024, b"\0")
            + payload)


# ---------------------------------------------------------------- ICNS

def icns_rle(band: bytes) -> bytes:
    """read_32's PackBits-like runs: 0x80 + (n - 3) then a byte for runs
    of 3-130, n - 1 then n bytes for literals of 1-128."""
    out, i = bytearray(), 0
    while i < len(band):
        j = i
        while j < len(band) and j - i < 130 and band[j] == band[i]:
            j += 1
        if j - i >= 3:
            out += bytes([0x80 + j - i - 3, band[i]])
            i = j
            continue
        k = i
        while k < len(band) and k - i < 128:
            if k + 2 < len(band) and band[k] == band[k + 1] == band[k + 2]:
                break
            k += 1
        out += bytes([k - i - 1]) + band[i:k]
        i = k
    return bytes(out)


def icns_bytes(blocks_):
    """An icns file of (code, payload) blocks."""
    body = b"".join(code + struct.pack(">I", len(p) + 8) + p
                    for code, p in blocks_)
    return b"icns" + struct.pack(">I", len(body) + 8) + body


# ---------------------------------------------------------------- IPTC

def iptc_field(rec, ds, data, extended=False):
    if extended:  # PIL reads five bytes, then the size's four after them
        return (bytes([0x1C, rec, ds, 0x84, 0]) + struct.pack(">I", len(data))
                + data)
    return bytes([0x1C, rec, ds]) + struct.pack(">H", len(data)) + data


def iptc_bytes(image_data, w, h, layers=1, component=0, band=None,
               compression=1, chunks=1):
    out = (iptc_field(2, 0, b"\0\2") + iptc_field(3, 60, bytes([layers, component]))
           + iptc_field(3, 20, struct.pack(">H", w))
           + iptc_field(3, 30, struct.pack(">H", h))
           + iptc_field(3, 120, bytes([compression])))
    if band is not None:
        out += iptc_field(3, 65, bytes([band]))
    step = -(-len(image_data) // chunks)
    for i in range(chunks):
        part = image_data[i * step:(i + 1) * step]
        out += iptc_field(8, 10, part, extended=len(part) > 30000 or i % 2)
    return out


# ---------------------------------------------------------------- FLI

def fli_chunk(kind, payload):
    if len(payload) % 2:
        payload += b"\0"
    return struct.pack("<IH", len(payload) + 6, kind) + payload


def fli_frame(chunks):
    body = b"".join(chunks)
    return struct.pack("<IHH", len(body) + 16, 0xF1FA, len(chunks)) + bytes(8) + body


def fli_bytes(w, h, frames, magic=0xAF12):
    head = bytearray(128)
    struct.pack_into("<IHHHHHH", head, 0, 0, magic, len(frames), w, h, 8, 0)
    struct.pack_into("<I", head, 16, 5)
    data = bytes(head) + b"".join(frames)
    struct.pack_into("<I", head, 0, len(data))
    return bytes(head) + data[128:]


def fli_color(entries, kind=4):
    """COLOR_256 (4) or COLOR_64 (11) of packets (skip, [(r, g, b), ...])."""
    out = struct.pack("<H", len(entries))
    for skip, cols in entries:
        out += bytes([skip, len(cols) % 256]) + bytes(np.asarray(cols, np.uint8).reshape(-1))
    return fli_chunk(kind, out)


def fli_brun(img):
    """BRUN of an [h, w] index image: a packet count byte, then per line
    runs (count < 128, one value) and literals (negative counts)."""
    out = bytearray()
    for row in img:
        row = bytes(row)
        line, i = bytearray(), 0
        while i < len(row):
            j = i
            while j < len(row) and j - i < 127 and row[j] == row[i]:
                j += 1
            if j - i >= 2:
                line += bytes([j - i, row[i]])
                i = j
            else:
                k = min(len(row), i + 1)
                while k < len(row) and k - i < 127 and not (
                        k + 1 < len(row) and row[k] == row[k + 1]):
                    k += 1
                line += bytes([256 - (k - i)]) + row[i:k]
                i = k
        out += b"\0" + line
    return fli_chunk(15, bytes(out))


def fli_lc(first, rows):
    """LC (byte delta) from line `first`: rows of (skip, kind, bytes),
    kind "run" (one value, count) or "copy"."""
    out = struct.pack("<HH", first, len(rows))
    for packets in rows:
        out += bytes([len(packets)])
        for skip, kind, data in packets:
            if kind == "run":
                out += bytes([skip, 256 - data[1], data[0]])
            else:
                out += bytes([skip, len(data)]) + bytes(data)
    return fli_chunk(12, out)


def fli_ss2(lines):
    """SS2 (word delta): per line a list of words: ("skip", n) lines to
    skip, ("last", v) the last byte of an odd line, ("packets", [(skip,
    kind, data)]) with kind "run" (a 2-byte value, count) or "copy"
    (bytes, an even count)."""
    out = struct.pack("<H", len(lines))
    for words in lines:
        for kind, v in words:
            if kind == "skip":
                out += struct.pack("<H", 65536 - v)
            elif kind == "last":
                out += struct.pack("<H", 0x8000 | v)
            else:
                out += struct.pack("<H", len(v))
                for skip, pk, data in v:
                    if pk == "run":
                        out += bytes([skip, 256 - data[2]]) + bytes(data[:2])
                    else:
                        out += bytes([skip, len(data) // 2]) + bytes(data)
    return fli_chunk(7, out)


# ---------------------------------------------------------------- PCD

PCD_SIZE = 96 * 2048 + 768 * 512 * 3 // 2


def pcd_bytes(orientation=0, seed=b"craytracer PCD"):
    """A PhotoCD image pack of PCD_SIZE bytes: the "PCD_" signature at
    2048, the orientation in byte 2048 + 1538, and every other byte from
    SHA-256 in counter mode over `seed` (no random number stream)."""
    out = bytearray()
    i = 0
    while len(out) < PCD_SIZE:
        out += hashlib.sha256(seed + i.to_bytes(8, "little")).digest()
        i += 1
    out = out[:PCD_SIZE]
    out[2048:2052] = b"PCD_"
    out[2048 + 1538] = (out[2048 + 1538] & ~3) | orientation
    return bytes(out)
