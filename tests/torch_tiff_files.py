"""TIFF, DDS and PSD files written byte by byte for the tests of the
port's decoders (craytracer_tpu_torch/csrc/imgdecode_tiff.h, _ccitt.h,
_dds.h, _psd.h), with the layouts PIL does not write: TIFF of any byte
order, BigTIFF, strips or tiles, planar configuration, fill order, bit
depth, sample format, photometric, predictor and compression (none,
PackBits, LZW new and old style, Deflate, CCITT RLE, Group 3 1D and 2D,
Group 4 and RLEW, JPEG strips from PIL's encoder with or without
JPEGTables);
DDS headers over any block or pixel bytes; PSD of every mode PIL opens,
raw or PackBits. numpy and zlib only: the tests hold each file to PIL's
decode of it."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_REV = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def lzw_tiff(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, 9-12 bits, the width growing one code
    early as libtiff reads it), a clear code first and an EOI last."""
    out, acc, nacc = bytearray(), 0, 0
    nbits = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)

    table = {bytes([i]): i for i in range(256)}
    free = 258
    put(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = free
        free += 1
        if free == 4094:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            free, nbits = 258, 9
        elif free > (1 << nbits) - 1:
            nbits += 1
        w = bytes([c])
    if w:
        put(table[w])
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def lzw_compat(data: bytes) -> bytes:
    """Old-style TIFF LZW, as libtiff's LZWDecodeCompat reads it: codes
    low bit first, a clear code first (so the strip starts 00 with bit 0
    of its second byte set), the width growing once the reader's table
    passes 511, 1023 and 2047, an EOI last."""
    out, acc, nacc = bytearray(), 0, 0
    nbits, dec_free, first = 9, 258, True

    def put(code):
        nonlocal acc, nacc, nbits, dec_free, first
        acc |= code << nacc
        nacc += nbits
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8
        if code == 256:
            nbits, dec_free, first = 9, 258, True
        elif first:
            first = False
        else:  # the reader adds an entry on every code but a first
            dec_free += 1
            if dec_free > (1 << nbits) - 1 and nbits < 12:
                nbits += 1

    table = {bytes([i]): i for i in range(256)}
    free = 258
    put(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = free
        free += 1
        if free == 4000:
            put(256)
            table = {bytes([i]): i for i in range(256)}
            free = 258
        w = bytes([c])
    if w:
        put(table[w])
    put(257)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


# T.4's code tables, first bit first: white and black terminating codes
# (runs 0-63), make-up codes (64-1728) and the shared extended make-up
# codes (1792-2560)
_TERM_W = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 "
    "001000 000011 110100 110101 101010 101011 0100111 0001100 0001000 "
    "0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 "
    "00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
    "01010011 01010100 01010101 00100100 00100101 01011000 01011001 "
    "01011010 01011011 01001010 01001011 00110010 00110011 00110100").split()
_MAKEUP_W = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011").split()
_TERM_B = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()
_MAKEUP_B = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101").split()
_MAKEUP_X = (
    "00000001000 00000001100 00000001101 000000010010 000000010011 "
    "000000010100 000000010101 000000010110 000000010111 000000011100 "
    "000000011101 000000011110 000000011111").split()
_EOL = "000000000001"
_MODES = {"P": "0001", "H": "001", 0: "1", 1: "011", 2: "000011",
          3: "0000011", -1: "010", -2: "000010", -3: "0000010"}


def _run_code(run: int, black: bool) -> str:
    term, makeup = (_TERM_B, _MAKEUP_B) if black else (_TERM_W, _MAKEUP_W)
    out = ""
    while run > 2560:
        out += _MAKEUP_X[-1]
        run -= 2560
    if run >= 1792:
        out += _MAKEUP_X[(run - 1792) // 64]
        run %= 64
    elif run >= 64:
        out += makeup[run // 64 - 1]
        run %= 64
    return out + term[run]


def _changes(row) -> list:
    """The positions where a row of 0 (white) and 1 (black) changes
    colour, starting from white, then twice the width."""
    r = np.concatenate([[0], np.asarray(row, np.int64)])
    pos = list(np.flatnonzero(r[1:] != r[:-1]))
    return pos + [len(row), len(row)]


def _mh_row(row) -> str:
    runs, x, w = [], 0, len(row)
    for p in _changes(row)[:-2] + [w]:
        runs.append(p - x)
        x = p
    return "".join(_run_code(r, k % 2 == 1) for k, r in enumerate(runs))


def _t6_row(row, ref) -> str:
    """T.4 2D / T.6 coding of a row against its reference row."""
    w = len(row)
    a = _changes(row)
    b = _changes(ref)
    out, a0, color = "", -1, 0

    def next_change(ch, after, col):
        # first change > after whose new colour is the opposite of col
        for i, p in enumerate(ch):
            if p > after and (i % 2 == col):
                return p
        return w

    while a0 < w:
        a1 = next_change(a, a0, color)
        a2 = next_change(a, a1, 1 - color)
        b1 = next_change(b, a0 if a0 >= 0 else -1, color)
        b2 = next_change(b, b1, 1 - color)
        if b2 < a1:
            out += _MODES["P"]
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out += _MODES[a1 - b1]
            a0, color = a1, 1 - color
        else:
            start = max(a0, 0)
            out += _MODES["H"] + _run_code(a1 - start, color == 1) \
                + _run_code(a2 - a1, color == 0)
            a0 = a2
    return out


def fax_bytes(bits, compression: int, t4options=0, two_d=None,
              fill_eol=False) -> bytes:
    """CCITT-coded rows of `bits` [H, W] (1 black): compression 2 (MH,
    rows byte-aligned), 3 (Group 3: an EOL before each row; with
    t4options bit 0 a tag bit after it, and rows where `two_d` [H] is
    true coded 2D against the row before; `fill_eol` pads each EOL to end
    on a byte), 4 (Group 4, an EOFB last) or 32771 (MH, rows aligned to
    16-bit words)."""
    bits = np.asarray(bits, np.int64)
    h, w = bits.shape
    out = ""
    ref = np.zeros(w, np.int64)
    for y in range(h):
        row = bits[y]
        if compression == 3:
            eol = _EOL
            if fill_eol:
                pad = (-(len(out) + len(_EOL))) % 8
                eol = "0" * pad + _EOL
            out += eol
            if t4options & 1:
                d2 = bool(two_d[y]) if two_d is not None else False
                out += "0" if d2 else "1"
                out += _t6_row(row, ref) if d2 else _mh_row(row)
            else:
                out += _mh_row(row)
        elif compression == 4:
            out += _t6_row(row, ref)
        else:
            out += _mh_row(row)
            align = 8 if compression == 2 else 16
            out += "0" * ((-len(out)) % align)
        ref = row
    if compression == 4:
        out += _EOL * 2
    out += "0" * ((-len(out)) % 8)
    return bytes(int(out[i:i + 8], 2) for i in range(0, len(out), 8))


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 or more repeated bytes, literals otherwise."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _pack_rows(s: np.ndarray, bps: int, order: str, sf: int) -> bytes:
    """Samples [rows, n] packed row by row (each row padded to a byte)."""
    if bps < 8:
        per = 8 // bps
        rows = []
        for r in s:
            v = np.concatenate([r.astype(np.int64), np.zeros(
                (-len(r)) % per, np.int64)]).reshape(-1, per)
            rows.append(((v << (bps * np.arange(per - 1, -1, -1))).sum(1))
                        .astype(np.uint8).tobytes())
        return b"".join(rows)
    if bps == 12:
        rows = []
        for r in s:
            v = np.concatenate([r.astype(np.int64), np.zeros(len(r) % 2,
                                                             np.int64)])
            a, b = v[0::2], v[1::2]
            t = np.stack([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255], -1)
            rows.append(t.astype(np.uint8).tobytes()[:(len(r) * 12 + 7) // 8])
        return b"".join(rows)
    kind = {1: "u", 2: "i", 3: "f"}[sf]
    dt = np.dtype(f"{order}{kind}{bps // 8}")
    return np.ascontiguousarray(s).astype(dt).tobytes()


def _predict(s: np.ndarray, spp: int, bps: int, predictor: int, order: str):
    """Samples [rows, w * spp] after horizontal differencing (2), or the
    packed bytes of the floating-point predictor (3) as one row each."""
    if predictor == 2:
        d = s.astype(np.int64).copy()
        d[:, spp:] -= s.astype(np.int64)[:, :-spp]
        return d & ((1 << bps) - 1), None
    rows = []
    nb = bps // 8
    for r in s:
        b = np.frombuffer(r.astype(f">f{nb}").tobytes(), np.uint8)
        b = b.reshape(-1, nb).T.reshape(-1).astype(np.int64)
        d = b.copy()
        d[spp:] -= b[:-spp]
        rows.append((d & 255).astype(np.uint8).tobytes())
    return None, b"".join(rows)


def tiff_bytes(samples, bps, photometric, *, order="<", big=False,
               sample_format=1, extra=(), compression=1, predictor=1,
               rows_per_strip=None, tile=None, planar=1, fill_order=1,
               colormap=None, jpeg=None, jpeg_tables=None, orientation=None,
               extra_tags=(), spp_tag=True, tag_order=None, fax=None,
               old_lzw=False):
    """A TIFF of `samples` [H, W, spp] (float for sample_format 3) at
    `bps` bits. `jpeg` is a callable giving the JPEG bytes of a segment's
    samples [h, w, spp] (compression 7); `jpeg_tables` goes in as the
    JPEGTables tag. `extra_tags` adds (tag, type, values) entries.
    Compressions 2, 3, 4 and 32771 code 1-bit samples (1 black) with
    fax_bytes(**fax); `old_lzw` writes compression 5 as old-style LZW."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, spp = s.shape
    if tile:
        tw, th = tile
        segs = [(x, y, tw, th) for y in range(0, h, th)
                for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        segs = [(0, y, w, rps) for y in range(0, h, rps)]
    planes = [s[..., k:k + 1] for k in range(spp)] if planar == 2 else [s]
    blobs = []
    for pl in planes:
        for x, y, sw, sh in segs:
            seg = pl[y:y + sh, x:x + sw]
            if tile:  # tiles are padded to full size
                pad = np.zeros((th, tw, pl.shape[2]), pl.dtype)
                pad[:seg.shape[0], :seg.shape[1]] = seg
                seg = pad
            if compression == 7:
                blobs.append(jpeg(seg))
                continue
            flat = seg.reshape(seg.shape[0], -1)
            if predictor == 2:
                flat, _ = _predict(flat, pl.shape[2], bps, 2, order)
                raw = _pack_rows(flat, bps, order, 1 if sample_format == 3
                                 else sample_format)
            elif predictor == 3:
                _, raw = _predict(flat, pl.shape[2], bps, 3, order)
            else:
                raw = _pack_rows(flat, bps, order, sample_format)
            if compression in (2, 3, 4, 32771):
                raw = fax_bytes(flat, compression, **(fax or {}))
            elif compression == 5:
                raw = lzw_compat(raw) if old_lzw else lzw_tiff(raw)
            elif compression in (8, 32946):
                raw = zlib.compress(raw)
            elif compression == 32773:
                raw = packbits(raw)
            if fill_order == 2:
                raw = raw.translate(_REV)
            blobs.append(raw)
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bps] * spp),
            (259, 3, [compression]), (262, 3, [photometric])]
    if spp_tag:
        tags.append((277, 3, [spp]))
    if fill_order != 1:
        tags.append((266, 3, [fill_order]))
    if planar != 1:
        tags.append((284, 3, [planar]))
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if sample_format != 1:
        tags.append((339, 3, [sample_format] * spp))
    if extra:
        tags.append((338, 3, list(extra)))
    if colormap is not None:
        tags.append((320, 3, list(np.asarray(colormap).T.reshape(-1))))
    if orientation:
        tags.append((274, 3, [orientation]))
    if jpeg_tables is not None:
        tags.append((347, 7, jpeg_tables))
    tags += list(extra_tags)
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    if tile:
        tags += [(322, 3, [tile[0]]), (323, 3, [tile[1]])]
    else:
        tags.append((278, 3, [rows_per_strip or h]))
    long_t = 16 if big else 4
    tags.append((off_tag, long_t, [0] * len(blobs)))
    tags.append((cnt_tag, long_t, [len(b) for b in blobs]))
    tags.sort(key=lambda t: t[0] if tag_order is None else tag_order(t[0]))
    # layout: header, image data, IFD, out-of-line values
    e = order
    head = (b"II" if e == "<" else b"MM") + (
        struct.pack(e + "HHHQ", 43, 8, 0, 0) if big else
        struct.pack(e + "HI", 42, 0))
    data = bytearray(head)
    offsets = []
    for b in blobs:
        offsets.append(len(data))
        data += b
        if len(data) & 1:
            data += b"\0"
    tags = [(t, ty, offsets if t == off_tag else v) for t, ty, v in tags]
    ifd_at = len(data)
    fmt = {1: "B", 2: "B", 3: "H", 4: "I", 7: "B", 16: "Q", 6: "b", 8: "h",
           9: "i", 17: "q"}
    entry = 20 if big else 12
    inline = 8 if big else 4
    ifd_size = (8 if big else 2) + entry * len(tags) + (8 if big else 4)
    extra_at = ifd_at + ifd_size
    ifd = bytearray(struct.pack(e + ("Q" if big else "H"), len(tags)))
    tail = bytearray()
    for t, ty, v in tags:
        payload = (bytes(v) if ty == 7 else
                   struct.pack(e + fmt[ty] * len(v), *v))
        if len(payload) <= inline:
            val = payload + b"\0" * (inline - len(payload))
        else:
            val = struct.pack(e + ("Q" if big else "I"),
                              extra_at + len(tail))
            tail += payload
            if len(tail) & 1:
                tail += b"\0"
        ifd += struct.pack(e + ("HHQ" if big else "HHI"), t, ty, len(v)) + val
    ifd += struct.pack(e + ("Q" if big else "I"), 0)
    out = data + ifd + tail
    struct.pack_into(e + ("Q" if big else "I"), out, 8 if big else 4, ifd_at)
    return bytes(out)


# ------------------------------------------------------------------ DDS

def dds_bytes(w, h, payload: bytes, *, fourcc=b"", dxgi=None, pfflags=None,
              bitcount=0, masks=(0, 0, 0, 0), mips=1):
    """A DDS file: the 124-byte header (a FourCC, or pixel-format flags,
    bit count and RGBA masks), the DX10 header when `dxgi` is given, then
    `payload`."""
    if pfflags is None:
        pfflags = 0x4 if fourcc or dxgi is not None else 0x40
    if dxgi is not None:
        fourcc = b"DX10"
    pf = struct.pack("<II4sI4I", 32, pfflags, fourcc.ljust(4, b"\0"),
                     bitcount, *masks)
    hdr = struct.pack("<7I", 124, 0x1007 | 0x20000, h, w, 0, 0, mips)
    hdr += b"\0" * 44 + pf + struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    assert len(hdr) == 124
    out = b"DDS " + hdr
    if dxgi is not None:
        out += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return out + payload


# ------------------------------------------------------------------ PSD

def psd_bytes(channels, mode, bits=8, *, rle=False, color_data=b"",
              resources=b"", layers=b"", n_channels=None):
    """A PSD of `channels` [C, H, W] (bytes; bit-packed rows for bits=1),
    in colour mode `mode`, its image data raw or PackBits row by row."""
    c, h, w = channels.shape[:3]
    row = (w + 7) // 8 if bits == 1 else w
    nc = c if n_channels is None else n_channels
    out = (b"8BPS" + struct.pack(">H6xHIIHH", 1, nc, h, w, bits, mode)
           + struct.pack(">I", len(color_data)) + color_data
           + struct.pack(">I", len(resources)) + resources
           + struct.pack(">I", len(layers)) + layers)
    planes = [np.asarray(channels[k]).reshape(h, -1)[:, :row].astype(
        np.uint8) for k in range(c)]
    if not rle:
        return out + struct.pack(">H", 0) + b"".join(
            p.tobytes() for p in planes)
    rows = [packbits(p[y].tobytes()) for p in planes for y in range(h)]
    return (out + struct.pack(">H", 1)
            + b"".join(struct.pack(">H", len(r)) for r in rows)
            + b"".join(rows))
