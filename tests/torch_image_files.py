"""Image files of every variant the port's decoders read
(craytracer_tpu_torch/csrc/imgdecode.cpp), written byte by byte where PIL
writes no such file: PNG of any bit depth, colour type, interlace and row
filters; PNM P1-P6 at any maxval; BMP of any depth, header, row order,
BITFIELDS layout and RLE packets; TGA raw and RLE with chosen packets;
GIF with an LZW stream, global or local palette, an offset frame,
interlace and transparency; a baseline JPEG with any sampling factors,
and its arithmetic-coded twin (SOF9, or SOF10 with any scan script).
numpy and the standard library only: the tests hold each file to PIL's
decode of it."""

from __future__ import annotations

import struct
import zlib

import numpy as np

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack_row(row: np.ndarray, depth: int) -> np.ndarray:
    """One row of samples (flattened) packed at `depth` bits, big-endian,
    the last byte padded with zero bits."""
    v = row.reshape(-1).astype(np.int64)
    if depth == 16:
        return np.stack([v >> 8, v & 255], -1).reshape(-1).astype(np.uint8)
    if depth == 8:
        return v.astype(np.uint8)
    per = 8 // depth
    v = np.concatenate([v, np.zeros((-len(v)) % per, np.int64)])
    v = v.reshape(-1, per)
    shifts = depth * np.arange(per - 1, -1, -1)
    return (v << shifts).sum(1).astype(np.uint8)


def _filter_row(x: np.ndarray, prior: np.ndarray, ft: int, bpp: int):
    x = x.astype(np.int64)
    prior = prior.astype(np.int64)
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
        f = x - np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prior, ul))
    return bytes([ft]) + (f & 0xFF).astype(np.uint8).tobytes()


def png_bytes(samples, depth, ctype, interlace=0, palette=None, trns=None,
              filters=(0, 1, 2, 3, 4), level=6, idat_chunks=2):
    """A PNG of `samples` [H, W, channels of ctype] at `depth` bits, each
    row filtered with the next type of `filters`, the zlib stream at
    `level` split over `idat_chunks` IDAT chunks; `palette` [N, 3] for
    colour type 3, `trns` the tRNS payload."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, c = s.shape
    assert c == PNG_CHANNELS[ctype]
    bpp = max(1, c * depth // 8)
    raw, k = bytearray(), 0
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = s[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prior = None
        for row in sub:
            packed = _pack_row(row, depth)
            if prior is None:
                prior = np.zeros_like(packed)
            raw += _filter_row(packed, prior, filters[k % len(filters)], bpp)
            k += 1
            prior = packed
    z = zlib.compress(bytes(raw), level)
    cuts = np.linspace(0, len(z), idat_chunks + 1).astype(int)
    out = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    for a, b in zip(cuts[:-1], cuts[1:]):
        out += _chunk(b"IDAT", z[a:b])
    return out + _chunk(b"IEND", b"")


def pnm_bytes(kind: int, img, maxval=255, comment=True):
    """PNM P`kind`: `img` [H, W] (P1/P2/P4/P5) or [H, W, 3] (P3/P6) of
    values up to maxval (0/1 for P1/P4, 1 = black); plain formats wrap
    lines and carry a comment inside the data."""
    a = np.asarray(img).astype(np.int64)
    h, w = a.shape[:2]
    head = f"P{kind}\n" + ("# made by a test\n" if comment else "")
    head += f"{w} {h}\n" + ("" if kind in (1, 4) else f"{maxval}\n")
    if kind == 4:
        rows = [np.packbits(r.astype(np.uint8)).tobytes() for r in a]
        return head.encode() + b"".join(rows)
    if kind in (5, 6):
        dt = ">u2" if maxval > 255 else np.uint8
        return head.encode() + a.astype(dt).tobytes()
    vals = [str(v) for v in a.reshape(-1)]
    lines = [" ".join(vals[i:i + 11]) for i in range(0, len(vals), 11)]
    if comment and len(lines) > 2:
        lines.insert(2, "# a comment among the values")
    return (head + "\n".join(lines) + "\n").encode()


def bmp_bytes(pixels: bytes, w: int, h: int, bits: int, *, palette=None,
              header=40, compression=0, masks=None, top_down=False,
              colors=None, offset=None):
    """A BMP around `pixels` (already in the file's row order and padding,
    or RLE packets): palette [N, 3] RGB, written BGRX (BGR for the
    12-byte header); `masks` for BITFIELDS (in the header past 40 bytes,
    after it at 40)."""
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)
        pal = p.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
        extra = b""
    else:
        hh = (2 ** 32 - h) if top_down else h
        n_colors = len(palette) if (palette is not None and colors is None) \
            else (colors or 0)
        info = struct.pack("<IiIHHIIiiII", header, w, hh, 1, bits,
                           compression, len(pixels), 2835, 2835, n_colors, 0)
        extra = b""
        if masks is not None and header == 40:
            extra = struct.pack("<III", *masks[:3])
        tail = bytearray(header - 40)
        if masks is not None and header > 40:
            m = struct.pack("<IIII", *(tuple(masks) + (0,) * 4)[:4])
            tail[:min(16, len(tail))] = m[:min(16, len(tail))]
        info += bytes(tail)
    off = 14 + len(info) + len(extra) + len(pal) if offset is None else offset
    body = info + extra + pal
    return (b"BM" + struct.pack("<IHHI", 14 + len(body) + len(pixels), 0, 0,
                                off) + body + pixels)


def bmp_rows(idx_or_bytes: np.ndarray, bits: int, top_down=False) -> bytes:
    """Rows [H, W] of indices (bits <= 8) or [H, W, B] bytes, packed at
    `bits` and padded to 4 bytes, bottom row first unless top_down."""
    a = np.asarray(idx_or_bytes)
    rows = []
    for r in a if top_down else a[::-1]:
        b = _pack_row(r, bits).tobytes() if bits <= 8 else \
            r.astype(np.uint8).tobytes()
        rows.append(b + bytes((-len(b)) % 4))
    return b"".join(rows)


def tga_bytes(data: bytes, w: int, h: int, itype: int, depth: int, *,
              cmap=None, cmap_start=0, cmap_depth=24, descriptor=0,
              id_field=b"abc"):
    """A TGA around `data` (pixels or RLE packets in file order); `cmap`
    the colour-map entries' bytes."""
    n = 0 if cmap is None else len(cmap) // (cmap_depth // 8)
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), cmap is not None,
                       itype, cmap_start, n, cmap_depth if cmap is not None
                       else 0, 0, 0, w, h, depth, descriptor)
    return head + id_field + (cmap or b"") + data


def tga_rle(pixels: np.ndarray, bpp: int, pattern=(1, 3, 130)) -> bytes:
    """RLE packets over `pixels` ([N * bpp] bytes in file order): packet
    lengths cycle through `pattern`, a length over 128 meaning a run of
    the same pixel (the pixels are made equal there by the caller)."""
    px = np.asarray(pixels, np.uint8).reshape(-1, bpp)
    out, i, k = bytearray(), 0, 0
    while i < len(px):
        n = pattern[k % len(pattern)]
        k += 1
        if n > 128:
            n = min(n - 128, len(px) - i)
            out += bytes([0x80 | (n - 1)]) + px[i].tobytes()
        else:
            n = min(n, len(px) - i)
            out += bytes([n - 1]) + px[i:i + n].tobytes()
        i += n
    return bytes(out)


def tga_rle_exact(pixels: np.ndarray, bpp: int, width: int) -> bytes:
    """Lossless RLE packets row by row: a run packet for two or more equal
    pixels, literal packets (at most 128 pixels) for the rest."""
    px = np.asarray(pixels, np.uint8).reshape(-1, width, bpp)
    out = bytearray()
    for row in px:
        i = 0
        while i < width:
            j = i + 1
            while j < width and j - i < 128 and (row[j] == row[i]).all():
                j += 1
            if j - i >= 2:
                out += bytes([0x80 | (j - i - 1)]) + row[i].tobytes()
                i = j
                continue
            j = i + 1
            while j < width and j - i < 128 and not (
                    j + 1 < width and (row[j + 1] == row[j]).all()):
                j += 1
            out += bytes([j - i - 1]) + row[i:j].tobytes()
            i = j
    return bytes(out)


def lzw_encode(idx: np.ndarray, bits: int, clear_every=0) -> bytes:
    """GIF LZW of the indices at minimum code size `bits`, a greedy
    dictionary encoder, a clear code every `clear_every` codes if set
    (else when the table fills), then the end code; sub-blocks and the
    terminator included."""
    clear, end = 1 << bits, (1 << bits) + 1
    out_bits, codes = [], []
    size = bits + 1

    def emit(code):
        codes.append((code, size))

    table = {(i,): i for i in range(clear)}
    nxt = end + 1
    emit(clear)
    seq = ()
    n_codes = 0
    for v in np.asarray(idx).reshape(-1).tolist():
        cand = seq + (v,)
        if cand in table:
            seq = cand
            continue
        emit(table[seq])
        n_codes += 1
        if nxt < 4096:
            table[cand] = nxt
            nxt += 1
            if nxt - 1 == (1 << size) and size < 12:
                size += 1
        if (clear_every and n_codes % clear_every == 0) or nxt >= 4095:
            emit(clear)
            table = {(i,): i for i in range(clear)}
            nxt, size = end + 1, bits + 1
        seq = (v,)
    if seq:
        emit(table[seq])
    emit(end)
    acc, nacc, data = 0, 0, bytearray()
    for code, sz in codes:
        acc |= code << nacc
        nacc += sz
        while nacc >= 8:
            data.append(acc & 255)
            acc >>= 8
            nacc -= 8
    if nacc:
        data.append(acc & 255)
    blocks = b"".join(bytes([len(data[i:i + 255])]) + bytes(data[i:i + 255])
                      for i in range(0, len(data), 255))
    return bytes([bits]) + blocks + b"\0"


def gif_bytes(idx: np.ndarray, *, screen=None, offset=(0, 0),
              global_palette=None, local_palette=None, interlace=False,
              transparency=None, bits=None, clear_every=0):
    """A GIF89a of one frame of indices `idx` [h, w] placed at `offset`
    on a logical screen `screen` (w, h; the frame's size if None)."""
    fh, fw = idx.shape
    sw, sh = screen or (fw + offset[0], fh + offset[1])

    def pal_bytes(p):
        p = np.asarray(p, np.uint8)
        n = max(1, int(np.ceil(np.log2(max(len(p), 2)))))
        full = np.zeros((1 << n, 3), np.uint8)
        full[:len(p)] = p
        return n, full.tobytes()

    out = b"GIF89a" + struct.pack("<HH", sw, sh)
    if global_palette is not None:
        n, pb = pal_bytes(global_palette)
        out += bytes([0x80 | (n - 1), 0, 0]) + pb
    else:
        out += bytes([0, 0, 0])
    if transparency is not None:
        out += b"!\xf9\x04" + bytes([1, 0, 0, transparency, 0])
    out += b"!\xfe\x05hello\x00"  # a comment extension
    rows = np.arange(fh)
    if interlace:
        rows = np.concatenate([np.arange(s, fh, st) for s, st in
                               ((0, 8), (4, 8), (2, 4), (1, 2))])
    flags = 0x40 if interlace else 0
    lp = b""
    if local_palette is not None:
        n, lp = pal_bytes(local_palette)
        flags |= 0x80 | (n - 1)
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], fw, fh,
                              flags) + lp
    code_bits = bits or max(2, int(np.ceil(np.log2(int(idx.max()) + 1))))
    out += lzw_encode(idx[rows], code_bits, clear_every)
    return out + b";"


# ---------------------------------------------------------------- JPEG

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
# Annex K's typical luminance tables (one DC and one AC table for all)
_DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_VALS = list(range(12))
_AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d]
_AC_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa]


def _huff_codes(bits, vals):
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _jpeg_coefs(planes, factors, q):
    """Each plane box-averaged to its sampling factors, cut into the
    blocks of whole MCUs, transformed with a float DCT and quantized by a
    flat table of `q`: a list of [rows, cols, 8, 8] int arrays."""
    planes = [np.asarray(p, np.float64) for p in planes]
    H, W = planes[0].shape
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    u = np.arange(8)
    cmat = np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
    cmat *= np.where(u == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))[:, None]
    comps = []
    for p, (h, v) in zip(planes, factors):
        fy, fx = vmax // v, hmax // h
        ph, pw = my * v * 8, mx * h * 8
        big = np.pad(p, ((0, ph * fy - H), (0, pw * fx - W)), mode="edge")
        small = big.reshape(ph, fy, pw, fx).mean((1, 3)) - 128
        blocks = small.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ij,abjk,lk->abil", cmat, blocks, cmat)
        comps.append(np.rint(coef / q).astype(np.int64))
    return comps


def _jseg(marker, payload):
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
        + payload


def _jpeg_head(n, H, W, factors, q, adobe, sof):
    out = b"\xff\xd8"
    if adobe is None and n in (1, 3):
        out += _jseg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    if adobe is not None:
        out += _jseg(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([adobe]))
    out += _jseg(0xDB, b"\0" + bytes([q] * 64))
    body = struct.pack(">BHHB", 8, H, W, n)
    for i, (h, v) in enumerate(factors):
        body += bytes([i + 1, (h << 4) | v, 0])
    return out + _jseg(sof, body)


def _mcu_blocks(comps, factors, members, H, W):
    """(component index, [8, 8] block) in a scan's MCU order, with None
    between MCUs: interleaved MCUs over `members`, or one component's
    blocks that hold image samples, row by row."""
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    if len(members) == 1:
        ci = members[0]
        h, v = factors[ci]
        bw = -(-(-(-W * h // hmax)) // 8)
        bh = -(-(-(-H * v // vmax)) // 8)
        for by in range(bh):
            for bx in range(bw):
                yield None
                yield ci, comps[ci][by, bx]
        return
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    for by in range(my):
        for bx in range(mx):
            yield None
            for ci in members:
                h, v = factors[ci]
                for y in range(v):
                    for x in range(h):
                        yield ci, comps[ci][by * v + y, bx * h + x]


def jpeg_bytes(planes, factors, q=8, adobe=None, restart=0):
    """A baseline JPEG of component planes (each [H, W] uint8 at full
    size, already in the colour space the file declares) with sampling
    `factors` [(h, v), ...]: each plane is box-averaged to its factors,
    cut into blocks, transformed with a float DCT and quantized by a flat
    table of `q`; interleaved MCUs, Annex K's tables, a restart marker
    every `restart` MCUs if set, an Adobe APP14 of that transform if
    given (else JFIF for 1 or 3 components)."""
    H, W = np.asarray(planes[0]).shape
    comps = _jpeg_coefs(planes, factors, q)
    dc = _huff_codes(_DC_BITS, _DC_VALS)
    ac = _huff_codes(_AC_BITS, _AC_VALS)
    bits_out = []

    def put(code, length):
        bits_out.append((code, length))

    def magnitude(v):
        n = int(abs(v)).bit_length()
        return n, (v if v >= 0 else v + (1 << n) - 1)

    entropy = bytearray()

    def flush(pad=True):
        acc, nacc = 0, 0
        for code, length in bits_out:
            acc = (acc << length) | code
            nacc += length
            while nacc >= 8:
                byte = (acc >> (nacc - 8)) & 255
                entropy.append(byte)
                if byte == 255:
                    entropy.append(0)
                nacc -= 8
        if nacc and pad:
            byte = ((acc << (8 - nacc)) | ((1 << (8 - nacc)) - 1)) & 255
            entropy.append(byte)
            if byte == 255:
                entropy.append(0)
        bits_out.clear()

    preds = [0] * len(comps)
    n_mcu = 0
    for item in _mcu_blocks(comps, factors, range(len(comps)), H, W):
        if item is None:
            if restart and n_mcu and n_mcu % restart == 0:
                flush()
                entropy.extend(bytes([0xFF, 0xD0 + (n_mcu // restart - 1) % 8]))
                preds = [0] * len(comps)
            n_mcu += 1
            continue
        ci, blk = item
        zz = blk.reshape(-1)[_ZIGZAG]
        diff = int(zz[0]) - preds[ci]
        preds[ci] = int(zz[0])
        n, m = magnitude(diff)
        put(*dc[n])
        if n:
            put(m, n)
        run = 0
        for k in range(1, 64):
            val = int(zz[k])
            if val == 0:
                run += 1
                continue
            while run > 15:
                put(*ac[0xF0])
                run -= 16
            n, m = magnitude(val)
            put(*ac[(run << 4) | n])
            put(m, n)
            run = 0
        if run:
            put(*ac[0x00])
    flush()

    out = _jpeg_head(len(planes), H, W, factors, q, adobe, 0xC0)
    out += _jseg(0xC4, b"\x00" + bytes(_DC_BITS) + bytes(_DC_VALS))
    out += _jseg(0xC4, b"\x10" + bytes(_AC_BITS) + bytes(_AC_VALS))
    if restart:
        out += _jseg(0xDD, struct.pack(">H", restart))
    sos = bytes([len(planes)])
    for i in range(len(planes)):
        sos += bytes([i + 1, 0x00])
    out += _jseg(0xDA, sos + b"\x00\x3f\x00")
    return out + bytes(entropy) + b"\xff\xd9"


def _aritab():
    """T.81 Table D.2 (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS),
    as the port's csrc/imgdecode_arith.h holds it."""
    import re
    from pathlib import Path
    src = (Path(__file__).resolve().parent.parent / "craytracer_tpu_torch"
           / "csrc" / "imgdecode_arith.h").read_text()
    body = src[src.index("ARITAB[114]"):]
    body = body[:body.index("};")]
    return [tuple(int(x, 0) for x in m) for m in re.findall(
        r"\{(0x[0-9a-f]+), (\d+), (\d+), (\d+)\}", body)]


class ArithCoder:
    """jcarith.c's arith_encode and finish_pass (T.81 D.1): binary
    decisions coded against state bytes that the caller keeps (ints in a
    list, index `st`), bytes out with 0xFF stuffing."""

    def __init__(self):
        self.tab = _aritab()
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _zeros(self):
        while self.zc:
            self.out.append(0)
            self.zc -= 1

    def _byte_out(self, temp):
        if temp > 0xFF:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
            self.buffer = temp & 0xFF
        elif temp == 0xFF:
            self.sc += 1
        else:
            self._flush_stacked()
            self.buffer = temp & 0xFF

    def _flush_stacked(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._emit(self.buffer)
        if self.sc:
            self._zeros()
            for _ in range(self.sc):
                self.out += b"\xff\x00"
            self.sc = 0

    def encode(self, stats, st, val):
        sv = stats[st]
        qe, nlps, nmps, sw = self.tab[sv & 0x7F]
        nl, nm = sw << 7 | nlps, nmps
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[st] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[st] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out(self.c >> 19)
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            self._flush_stacked()
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
        self.reset()


def jpeg_arith_bytes(planes, factors, q=8, adobe=None, restart=0,
                     scans=None, dac=None):
    """The arithmetic-coded twin of `jpeg_bytes` (T.81 Annex D and F.1.4,
    jcarith.c's coder): the same quantized coefficients, SOF9 with one
    interleaved scan, or SOF10 with `scans`, a list of (component
    indices, Ss, Se, Ah, Al) in file order; a restart marker every
    `restart` MCUs of each scan if set; a DAC segment of (index, value)
    pairs if given (index < 16 sets a DC table's L | U << 4, 16 + t an AC
    table's K; every component uses tables 0)."""
    H, W = np.asarray(planes[0]).shape
    comps = _jpeg_coefs(planes, factors, q)
    L, U, K = 0, 1, 5
    for index, val in dac or ():
        if index == 0:
            L, U = val & 15, val >> 4
        elif index == 16:
            K = val
    progressive = scans is not None
    scans = scans or [(list(range(len(comps))), 0, 63, 0, 0)]
    nat = _ZIGZAG

    def scan_bytes(members, Ss, Se, Ah, Al):
        coder = ArithCoder()
        fixed = [113]
        state = {}

        def clear():
            state["dc"] = [0] * 64
            state["ac"] = [0] * 256
            state["last"] = {ci: 0 for ci in members}
            state["ctx"] = {ci: 0 for ci in members}

        def magnitude(stats, st, v, x1, k=None):
            # Figures F.8 and F.9: v > 0 after the sign
            m = 0
            v -= 1
            if v:
                coder.encode(stats, st, 1)
                m = 1
                v2 = v
                if k is None:
                    st = x1
                    v2 >>= 1
                    while v2:
                        coder.encode(stats, st, 1)
                        m <<= 1
                        st += 1
                        v2 >>= 1
                else:
                    v2 >>= 1
                    if v2:
                        coder.encode(stats, st, 1)
                        m <<= 1
                        st = 189 if k <= K else 217
                        v2 >>= 1
                        while v2:
                            coder.encode(stats, st, 1)
                            m <<= 1
                            st += 1
                            v2 >>= 1
            coder.encode(stats, st, 0)
            return m, st, v

        def dc_value(ci, value):
            dcs, ctx = state["dc"], state["ctx"]
            st = ctx[ci]
            v = value - state["last"][ci]
            if v == 0:
                coder.encode(dcs, st, 0)
                ctx[ci] = 0
                return
            state["last"][ci] = value
            coder.encode(dcs, st, 1)
            if v > 0:
                coder.encode(dcs, st + 1, 0)
                st += 2
                ctx[ci] = 4
            else:
                v = -v
                coder.encode(dcs, st + 1, 1)
                st += 3
                ctx[ci] = 8
            m, st, v = magnitude(dcs, st, v, 20)
            if m < (1 << L) >> 1:
                ctx[ci] = 0
            elif m > (1 << U) >> 1:
                ctx[ci] += 8
            st += 14
            m >>= 1
            while m:
                coder.encode(dcs, st, 1 if m & v else 0)
                m >>= 1

        def shifted(blk, k, al):
            v = int(blk[nat[k]])
            return v >> al if v >= 0 else -((-v) >> al)

        def ac_first(blk, ks, ke_max, al):
            acs = state["ac"]
            ke = ke_max
            while ke > 0 and shifted(blk, ke, al) == 0:
                ke -= 1
            k = ks
            while k <= ke:
                st = 3 * (k - 1)
                coder.encode(acs, st, 0)
                while shifted(blk, k, al) == 0:
                    coder.encode(acs, st + 1, 0)
                    st += 3
                    k += 1
                coder.encode(acs, st + 1, 1)
                v = shifted(blk, k, al)
                coder.encode(fixed, 0, 0 if v > 0 else 1)
                v = abs(v)
                st += 2
                m, st, v = magnitude(acs, st, v, None, k)
                st += 14
                m >>= 1
                while m:
                    coder.encode(acs, st, 1 if m & v else 0)
                    m >>= 1
                k += 1
            if k <= ke_max:
                coder.encode(acs, 3 * (k - 1), 1)

        def ac_refine(blk):
            acs = state["ac"]
            ke = Se
            while ke > 0 and shifted(blk, ke, Al) == 0:
                ke -= 1
            kex = ke
            while kex > 0 and shifted(blk, kex, Ah) == 0:
                kex -= 1
            k = Ss
            while k <= ke:
                st = 3 * (k - 1)
                if k > kex:
                    coder.encode(acs, st, 0)
                while True:
                    v = shifted(blk, k, Al)
                    if v:
                        if abs(v) >> 1:
                            coder.encode(acs, st + 2, abs(v) & 1)
                        else:
                            coder.encode(acs, st + 1, 1)
                            coder.encode(fixed, 0, 0 if v > 0 else 1)
                        break
                    coder.encode(acs, st + 1, 0)
                    st += 3
                    k += 1
                k += 1
            if k <= Se:
                coder.encode(acs, 3 * (k - 1), 1)

        clear()
        n_mcu = 0
        for item in _mcu_blocks(comps, factors, members, H, W):
            if item is None:
                if restart and n_mcu and n_mcu % restart == 0:
                    coder.finish()
                    coder.out += bytes([0xFF, 0xD0 + (n_mcu // restart - 1) % 8])
                    clear()
                n_mcu += 1
                continue
            ci, blk = item
            blk = blk.reshape(-1)
            if not progressive:
                dc_value(ci, int(blk[0]))
                ac_first(blk, 1, 63, 0)
            elif Ss == 0 and Ah == 0:
                dc_value(ci, int(blk[0]) >> Al)
            elif Ss == 0:
                coder.encode(fixed, 0, (int(blk[0]) >> Al) & 1)
            elif Ah == 0:
                ac_first(blk, Ss, Se, Al)
            else:
                ac_refine(blk)
        coder.finish()
        return bytes(coder.out)

    out = _jpeg_head(len(planes), H, W, factors, q, adobe,
                     0xCA if progressive else 0xC9)
    if dac:
        out += _jseg(0xCC, b"".join(bytes([i, v]) for i, v in dac))
    if restart:
        out += _jseg(0xDD, struct.pack(">H", restart))
    for members, Ss, Se, Ah, Al in scans:
        sos = bytes([len(members)])
        for ci in members:
            sos += bytes([ci + 1, 0x00])
        out += _jseg(0xDA, sos + bytes([Ss, Se, (Ah << 4) | Al]))
        out += scan_bytes(list(members), Ss, Se, Ah, Al)
    return out + b"\xff\xd9"


# lossless JPEG's difference categories 0-16, one table for all
_LL_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0]
_LL_VALS = list(range(17))


def _ll_predict(sel, ra, rb, rc):
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[sel]


def jpeg_lossless_bytes(planes, predictor=1, pt=0, restart_rows=0,
                        factors=None, markers="none", ids=None,
                        precision=8, scans=None):
    """A lossless (SOF3) JPEG of component planes (each [H, W] ints at
    full size; subsampled components keep every h-th column and v-th row
    of theirs): T.81 Annex H with selection value `predictor`, point
    transform `pt` (the samples' low bits dropped), a restart interval of
    `restart_rows` MCU rows if set, component ids `ids` (default 1, 2,
    ...), a JFIF or Adobe (transform 0) marker or none, and the
    components in one interleaved scan or in `scans` (lists of component
    indices)."""
    n = len(planes)
    factors = factors or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    H, W = np.asarray(planes[0]).shape
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mx, my = -(-W // hmax), -(-H // vmax)
    comps = []
    for p, (h, v) in zip(planes, factors):
        a = np.asarray(p, np.int64)[::vmax // v, ::hmax // h] >> pt
        cw, ch = -(-W * h // hmax), -(-H * v // vmax)
        a = a[:ch, :cw]
        # the MCUs' padding repeats the last column and row
        comps.append(np.pad(a, ((0, my * v - ch), (0, mx * h - cw)),
                            mode="edge"))
    table = _huff_codes(_LL_BITS, _LL_VALS)
    init = 1 << (precision - pt - 1)

    def diffs(ci):
        a = comps[ci]
        h, v = factors[ci]
        ch, cw = -(-H * v // vmax), -(-W * h // hmax)
        d = np.zeros_like(a)
        rows_per_interval = restart_rows * v if restart_rows else 0
        for y in range(a.shape[0]):
            first = y == 0 or (rows_per_interval
                               and y % rows_per_interval == 0)
            for x in range(a.shape[1]):
                if y >= ch or x >= cw:
                    pred = 0  # padding: any difference will do
                elif first:
                    pred = init if x == 0 else a[y, x - 1]
                elif x == 0:
                    pred = a[y - 1, 0]
                else:
                    pred = _ll_predict(predictor, a[y, x - 1], a[y - 1, x],
                                       a[y - 1, x - 1])
                d[y, x] = (a[y, x] - pred) & 0xFFFF
        return d

    def scan(members):
        ds = {ci: diffs(ci) for ci in members}
        out, acc, nacc = bytearray(), 0, 0

        def put(code, length):
            nonlocal acc, nacc
            acc = (acc << length) | code
            nacc += length
            while nacc >= 8:
                byte = (acc >> (nacc - 8)) & 255
                out.append(byte)
                if byte == 255:
                    out.append(0)
                nacc -= 8
                acc &= (1 << nacc) - 1

        def flush():
            nonlocal acc, nacc
            if nacc:
                put((1 << (8 - nacc)) - 1, 8 - nacc)

        one = len(members) == 1
        if one:  # a non-interleaved scan's MCU is one sample
            h, v = factors[members[0]]
            cw, ch = -(-W * h // hmax), -(-H * v // vmax)
            rows, cols = ch, cw
            units = [(members[0], 0, 0)]
        else:
            rows, cols = my, mx
            units = [(ci, yy, xx) for ci in members
                     for yy in range(factors[ci][1])
                     for xx in range(factors[ci][0])]
        rst = 0
        for r in range(rows):
            if restart_rows and r and r % restart_rows == 0:
                flush()
                out.extend(bytes([0xFF, 0xD0 + rst % 8]))
                rst += 1
            for c in range(cols):
                for ci, yy, xx in units:
                    h, v = factors[ci]
                    y, x = (r, c) if one else (r * v + yy, c * h + xx)
                    dv = int(ds[ci][y, x])
                    if dv >= 32768:
                        dv -= 65536
                    if dv == -32768:
                        put(*table[16])
                        continue
                    nb = abs(dv).bit_length()
                    put(*table[nb])
                    if nb:
                        put(dv if dv >= 0 else dv + (1 << nb) - 1, nb)
        flush()
        return bytes(out), (cols if one else mx)

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
            + payload

    out = b"\xff\xd8"
    if markers == "jfif":
        out += seg(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    elif markers == "adobe":
        out += seg(0xEE, b"Adobe\0\x64\0\0\0\0\0")
    sof = struct.pack(">BHHB", precision, H, W, n)
    for i, (h, v) in enumerate(factors):
        sof += bytes([ids[i], (h << 4) | v, 0])
    out += seg(0xC3, sof)
    out += seg(0xC4, b"\x00" + bytes(_LL_BITS) + bytes(_LL_VALS))
    for members in scans or [list(range(n))]:
        data, per_row = scan(members)
        if restart_rows:
            out += seg(0xDD, struct.pack(">H", restart_rows * per_row))
        sos = bytes([len(members)])
        for ci in members:
            sos += bytes([ids[ci], 0x00])
        out += seg(0xDA, sos + bytes([predictor, 0, pt])) + data
    return out + b"\xff\xd9"


def sgi_bytes(planes, bpc=1, rle=True, dimension=None, row_order=None):
    """An SGI image of `planes` [bands, H, W] (values < 256 ** bpc), rows
    stored bottom first: raw, or RLE with repeat runs of 3 or more values
    and copy runs otherwise (up to 127 values a chunk, a 0 chunk ending
    each row), the offset and length tables first. `row_order` permutes
    where each (band, row)'s chunk list is stored."""
    p = np.asarray(planes, np.int64)
    z, h, w = p.shape
    dim = dimension or (1 if z == 1 and h == 1 else 2 if z == 1 else 3)
    head = struct.pack(">HBBHHHHII4s80sI", 474, 1 if rle else 0, bpc, dim, w,
                       h, z, 0, 255 if bpc == 1 else 65535, b"", b"x", 0)
    head = head.ljust(512, b"\0")
    fmt = ">u1" if bpc == 1 else ">u2"
    rows = p[:, ::-1]  # bottom row first
    if not rle:
        return head + rows.astype(fmt).tobytes()

    def encode(row):
        out, i = [], 0
        while i < w:
            j = i
            while j + 1 < w and row[j + 1] == row[i] and j - i < 126:
                j += 1
            if j - i >= 2:
                out += [j - i + 1, int(row[i])]
                i = j + 1
                continue
            j = i
            while j < w and j - i < 127 and not (
                    j + 2 < w and row[j] == row[j + 1] == row[j + 2]):
                j += 1
            out += [0x80 | (j - i)] + [int(v) for v in row[i:j]]
            i = j
        return np.array(out + [0], np.int64).astype(fmt).tobytes()

    chunks = [encode(rows[b, y]) for b in range(z) for y in range(h)]
    order = row_order or list(range(len(chunks)))
    base = 512 + 8 * len(chunks)
    offsets, data = [0] * len(chunks), b""
    for k in order:
        offsets[k] = base + len(data)
        data += chunks[k]
    return (head + struct.pack(f">{len(chunks)}I", *offsets)
            + struct.pack(f">{len(chunks)}I", *[len(c) for c in chunks])
            + data)


def pcx_bytes(lines, w, h, bits, planes, *, version=5, palette=None,
              stride=None, runs=True, trailer=None):
    """A PCX file: `lines` [h, planes * stride] bytes (each plane's bytes
    of a row, `stride` apart), RLE-coded per row (runs of 2 or more and
    every byte of 0xC0 or more as a run), `palette` (16 RGB) in the
    header, `trailer` (the 769-byte 8-bit palette block) appended."""
    stride = stride or ((w * bits + 7) // 8 + ((w * bits + 7) // 8) % 2)
    head = bytearray(128)
    head[0:4] = bytes([10, version, 1, bits])
    struct.pack_into("<HHHHHH", head, 4, 0, 0, w - 1, h - 1, 72, 72)
    if palette is not None:
        pal = np.asarray(palette, np.uint8).reshape(-1)[:48]
        head[16:16 + 48] = pal.tobytes()
    head[65] = planes
    struct.pack_into("<HH", head, 66, stride, 1)
    out = bytearray(head)
    for row in np.asarray(lines, np.uint8).reshape(h, -1):
        i, n = 0, len(row)
        while i < n:
            j = i
            while runs and j + 1 < n and row[j + 1] == row[i] and j - i < 62:
                j += 1
            if j > i or row[i] >= 0xC0:
                out += bytes([0xC0 | (j - i + 1), row[i]])
            else:
                out.append(row[i])
            i = j + 1
    return bytes(out) + (trailer or b"")


def dib_frame(dib: bytes, mask=True) -> bytes:
    """PIL's DIB of an image as an icon or cursor frame: the header's
    height doubled and, with `mask`, a blank AND mask (rows of 32-bit
    words) appended."""
    d = bytearray(dib)
    hs, = struct.unpack_from("<I", d, 0)
    if hs == 12:
        w, h = struct.unpack_from("<HH", d, 4)
        struct.pack_into("<H", d, 6, 2 * h)
    else:
        w, h = struct.unpack_from("<ii", d, 4)
        struct.pack_into("<i", d, 8, 2 * h)
    if mask:
        d += bytes((w + 31) // 32 * 4 * abs(h))
    return bytes(d)


def icon_bytes(frames, cursor=False) -> bytes:
    """An ICO (or CUR) of `frames`: (width byte, height byte, colour count,
    planes or hotspot x, bpp or hotspot y, frame bytes: PNG or DIB)."""
    out = struct.pack("<HHH", 0, 2 if cursor else 1, len(frames))
    at = 6 + 16 * len(frames)
    data = b""
    for w, h, ncol, a, b, blob in frames:
        out += struct.pack("<BBBBHHII", w, h, ncol, 0, a, b, len(blob),
                           at + len(data))
        data += blob
    return out + data


def spider_bytes(f, big=True, stack=False) -> bytes:
    """A SPIDER image of float32 `f` [H, W]: the 1024-byte-record header
    (labrec 1, lenbyt 4 * W rounded to a record) in either byte order,
    alone or as the first image of a stack (its own header after the
    stack's)."""
    f = np.asarray(f, np.float32)
    h, w = f.shape
    lenbyt = 4 * w
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    hdr = np.zeros(labbyt // 4, np.float32)
    hdr[[0, 1, 4, 11, 12, 21, 22]] = [1, h, 1, w, labrec, labbyt, lenbyt]
    dt = ">f4" if big else "<f4"
    if stack:
        top = hdr.copy()
        top[23], top[25] = 2, 1  # istack, maxim
        one = hdr.copy()
        one[26] = 1  # imgnum
        return (top.astype(dt).tobytes() + one.astype(dt).tobytes()
                + f.astype(dt).tobytes())
    return hdr.astype(dt).tobytes() + f.astype(dt).tobytes()
