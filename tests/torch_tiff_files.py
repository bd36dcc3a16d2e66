"""TIFF, DDS and PSD files written byte by byte for the tests of the
port's decoders (craytracer_tpu_torch/csrc/imgdecode_tiff.h, _dds.h,
_psd.h), with the layouts PIL does not write: TIFF of any byte order,
BigTIFF, strips or tiles, planar configuration, fill order, bit depth,
sample format, photometric, predictor and compression (none, PackBits,
LZW, Deflate, JPEG strips from PIL's encoder with or without JPEGTables);
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
               extra_tags=(), spp_tag=True, tag_order=None):
    """A TIFF of `samples` [H, W, spp] (float for sample_format 3) at
    `bps` bits. `jpeg` is a callable giving the JPEG bytes of a segment's
    samples [h, w, spp] (compression 7); `jpeg_tables` goes in as the
    JPEGTables tag. `extra_tags` adds (tag, type, values) entries."""
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
            if compression == 5:
                raw = lzw_tiff(raw)
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
