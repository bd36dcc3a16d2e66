"""OpenEXR reader and writer in zlib and numpy (the port's copy of
craytracer_tpu/io/exr.py: `read_exr` :40, `write_exr` :131).

Single-part scanline images, NONE, ZIPS (1 line per block) or ZIP (16
lines per block) compression, HALF and FLOAT channels: what lat-long HDR
environment maps use (readRgba1, imagefile.h:11-34). `read_exr` returns
[H, W, 3] float32 (R, G, B; an absent channel reads 0); `write_exr`
writes FLOAT R/G/B with ZIP, storing a block raw where zip does not
shrink it, and round-trips bit for bit through `read_exr`. Anything
else (multi-part, tiled, PIZ/PXR24/B44/DWA compression) raises
NotImplementedError naming what it found.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}  # UINT, HALF, FLOAT
_LINES_PER_BLOCK = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP
_COMPRESSION_NAMES = {1: "RLE", 4: "PIZ", 5: "PXR24", 6: "B44", 7: "B44A",
                      8: "DWAA", 9: "DWAB"}


def _read_null_str(buf, pos):
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _unzip_block(data: bytes) -> bytes:
    """zlib, then the predictor t[i] = t[i-1] + d[i] - 128 (t[0] = d[0]),
    then the first half to even bytes and the second half to odd ones."""
    d = np.frombuffer(zlib.decompress(data), np.uint8).astype(np.int64)
    d[1:] = d[1:] - 128
    t = np.cumsum(d) & 0xFF
    out = np.empty(len(t), np.uint8)
    half = (len(t) + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _zip_block(raw: bytes) -> bytes:
    """The inverse of `_unzip_block`."""
    t = np.frombuffer(raw, np.uint8)
    half = (len(t) + 1) // 2
    re = np.empty(len(t), np.uint8)
    re[:half] = t[0::2]
    re[half:] = t[1::2]
    d = re.astype(np.int64)
    d[1:] = (d[1:] - d[:-1] + 128) & 0xFF
    return zlib.compress(d.astype(np.uint8).tobytes())


def read_exr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path} is not an EXR file")
    if version & 0x1A00:
        raise NotImplementedError(
            f"{path}: tiled, deep or multi-part EXR (version flags "
            f"{version:#x}); only single-part scanline EXR is decoded")
    pos = 8
    channels = []  # (name, pixel type)
    compression = 0
    data_window = None
    while buf[pos] != 0:
        name, pos = _read_null_str(buf, pos)
        _, pos = _read_null_str(buf, pos)  # attribute type
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        val = buf[pos:pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while val[cpos] != 0:
                cname, cpos = _read_null_str(val, cpos)
                (ptype,) = struct.unpack_from("<i", val, cpos)
                cpos += 16  # pixel type, pLinear, reserved, x/y sampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", val)
    pos += 1
    if compression not in _LINES_PER_BLOCK:
        raise NotImplementedError(
            f"{path}: EXR compression "
            f"{_COMPRESSION_NAMES.get(compression, compression)}; only NONE, "
            "ZIPS and ZIP are decoded")
    x_min, y_min, x_max, y_max = data_window
    width = x_max - x_min + 1
    height = y_max - y_min + 1
    lines_per_block = _LINES_PER_BLOCK[compression]
    num_blocks = (height + lines_per_block - 1) // lines_per_block
    # channels are stored sorted by name, each line channel after channel
    ch_sorted = sorted(channels, key=lambda c: c[0])
    dtypes = [_PIXEL_DTYPES[c[1]] for c in ch_sorted]
    line_bytes = sum(np.dtype(d).itemsize for d in dtypes) * width
    pos += 8 * num_blocks  # the offset table; the blocks follow in order
    planes = {name: np.zeros((height, width), np.float32)
              for name, _ in ch_sorted}
    for _ in range(num_blocks):
        y, nbytes = struct.unpack_from("<ii", buf, pos)
        pos += 8
        data = buf[pos:pos + nbytes]
        pos += nbytes
        y0 = y - y_min
        nlines = min(lines_per_block, height - y0)
        expect = line_bytes * nlines
        if compression == 0 or nbytes >= expect:
            raw = data[:expect]
        else:
            raw = _unzip_block(data)[:expect]
        off = 0
        for li in range(nlines):
            for (name, _), dt in zip(ch_sorted, dtypes):
                row = np.frombuffer(raw, dt, count=width, offset=off)
                planes[name][y0 + li] = row.astype(np.float32)
                off += np.dtype(dt).itemsize * width
    zero = np.zeros((height, width), np.float32)
    return np.stack([planes.get(c, zero) for c in "RGB"], axis=-1)


def write_exr(path: str, img: np.ndarray):
    """[H, W, 3] -> scanline EXR, FLOAT B/G/R channels, ZIP."""
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("write_exr expects [H, W, 3]")
    height, width = img.shape[:2]

    def attr(name: bytes, atype: bytes, val: bytes) -> bytes:
        return (name + b"\x00" + atype + b"\x00"
                + struct.pack("<i", len(val)) + val)

    def chan(name: bytes) -> bytes:
        # FLOAT, pLinear 0, reserved, x/y sampling 1
        return name + b"\x00" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)

    dw = struct.pack("<iiii", 0, 0, width - 1, height - 1)
    header = b"".join([
        attr(b"channels", b"chlist",
             chan(b"B") + chan(b"G") + chan(b"R") + b"\x00"),
        attr(b"compression", b"compression", bytes([3])),
        attr(b"dataWindow", b"box2i", dw),
        attr(b"displayWindow", b"box2i", dw),
        attr(b"lineOrder", b"lineOrder", bytes([0])),
        attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
        attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0)),
        attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
        b"\x00",
    ])
    lines = _LINES_PER_BLOCK[3]
    blocks = []
    for y0 in range(0, height, lines):
        raw = b"".join(img[li, :, c].tobytes()
                       for li in range(y0, min(y0 + lines, height))
                       for c in (2, 1, 0))
        comp = _zip_block(raw)
        blocks.append((y0, comp if len(comp) < len(raw) else raw))
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        cur = f.tell() + 8 * len(blocks)
        offsets = []
        for _, comp in blocks:
            offsets.append(cur)
            cur += 8 + len(comp)
        f.write(b"".join(struct.pack("<Q", o) for o in offsets))
        for y0, comp in blocks:
            f.write(struct.pack("<ii", y0, len(comp)))
            f.write(comp)
