// PSD (Photoshop) for csrc/imgdecode.cpp, which includes this file after
// its shared helpers: the merged image as PIL's PsdImagePlugin opens it,
// then convert("RGB").
//
// PIL's modes by (colour mode, depth): bitmap at 1 bit ("1": a set bit is
// white), grayscale, duotone and multichannel as "L" (the first channel),
// indexed (a 768-byte colour table, else black), RGB (RGBA with exactly 4
// channels), CMYK (each channel inverted, then PIL's cmyk2rgb). Channel
// data raw or PackBits (PackbitsDecode.c: what a run or literal puts past
// the row's end is dropped). PIL's own quirks are kept: it reads the
// PackBits byte-count table for the channels of its mode only, so with
// extra channels the data it decodes starts inside the table, and raw
// channels are taken width * height bytes apart whatever the depth. Lab opens in PIL and is
// refused here (status 1); other depths, ZIP channel data and short files
// PIL fails on (status 2).

namespace {

void decode_psd(const uint8_t* d, size_t n, Image& img) {
  if (n < 26 || std::memcmp(d, "8BPS", 4) != 0 || be16(d + 4) != 1)
    invalid("not a PSD file");
  const int channels_in_file = int(be16(d + 12));
  const int64_t h = be32(d + 14), w = be32(d + 18);
  const int bits = int(be16(d + 22)), cmode = int(be16(d + 24));
  enum { BIT, GRAY, PAL, RGB3, RGBA4, CMYK } mode;
  int channels;
  if (bits == 1 && cmode == 0) {
    mode = BIT, channels = 1;
  } else if (bits == 8 && (cmode == 0 || cmode == 1 || cmode == 7 ||
                           cmode == 8)) {
    mode = GRAY, channels = 1;
  } else if (bits == 8 && cmode == 2) {
    mode = PAL, channels = 1;
  } else if (bits == 8 && cmode == 3) {
    mode = RGB3, channels = 3;
  } else if (bits == 8 && cmode == 4) {
    mode = CMYK, channels = 4;
  } else if (bits == 8 && cmode == 9) {
    throw Unsupported("Lab PSD is not decoded by craytracer_tpu_torch "
                      "(bitmap, grayscale, indexed, RGB and CMYK PSD are)");
  } else {
    invalid("PSD mode or depth PIL does not open");
  }
  if (channels > channels_in_file) invalid("not enough PSD channels");
  if (mode == RGB3 && channels_in_file == 4) mode = RGBA4, channels = 4;
  size_t pos = 26;
  // PIL reads with fp.read: short reads past the end, never an error
  auto read = [&](size_t k) {
    size_t p = pos;
    pos = std::min(n, pos + k);
    return std::make_pair(d + p, pos - p);
  };
  auto read32 = [&]() {
    auto r = read(4);
    if (r.second < 4) invalid("truncated PSD");
    return be32(r.first);
  };
  uint8_t pal[256][3] = {};
  {
    uint32_t size = read32();
    auto r = read(size);
    if (mode == PAL && size == 768 && r.second == 768)
      for (int i = 0; i < 256; i++)
        for (int c = 0; c < 3; c++) pal[i][c] = r.first[c * 256 + i];
  }
  {
    uint32_t size = read32();
    size_t end = pos + size;
    while (size && pos < end) {
      read(4);
      read(2);
      auto len = read(1);
      if (!len.second) invalid("truncated PSD resource");
      size_t nl = *len.first;
      read(nl);
      if (!(nl & 1)) read(1);
      uint32_t dl = read32();
      read(dl);
      if (dl & 1) read(1);
    }
  }
  {
    uint32_t size = read32();
    if (size) {
      size_t end = pos + size;
      read(4);
      pos = end;  // a seek: may point past the end
    }
  }
  if (pos + 2 > n) invalid("truncated PSD");
  const int compression = int(be16(d + pos));
  pos += 2;
  if (compression > 1) invalid("PSD channel compression PIL does not read");
  img.alloc(w, h);
  const size_t row = mode == BIT ? size_t((w + 7) / 8) : size_t(w);
  std::vector<std::vector<uint8_t>> planes(channels);
  if (compression == 0) {
    size_t off = pos;
    for (int c = 0; c < channels; c++) {
      if (off > n || (n - off) / row < size_t(h)) invalid("truncated PSD data");
      planes[c].assign(d + off, d + off + row * size_t(h));
      off += size_t(w * h);
    }
  } else {
    if ((n - pos) / 2 < size_t(channels) * size_t(h))
      invalid("truncated PSD byte counts");
    const uint8_t* counts = d + pos;
    size_t off = pos + size_t(channels) * size_t(h) * 2;
    size_t ci = 0;
    for (int c = 0; c < channels; c++) {
      std::vector<uint8_t>& out = planes[c];
      out.reserve(row * size_t(h));
      size_t p = off, x = 0;
      std::vector<uint8_t> line(row);
      while (out.size() < row * size_t(h)) {
        if (p >= n) invalid("truncated PSD PackBits data");
        int b = d[p];
        if (b == 0x80) {
          p++;
          continue;
        }
        if (b & 0x80) {
          if (p + 2 > n) invalid("truncated PSD PackBits data");
          for (int k = 257 - b; k > 0 && x < row; k--) line[x++] = d[p + 1];
          p += 2;
        } else {
          if (p + size_t(b) + 2 > n) invalid("truncated PSD PackBits data");
          for (int k = 1; k < b + 2 && x < row; k++) line[x++] = d[p + k];
          p += size_t(b) + 2;
        }
        if (x >= row) {
          out.insert(out.end(), line.begin(), line.end());
          x = 0;
        }
      }
      for (int64_t y = 0; y < h; y++, ci += 2) off += be16(counts + ci);
    }
  }
  for (int64_t y = 0; y < h; y++)
    for (int64_t x = 0; x < w; x++) {
      const size_t i = size_t(y) * row + size_t(x);
      uint8_t* o = img.px(x, y);
      switch (mode) {
        case BIT: {
          uint8_t v = (planes[0][size_t(y) * row + size_t(x / 8)] >>
                       (7 - x % 8)) & 1 ? 255 : 0;
          o[0] = o[1] = o[2] = v;
          break;
        }
        case GRAY:
          o[0] = o[1] = o[2] = planes[0][i];
          break;
        case PAL:
          std::memcpy(o, pal[planes[0][i]], 3);
          break;
        case CMYK:
          cmyk_to_rgb(o, 255 - planes[0][i], 255 - planes[1][i],
                      255 - planes[2][i], 255 - planes[3][i]);
          break;
        default:
          for (int c = 0; c < 3; c++) o[c] = planes[c][i];
      }
    }
}

}  // namespace
