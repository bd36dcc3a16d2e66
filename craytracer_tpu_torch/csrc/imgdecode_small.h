// The small formats of PIL's plugins for csrc/imgdecode.cpp, which
// includes this file after its shared helpers (the BMP core and the PNG
// decoder among them): QOI, SGI, PCX, DIB, ICO, CUR, IM, XBM and SPIDER,
// each to what PIL 12.1's plugin and Image.convert("RGB") give.
//
// - QOI: QoiImagePlugin's Python decoder op for op (a run does not enter
//   the index; an index never written reads 0, 0, 0, 0).
// - SGI: raw (one plane a band, 8 bit, or 16 bit through the high byte)
//   and RLE (SgiRleDecode.c: the row buffer carries over between rows, a
//   row's chunk count is its byte length, an overrun fails).
// - PCX: PcxDecode.c, its plane repacking included, then the unpackers of
//   1, P;2L, P;4L, L (or P, from the 769-byte trailer) and RGB;L.
// - DIB, ICO, CUR: the BMP core at the header's offset; the icon's XOR
//   half; the entry PIL picks (ICO: the largest, then the smallest colour
//   depth; CUR: the first, replaced by any larger in both sides); an ICO
//   entry may hold a PNG. The AND mask or alpha only has to be there.
// - IM: the text header as ImImagePlugin parses it, the LUT, then the raw
//   modes PIL reads bottom-up (and the bit decoder of L*N images).
// - XBM: the header regex, then XbmDecode.c's hex scan ("1;R" bits).
// - SPIDER: the float header, either byte order, then F -> L truncating.
//
// A failure inside the plugin's _open that PIL's Image.open answers by
// trying the next plugin is status 3 (HandOnErr).

namespace {

// ---------------------------------------------------------------- QOI

void decode_qoi(const uint8_t* d, size_t n, Image& img) {
  if (n < 13 || std::memcmp(d, "qoif", 4) != 0)
    throw HandOnErr("not a QOI file");
  // 3 or 4 channels decode alike: convert("RGB") drops the alpha
  const int64_t w = be32(d + 4), h = be32(d + 8);
  img.alloc(w, h);
  const size_t want = size_t(w) * size_t(h);
  size_t p = 14, got = 0;  // pixels written
  uint8_t px[4] = {0, 0, 0, 255};
  uint8_t seen[64][4] = {};
  bool have[64] = {};
  auto byte = [&]() -> int {
    if (p >= n) invalid("QOI data ends early");
    return d[p++];
  };
  auto emit = [&](const uint8_t* v, size_t k) {
    for (size_t i = 0; i < k && got < want; i++, got++)
      std::memcpy(&img.rgb[got * 3], v, 3);
  };
  while (got < want) {
    const int b = byte();
    uint8_t v[4];
    if (b == 0xFE) {
      if (n - p < 3) invalid("QOI data ends early");
      v[0] = d[p], v[1] = d[p + 1], v[2] = d[p + 2], v[3] = px[3];
      p += 3;
    } else if (b == 0xFF) {
      if (n - p < 4) invalid("QOI data ends early");
      std::memcpy(v, d + p, 4);
      p += 4;
    } else if ((b >> 6) == 0) {
      if (have[b & 63])
        std::memcpy(v, seen[b & 63], 4);
      else
        std::memset(v, 0, 4);
    } else if ((b >> 6) == 1) {
      v[0] = uint8_t(px[0] + ((b >> 4) & 3) - 2);
      v[1] = uint8_t(px[1] + ((b >> 2) & 3) - 2);
      v[2] = uint8_t(px[2] + (b & 3) - 2);
      v[3] = px[3];
    } else if ((b >> 6) == 2) {
      const int b2 = byte();
      const int dg = (b & 63) - 32;
      v[0] = uint8_t(px[0] + dg + ((b2 >> 4) - 8));
      v[1] = uint8_t(px[1] + dg);
      v[2] = uint8_t(px[2] + dg + ((b2 & 15) - 8));
      v[3] = px[3];
    } else {  // a run repeats the last pixel and leaves the index alone
      emit(px, size_t(b & 63) + 1);
      continue;
    }
    std::memcpy(px, v, 4);
    const int hsh = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    std::memcpy(seen[hsh], v, 4);
    have[hsh] = true;
    emit(v, 1);
  }
}

// ---------------------------------------------------------------- SGI

void decode_sgi(const uint8_t* d, size_t n, Image& img) {
  if (n < 12 || be16(d) != 474) throw HandOnErr("not an SGI file");
  const int comp = d[2], bpc = d[3];
  const int dim = int(be16(d + 4));
  const int64_t w = be16(d + 6), h = be16(d + 8);
  const int zsize = int(be16(d + 10));
  // SgiImagePlugin.MODES by (bpc, dimension, zsize)
  int bands = 0;
  if ((bpc == 1 || bpc == 2) && (dim == 1 || dim == 2) && zsize == 1)
    bands = 1;
  else if ((bpc == 1 || bpc == 2) && dim == 3 && (zsize == 3 || zsize == 4))
    bands = zsize;
  if (!bands) invalid("Unsupported SGI image mode");
  if (w <= 0 || h <= 0) throw HandOnErr("SGI image of size 0");
  if (comp != 0 && comp != 1) invalid("SGI compression PIL cannot load");
  img.alloc(w, h);
  // the value of band b at (x, y) (y from the top) into the image
  std::vector<uint8_t> planes(size_t(w) * size_t(h) * size_t(bands));
  auto at = [&](int b, int64_t x, int64_t y) -> uint8_t& {
    return planes[(size_t(y) * size_t(w) + size_t(x)) * size_t(bands) +
                  size_t(b)];
  };
  if (comp == 0) {
    const size_t page = size_t(w) * size_t(h) * size_t(bpc);
    if (n - 512 < page * size_t(bands) || n < 512)
      invalid("truncated SGI image data");
    for (int b = 0; b < bands; b++)
      for (int64_t r = 0; r < h; r++)
        for (int64_t x = 0; x < w; x++)
          at(b, x, h - 1 - r) =
              d[512 + page * size_t(b) + (size_t(r) * size_t(w) + size_t(x)) *
                                              size_t(bpc)];
  } else {
    // SgiRleDecode.c
    if (n < 512) invalid("truncated SGI file");
    const uint64_t bufsize = n - 512;
    const uint64_t tablen = uint64_t(bands) * uint64_t(h);
    if (bufsize < 8 * tablen) invalid("SGI RLE tables past the file");
    const uint8_t* buf = d + 512;
    const size_t rowbytes = size_t(w) * size_t(bands) * size_t(bpc);
    std::vector<uint8_t> row(rowbytes, 0);  // carried from row to row
    const uint8_t* end = buf + bufsize - 1;   // the last byte
    for (int64_t rowno = 0; rowno < h; rowno++) {
      bool stop = false;
      for (int ch = 0; ch < bands && !stop; ch++) {
        const uint64_t ti = uint64_t(rowno) + uint64_t(ch) * uint64_t(h);
        uint64_t off = be32(buf + 4 * ti);
        const uint64_t len = be32(buf + 4 * (tablen + ti));
        if (off < 512) invalid("SGI RLE offset inside the header");
        off -= 512;
        if (off + len > bufsize) invalid("SGI RLE row past the file");
        const uint8_t* src = buf + off;
        uint8_t* dest = row.data() + size_t(ch) * size_t(bpc);
        const size_t step = size_t(bands) * size_t(bpc);
        int64_t x = 0;
        int status = 0;
        for (int64_t k = int64_t(len); k > 0; k--) {
          int pixel;
          if (bpc == 1) {
            if (src > end) { status = -1; break; }
            pixel = *src++;
          } else {
            if (src + 1 > end) { status = -1; break; }
            pixel = src[1];
            src += 2;
          }
          if (k == 1 && pixel != 0) { status = 1; break; }
          int count = pixel & 0x7F;
          if (!count) break;
          if (x + count > w) { status = -1; break; }
          x += count;
          if (pixel & 0x80) {
            if (src + size_t(count) * size_t(bpc) > end) {
              status = -1;
              break;
            }
            while (count--) {
              std::memcpy(dest, src, size_t(bpc));
              src += bpc;
              dest += step;
            }
          } else {
            if (bpc == 1 ? src > end : src + 2 > end) { status = -1; break; }
            while (count--) {
              std::memcpy(dest, src, size_t(bpc));
              dest += step;
            }
            src += bpc;
          }
        }
        if (status == -1) invalid("SGI RLE overrun");
        if (status == 1) stop = true;  // PIL stops here without an error
      }
      if (stop) break;
      for (int64_t xx = 0; xx < w; xx++)
        for (int b = 0; b < bands; b++)
          at(b, xx, h - 1 - rowno) =
              row[(size_t(xx) * size_t(bands) + size_t(b)) * size_t(bpc)];
    }
  }
  for (int64_t y = 0; y < h; y++)
    for (int64_t x = 0; x < w; x++) {
      if (bands == 1) {
        const int v = at(0, x, y);
        img.put(x, y, v, v, v);
      } else {
        img.put(x, y, at(0, x, y), at(1, x, y), at(2, x, y));
      }
    }
}

// ---------------------------------------------------------------- PCX

void decode_pcx(const uint8_t* d, size_t n, Image& img) {
  if (n < 68 || d[0] != 10 || !(d[1] == 0 || d[1] == 2 || d[1] == 3 ||
                                d[1] == 5))
    throw HandOnErr("not a PCX file");
  const int64_t x0 = le16(d + 4), y0 = le16(d + 6);
  const int64_t x1 = int64_t(le16(d + 8)) + 1, y1 = int64_t(le16(d + 10)) + 1;
  if (x1 <= x0 || y1 <= y0) throw HandOnErr("bad PCX image size");
  const int version = d[1], bits = d[3], planes = d[65];
  const int64_t provided = le16(d + 66);
  const int64_t w = x1 - x0, h = y1 - y0;
  enum { ONE, P2L, P4L, L8, RGBL } kind;
  Palette pal;
  bool paletted = false;
  if (bits == 1 && planes == 1) {
    kind = ONE;
  } else if (bits == 1 && (planes == 2 || planes == 4)) {
    kind = planes == 2 ? P2L : P4L;
    paletted = true;
    for (int i = 0; i < 16; i++)
      for (int c = 0; c < 3; c++) pal.rgb[i][c] = d[16 + 3 * i + c];
  } else if (version == 5 && bits == 8 && planes == 1) {
    kind = L8;
    if (n < 769) invalid("PCX shorter than its palette");
    const uint8_t* s = d + n - 769;
    if (s[0] == 12) {
      for (int i = 0; i < 256 && !paletted; i++)
        if (s[1 + 3 * i] != i || s[2 + 3 * i] != i || s[3 + 3 * i] != i)
          paletted = true;
      if (paletted)
        for (int i = 0; i < 256; i++)
          for (int c = 0; c < 3; c++) pal.rgb[i][c] = s[1 + 3 * i + c];
    }
  } else if (version == 5 && bits == 8 && planes == 3) {
    kind = RGBL;
  } else {
    invalid("unknown PCX mode");
  }
  img.alloc(w, h);
  int64_t stride = (w * bits + 7) / 8;
  if (provided != stride) stride += stride % 2;
  const int64_t bytes = planes * stride;
  // the unpacker's bits per pixel: 1, P;2L 2, P;4L 4, L 8, RGB;L 24
  const int ubits = kind == ONE ? 1 : kind == P2L ? 2 : kind == P4L ? 4
                    : kind == L8 ? 8 : 24;
  if ((w * ubits + 7) / 8 > bytes) invalid("PCX line overrun");
  std::vector<uint8_t> line(static_cast<size_t>(bytes), 0);
  size_t p = 128;
  int64_t x = 0, y = 0;
  bool overrun = false;
  auto unpack = [&]() {
    // PcxDecode.c's plane repacking: P;2L and P;4L planes to (w + 7) / 8
    // bytes apart; other modes to w bytes apart, in bytes / w bands
    int64_t xs = w, nb = bytes / w, st = nb ? bytes / nb : 0;
    if (ubits == 2 || ubits == 4) {
      xs = (w + 7) / 8;
      nb = ubits;
      st = bytes / ubits;
    }
    if (st > xs)
      for (int64_t i = 1; i < nb; i++)
        std::memmove(&line[size_t(i * xs)], &line[size_t(i * st)],
                     size_t(xs));
    const int64_t s = (w + 7) / 8;
    for (int64_t i = 0; i < w; i++) {
      const int m = 128 >> (i & 7);
      const size_t j = size_t(i >> 3);
      switch (kind) {
        case ONE: {
          const int v = line[j] & m ? 255 : 0;
          img.put(i, y, v, v, v);
          break;
        }
        case P2L:
        case P4L: {
          int v = (line[j] & m ? 1 : 0) + (line[j + size_t(s)] & m ? 2 : 0);
          if (kind == P4L)
            v += (line[j + size_t(2 * s)] & m ? 4 : 0) +
                 (line[j + size_t(3 * s)] & m ? 8 : 0);
          img.put(i, y, pal.rgb[v][0], pal.rgb[v][1], pal.rgb[v][2]);
          break;
        }
        case L8: {
          const int v = line[size_t(i)];
          if (paletted)
            img.put(i, y, pal.rgb[v][0], pal.rgb[v][1], pal.rgb[v][2]);
          else
            img.put(i, y, v, v, v);
          break;
        }
        case RGBL:
          img.put(i, y, line[size_t(i)], line[size_t(i + w)],
                  line[size_t(i + 2 * w)]);
          break;
      }
    }
  };
  for (;;) {
    if (p >= n) invalid("truncated PCX image data");
    if ((d[p] & 0xC0) == 0xC0) {
      if (n - p < 2) invalid("truncated PCX image data");
      int k = d[p] & 0x3F;
      while (k > 0) {
        if (x >= bytes) {
          overrun = true;
          break;
        }
        line[size_t(x++)] = d[p + 1];
        k--;
      }
      p += 2;
    } else {
      line[size_t(x++)] = d[p++];
    }
    if (x >= bytes) {
      unpack();
      x = 0;
      if (++y >= h) break;
    }
  }
  if (overrun) invalid("PCX run past its line");
}

// ---------------------------------------------------------- DIB, ICO, CUR

int64_t half_rows(int64_t h) { return h / 2; }

void decode_dib(const uint8_t* d, size_t n, Image& img) {
  decode_bitmap(d, n, 0, 0, img, all_rows);
}

void decode_cur(const uint8_t* d, size_t n, Image& img) {
  if (n < 6 || std::memcmp(d, "\0\0\2\0", 4) != 0)
    throw HandOnErr("not a CUR file");
  const int count = int(le16(d + 4));
  size_t m = 0, mlen = 0;  // the chosen entry's place and bytes read
  size_t pos = 6;
  for (int i = 0; i < count; i++) {
    const size_t len = pos < n ? std::min<size_t>(16, n - pos) : 0;
    if (!mlen) {
      m = pos, mlen = len;
    } else {
      if (len < 1 || (d[pos] > d[m] && (len < 2 || mlen < 2)))
        throw HandOnErr("short CUR entry");
      if (d[pos] > d[m] && d[pos + 1] > d[m + 1]) m = pos, mlen = len;
    }
    pos += len;
  }
  if (!mlen) throw HandOnErr("No cursors were found");
  if (mlen < 16) throw HandOnErr("short CUR entry");
  size_t hpos = le32(d + m + 12);
  if (!hpos) hpos = pos;  // _bitmap(0) reads on where the entries end
  decode_bitmap(d, n, hpos, 0, img, half_rows);
}

void decode_ico(const uint8_t* d, size_t n, Image& img) {
  if (n < 6 || std::memcmp(d, "\0\0\1\0", 4) != 0)
    throw HandOnErr("not an ICO file");
  const int count = int(le16(d + 4));
  struct Entry {
    int64_t w, h, square, depth, bpp, size, offset;
  };
  std::vector<Entry> entries;
  for (int i = 0; i < count; i++) {
    const size_t p = 6 + 16 * size_t(i);
    if (p > n || n - p < 16) throw HandOnErr("short ICO entry");
    const uint8_t* s = d + p;
    Entry e;
    e.w = s[0] ? s[0] : 256;
    e.h = s[1] ? s[1] : 256;
    const int ncol = s[2];
    e.bpp = le16(s + 6);
    e.size = le32(s + 8);
    e.offset = le32(s + 12);
    e.square = e.w * e.h;
    e.depth = e.bpp ? e.bpp
                    : ncol ? int64_t(std::ceil(std::log(double(ncol)) /
                                               std::log(2.0)))
                           : 0;
    if (!e.depth) e.depth = 256;
    entries.push_back(e);
  }
  if (entries.empty()) throw HandOnErr("ICO without entries");
  // sorted by colour depth, then (stable) by size, largest first
  std::stable_sort(entries.begin(), entries.end(),
                   [](const Entry& a, const Entry& b) {
                     return a.depth < b.depth;
                   });
  std::stable_sort(entries.begin(), entries.end(),
                   [](const Entry& a, const Entry& b) {
                     return a.square > b.square;
                   });
  const Entry& e = entries[0];
  const size_t off = size_t(e.offset);
  if (off <= n && n - off >= 8 &&
      std::memcmp(d + off, "\x89PNG\r\n\x1a\n", 8) == 0) {
    decode_png(d + off, n - off, img);
    return;
  }
  Bitmap bm;
  const size_t start = decode_bitmap(d, n, off, 0, img, half_rows, &bm, true);
  // the mask PIL builds (and convert("RGB") drops) must be readable
  if (e.bpp == 32) {
    if (start > n || (n - start) / 4 < size_t(bm.w) * size_t(bm.h))
      invalid("ICO alpha shorter than its image");
  } else {
    const int64_t w32 = (bm.w + 31) / 32 * 32;
    const int64_t total = w32 * bm.h / 8;
    const int64_t at = e.offset + e.size - total;
    if (at < 0) invalid("ICO mask before the start of the file");
    if (at > int64_t(n) || int64_t(n) - at < total)
      invalid("ICO mask shorter than its image");
  }
}

// ----------------------------------------------------------------- IM

// a header number as Python's int() and float() see it: whitespace
// around it stripped
std::string py_strip(std::string t) {
  auto ws = [](char c) {
    return c == ' ' || (c >= '\t' && c <= '\r') || (c >= 0x1c && c <= 0x1f);
  };
  while (!t.empty() && ws(t.back())) t.pop_back();
  size_t i = 0;
  while (i < t.size() && ws(t[i])) i++;
  return t.substr(i);
}

// PIL's ycbcr2rgb (ConvertYCbCr.c): tables of (int)(f * (i - 128) * 64
// + 0.5), shifted down by 6
void ycbcr_to_rgb(int y, int cb, int cr, uint8_t* o) {
  struct T {
    int r_cr[256], g_cb[256], g_cr[256], b_cb[256];
    T() {
      for (int i = 0; i < 256; i++) {
        r_cr[i] = int(1.402 * (i - 128) * 64 + 0.5);
        g_cb[i] = int(-0.34414 * (i - 128) * 64 + 0.5);
        g_cr[i] = int(-0.71414 * (i - 128) * 64 + 0.5);
        b_cb[i] = int(1.772 * (i - 128) * 64 + 0.5);
      }
    }
  };
  static const T t;
  auto c = [](int v) { return uint8_t(v <= 0 ? 0 : v >= 255 ? 255 : v); };
  o[0] = c(y + (t.r_cr[cr] >> 6));
  o[1] = c(y + ((t.g_cb[cb] + t.g_cr[cr]) >> 6));
  o[2] = c(y + (t.b_cb[cb] >> 6));
}

void decode_im(const uint8_t* d, size_t n, Image& img) {
  if (!std::memchr(d, '\n', std::min<size_t>(n, 100)))
    throw HandOnErr("not an IM file");
  std::map<std::string, std::string> info;
  int tags = 0;
  std::string mode = "L", rawmode = "L";
  int64_t w = 512, h = 512;
  bool have_lut = false;
  size_t p = 0;
  int last = -1;  // the byte that ended the header, -1 at the end
  static const char* const TAGS[] = {
      "Comment", "Date", "Digitalization equipment",
      "File size (no of images)", "Lut", "Name", "Scale (x,y)",
      "Image size (x*y)", "Image type"};
  // ImImagePlugin.OPEN
  static const std::map<std::string, std::pair<std::string, std::string>>
      OPEN = [] {
        std::map<std::string, std::pair<std::string, std::string>> o = {
            {"0 1 image", {"1", "1"}},         {"L 1 image", {"1", "1"}},
            {"Greyscale image", {"L", "L"}},   {"Grayscale image", {"L", "L"}},
            {"RGB image", {"RGB", "RGB;L"}},   {"RLB image", {"RGB", "RLB"}},
            {"RYB image", {"RGB", "RLB"}},     {"B1 image", {"1", "1"}},
            {"B2 image", {"P", "P;2"}},        {"B4 image", {"P", "P;4"}},
            {"X 24 image", {"RGB", "RGB"}},    {"L 32 S image", {"I", "I;32"}},
            {"L 32 F image", {"F", "F;32"}},   {"RGB3 image", {"RGB", "RGB;T"}},
            {"RYB3 image", {"RGB", "RYB;T"}},  {"LA image", {"LA", "LA;L"}},
            {"PA image", {"LA", "PA;L"}},
            {"RGBA image", {"RGBA", "RGBA;L"}},
            {"RGBX image", {"RGB", "RGBX;L"}},
            {"CMYK image", {"CMYK", "CMYK;L"}},
            {"YCC image", {"YCbCr", "YCbCr;L"}}};
        for (const char* i : {"8", "8S", "16", "16S", "32", "32F"}) {
          o[std::string("L ") + i + " image"] = {"F", std::string("F;") + i};
          o[std::string("L*") + i + " image"] = {"F", std::string("F;") + i};
        }
        for (const char* i : {"16", "16L", "16B"}) {
          o[std::string("L ") + i + " image"] = {std::string("I;") + i,
                                                 std::string("I;") + i};
          o[std::string("L*") + i + " image"] = {std::string("I;") + i,
                                                 std::string("I;") + i};
        }
        o["L 32S image"] = o["L*32S image"] = {"I", "I;32S"};
        for (int j = 2; j < 33; j++)
          o["L*" + std::to_string(j) + " image"] = {"F",
                                                     "F;" + std::to_string(j)};
        return o;
      }();
  bool size_ok = true;  // the size is two Python ints
  for (;;) {
    if (p >= n) {
      last = -1;
      break;
    }
    int c = d[p++];
    if (c == '\r') continue;
    if (c == 0 || c == 0x1A) {
      last = c;
      break;
    }
    size_t q = p;
    while (q < n && d[q] != '\n') q++;
    if (q < n) q++;
    std::string s(reinterpret_cast<const char*>(d + p - 1), q - p + 1);
    p = q;
    if (s.size() > 100) throw HandOnErr("not an IM file");
    if (s.size() >= 2 && s.compare(s.size() - 2, 2, "\r\n") == 0)
      s.resize(s.size() - 2);
    else if (!s.empty() && s.back() == '\n')
      s.pop_back();
    // ^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$
    const size_t colon = s.find(':');
    if (s.empty() || !std::isalpha(uint8_t(s[0])) || colon == std::string::npos)
      throw HandOnErr("Syntax error in IM header");
    const std::string k = s.substr(0, colon);
    size_t vi = colon + 1;
    while (vi < s.size() && (s[vi] == ' ' || s[vi] == '\t')) vi++;
    std::string v = s.substr(vi);
    if (k == "File size (no of images)" || k == "Scale (x,y)" ||
        k == "Image size (x*y)") {
      std::replace(v.begin(), v.end(), '*', ',');
      std::vector<std::string> parts;
      size_t a = 0;
      for (;;) {
        size_t b = v.find(',', a);
        parts.push_back(v.substr(a, b == std::string::npos ? b : b - a));
        if (b == std::string::npos) break;
        a = b + 1;
      }
      bool ints = true;
      std::vector<int64_t> iv;
      for (const std::string& t : parts) {
        int64_t x;
        double f;
        if (py_int(py_strip(t), x)) {
          iv.push_back(x);
        } else {
          if (!py_float(py_strip(t), f)) invalid("bad number in IM header");
          ints = false;
        }
      }
      if (k == "Image size (x*y)") {
        if (parts.size() == 1) throw HandOnErr("IM size of one number");
        size_ok = ints && parts.size() == 2;
        if (size_ok) w = iv[0], h = iv[1];
      }
    } else if (k == "Image type") {
      auto it = OPEN.find(v);
      if (it != OPEN.end()) {
        mode = it->second.first;
        rawmode = it->second.second;
      } else {
        mode = v;
      }
    }
    if (k == "Lut") have_lut = true;
    for (const char* t : TAGS)
      if (k == t) tags++;
  }
  if (!tags) throw HandOnErr("Not an IM file");
  if (size_ok && (w <= 0 || h <= 0)) throw HandOnErr("IM image of size 0");
  // skip to the \x1a that starts the data
  while (last != -1 && last != 0x1A) last = p < n ? d[p++] : -1;
  if (last == -1) throw HandOnErr("File truncated");
  Palette pal;
  bool paletted = false;
  if (have_lut) {
    const size_t k = std::min<size_t>(768, n - p);
    const uint8_t* lut = d + p;
    bool grey = true;
    for (int i = 0; i < 256; i++) {  // palette[i] == [i + 256] == [i + 512]
      if (size_t(i + 256) >= k) throw HandOnErr("short IM LUT");
      if (lut[i] == lut[i + 256]) {
        if (size_t(i + 512) >= k) throw HandOnErr("short IM LUT");
        if (lut[i + 256] != lut[i + 512]) grey = false;
      } else {
        grey = false;
      }
    }
    if (!grey && (mode == "L" || mode == "LA" || mode == "P" || mode == "PA")) {
      if (mode == "L" || mode == "P") {
        mode = rawmode = "P";
      } else {
        mode = "PA";
        rawmode = "PA;L";
      }
      paletted = true;
      for (int i = 0; i < 256; i++)
        for (int c = 0; c < 3; c++) pal.rgb[i][c] = lut[i + 256 * c];
    }
    p += k;
  }
  if (!size_ok) invalid("IM size PIL cannot make an image of");
  // the raw modes PIL reads: bits per pixel of a row, and the decode
  struct Raw {
    const char* mode;
    const char* raw;
    int bits;
  };
  static const Raw RAWS[] = {
      {"1", "1", 1},          {"L", "L", 8},          {"P", "L", 8},
      {"P", "P", 8},          {"P", "P;2", 2},        {"P", "P;4", 4},
      {"PA", "PA;L", 16},     {"LA", "LA;L", 16},     {"RGB", "RGB;L", 24},
      {"RGB", "RGB", 24},     {"RGB", "RGBX;L", 32},  {"RGBA", "RGBA;L", 32},
      {"CMYK", "CMYK;L", 32}, {"YCbCr", "YCbCr;L", 24}, {"I", "I;32", 32},
      {"I", "I;32S", 32},     {"F", "F;32", 32},      {"F", "F;32F", 32},
      {"F", "F;8", 8},        {"F", "F;8S", 8},       {"F", "F;16", 16},
      {"F", "F;16S", 16},     {"I;16", "I;16", 16},   {"I;16L", "I;16L", 16},
      {"I;16B", "I;16B", 16}, {"RGB", "RGB;T", 8},    {"RGB", "RYB;T", 8}};
  const Raw* raw = nullptr;
  for (const Raw& r : RAWS)
    if (mode == r.mode && rawmode == r.raw) raw = &r;
  int fbits = 0;  // the bit decoder of F;N
  if (!raw && mode == "F" && rawmode.size() > 2 &&
      rawmode.compare(0, 2, "F;") == 0) {
    int64_t b;
    if (py_int(rawmode.substr(2), b) && b != 8 && b != 16 && b != 32)
      fbits = int(b);
  }
  if (!raw && !fbits) invalid("IM mode PIL does not read");
  img.alloc(w, h);
  if (fbits) {
    // BitDecode.c with (bits, pad 8, fill 3, unsigned, bottom-up): bits
    // taken from the low end of a buffer filled low byte first; at the end
    // of a row its count goes to 0 and its bits stay
    if (fbits < 1 || fbits >= 32) invalid("IM bit depth PIL cannot decode");
    const uint64_t mask = (uint64_t(1) << fbits) - 1;
    uint64_t buf = 0;
    int count = 0;
    int64_t x = 0, y = h - 1;
    for (size_t q = p; q < n; q++) {
      const uint8_t byte = d[q];
      buf |= uint64_t(byte) << count;
      count += 8;
      while (count >= fbits) {
        const uint64_t v = buf & mask;
        if (count > 32)
          buf = byte >> (8 - (count - fbits));
        else
          buf >>= fbits;
        count -= fbits;
        const uint8_t g = float_to_l(float(v));
        img.put(x, y, g, g, g);
        if (++x >= w) {
          if (--y < 0) return;
          x = 0;
          count = 0;  // the buffer keeps its bits, ORed with the next byte
        }
      }
    }
    invalid("truncated IM image data");
  }
  const std::string rm = raw->raw;
  if (rm == "RGB;T" || rm == "RYB;T") {  // three whole planes: G, R, B
    const size_t sz = size_t(w) * size_t(h);
    if (n - p < 3 * sz) invalid("truncated IM image data");
    for (int64_t r = 0; r < h; r++)
      for (int64_t x = 0; x < w; x++) {
        const size_t i = size_t(r) * size_t(w) + size_t(x);
        img.put(x, h - 1 - r, d[p + sz + i], d[p + i], d[p + 2 * sz + i]);
      }
    return;
  }
  const size_t stride = size_t((w * raw->bits + 7) / 8);
  if ((n - p) / stride < size_t(h)) invalid("truncated IM image data");
  for (int64_t r = 0; r < h; r++) {
    const uint8_t* s = d + p + size_t(r) * stride;
    const int64_t y = h - 1 - r;  // IM rows run bottom-up
    for (int64_t x = 0; x < w; x++) {
      uint8_t* o = img.px(x, y);
      auto gray = [&](int v) { o[0] = o[1] = o[2] = uint8_t(v); };
      auto index = [&](int v) {
        if (paletted) {
          std::memcpy(o, pal.rgb[v], 3);
        } else {
          gray(0);  // a P image without a palette converts to black
        }
      };
      if (rm == "1") {
        gray(s[x >> 3] & (128 >> (x & 7)) ? 255 : 0);
      } else if (rm == "L") {
        if (mode == "P") index(s[x]); else gray(s[x]);
      } else if (rm == "P") {
        index(s[x]);
      } else if (rm == "P;2") {
        index((s[x >> 2] >> (6 - 2 * (x & 3))) & 3);
      } else if (rm == "P;4") {
        index((s[x >> 1] >> (x & 1 ? 0 : 4)) & 15);
      } else if (rm == "PA;L") {
        index(s[x]);
      } else if (rm == "LA;L") {
        gray(s[x]);
      } else if (rm == "RGB;L" || rm == "RGBX;L" || rm == "RGBA;L") {
        o[0] = s[x], o[1] = s[x + w], o[2] = s[x + 2 * w];
      } else if (rm == "RGB") {
        std::memcpy(o, s + 3 * x, 3);
      } else if (rm == "CMYK;L") {
        cmyk_to_rgb(o, s[x], s[x + w], s[x + 2 * w], s[x + 3 * w]);
      } else if (rm == "YCbCr;L") {
        ycbcr_to_rgb(s[x], s[x + w], s[x + 2 * w], o);
      } else if (rm == "I;32" || rm == "I;32S") {
        const int32_t v = int32_t(le32(s + 4 * x));
        gray(v < 0 ? 0 : v > 255 ? 255 : v);
      } else if (rm == "F;32") {  // unsigned 32-bit to float
        gray(float_to_l(float(le32(s + 4 * x))));
      } else if (rm == "F;32F") {
        float f;
        std::memcpy(&f, s + 4 * x, 4);
        gray(float_to_l(f));
      } else if (rm == "F;8") {
        gray(s[x]);
      } else if (rm == "F;8S") {
        gray(float_to_l(float(int8_t(s[x]))));
      } else if (rm == "F;16") {
        gray(float_to_l(float(le16(s + 2 * x))));
      } else if (rm == "F;16S") {
        gray(float_to_l(float(int16_t(le16(s + 2 * x)))));
      } else if (rm == "I;16" || rm == "I;16L") {
        gray(std::min<int>(int(le16(s + 2 * x)), 255));
      } else {  // I;16B
        gray(std::min<int>(int(be16(s + 2 * x)), 255));
      }
    }
  }
}

// ---------------------------------------------------------------- XBM

// XbmImagePlugin.xbm_head over the first 512 bytes: the width, height and
// end of the match, or false
bool xbm_head(const uint8_t* d, size_t n, int64_t& w, int64_t& h,
              size_t& end) {
  const size_t L = std::min<size_t>(n, 512);
  auto sp = [](int c) { return c == ' ' || c == '\t'; };
  auto nl = [](int c) { return c == '\r' || c == '\n'; };
  // "#define[ \t]+" at i: the index after it, or npos
  auto define = [&](size_t i) -> size_t {
    if (L - std::min(L, i) < 8 || std::memcmp(d + i, "#define", 7) != 0 ||
        !sp(d[i + 7]))
      return std::string::npos;
    i += 7;
    while (i < L && sp(d[i])) i++;
    return i;
  };
  // "[ \t]+([0-9]+)[\r\n]+" at i: the index after it and the number
  auto number = [&](size_t i, int64_t& v) -> size_t {
    if (i >= L || !sp(d[i])) return std::string::npos;
    while (i < L && sp(d[i])) i++;
    if (i >= L || !std::isdigit(d[i])) return std::string::npos;
    v = 0;
    while (i < L && std::isdigit(d[i]))
      v = std::min<int64_t>(v * 10 + (d[i++] - '0'), int64_t(1) << 40);
    if (i >= L || !nl(d[i])) return std::string::npos;
    while (i < L && nl(d[i])) i++;
    return i;
  };
  // ".*<word>" then a number: candidates from the last one on the line
  auto line_field = [&](size_t i, const char* word, auto&& rest) -> bool {
    const size_t wl = std::strlen(word);
    size_t e = i;
    while (e < L && d[e] != '\n') e++;
    for (size_t k = e; k-- > i;) {
      if (k + wl > e || std::memcmp(d + k, word, wl) != 0) continue;
      int64_t v;
      const size_t j = number(k + wl, v);
      if (j != std::string::npos && rest(j, v)) return true;
    }
    return false;
  };
  // the end of the last "_bits[]" at or after i
  size_t bits_end = std::string::npos;
  for (size_t k = 0; k + 7 <= L; k++)
    if (std::memcmp(d + k, "_bits[]", 7) == 0) bits_end = k + 7;
  if (bits_end == std::string::npos) return false;
  size_t i = 0;
  while (i < L && (d[i] == ' ' || (d[i] >= '\t' && d[i] <= '\r'))) i++;
  const size_t a = define(i);
  if (a == std::string::npos) return false;
  return line_field(a, "_width", [&](size_t j, int64_t wv) {
    const size_t b = define(j);
    if (b == std::string::npos) return false;
    return line_field(b, "_height", [&](size_t k, int64_t hv) {
      if (bits_end - 7 < k) return false;
      w = wv, h = hv, end = bits_end;
      return true;
    });
  });
}

void decode_xbm(const uint8_t* d, size_t n, Image& img) {
  int64_t w, h;
  size_t p;
  if (!xbm_head(d, n, w, h, p)) throw HandOnErr("not a XBM file");
  if (w <= 0 || h <= 0) throw HandOnErr("XBM image of size 0");
  img.alloc(w, h);
  auto hex = [](int v) {
    return v >= '0' && v <= '9'   ? v - '0'
           : v >= 'a' && v <= 'f' ? v - 'a' + 10
           : v >= 'A' && v <= 'F' ? v - 'A' + 10
                                  : 0;
  };
  const int64_t bytes = (w + 7) / 8;
  std::vector<uint8_t> line(static_cast<size_t>(bytes));
  int64_t x = 0, y = 0;
  for (;;) {  // XbmDecode.c: each value is the two characters after an 'x'
    while (p < n && d[p] != 'x') p++;
    if (n - p < 3) invalid("truncated XBM data");
    line[size_t(x)] = uint8_t((hex(d[p + 1]) << 4) + hex(d[p + 2]));
    p += 3;
    if (++x >= bytes) {
      for (int64_t i = 0; i < w; i++) {  // "1;R": bit 0 first, set is white
        const int v = line[size_t(i >> 3)] >> (i & 7) & 1 ? 255 : 0;
        img.put(i, y, v, v, v);
      }
      x = 0;
      if (++y >= h) return;
    }
  }
}

// ------------------------------------------------------------- SPIDER

void decode_spider(const uint8_t* d, size_t n, Image& img) {
  if (n < 108) throw HandOnErr("not a valid Spider file");
  double t[28];
  auto header = [&](bool big) -> int64_t {
    t[0] = 99;
    for (int i = 0; i < 27; i++) {
      uint32_t u = big ? be32(d + 4 * i) : le32(d + 4 * i);
      float f;
      std::memcpy(&f, &u, 4);
      t[i + 1] = f;
    }
    for (int i : {1, 2, 5, 12, 13, 22, 23})
      if (!std::isfinite(t[i]) || t[i] != std::trunc(t[i])) return 0;
    const double iform = t[5];
    if (iform != 1 && iform != 3 && iform != -11 && iform != -12 &&
        iform != -21 && iform != -22)
      return 0;
    if (t[22] != t[13] * t[23]) return 0;  // exact in doubles for floats
    return int64_t(std::max(-1e15, std::min(1e15, t[22])));
  };
  bool big = true;
  int64_t hdrlen = header(true);
  if (!hdrlen) {
    big = false;
    hdrlen = header(false);
  }
  if (!hdrlen) throw HandOnErr("not a valid Spider file");
  if (t[5] != 1) throw HandOnErr("not a Spider 2D image");
  for (int i : {24, 27})
    if (!std::isfinite(t[i])) invalid("Spider stack field not a number");
  const double istack = std::trunc(t[24]), imgnumber = std::trunc(t[27]);
  int64_t offset;
  if (istack == 0 && imgnumber == 0)
    offset = hdrlen;
  else if (istack > 0 && imgnumber == 0)
    offset = hdrlen * 2;
  else if (istack == 0 && imgnumber > 0)
    invalid("Spider image of a stack PIL cannot seek to");
  else
    throw HandOnErr("inconsistent stack header values");
  const double wd = std::trunc(t[12]), hd = std::trunc(t[2]);
  if (wd <= 0 || hd <= 0) throw HandOnErr("Spider image of size 0");
  if (wd * hd > double(MAX_PIXELS)) invalid("image larger than PIL opens");
  const int64_t w = int64_t(wd), h = int64_t(hd);
  img.alloc(w, h);
  if (offset < 0 || size_t(offset) > n ||
      (n - size_t(offset)) / 4 / size_t(w) < size_t(h))
    invalid("truncated Spider image data");
  const uint8_t* s = d + offset;
  for (int64_t y = 0; y < h; y++)
    for (int64_t x = 0; x < w; x++, s += 4) {
      uint32_t u = big ? be32(s) : le32(s);
      float f;
      std::memcpy(&f, &u, 4);
      const uint8_t v = float_to_l(f);
      img.put(x, y, v, v, v);
    }
}

}  // namespace
