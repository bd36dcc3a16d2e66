// Lossless WebP for csrc/imgdecode.cpp, which includes this file after its
// shared helpers (the LSB-first bit reader among them): what PIL's WebP
// plugin gives through libwebp's animation decoder, then convert("RGB").
//
// - RIFF containers: a lone VP8L chunk, VP8X with a VP8L chunk (canvas and
//   bitstream sizes must agree), and VP8X animations, whose first frame
//   (ANMF, always a key frame) is decoded into its rectangle of a canvas
//   cleared to transparent black, with no blending. The whole container is
//   checked first, as libwebp's demuxer checks it: every frame's bitstream
//   header, and the frame (the bitstream's size, not the ANMF's) inside
//   the canvas.
// - The VP8L bitstream (RFC 9649): simple and normal prefix codes (which
//   must be complete, as libwebp requires), the colour cache, meta prefix
//   codes, and the four transforms undone in reverse order: predictor
//   (14 modes, 14 and 15 acting as mode 0), cross-colour, subtract-green
//   and colour indexing with pixel bundling (indexes past the table give
//   transparent black).
// - RGB is taken as decoded: libwebp's RGBA output is not premultiplied.
//
// A VP8 (lossy) bitstream, alone or as the first frame, is refused by name
// (status 1); a malformed file gives status 2.

namespace {

// A canonical prefix code read LSB-first (codes start at their MSB)
struct WHuff {
  uint16_t fast[1 << 9] = {};  // symbol << 4 | length, codes <= 9 bits
  uint16_t count[16] = {};
  std::vector<uint16_t> sym;
  int single = -1;  // the one symbol of a zero-bit code
  void build(const uint8_t* lens, int n) {
    std::memset(count, 0, sizeof count);
    int used = 0, last = 0;
    for (int i = 0; i < n; i++) {
      if (lens[i] > 15) invalid("WebP code length past 15");
      count[lens[i]]++;
      if (lens[i]) used++, last = i;
    }
    if (used == 0) invalid("empty WebP prefix code");
    if (used == 1) {  // libwebp: a lone symbol costs no bits
      single = last;
      return;
    }
    count[0] = 0;
    int left = 1;
    for (int l = 1; l < 16; l++) {
      left <<= 1;
      left -= count[l];
      if (left < 0) invalid("over-subscribed WebP prefix code");
    }
    if (left != 0) invalid("incomplete WebP prefix code");
    uint16_t offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; l++) offs[l + 1] = uint16_t(offs[l] + count[l]);
    sym.assign(size_t(n), 0);
    for (int i = 0; i < n; i++)
      if (lens[i]) sym[offs[lens[i]]++] = uint16_t(i);
    int code = 0, k = 0;
    for (int l = 1; l <= 15; l++) {
      for (int c = 0; c < count[l]; c++, k++, code++) {
        if (l > 9) continue;
        int rev = 0;
        for (int b = 0; b < l; b++) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (int j = rev; j < 512; j += 1 << l)
          fast[j] = uint16_t(sym[size_t(k)] << 4 | l);
      }
      code <<= 1;
    }
  }
  int decode(LsbBits& b) const {
    if (single >= 0) return single;
    b.need(15);
    uint16_t e = fast[b.buf & 511];
    if (e) {
      b.drop(e & 15);
      return e >> 4;
    }
    int code = 0, first = 0, index = 0;
    uint64_t bits = b.buf;
    for (int l = 1; l <= 15; l++) {
      code |= int(bits & 1);
      bits >>= 1;
      int cnt = count[l];
      if (code - cnt < first) {
        b.drop(l);
        return sym[size_t(index + (code - first))];
      }
      index += cnt;
      first += cnt;
      first <<= 1;
      code <<= 1;
    }
    invalid("bad WebP prefix code");
  }
};

const int8_t VP8L_DIST[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2},
    {2, 1},  {-2, 1}, {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3},
    {3, 1},  {-3, 1}, {2, 3},  {-2, 3}, {3, 2},  {-3, 2}, {0, 4},  {4, 0},
    {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3}, {2, 4},  {-2, 4},
    {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2},
    {4, 4},  {-4, 4}, {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},
    {1, 6},  {-1, 6}, {6, 1},  {-6, 1}, {2, 6},  {-2, 6}, {6, 2},  {-6, 2},
    {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6}, {6, 3},  {-6, 3},
    {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2},
    {3, 7},  {-3, 7}, {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5},
    {8, 0},  {4, 7},  {-4, 7}, {7, 4},  {-7, 4}, {8, 1},  {8, 2},  {6, 6},
    {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5}, {8, 4},  {6, 7},
    {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

struct Vp8l {
  LsbBits b;

  uint32_t bits(int n) {
    uint32_t v = b.get(n);
    if (b.overrun()) invalid("truncated WebP bitstream");
    return v;
  }

  void read_code(WHuff& h, int alphabet) {
    std::vector<uint8_t> lens(size_t(alphabet), 0);
    if (bits(1)) {  // simple code
      int num = int(bits(1)) + 1;
      int s0 = int(bits(bits(1) ? 8 : 1));
      if (s0 >= alphabet) invalid("WebP symbol past its alphabet");
      lens[size_t(s0)] = 1;
      if (num == 2) {
        int s1 = int(bits(8));
        if (s1 >= alphabet) invalid("WebP symbol past its alphabet");
        lens[size_t(s1)] = 1;
      }
    } else {
      static const uint8_t ORDER[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                        7,  8,  9, 10, 11, 12, 13, 14, 15};
      uint8_t cl[19] = {};
      int ncl = int(bits(4)) + 4;
      for (int i = 0; i < ncl; i++) cl[ORDER[i]] = uint8_t(bits(3));
      WHuff clh;
      clh.build(cl, 19);
      int max_symbol = alphabet;
      if (bits(1)) {
        int nb = 2 + 2 * int(bits(3));
        max_symbol = 2 + int(bits(nb));
        if (max_symbol > alphabet) invalid("WebP max symbol past alphabet");
      }
      int prev = 8, s = 0;
      while (s < alphabet) {
        if (max_symbol-- == 0) break;
        int c = clh.decode(b);
        if (b.overrun()) invalid("truncated WebP bitstream");
        if (c < 16) {
          lens[size_t(s++)] = uint8_t(c);
          if (c) prev = c;
          continue;
        }
        int rep = c == 16 ? 3 + int(bits(2)) : c == 17 ? 3 + int(bits(3))
                                                       : 11 + int(bits(7));
        int val = c == 16 ? prev : 0;
        if (s + rep > alphabet) invalid("WebP code lengths past alphabet");
        while (rep--) lens[size_t(s++)] = uint8_t(val);
      }
    }
    h.build(lens.data(), alphabet);
  }

  int lz_value(int prefix) {
    if (prefix < 4) return prefix + 1;
    int extra = (prefix - 2) >> 1;
    int offset = (2 + (prefix & 1)) << extra;
    return offset + int(bits(extra)) + 1;
  }

  // An entropy-coded image of w x h ARGB pixels; `level0` for the main
  // image (meta prefix codes allowed)
  std::vector<uint32_t> image(int w, int h, bool level0) {
    int cache_bits = 0;
    if (bits(1)) {
      cache_bits = int(bits(4));
      if (cache_bits < 1 || cache_bits > 11) invalid("bad WebP colour cache");
    }
    int prefix_bits = 0, groups = 1;
    std::vector<uint32_t> meta;
    if (level0 && bits(1)) {
      prefix_bits = int(bits(3)) + 2;
      int mw = (w + (1 << prefix_bits) - 1) >> prefix_bits;
      int mh = (h + (1 << prefix_bits) - 1) >> prefix_bits;
      meta = image(mw, mh, false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        groups = std::max(groups, int(m) + 1);
      }
    }
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    const int alpha_g = 256 + 24 + cache_size;
    std::vector<WHuff> codes(size_t(groups) * 5);
    for (int g = 0; g < groups; g++) {
      read_code(codes[size_t(g) * 5], alpha_g);
      read_code(codes[size_t(g) * 5 + 1], 256);
      read_code(codes[size_t(g) * 5 + 2], 256);
      read_code(codes[size_t(g) * 5 + 3], 256);
      read_code(codes[size_t(g) * 5 + 4], 40);
    }
    std::vector<uint32_t> cache(size_t(cache_size), 0);
    std::vector<uint32_t> px(size_t(w) * size_t(h));
    const size_t total = px.size();
    const int mw = prefix_bits ? (w + (1 << prefix_bits) - 1) >> prefix_bits
                               : 1;
    size_t pos = 0, cached = 0;
    auto flush_cache = [&]() {
      for (; cached < pos; cached++)
        cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
    };
    while (pos < total) {
      const int x = int(pos % size_t(w)), y = int(pos / size_t(w));
      const WHuff* g = &codes[0];
      if (prefix_bits)
        g = &codes[size_t(meta[size_t((y >> prefix_bits) * mw +
                                      (x >> prefix_bits))]) * 5];
      int s = g[0].decode(b);
      if (s < 256) {
        uint32_t red = uint32_t(g[1].decode(b));
        uint32_t blue = uint32_t(g[2].decode(b));
        uint32_t alpha = uint32_t(g[3].decode(b));
        px[pos++] = alpha << 24 | red << 16 | uint32_t(s) << 8 | blue;
      } else if (s < 256 + 24) {
        int len = lz_value(s - 256);
        int dsym = g[4].decode(b);
        int dcode = lz_value(dsym);
        int64_t dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          dist = VP8L_DIST[dcode - 1][0] + int64_t(VP8L_DIST[dcode - 1][1]) * w;
          if (dist < 1) dist = 1;
        }
        if (size_t(dist) > pos || total - pos < size_t(len))
          invalid("WebP backward reference out of the image");
        for (int k = 0; k < len; k++, pos++) px[pos] = px[pos - size_t(dist)];
      } else {
        if (!cache_size) invalid("WebP colour cache index without a cache");
        flush_cache();
        px[pos++] = cache[size_t(s - 280)];
      }
      if (b.overrun()) invalid("truncated WebP bitstream");
      if (cache_size) flush_cache();
    }
    return px;
  }

  static uint32_t avg2(uint32_t a, uint32_t c) {
    return (((a ^ c) & 0xfefefefeu) >> 1) + (a & c);
  }
  static uint32_t select(uint32_t l, uint32_t t, uint32_t tl) {
    int pl = 0, pt = 0;  // sum |T - TL| and sum |L - TL|
    for (int s = 0; s < 32; s += 8) {
      int a = int(l >> s & 255), c = int(t >> s & 255), d = int(tl >> s & 255);
      pl += std::abs(c - d);
      pt += std::abs(a - d);
    }
    return pl < pt ? l : t;
  }
  static uint32_t clamp_full(uint32_t a, uint32_t c, uint32_t d) {
    uint32_t o = 0;
    for (int s = 0; s < 32; s += 8) {
      int v = int(a >> s & 255) + int(c >> s & 255) - int(d >> s & 255);
      o |= uint32_t(v < 0 ? 0 : v > 255 ? 255 : v) << s;
    }
    return o;
  }
  static uint32_t clamp_half(uint32_t a, uint32_t c) {
    uint32_t o = 0;
    for (int s = 0; s < 32; s += 8) {
      int x = int(a >> s & 255), y = int(c >> s & 255);
      int v = x + (x - y) / 2;
      o |= uint32_t(v < 0 ? 0 : v > 255 ? 255 : v) << s;
    }
    return o;
  }
  static uint32_t add(uint32_t a, uint32_t c) {
    return (((a & 0xff00ff00u) + (c & 0xff00ff00u)) & 0xff00ff00u) |
           (((a & 0x00ff00ffu) + (c & 0x00ff00ffu)) & 0x00ff00ffu);
  }

  struct Transform {
    int type, bits, xsize;
    std::vector<uint32_t> data;
  };

  // the decoded w x h ARGB pixels of a VP8L chunk
  std::vector<uint32_t> decode(const uint8_t* d, size_t n, int& w, int& h) {
    if (n < 5 || d[0] != 0x2f) invalid("bad VP8L signature");
    b = LsbBits{d + 1, d + n};
    w = int(bits(14)) + 1;
    h = int(bits(14)) + 1;
    bits(1);  // alpha_is_used
    if (bits(3) != 0) invalid("bad VP8L version");
    std::vector<Transform> tr;
    int xsize = w;
    unsigned seen = 0;
    while (bits(1)) {
      Transform t;
      t.type = int(bits(2));
      if (seen & (1u << t.type)) invalid("WebP transform used twice");
      seen |= 1u << t.type;
      t.xsize = xsize;
      t.bits = 0;
      if (t.type == 0 || t.type == 1) {
        t.bits = int(bits(3)) + 2;
        int bw = (xsize + (1 << t.bits) - 1) >> t.bits;
        int bh = (h + (1 << t.bits) - 1) >> t.bits;
        t.data = image(bw, bh, false);
      } else if (t.type == 3) {
        int size = int(bits(8)) + 1;
        t.bits = size > 16 ? 0 : size > 4 ? 1 : size > 2 ? 2 : 3;
        std::vector<uint32_t> pal = image(size, 1, false);
        for (int i = 1; i < size; i++)
          pal[size_t(i)] = add(pal[size_t(i)], pal[size_t(i - 1)]);
        pal.resize(256, 0);  // an index past the table gives 0
        t.data = std::move(pal);
        xsize = (xsize + (1 << t.bits) - 1) >> t.bits;
      }
      tr.push_back(std::move(t));
    }
    std::vector<uint32_t> px = image(xsize, h, true);
    for (size_t k = tr.size(); k-- > 0;) {
      const Transform& t = tr[k];
      const int tw = t.xsize;
      if (t.type == 0) {  // predictor, in place, row by row
        const int bw = (tw + (1 << t.bits) - 1) >> t.bits;
        for (int y = 0; y < h; y++)
          for (int x = 0; x < tw; x++) {
            const size_t i = size_t(y) * tw + x;
            uint32_t pred;
            if (y == 0) {
              pred = x == 0 ? 0xff000000u : px[i - 1];
            } else if (x == 0) {
              pred = px[i - size_t(tw)];
            } else {
              const uint32_t L = px[i - 1], T = px[i - size_t(tw)];
              const uint32_t TL = px[i - size_t(tw) - 1];
              const uint32_t TR = px[i - size_t(tw) + 1];
              int mode = int(t.data[size_t((y >> t.bits) * bw + (x >> t.bits))]
                             >> 8 & 15);
              switch (mode) {
                case 1: pred = L; break;
                case 2: pred = T; break;
                case 3: pred = TR; break;
                case 4: pred = TL; break;
                case 5: pred = avg2(avg2(L, TR), T); break;
                case 6: pred = avg2(L, TL); break;
                case 7: pred = avg2(L, T); break;
                case 8: pred = avg2(TL, T); break;
                case 9: pred = avg2(T, TR); break;
                case 10: pred = avg2(avg2(L, TL), avg2(T, TR)); break;
                case 11: pred = select(L, T, TL); break;
                case 12: pred = clamp_full(L, T, TL); break;
                case 13: pred = clamp_half(avg2(L, T), TL); break;
                default: pred = 0xff000000u;
              }
            }
            px[i] = add(px[i], pred);
          }
      } else if (t.type == 1) {  // cross-colour
        const int bw = (tw + (1 << t.bits) - 1) >> t.bits;
        for (int y = 0; y < h; y++)
          for (int x = 0; x < tw; x++) {
            uint32_t& p = px[size_t(y) * tw + x];
            uint32_t m = t.data[size_t((y >> t.bits) * bw + (x >> t.bits))];
            int g2r = int8_t(m & 255), g2b = int8_t(m >> 8 & 255);
            int r2b = int8_t(m >> 16 & 255);
            int green = int8_t(p >> 8 & 255);
            int red = int(p >> 16 & 255), blue = int(p & 255);
            red = (red + ((g2r * green) >> 5)) & 255;
            blue = (blue + ((g2b * green) >> 5)) & 255;
            blue = (blue + ((r2b * int8_t(red)) >> 5)) & 255;
            p = (p & 0xff00ff00u) | uint32_t(red) << 16 | uint32_t(blue);
          }
      } else if (t.type == 2) {  // subtract green
        for (uint32_t& p : px) {
          uint32_t g = p >> 8 & 255;
          p = (p & 0xff00ff00u) | ((((p >> 16) + g) & 255) << 16) |
              ((p + g) & 255);
        }
      } else {  // colour indexing, unbundled to width tw
        const int packed = (tw + (1 << t.bits) - 1) >> t.bits;
        const int bpp = 8 >> t.bits, mask = (1 << bpp) - 1;
        std::vector<uint32_t> out(size_t(tw) * h);
        for (int y = 0; y < h; y++)
          for (int x = 0; x < tw; x++) {
            uint32_t g = px[size_t(y) * packed + (x >> t.bits)] >> 8 & 255;
            int idx = int(g >> (bpp * (x & ((1 << t.bits) - 1)))) & mask;
            out[size_t(y) * tw + x] = t.data[size_t(idx)];
          }
        px = std::move(out);
      }
    }
    return px;
  }
};

struct RiffChunk {
  uint32_t tag;
  const uint8_t* d;
  size_t n;
};

inline uint32_t fourcc(const char* s) {
  return le32(reinterpret_cast<const uint8_t*>(s));
}

// the chunks of a RIFF payload, each padded to even length
std::vector<RiffChunk> riff_chunks(const uint8_t* d, size_t n) {
  std::vector<RiffChunk> out;
  size_t p = 0;
  while (n - p >= 8) {
    uint32_t size = le32(d + p + 4);
    if (size > n - p - 8) invalid("truncated WebP chunk");
    out.push_back({le32(d + p), d + p + 8, size});
    p += 8 + size + (size & 1);
    if (p > n) break;
  }
  return out;
}

[[noreturn]] void webp_lossy() {
  throw Unsupported("lossy WebP (VP8) is not decoded by craytracer_tpu_torch "
                    "(lossless WebP, VP8L, is)");
}

// The size of a frame's bitstream as libwebp's WebPGetFeatures reads it
// (VP8L: signature and version; VP8: a key frame's start code); false
// where it would fail
bool webp_features(const RiffChunk& c, int64_t& w, int64_t& h) {
  const uint8_t* p = c.d;
  if (c.tag == fourcc("VP8L")) {
    if (c.n < 5 || p[0] != 0x2f || (p[4] >> 5) != 0) return false;
    uint32_t bits = le32(p + 1);
    w = int64_t(bits & 0x3fff) + 1;
    h = int64_t((bits >> 14) & 0x3fff) + 1;
    return true;
  }
  if (c.n < 10) return false;
  uint32_t tag = p[0] | p[1] << 8 | p[2] << 16;
  if ((tag & 1) || ((tag >> 1) & 7) > 3 || !((tag >> 4) & 1) ||
      (tag >> 5) >= c.n || p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a)
    return false;
  w = le16(p + 6) & 0x3fff;
  h = le16(p + 8) & 0x3fff;
  return w > 0 && h > 0;
}

// The image chunk of a frame's chunks as libwebp's demuxer stores it: an
// ALPH chunk may precede a VP8 one, never a VP8L one; null where the
// demuxer fails
const RiffChunk* webp_image(const std::vector<RiffChunk>& chunks,
                            size_t from) {
  bool alpha = false;
  for (size_t k = from; k < chunks.size(); k++) {
    const RiffChunk& c = chunks[k];
    if (c.tag == fourcc("ALPH")) {
      alpha = true;
    } else if (c.tag == fourcc("VP8L")) {
      return alpha ? nullptr : &c;
    } else if (c.tag == fourcc("VP8 ")) {
      return &c;
    } else if (from > 0 || alpha) {
      return nullptr;
    }
  }
  return nullptr;
}

void put_argb(Image& img, const std::vector<uint32_t>& px, int64_t x0,
              int64_t y0, int64_t w, int64_t h) {
  for (int64_t y = 0; y < h; y++)
    for (int64_t x = 0; x < w; x++) {
      uint32_t p = px[size_t(y * w + x)];
      img.put(x0 + x, y0 + y, int(p >> 16 & 255), int(p >> 8 & 255),
              int(p & 255));
    }
}

// libwebp's animation decoder, which PIL opens every WebP with: the
// demuxer checks the whole container (the RIFF size within the file,
// every frame's bitstream header, each frame inside the canvas) before the
// first frame is decoded
void decode_webp(const uint8_t* d, size_t n, Image& img) {
  if (n < 12 || std::memcmp(d, "RIFF", 4) || std::memcmp(d + 8, "WEBP", 4))
    invalid("not a WebP file");
  const size_t riff = le32(d + 4);
  if (riff < 12 || riff > n - 8) invalid("truncated WebP file");
  std::vector<RiffChunk> ch = riff_chunks(d + 12, riff - 4);
  if (ch.empty()) invalid("empty WebP file");
  Vp8l dec;
  int w = 0, h = 0;
  int64_t fw = 0, fh = 0;
  if (ch[0].tag != fourcc("VP8X")) {  // a simple file: one bitstream
    const RiffChunk* c = webp_image(ch, 0);
    if (!c || c != &ch[0] || !webp_features(*c, fw, fh))
      invalid("WebP without a valid image chunk");
    if (c->tag == fourcc("VP8 ")) webp_lossy();
    std::vector<uint32_t> px = dec.decode(c->d, c->n, w, h);
    img.alloc(w, h);
    put_argb(img, px, 0, 0, w, h);
    return;
  }
  if (ch[0].n < 10) invalid("truncated VP8X chunk");
  const uint8_t* x = ch[0].d;
  const bool anim = x[0] & 0x02;
  const int64_t cw = int64_t(x[4] | x[5] << 8 | x[6] << 16) + 1;
  const int64_t chh = int64_t(x[7] | x[8] << 8 | x[9] << 16) + 1;
  if (!anim) {
    const RiffChunk* c = webp_image(ch, 1);
    if (!c || !webp_features(*c, fw, fh) || fw != cw || fh != chh)
      invalid("WebP image chunk invalid or off its canvas");
    if (c->tag == fourcc("VP8 ")) webp_lossy();
    std::vector<uint32_t> px = dec.decode(c->d, c->n, w, h);
    img.alloc(cw, chh);
    put_argb(img, px, 0, 0, w, h);
    return;
  }
  // every frame checked, the first one decoded
  bool seen_anim = false, found = false;
  RiffChunk first{};  // a copy: `sub` below goes with its iteration
  int64_t first_x = 0, first_y = 0;
  for (size_t k = 1; k < ch.size(); k++) {
    const RiffChunk& c = ch[k];
    if (c.tag == fourcc("ANIM")) {
      if (c.n < 6) invalid("truncated ANIM chunk");
      seen_anim = true;
    } else if (c.tag == fourcc("ANMF")) {
      if (!seen_anim || c.n < 16) invalid("WebP frame before ANIM");
      const uint8_t* f = c.d;
      const int64_t fx = 2 * int64_t(f[0] | f[1] << 8 | f[2] << 16);
      const int64_t fy = 2 * int64_t(f[3] | f[4] << 8 | f[5] << 16);
      std::vector<RiffChunk> sub = riff_chunks(f + 16, c.n - 16);
      sub.insert(sub.begin(), RiffChunk{0, nullptr, 0});  // from = 1
      const RiffChunk* im = webp_image(sub, 1);
      if (!im || !webp_features(*im, fw, fh) || fx + fw > cw ||
          fy + fh > chh)
        invalid("WebP frame invalid or off its canvas");
      if (!found) {
        found = true;
        first = *im;
        first_x = fx;
        first_y = fy;
      }
    }
  }
  if (!found) invalid("WebP animation without a frame");
  if (first.tag == fourcc("VP8 ")) webp_lossy();
  img.alloc(cw, chh);  // transparent black where the frame does not reach
  std::vector<uint32_t> px = dec.decode(first.d, first.n, w, h);
  put_argb(img, px, first_x, first_y, w, h);
}

}  // namespace
