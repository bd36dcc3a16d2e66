// Texture decoders of craytracer_tpu_torch (io/teximage.py): PNG, JPEG,
// PNM, BMP, TGA and GIF to 8-bit RGB, each giving the texels that PIL's
// Image.open(path).convert("RGB") gives (the JAX package's loader,
// craytracer_tpu/io/teximage.py), quirks included:
//
// - PNG: bit depths 1/2/4/8/16, colour types 0/2/3/4/6, Adam7, the five
//   row filters, zlib inflated here. Low-bit gray is scaled (2-bit: 0, 85,
//   170, 255), 16-bit samples keep their high byte, except 16-bit gray,
//   which PIL opens as I;16 and clips at 255. A palette index past PLTE
//   is black; tRNS and alpha are dropped. The CRC of every chunk before
//   the first IDAT is checked, as PIL checks it.
// - JPEG: baseline, extended (SOF1) and progressive Huffman, 8-bit, 1, 3
//   or 4 components, any integral sampling factors, restart markers. The
//   stages are libjpeg-turbo's defaults, which PIL decodes with: the ISLOW
//   integer IDCT (jidctint.c), fancy upsampling (jdsample.c: h2v1, h1v2,
//   h2v2; box replication for other integral factors), jdcolor.c's
//   fixed-point YCbCr->RGB tables and YCCK->CMYK, then PIL's inverted
//   Adobe CMYK and its CMYK->RGB. A progressive file whose scans leave
//   coefficient bits unrefined would be block-smoothed by libjpeg
//   (jdcoefct.c): it is refused, as are arithmetic coding, lossless,
//   hierarchical and 12-bit JPEG.
// - PNM: P1-P6, any maxval, scaled as PIL's PpmDecoder and
//   PpmPlainDecoder scale (round half to even of v / maxval * 255; gray
//   past maxval 255 opens as mode I, scaled to 65535, and clips at 255);
//   PIL's own Pf (gray float, F -> L truncating), P0CMYK/PyCMYK, PyRGBA
//   and PyP (no palette: black). "PF" is not a file PIL reads.
// - BMP: 1/4/8/16/24/32 bit, RLE4/RLE8 (PIL's BmpRleDecoder byte for
//   byte), the BITFIELDS layouts PIL accepts, both row orders, the
//   12/40/52/56/64/108/124-byte headers.
// - TGA: raw and RLE, colour-mapped, true-colour and gray, both origins
//   and the right-to-left flag.
// - GIF: the first frame (LZW), global and local palettes, interlace, the
//   frame at its offset on the logical screen.
// - TIFF, DDS, lossless WebP and PSD: one file each, included below
//   (imgdecode_tiff.h, imgdecode_dds.h, imgdecode_webp.h,
//   imgdecode_psd.h), built with this file as one library.
//
// A file the decoder does not handle gives status 1 (the caller raises
// NotImplementedError); a file PIL would fail to read gives status 2 (the
// caller returns None, as the JAX loader does).
//
// C interface: imgd_decode(kind, bytes, n) -> handle; imgd_status,
// imgd_message, imgd_width, imgd_height, imgd_copy ([H, W, 3] uint8 rows),
// imgd_free. Built with g++ by io/imgdecode.py at first use.

#include <algorithm>
#include <cctype>
#include <cstdlib>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Unsupported : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct Invalid : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void invalid(const std::string& why) { throw Invalid(why); }

// PIL's decompression-bomb limit: Image.open refuses more pixels than this
const int64_t MAX_PIXELS = 2 * 89478485LL;

struct Image {
  int64_t w = 0, h = 0;
  std::vector<uint8_t> rgb;
  void alloc(int64_t w_, int64_t h_) {
    if (w_ <= 0 || h_ <= 0) invalid("image of size 0");
    if (w_ > MAX_PIXELS || h_ > MAX_PIXELS || w_ * h_ > MAX_PIXELS)
      invalid("image larger than PIL opens");
    w = w_;
    h = h_;
    rgb.assign(size_t(w * h * 3), 0);
  }
  uint8_t* px(int64_t x, int64_t y) { return &rgb[size_t((y * w + x) * 3)]; }
  void put(int64_t x, int64_t y, int r, int g, int b) {
    uint8_t* p = px(x, y);
    p[0] = uint8_t(r);
    p[1] = uint8_t(g);
    p[2] = uint8_t(b);
  }
};

inline uint32_t be16(const uint8_t* p) { return uint32_t(p[0]) << 8 | p[1]; }
inline uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 |
         p[3];
}
inline uint32_t le16(const uint8_t* p) { return uint32_t(p[1]) << 8 | p[0]; }
inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[3]) << 24 | uint32_t(p[2]) << 16 | uint32_t(p[1]) << 8 |
         p[0];
}

// PIL's Convert.c cmyk2rgb (MULDIV255 rounding) of one CMYK pixel
inline void cmyk_to_rgb(uint8_t* o, int c, int m, int y, int k) {
  auto muldiv255 = [](int a, int b) {
    int t = a * b + 128;
    return ((t >> 8) + t) >> 8;
  };
  auto clip = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
  const int nk = 255 - k;
  o[0] = clip(nk - muldiv255(c, nk));
  o[1] = clip(nk - muldiv255(m, nk));
  o[2] = clip(nk - muldiv255(y, nk));
}

// PIL's F -> L (and so F -> RGB): truncated, clipped, NaN to 0
inline uint8_t float_to_l(float v) {
  if (!(v > 0.0f)) return 0;
  if (v >= 255.0f) return 255;
  return uint8_t(int(v));
}

// A 256-entry RGB palette; entries past the file's are black, as in a
// PIL palette loaded from fewer entries.
struct Palette {
  uint8_t rgb[256][3] = {};
};

// ---------------------------------------------------------------- inflate

struct LsbBits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  int64_t pad = 0;  // zero bits appended past the end
  void need(int n) {
    while (cnt < n) {
      uint64_t byte = 0;
      if (p < end)
        byte = *p++;
      else
        pad += 8;
      buf |= byte << cnt;
      cnt += 8;
    }
  }
  uint32_t get(int n) {
    if (n == 0) return 0;
    need(n);
    uint32_t v = uint32_t(buf & ((uint64_t(1) << n) - 1));
    buf >>= n;
    cnt -= n;
    return v;
  }
  void drop(int n) {
    buf >>= n;
    cnt -= n;
  }
  bool overrun() const { return pad > cnt; }
};

struct InflateHuff {
  uint16_t fast[1 << 9];  // symbol << 4 | length for codes of <= 9 bits
  uint16_t count[16];
  uint16_t sym[320];
  void build(const uint8_t* lens, int n) {
    std::memset(count, 0, sizeof count);
    for (int i = 0; i < n; i++) count[lens[i]]++;
    count[0] = 0;
    int left = 1;
    for (int l = 1; l < 16; l++) {
      left <<= 1;
      left -= count[l];
      if (left < 0) invalid("over-subscribed deflate code");
    }
    uint16_t offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; l++) offs[l + 1] = uint16_t(offs[l] + count[l]);
    for (int i = 0; i < n; i++)
      if (lens[i]) sym[offs[lens[i]]++] = uint16_t(i);
    std::memset(fast, 0, sizeof fast);
    int code = 0, k = 0;
    for (int l = 1; l <= 15; l++) {
      for (int c = 0; c < count[l]; c++, k++, code++) {
        if (l > 9) continue;
        int rev = 0;
        for (int b = 0; b < l; b++) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (int j = rev; j < 512; j += 1 << l)
          fast[j] = uint16_t(sym[k] << 4 | l);
      }
      code <<= 1;
    }
  }
  int decode(LsbBits& b) const {
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
        return sym[index + (code - first)];
      }
      index += cnt;
      first += cnt;
      first <<= 1;
      code <<= 1;
    }
    invalid("bad deflate code");
  }
};

const uint16_t LEN_BASE[29] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  13,
                               15, 17, 19, 23, 27, 31, 35, 43,  51,  59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t LEN_EXTRA[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t DIST_BASE[30] = {
    1,   2,   3,   4,   5,   7,    9,    13,   17,   25,   33,   49,   65,    97,    129,
    193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
const uint8_t DIST_EXTRA[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

// The zlib stream's data, stopping once `want` bytes are out (PIL stops
// reading when the image is complete). Fewer bytes than `want` raise,
// unless `partial` asks for what the stream holds. With `adler`, a stream
// that ends with its whole Adler-32 checksum is held to it, as zlib's
// inflate, which libtiff calls, holds it.
std::vector<uint8_t> zlib_inflate(const uint8_t* d, size_t n, size_t want,
                                  bool partial = false, bool adler = false) {
  if (n < 2) invalid("truncated zlib stream");
  if ((d[0] & 15) != 8 || (uint32_t(d[0]) << 8 | d[1]) % 31 != 0 ||
      (d[1] & 32))
    invalid("bad zlib header");
  std::vector<uint8_t> out;
  out.reserve(want);
  LsbBits b{d + 2, d + n};
  // built once, thread-safely (ctypes calls run without the GIL)
  static const InflateHuff fixed_lit = [] {
    InflateHuff t;
    uint8_t l[288];
    for (int i = 0; i < 288; i++)
      l[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
    t.build(l, 288);
    return t;
  }();
  static const InflateHuff fixed_dist = [] {
    InflateHuff t;
    uint8_t l[30];
    std::memset(l, 5, 30);
    t.build(l, 30);
    return t;
  }();
  InflateHuff lit, dist;
  bool last = false;
  while (!last && out.size() < want) {
    last = b.get(1);
    int type = int(b.get(2));
    if (type == 0) {
      b.drop(b.cnt & 7);
      uint32_t len = b.get(16), nlen = b.get(16);
      if ((len ^ 0xFFFF) != nlen) invalid("bad stored block");
      while (len && b.cnt >= 8) {
        out.push_back(uint8_t(b.get(8)));
        len--;
      }
      if (b.overrun() || size_t(b.end - b.p) < len)
        invalid("truncated stored block");
      out.insert(out.end(), b.p, b.p + len);
      b.p += len;
      continue;
    }
    const InflateHuff* hl = &fixed_lit;
    const InflateHuff* hd = &fixed_dist;
    if (type == 2) {
      int hlit = int(b.get(5)) + 257, hdist = int(b.get(5)) + 1;
      int hclen = int(b.get(4)) + 4;
      static const uint8_t ORDER[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                        11, 4,  12, 3, 13, 2, 14, 1, 15};
      uint8_t cl[19] = {};
      for (int i = 0; i < hclen; i++) cl[ORDER[i]] = uint8_t(b.get(3));
      InflateHuff clh;
      clh.build(cl, 19);
      uint8_t lens[320] = {};
      int i = 0;
      while (i < hlit + hdist) {
        int s = clh.decode(b);
        if (s < 16) {
          lens[i++] = uint8_t(s);
          continue;
        }
        int rep = 0, val = 0;
        if (s == 16) {
          if (i == 0) invalid("repeat with no previous length");
          val = lens[i - 1];
          rep = 3 + int(b.get(2));
        } else if (s == 17) {
          rep = 3 + int(b.get(3));
        } else {
          rep = 11 + int(b.get(7));
        }
        if (i + rep > hlit + hdist) invalid("too many code lengths");
        while (rep--) lens[i++] = uint8_t(val);
      }
      if (lens[256] == 0) invalid("no end-of-block code");
      lit.build(lens, hlit);
      dist.build(lens + hlit, hdist);
      hl = &lit;
      hd = &dist;
    } else if (type != 1) {
      invalid("bad deflate block type");
    }
    bool cut = false;  // the data ran out inside the block
    for (;;) {
      int s = hl->decode(b);
      if (b.overrun()) {
        cut = true;
        break;
      }
      if (s < 256) {
        out.push_back(uint8_t(s));
      } else if (s == 256) {
        break;
      } else {
        s -= 257;
        if (s >= 29) invalid("bad length code");
        size_t len = LEN_BASE[s] + b.get(LEN_EXTRA[s]);
        int ds = hd->decode(b);
        if (ds >= 30) invalid("bad distance code");
        size_t dd = DIST_BASE[ds] + b.get(DIST_EXTRA[ds]);
        if (b.overrun()) {
          cut = true;
          break;
        }
        if (dd > out.size()) invalid("distance past the start");
        size_t from = out.size() - dd;
        for (size_t k = 0; k < len; k++) out.push_back(out[from + k]);
      }
    }
    if (cut) {
      if (!partial) invalid("truncated deflate stream");
      break;
    }
    if (b.overrun()) invalid("truncated deflate stream");
  }
  if (!partial && (b.overrun() || out.size() < want))
    invalid("truncated PNG image data");
  // zlib reaches the checksum only when the output did not fill first
  if (adler && last && out.size() <= want && !b.overrun()) {
    b.drop(b.cnt & 7);
    uint32_t want_sum = 0;
    for (int k = 0; k < 4; k++) want_sum = want_sum << 8 | b.get(8);
    if (!b.overrun()) {
      uint32_t s1 = 1, s2 = 0;
      for (uint8_t c : out) {
        s1 = (s1 + c) % 65521;
        s2 = (s2 + s1) % 65521;
      }
      if ((s2 << 16 | s1) != want_sum) invalid("zlib checksum mismatch");
    }
  }
  return out;
}

// ---------------------------------------------------------------- PNG

uint32_t crc32_of(const uint8_t* p, size_t n, uint32_t crc = 0) {
  struct Table {
    uint32_t v[256];
    Table() {
      for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
          c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        v[i] = c;
      }
    }
  };
  static const Table t;
  const uint32_t* table = t.v;
  crc = ~crc;
  for (size_t i = 0; i < n; i++) crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

void unfilter(int ft, uint8_t* cur, const uint8_t* prev, size_t n, int bpp) {
  switch (ft) {
    case 0:
      return;
    case 1:
      for (size_t i = bpp; i < n; i++) cur[i] = uint8_t(cur[i] + cur[i - bpp]);
      return;
    case 2:
      for (size_t i = 0; i < n; i++) cur[i] = uint8_t(cur[i] + prev[i]);
      return;
    case 3:
      for (size_t i = 0; i < n; i++) {
        int left = i >= size_t(bpp) ? cur[i - bpp] : 0;
        cur[i] = uint8_t(cur[i] + ((left + prev[i]) >> 1));
      }
      return;
    case 4:
      for (size_t i = 0; i < n; i++) {
        int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
        int c = i >= size_t(bpp) ? prev[i - bpp] : 0;
        cur[i] = uint8_t(cur[i] + paeth(a, prev[i], c));
      }
      return;
    default:
      invalid("bad PNG row filter");
  }
}

void decode_png(const uint8_t* d, size_t n, Image& img) {
  static const uint8_t SIG[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (n < 8 || std::memcmp(d, SIG, 8) != 0) invalid("not a PNG file");
  size_t pos = 8;
  bool have_ihdr = false;
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = 0, interlace = 0;
  Palette pal;
  bool have_plte = false;
  std::vector<uint8_t> idat;
  for (;;) {
    if (n - pos < 8) invalid("truncated PNG");
    uint32_t len = be32(d + pos);
    const uint8_t* type = d + pos + 4;
    for (int i = 0; i < 4; i++)
      if (!(std::isalnum(type[i]) || type[i] == '_'))
        invalid("broken PNG chunk");
    if (len > n - pos - 8) invalid("truncated PNG chunk");
    const uint8_t* data = d + pos + 8;
    if (std::memcmp(type, "IDAT", 4) == 0) {
      // the image data: this IDAT and the ones right after it
      while (std::memcmp(d + pos + 4, "IDAT", 4) == 0) {
        uint32_t l = be32(d + pos);
        if (l > n - pos - 8) invalid("truncated PNG chunk");
        idat.insert(idat.end(), d + pos + 8, d + pos + 8 + l);
        pos += 12 + size_t(l);
        if (n < pos + 8) break;
      }
      break;
    }
    if (n - pos - 8 - len < 4) invalid("truncated PNG checksum");
    if (crc32_of(data, len, crc32_of(type, 4)) != be32(data + len))
      invalid("bad PNG chunk checksum");
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) invalid("truncated IHDR");
      w = be32(data);
      h = be32(data + 4);
      depth = data[8];
      ctype = data[9];
      if (data[11]) invalid("unknown PNG filter category");
      interlace = data[12] ? 1 : 0;
      have_ihdr = true;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      for (uint32_t i = 0; i < len / 3 && i < 256; i++)
        for (int c = 0; c < 3; c++) pal.rgb[i][c] = data[3 * i + c];
      have_plte = true;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      invalid("PNG without image data");
    }
    pos += 12 + size_t(len);
  }
  if (!have_ihdr) invalid("PNG without IHDR");
  bool ok = (ctype == 0 && (depth == 1 || depth == 2 || depth == 4 ||
                            depth == 8 || depth == 16)) ||
            ((ctype == 2 || ctype == 4 || ctype == 6) &&
             (depth == 8 || depth == 16)) ||
            (ctype == 3 && (depth == 1 || depth == 2 || depth == 4 ||
                            depth == 8));
  if (!ok) invalid("PNG of an unknown mode");
  if (ctype == 3 && !have_plte) invalid("palette PNG without PLTE");
  img.alloc(w, h);
  const int channels = ctype == 0 ? 1 : ctype == 2 ? 3 : ctype == 3 ? 1
                                       : ctype == 4 ? 2 : 4;
  const int bits_pp = channels * depth;
  const int bpp = std::max(1, bits_pp / 8);
  struct Pass {
    int x0, y0, dx, dy;
  };
  static const Pass ADAM7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                                {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                                {0, 1, 1, 2}};
  static const Pass WHOLE = {0, 0, 1, 1};
  const Pass* passes = interlace ? ADAM7 : &WHOLE;
  const int npass = interlace ? 7 : 1;
  size_t want = 0;
  for (int p = 0; p < npass; p++) {
    const Pass& ps = passes[p];
    size_t pw = w > uint32_t(ps.x0) ? (w - ps.x0 + ps.dx - 1) / ps.dx : 0;
    size_t ph = h > uint32_t(ps.y0) ? (h - ps.y0 + ps.dy - 1) / ps.dy : 0;
    if (pw && ph) want += ph * (1 + (pw * bits_pp + 7) / 8);
  }
  std::vector<uint8_t> raw = zlib_inflate(idat.data(), idat.size(), want);
  const uint8_t* rp = raw.data();
  const int scale = depth == 1 ? 255 : depth == 2 ? 85 : depth == 4 ? 17 : 1;
  for (int p = 0; p < npass; p++) {
    const Pass& ps = passes[p];
    size_t pw = w > uint32_t(ps.x0) ? (w - ps.x0 + ps.dx - 1) / ps.dx : 0;
    size_t ph = h > uint32_t(ps.y0) ? (h - ps.y0 + ps.dy - 1) / ps.dy : 0;
    if (!pw || !ph) continue;
    size_t rb = (pw * bits_pp + 7) / 8;
    std::vector<uint8_t> prev(rb, 0), cur(rb);
    for (size_t r = 0; r < ph; r++) {
      int ft = *rp++;
      std::memcpy(cur.data(), rp, rb);
      rp += rb;
      unfilter(ft, cur.data(), prev.data(), rb, bpp);
      const uint8_t* row = cur.data();
      int64_t y = ps.y0 + int64_t(r) * ps.dy;
      for (size_t c = 0; c < pw; c++) {
        int64_t x = ps.x0 + int64_t(c) * ps.dx;
        if (depth < 8) {
          size_t bit = c * depth;
          int v = (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
          if (ctype == 3)
            img.put(x, y, pal.rgb[v][0], pal.rgb[v][1], pal.rgb[v][2]);
          else
            img.put(x, y, v * scale, v * scale, v * scale);
          continue;
        }
        const uint8_t* s = row + c * (bits_pp / 8);
        if (depth == 8) {
          if (ctype == 0 || ctype == 4)
            img.put(x, y, s[0], s[0], s[0]);
          else if (ctype == 3)
            img.put(x, y, pal.rgb[s[0]][0], pal.rgb[s[0]][1], pal.rgb[s[0]][2]);
          else
            img.put(x, y, s[0], s[1], s[2]);
        } else if (ctype == 0) {  // I;16, clipped by convert("RGB")
          int v = std::min<int>(be16(s), 255);
          img.put(x, y, v, v, v);
        } else if (ctype == 4) {
          img.put(x, y, s[0], s[0], s[0]);
        } else {
          img.put(x, y, s[0], s[2], s[4]);
        }
      }
      std::swap(prev, cur);
    }
  }
}

// ---------------------------------------------------------------- JPEG

// zigzag index -> natural (row-major) index, with libjpeg's 16 extra
// entries for a corrupt run past the end of a block
const int NATURAL[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct JHuff {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << 9];  // length << 8 | symbol for codes of <= 9 bits
};

// jdhuff.c jpeg_make_d_derived_tbl
void build_jhuff(JHuff& t, const uint8_t* counts, const uint8_t* vals,
                 int nvals, bool dc) {
  uint8_t size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < counts[l - 1]; i++) size[p++] = uint8_t(l);
  size[p] = 0;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (uint32_t(1) << si)) invalid("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (counts[l - 1]) {
      t.valoffset[l] = p - int32_t(code_of[p]);
      p += counts[l - 1];
      t.maxcode[l] = int32_t(code_of[p - 1]);
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0xFFFFF;
  std::memset(t.look, 0, sizeof t.look);
  p = 0;
  for (int l = 1; l <= 9; l++)
    for (int i = 0; i < counts[l - 1]; i++, p++) {
      uint32_t lb = code_of[p] << (9 - l);
      for (int c = 0; c < (1 << (9 - l)); c++)
        t.look[lb + c] = uint16_t(l << 8 | vals[p]);
    }
  std::memcpy(t.vals, vals, nvals);
  if (dc)
    for (int i = 0; i < nvals; i++)
      if (vals[i] > 15) invalid("bad DC Huffman table");
  t.defined = true;
}

struct JBits {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t buf = 0;  // bits left-aligned
  int cnt = 0;
  bool marker = false;       // the next bytes are a marker (or the end)
  bool insufficient = false;  // bits were needed past it: libjpeg's flag
  bool eof = false;           // ... and the file ended there
  void fill() {
    while (cnt <= 56 && !marker) {
      if (pos >= n) {
        marker = eof = true;
        break;
      }
      uint32_t c = d[pos];
      if (c == 0xFF) {
        size_t q = pos + 1;
        while (q < n && d[q] == 0xFF) q++;
        if (q < n && d[q] == 0) {
          pos = q + 1;
        } else {
          marker = true;
          if (q >= n) eof = true;
          break;
        }
      } else {
        pos++;
      }
      buf |= uint64_t(c) << (56 - cnt);
      cnt += 8;
    }
  }
  void ensure(int k) {
    if (cnt < k) {
      fill();
      if (cnt < k) {
        insufficient = true;  // zeros past the marker, as libjpeg feeds
        cnt = 64;
      }
    }
  }
  int get(int k) {
    if (k == 0) return 0;
    ensure(k);
    int v = int(buf >> (64 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }
  int decode(const JHuff& t) {
    if (cnt < 16) fill();
    if (cnt < 16) {
      // near a marker: take bits one at a time, so that only the bits
      // the code needs count as missing (jdhuff.c jpeg_huff_decode)
      int l = 1;
      int32_t code = get(1);
      while (l <= 16 && code > t.maxcode[l]) {
        code = (code << 1) | get(1);
        l++;
      }
      if (l > 16) return 0;
      return t.vals[(code + t.valoffset[l]) & 0xFF];
    }
    uint16_t e = t.look[buf >> (64 - 9)];
    if (e) {
      int l = e >> 8;
      buf <<= l;
      cnt -= l;
      return e & 0xFF;
    }
    int l = 10;
    int32_t code = int32_t(buf >> (64 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      l++;
      code = int32_t(buf >> (64 - l));
    }
    if (l > 16) {  // libjpeg: a bad code takes 17 bits and decodes as 0
      buf <<= 16;
      cnt -= 16;
      get(1);
      return 0;
    }
    buf <<= l;
    cnt -= l;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct JComp {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int wib, hib;  // blocks holding image samples
  int bw, bh;    // blocks in the coefficient buffer (whole MCUs)
  int pred = 0;
  bool latched = false;
  int16_t q[64];  // natural order, as libjpeg's ISLOW multiplier table
  std::vector<int16_t> coef;
  int coef_bits[64];
  int16_t* block(int by, int bx) {
    return &coef[(size_t(by) * bw + bx) * 64];
  }
};

// jidctint.c jpeg_idct_islow, with the range-limit table of
// jdmaster.c prepare_range_limit_table
void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                size_t stride) {
  // idct_table[x & 1023]: x + 128 clamped to [0, 255], wrapping past
  // +-512 as libjpeg's table does
  struct Limit {
    uint8_t v[1024];
    Limit() {
      for (int i = 0; i < 1024; i++) {
        int x = i < 512 ? i : i - 1024;
        v[i] = uint8_t(i >= 512 && i < 896 ? 0
                                           : std::min(255, std::max(0, x + 128)));
      }
    }
  };
  static const Limit lim;
  const uint8_t* limit = lim.v;
  const int CB = 13, P1 = 2;
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int nb) {
    return (x + (int64_t(1) << (nb - 1))) >> nb;
  };
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = (int(ip[0]) * int(qp[0])) * (1 << P1);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int(ip[16]) * int(qp[16]), z3 = int(ip[48]) * int(qp[48]);
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = int(ip[0]) * int(qp[0]);
    z3 = int(ip[32]) * int(qp[32]);
    int64_t tmp0 = (z2 + z3) * (1 << CB);
    int64_t tmp1 = (z2 - z3) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int(ip[56]) * int(qp[56]);
    tmp1 = int(ip[40]) * int(qp[40]);
    tmp2 = int(ip[24]) * int(qp[24]);
    tmp3 = int(ip[8]) * int(qp[8]);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    wp[0] = int(descale(tmp10 + tmp3, CB - P1));
    wp[56] = int(descale(tmp10 - tmp3, CB - P1));
    wp[8] = int(descale(tmp11 + tmp2, CB - P1));
    wp[48] = int(descale(tmp11 - tmp2, CB - P1));
    wp[16] = int(descale(tmp12 + tmp1, CB - P1));
    wp[40] = int(descale(tmp12 - tmp1, CB - P1));
    wp[24] = int(descale(tmp13 + tmp0, CB - P1));
    wp[32] = int(descale(tmp13 - tmp0, CB - P1));
  }
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t v = limit[int(descale(wp[0], P1 + 3)) & 1023];
      std::memset(op, v, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << CB);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int S = CB + P1 + 3;
    op[0] = limit[int(descale(tmp10 + tmp3, S)) & 1023];
    op[7] = limit[int(descale(tmp10 - tmp3, S)) & 1023];
    op[1] = limit[int(descale(tmp11 + tmp2, S)) & 1023];
    op[6] = limit[int(descale(tmp11 - tmp2, S)) & 1023];
    op[2] = limit[int(descale(tmp12 + tmp1, S)) & 1023];
    op[5] = limit[int(descale(tmp12 - tmp1, S)) & 1023];
    op[3] = limit[int(descale(tmp13 + tmp0, S)) & 1023];
    op[4] = limit[int(descale(tmp13 - tmp0, S)) & 1023];
  }
}

const char* sof_name(int m) {
  static const char* names[16] = {
      "SOF0", "SOF1", "SOF2", "SOF3 (lossless)", "DHT", "SOF5 (hierarchical)",
      "SOF6 (hierarchical)", "SOF7 (hierarchical lossless)", "JPG",
      "SOF9 (arithmetic coding)", "SOF10 (arithmetic coding)",
      "SOF11 (arithmetic coding)", "DAC", "SOF13 (arithmetic coding)",
      "SOF14 (arithmetic coding)", "SOF15 (arithmetic coding)"};
  return names[m - 0xC0];
}

struct Jpeg {
  const uint8_t* d;
  size_t n;
  size_t pos = 2;
  JHuff dc[4], ac[4];
  struct {
    bool defined = false;
    uint16_t v[64];  // natural order
  } qt[4];
  int restart = 0;
  bool jfif = false, adobe = false;
  int transform = -1;
  bool frame = false, progressive = false;
  int W = 0, H = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<JComp> comps;
  // for TIFF's JPEG strips: keep the upsampled component planes instead of
  // converting (libjpeg's JCS_UNKNOWN), or convert as YCbCr whatever the
  // markers say (libtiff's JPEGCOLORMODE_RGB)
  bool keep_planes = false, force_ycc = false;
  bool short_ok = false;  // data ending inside a scan leaves zeros
  std::vector<std::vector<uint8_t>> planes;

  // the marker code at or after `pos` (skipping any other bytes and fill
  // FFs, as libjpeg's next_marker does), pos after it; -1 at the end
  int next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) pos++;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) return -1;
      int m = d[pos++];
      if (m != 0) return 0xFF00 | m;
    }
  }
  size_t segment() {  // a marker segment's payload length; pos at it
    if (n - pos < 2) invalid("truncated JPEG marker");
    size_t len = be16(d + pos);
    if (len < 2 || len > n - pos) invalid("truncated JPEG marker");
    pos += 2;
    return len - 2;
  }

  void read_sof(int m) {
    size_t len = segment();
    const uint8_t* s = d + pos;
    if (len < 6) invalid("short SOF");
    if (frame) invalid("two frames in one JPEG");
    if (s[0] != 8)  // libjpeg's 8-bit interface, which PIL calls, refuses it
      invalid("JPEG " + std::string(sof_name(m & 0xFF)) + " with " +
              std::to_string(s[0]) + "-bit samples");
    H = int(be16(s + 1));
    W = int(be16(s + 3));
    int nc = s[5];
    if (nc != 1 && nc != 3 && nc != 4 && !(keep_planes && nc == 2))
      invalid("JPEG of that many layers");
    if (len < size_t(6 + 3 * nc)) invalid("short SOF");
    if (W <= 0 || H <= 0) invalid("empty JPEG");
    if (int64_t(W) * H > MAX_PIXELS) invalid("JPEG larger than PIL opens");
    comps.resize(nc);
    for (int i = 0; i < nc; i++) {
      JComp& c = comps[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        invalid("bad JPEG sampling factors");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (JComp& c : comps) {
      c.wib = int((int64_t(W) * c.h + 8 * hmax - 1) / (8 * hmax));
      c.hib = int((int64_t(H) * c.v + 8 * vmax - 1) / (8 * vmax));
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    progressive = (m & 0xFF) == 0xC2;
    frame = true;
    pos += len;
  }

  void read_dht() {
    size_t len = segment();
    size_t end = pos + len;
    while (pos < end) {
      if (end - pos < 17) invalid("short DHT");
      int cls = d[pos] >> 4, id = d[pos] & 15;
      const uint8_t* counts = d + pos + 1;
      int total = 0;
      for (int i = 0; i < 16; i++) total += counts[i];
      if (total > 256 || size_t(17 + total) > end - pos || id > 3 || cls > 1)
        invalid("bad DHT");
      build_jhuff(cls ? ac[id] : dc[id], counts, d + pos + 17, total,
                  cls == 0);
      pos += 17 + size_t(total);
    }
  }

  void read_dqt() {
    size_t len = segment();
    size_t end = pos + len;
    while (pos < end) {
      int prec = d[pos] >> 4, id = d[pos] & 15;
      size_t need = 1 + 64 * (prec ? 2 : 1);
      if (id > 3 || end - pos < need) invalid("bad DQT");
      for (int k = 0; k < 64; k++)
        qt[id].v[NATURAL[k]] =
            uint16_t(prec ? be16(d + pos + 1 + 2 * k) : d[pos + 1 + k]);
      qt[id].defined = true;
      pos += need;
    }
  }

  void read_app(int m) {
    size_t len = segment();
    const uint8_t* s = d + pos;
    if (m == 0xFFE0 && len >= 14 && std::memcmp(s, "JFIF\0", 5) == 0)
      jfif = true;
    if (m == 0xFFEE && len >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
      adobe = true;
      transform = s[11];
    }
    pos += len;
  }

  // libjpeg's process_restart: drop the buffered bits, read the RSTn
  void restart_at(JBits& b) {
    b.buf = 0;
    b.cnt = 0;
    size_t p = b.pos;
    while (p < n && d[p] != 0xFF) p++;
    size_t q = p;
    while (q < n && d[q] == 0xFF) q++;
    if (q < n && d[q] >= 0xD0 && d[q] <= 0xD7) {
      b.pos = q + 1;
      b.marker = false;
      b.insufficient = false;
    } else {
      b.pos = p;
      b.marker = true;
    }
    for (JComp& c : comps) c.pred = 0;
  }

  void read_sos() {
    if (!frame) invalid("SOS before SOF");
    size_t len = segment();
    const uint8_t* s = d + pos;
    if (len < 1) invalid("short SOS");
    int ns = s[0];
    if (ns < 1 || ns > 4 || len < size_t(4 + 2 * ns)) invalid("bad SOS");
    std::vector<JComp*> sc;
    for (int i = 0; i < ns; i++) {
      int cid = s[1 + 2 * i];
      JComp* c = nullptr;
      for (JComp& x : comps)
        if (x.id == cid) c = &x;
      if (!c) invalid("SOS names an unknown component");
      c->td = s[2 + 2 * i] >> 4;
      c->ta = s[2 + 2 * i] & 15;
      if (c->td > 3 || c->ta > 3) invalid("bad SOS table");
      sc.push_back(c);
    }
    if (ns > 1) {  // jdinput.c per_scan_setup: D_MAX_BLOCKS_IN_MCU
      int blocks = 0;
      for (JComp* c : sc) blocks += c->h * c->v;
      if (blocks > 10) invalid("JPEG MCU of more than 10 blocks");
    }
    int Ss = s[1 + 2 * ns], Se = s[2 + 2 * ns];
    int Ah = s[3 + 2 * ns] >> 4, Al = s[3 + 2 * ns] & 15;
    pos += len;
    if (progressive) {
      bool bad = false;
      if (Ss == 0) {
        if (Se != 0) bad = true;
      } else {
        if (Se < Ss || Se > 63 || ns != 1) bad = true;
      }
      if (Ah != 0 && Al != Ah - 1) bad = true;
      if (Al > 13) bad = true;
      if (bad) invalid("bad progressive scan parameters");
      for (JComp* c : sc)
        for (int k = Ss; k <= Se; k++) c->coef_bits[k] = Al;
    } else {
      Ss = 0;
      Se = 63;
      Ah = Al = 0;
    }
    for (JComp* c : sc) {  // jdinput.c latch_quant_tables
      if (c->latched) continue;
      if (!qt[c->tq].defined) invalid("missing quantization table");
      for (int k = 0; k < 64; k++) c->q[k] = int16_t(qt[c->tq].v[k]);
      c->latched = true;
    }
    const bool dc_first = progressive && Ss == 0 && Ah == 0;
    const bool dc_refine = progressive && Ss == 0 && Ah != 0;
    const bool ac_first = progressive && Ss != 0 && Ah == 0;
    const bool ac_refine = progressive && Ss != 0 && Ah != 0;
    for (JComp* c : sc) {
      if ((!progressive || dc_first) && !dc[c->td].defined)
        invalid("missing DC Huffman table");
      if ((!progressive || ac_first || ac_refine) && !ac[c->ta].defined)
        invalid("missing AC Huffman table");
      c->pred = 0;
    }
    JBits b{d, n, pos};
    int eobrun = 0;
    const int p1 = 1 << Al, m1 = -1 * (1 << Al);

    auto block_seq = [&](JComp& c, int16_t* blk) {
      int s = b.decode(dc[c.td]);
      if (s) s = extend(b.get(s), s);
      c.pred += s;
      blk[0] = int16_t(c.pred);
      const JHuff& t = ac[c.ta];
      for (int k = 1; k < 64; k++) {
        int rs = b.decode(t);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[NATURAL[k]] = int16_t(extend(b.get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    };
    auto block_dc_first = [&](JComp& c, int16_t* blk) {
      int s = b.decode(dc[c.td]);
      if (s) s = extend(b.get(s), s);
      c.pred += s;
      blk[0] = int16_t(int(unsigned(c.pred) << Al));
    };
    auto block_dc_refine = [&](JComp&, int16_t* blk) {
      if (b.get(1)) blk[0] = int16_t(blk[0] | p1);
    };
    auto block_ac_first = [&](JComp& c, int16_t* blk) {
      if (eobrun > 0) {
        eobrun--;
        return;
      }
      const JHuff& t = ac[c.ta];
      for (int k = Ss; k <= Se; k++) {
        int rs = b.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[NATURAL[k]] = int16_t(int(unsigned(extend(b.get(s), s)) << Al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += b.get(r);
          eobrun--;
          break;
        }
      }
    };
    auto refine_nonzero = [&](int16_t& co) {
      if (b.get(1) && (co & p1) == 0)
        co = int16_t(co >= 0 ? co + p1 : co + m1);
    };
    auto block_ac_refine = [&](JComp& c, int16_t* blk) {
      int k = Ss;
      if (eobrun == 0) {
        const JHuff& t = ac[c.ta];
        for (; k <= Se; k++) {
          int rs = b.decode(t);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            s = b.get(1) ? p1 : m1;
          } else if (r != 15) {
            eobrun = 1 << r;
            if (r) eobrun += b.get(r);
            break;
          }
          do {
            int16_t& co = blk[NATURAL[k]];
            if (co != 0) {
              refine_nonzero(co);
            } else {
              if (--r < 0) break;
            }
            k++;
          } while (k <= Se);
          if (s) blk[NATURAL[k]] = int16_t(s);
        }
      }
      if (eobrun > 0) {
        for (; k <= Se; k++) {
          int16_t& co = blk[NATURAL[k]];
          if (co != 0) refine_nonzero(co);
        }
        eobrun--;
      }
    };

    auto run = [&](auto&& fn) {
      int64_t total;
      if (ns == 1) {
        JComp& c = *sc[0];
        total = int64_t(c.wib) * c.hib;
        for (int64_t m = 0; m < total; m++) {
          if (restart && m > 0 && m % restart == 0) {
            restart_at(b);
            eobrun = 0;
          }
          if (b.insufficient) continue;
          fn(c, c.block(int(m / c.wib), int(m % c.wib)));
        }
      } else {
        total = int64_t(mcux) * mcuy;
        for (int64_t m = 0; m < total; m++) {
          if (restart && m > 0 && m % restart == 0) {
            restart_at(b);
            eobrun = 0;
          }
          if (b.insufficient) continue;
          int my = int(m / mcux), mx = int(m % mcux);
          for (JComp* c : sc)
            for (int y = 0; y < c->v; y++)
              for (int x = 0; x < c->h; x++)
                fn(*c, c->block(my * c->v + y, mx * c->h + x));
        }
      }
    };
    if (!progressive)
      run(block_seq);
    else if (dc_first)
      run(block_dc_first);
    else if (dc_refine)
      run(block_dc_refine);
    else if (ac_first)
      run(block_ac_first);
    else
      run(block_ac_refine);
    if (b.insufficient && b.eof && !short_ok) invalid("truncated JPEG data");
    pos = b.pos;
  }

  void decode(Image& img) {
    if (n < 3 || d[0] != 0xFF || d[1] != 0xD8 || d[2] != 0xFF)
      invalid("not a JPEG file");
    bool scanned = false;
    for (;;) {
      int m = next_marker();
      if (m < 0) break;
      if (m == 0xFFD9) break;
      if (m == 0xFFC0 || m == 0xFFC1 || m == 0xFFC2) {
        read_sof(m);
      } else if ((m >= 0xFFC3 && m <= 0xFFCF) && m != 0xFFC4 &&
                 m != 0xFFC8 && m != 0xFFCC) {
        throw Unsupported(std::string("JPEG ") + sof_name(m & 0xFF) +
                          " is not decoded by craytracer_tpu_torch "
                          "(baseline, extended and progressive Huffman "
                          "JPEG are)");
      } else if (m == 0xFFC4) {
        read_dht();
      } else if (m == 0xFFDB) {
        read_dqt();
      } else if (m == 0xFFDD) {
        if (segment() < 2) invalid("short DRI");
        restart = int(be16(d + pos));
        pos += 2;
      } else if (m == 0xFFDA) {
        read_sos();
        scanned = true;
      } else if (m >= 0xFFE0 && m <= 0xFFEF) {
        read_app(m);
      } else if (m == 0xFFD8 || m == 0xFF01 || (m >= 0xFFD0 && m <= 0xFFD7)) {
        if (m == 0xFFD8) invalid("second SOI");
      } else {
        pos += segment();
      }
    }
    if (!frame || !scanned) invalid("JPEG without image data");
    if (progressive) smoothing_check();
    output(img);
  }

  // jdcoefct.c smoothing_ok (libjpeg-turbo 2.1+): block smoothing runs
  // when every component's DC is known, its first ten quantizers are
  // non-zero, and some coefficient 1-9 of some component is unrefined.
  void smoothing_check() {
    static const int Q[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (JComp& c : comps) {
      if (!c.latched) return;
      for (int i = 0; i < 10; i++)
        if (c.q[Q[i]] == 0) return;
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (useful)
      throw Unsupported(
          "progressive JPEG whose scans leave coefficient bits unrefined: "
          "libjpeg block-smooths it (jdcoefct.c), which craytracer_tpu_torch "
          "does not reproduce");
  }

  void output(Image& img) {
    const int nc = int(comps.size());
    std::vector<std::vector<uint8_t>> full(nc);
    for (int ci = 0; ci < nc; ci++) {
      JComp& c = comps[ci];
      if (!c.latched) invalid("a component no scan carries");
      size_t stride = size_t(c.wib) * 8;
      std::vector<uint8_t> plane(stride * size_t(c.hib) * 8);
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++)
          idct_islow(c.block(by, bx), c.q, &plane[by * 8 * stride + bx * 8],
                     stride);
      int dw = int((int64_t(W) * c.h + hmax - 1) / hmax);
      int dh = int((int64_t(H) * c.v + vmax - 1) / vmax);
      full[ci] = upsample(plane, stride, dw, dh, hmax / c.h, vmax / c.v,
                          hmax % c.h || vmax % c.v);
    }
    if (keep_planes) {
      planes = std::move(full);
      return;
    }
    img.alloc(W, H);
    enum { GRAY, YCC, RGB, CMYK, YCCK } cs;
    if (nc == 1) {
      cs = GRAY;
    } else if (nc == 3) {
      if (jfif)
        cs = YCC;
      else if (adobe)
        cs = transform == 0 ? RGB : YCC;
      else if (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66)
        cs = RGB;
      else
        cs = YCC;
    } else {
      cs = adobe ? (transform == 0 ? CMYK : YCCK) : CMYK;
    }
    if (force_ycc && nc == 3) cs = YCC;
    // jdcolor.c build_ycc_rgb_table
    struct Ycc {
      int cr_r[256], cb_b[256];
      int32_t cr_g[256], cb_g[256];
      Ycc() {
        const int64_t ONE_HALF = int64_t(1) << 15;
        auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
        for (int i = 0, x = -128; i < 256; i++, x++) {
          cr_r[i] = int((fix(1.40200) * x + ONE_HALF) >> 16);
          cb_b[i] = int((fix(1.77200) * x + ONE_HALF) >> 16);
          cr_g[i] = int32_t(-fix(0.71414) * x);
          cb_g[i] = int32_t(-fix(0.34414) * x + ONE_HALF);
        }
      }
    };
    static const Ycc ycc;
    const int *cr_r = ycc.cr_r, *cb_b = ycc.cb_b;
    const int32_t *cr_g = ycc.cr_g, *cb_g = ycc.cb_g;
    auto clamp = [](int v) { return v < 0 ? 0 : v > 255 ? 255 : v; };
    const size_t np = size_t(W) * H;
    uint8_t* out = img.rgb.data();
    for (size_t i = 0; i < np; i++, out += 3) {
      if (cs == GRAY) {
        out[0] = out[1] = out[2] = full[0][i];
        continue;
      }
      int a = full[0][i], b = full[1][i], c = full[2][i];
      int r, g, bl;
      if (cs == RGB || cs == CMYK) {
        r = a;
        g = b;
        bl = c;
      } else {
        r = clamp(a + cr_r[c]);
        g = clamp(a + int((cb_g[b] + cr_g[c]) >> 16));
        bl = clamp(a + cb_b[b]);
        if (cs == YCCK) {  // ycck_cmyk_convert
          r = clamp(255 - (a + cr_r[c]));
          g = clamp(255 - (a + int((cb_g[b] + cr_g[c]) >> 16)));
          bl = clamp(255 - (a + cb_b[b]));
        }
      }
      if (cs == CMYK || cs == YCCK) {
        // PIL: "CMYK;I" inverts the bytes, then Convert.c cmyk2rgb
        cmyk_to_rgb(out, 255 - r, 255 - g, 255 - bl, 255 - full[3][i]);
      } else {
        out[0] = uint8_t(r);
        out[1] = uint8_t(g);
        out[2] = uint8_t(bl);
      }
    }
  }

  // jdsample.c: the W x H plane of one component from its dw x dh
  // samples (rows `stride` apart), for expansion factors rh x rv
  std::vector<uint8_t> upsample(const std::vector<uint8_t>& in, size_t stride,
                                int dw, int dh, int rh, int rv,
                                bool fractional) {
    if (fractional) invalid("fractional JPEG sampling factors");
    std::vector<uint8_t> out(size_t(W) * H);
    auto at = [&](int x, int y) -> int { return in[size_t(y) * stride + x]; };
    const bool h2v1 = rh == 2 && rv == 1 && dw > 2;
    const bool h1v2 = rh == 1 && rv == 2;
    const bool h2v2 = rh == 2 && rv == 2 && dw > 2;
    if (h2v1) {
      for (int y = 0; y < H; y++)
        for (int x = 0; x < W; x++) {
          int c = x >> 1;
          int o = x & 1 ? std::min(c + 1, dw - 1) : std::max(c - 1, 0);
          out[size_t(y) * W + x] =
              uint8_t((3 * at(c, y) + at(o, y) + (x & 1 ? 2 : 1)) >> 2);
        }
    } else if (h1v2) {
      for (int y = 0; y < H; y++) {
        int r = y >> 1;
        int o = y & 1 ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
        for (int x = 0; x < W; x++)
          out[size_t(y) * W + x] =
              uint8_t((3 * at(x, r) + at(x, o) + (y & 1 ? 2 : 1)) >> 2);
      }
    } else if (h2v2) {
      std::vector<int> colsum(dw);
      for (int y = 0; y < H; y++) {
        int r = y >> 1;
        int o = y & 1 ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
        for (int c = 0; c < dw; c++) colsum[c] = 3 * at(c, r) + at(c, o);
        for (int x = 0; x < W; x++) {
          int c = x >> 1;
          int v = x & 1
                      ? (3 * colsum[c] + colsum[std::min(c + 1, dw - 1)] + 7) >> 4
                      : (3 * colsum[c] + colsum[std::max(c - 1, 0)] + 8) >> 4;
          out[size_t(y) * W + x] = uint8_t(v);
        }
      }
    } else {  // fullsize, box h2v1 / h2v2, int_upsample
      for (int y = 0; y < H; y++)
        for (int x = 0; x < W; x++)
          out[size_t(y) * W + x] = uint8_t(at(x / rh, y / rv));
    }
    return out;
  }
};

// ---------------------------------------------------------------- PNM

const int SAFEBLOCK = 1024 * 1024;  // PIL's ImageFile.SAFEBLOCK

inline bool pnm_ws(int c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
         c == '\r';
}

// Python's int() of an ASCII token: a sign, digits, single underscores
// between digits
bool py_int(const std::string& t, int64_t& v) {
  size_t i = 0;
  bool neg = false;
  if (i < t.size() && (t[i] == '+' || t[i] == '-')) neg = t[i++] == '-';
  if (i >= t.size() || !std::isdigit(uint8_t(t[i]))) return false;
  v = 0;
  for (; i < t.size(); i++) {
    if (t[i] == '_') {
      if (i + 1 >= t.size() || !std::isdigit(uint8_t(t[i + 1]))) return false;
      continue;
    }
    if (!std::isdigit(uint8_t(t[i]))) return false;
    v = v * 10 + (t[i] - '0');
    if (v > (int64_t(1) << 40)) return false;
  }
  if (neg) v = -v;
  return true;
}

// PIL's round(value / maxval * out_max), round half to even
inline int pnm_scale(int64_t v, int64_t maxval, int out_max) {
  double x = double(v) / double(maxval) * double(out_max);
  return int(std::nearbyint(x));
}

// Python's float() of an ASCII token, finite or not; false if it would
// raise
bool py_float(const std::string& t, double& v) {
  std::string u;
  for (size_t i = 0; i < t.size(); i++) {
    char c = t[i];
    if (c == '_') {  // only between digits
      if (i == 0 || i + 1 == t.size() || !std::isdigit(uint8_t(t[i - 1])) ||
          !std::isdigit(uint8_t(t[i + 1])))
        return false;
      continue;
    }
    if (c == 'x' || c == 'X' || c == 'p' || c == 'P') return false;
    u += c;
  }
  if (u.empty()) return false;
  char* end = nullptr;
  v = std::strtod(u.c_str(), &end);
  return end == u.c_str() + u.size();
}

// PIL's Pf: gray float32, little-endian under a negative scale, rows
// bottom-up; convert("RGB") goes through F -> L
void decode_pfm(const uint8_t* d, size_t n, size_t pos, int64_t w, int64_t h,
                double scale, Image& img) {
  if (scale == 0.0 || !std::isfinite(scale))
    invalid("PFM scale must be finite and non-zero");
  img.alloc(w, h);
  if ((n - pos) / 4 < size_t(w * h)) invalid("truncated PFM data");
  for (int64_t y = 0; y < h; y++)
    for (int64_t x = 0; x < w; x++) {
      const uint8_t* p = d + pos + size_t((h - 1 - y) * w + x) * 4;
      uint32_t bits = scale < 0 ? le32(p) : be32(p);
      float f;
      std::memcpy(&f, &bits, 4);
      uint8_t v = float_to_l(f);
      img.put(x, y, v, v, v);
    }
}

void decode_pnm(const uint8_t* d, size_t n, Image& img) {
  size_t pos = 0;
  std::string magic;
  for (int i = 0; i < 6; i++) {
    if (pos >= n) break;
    int c = d[pos++];
    if (pnm_ws(c)) break;
    magic += char(c);
  }
  // PIL's own modes: 0 none, 1 CMYK, 2 P, 3 RGBA, 4 F
  int ext = magic == "P0CMYK" || magic == "PyCMYK" ? 1
            : magic == "PyP"                       ? 2
            : magic == "PyRGBA"                    ? 3
            : magic == "Pf"                        ? 4
                                                   : 0;
  if (!ext && (magic.size() != 2 || magic[0] != 'P' || magic[1] < '1' ||
               magic[1] > '6'))
    invalid("not a PPM file");
  const int kind = ext ? 5 : magic[1] - '0';  // PIL's own: the raw path
  auto token_str = [&]() {
    std::string t;
    while (t.size() <= 10) {
      if (pos >= n) break;
      int c = d[pos++];
      if (pnm_ws(c)) {
        if (t.empty()) continue;
        break;
      }
      if (c == '#') {
        while (pos < n) {
          int e = d[pos++];
          if (e == '\r' || e == '\n') break;
        }
        continue;
      }
      t += char(c);
    }
    if (t.empty() || t.size() > 10) invalid("bad PNM header");
    return t;
  };
  auto token = [&]() -> int64_t {
    int64_t v;
    if (!py_int(token_str(), v)) invalid("bad PNM header");
    return v;
  };
  int64_t w = token(), h = token();
  if (ext == 4) {
    double scale = 0.0;
    if (!py_float(token_str(), scale)) invalid("bad PFM scale");
    decode_pfm(d, n, pos, w, h, scale, img);
    return;
  }
  const bool bitonal = kind == 1 || kind == 4;
  const bool rgb = kind == 3 || kind == 6;
  int64_t maxval = 1;
  if (!bitonal) {
    maxval = token();
    if (!(maxval > 0 && maxval < 65536)) invalid("bad PNM maxval");
  }
  img.alloc(w, h);
  const int bands = ext == 1 || ext == 3 ? 4 : ext == 2 ? 1 : rgb ? 3 : 1;
  const bool mode_i = !ext && !rgb && !bitonal && maxval > 255;  // mode "I"
  const int out_max = mode_i ? 65535 : 255;
  const size_t total = size_t(w) * size_t(h) * bands;
  std::vector<int> vals(total);
  if (kind == 4) {
    size_t rb = size_t((w + 7) / 8);
    if ((n - pos) / rb < size_t(h)) invalid("truncated PBM data");
    for (int64_t y = 0; y < h; y++)
      for (int64_t x = 0; x < w; x++)
        vals[size_t(y * w + x)] =
            (d[pos + y * rb + x / 8] >> (7 - x % 8)) & 1 ? 0 : 255;
  } else if (kind == 5 || kind == 6) {  // and PIL's own modes
    if (maxval == 255 || (mode_i && maxval == 65535)) {  // the raw decoder
      size_t bytes = maxval == 255 ? 1 : 2;
      if ((n - pos) / bytes < total) invalid("truncated PNM data");
      for (size_t i = 0; i < total; i++)
        vals[i] = bytes == 1 ? d[pos + i] : int(be16(d + pos + 2 * i));
    } else {  // PIL's PpmDecoder, whole pixels only
      size_t bytes = maxval < 256 ? 1 : 2;
      if ((n - pos) / (bytes * bands) < total / bands)
        invalid("truncated PNM data");
      for (size_t i = 0; i < total; i++) {
        int64_t v = bytes == 1 ? d[pos + i] : int64_t(be16(d + pos + 2 * i));
        vals[i] = std::min(out_max, pnm_scale(v, maxval, out_max));
      }
    }
  } else {
    // PIL's PpmPlainDecoder: comments (to the first CR or LF, which goes
    // with them) are cut out of the text before it is split at whitespace
    size_t got = 0;
    size_t block_end = pos + SAFEBLOCK;
    std::string t;
    bool in_comment = false;
    for (size_t i = pos; i < n; i++) {
      if (i >= block_end) {
        if (got >= total) break;
        block_end += SAFEBLOCK;
      }
      // a plain P2/P3 stops at its last value; P1 checks the rest of the
      // block it ends in, as PIL's _decode_bitonal does
      if (got >= total && kind != 1) break;
      int c = d[i];
      if (in_comment) {
        if (c == '\r' || c == '\n') in_comment = false;
        continue;
      }
      if (c == '#') {
        in_comment = true;
        continue;
      }
      if (kind == 1) {
        if (pnm_ws(c)) continue;
        if (c != '0' && c != '1') invalid("bad PBM token");
        if (got < total) vals[got++] = c == '1' ? 0 : 255;
        continue;
      }
      if (!pnm_ws(c)) {
        t += char(c);
        if (t.size() > 10) invalid("PNM token too long");
        if (i + 1 < n) continue;
      }
      if (t.empty()) continue;
      int64_t v;
      if (!py_int(t, v) || v < 0 || v > maxval) invalid("bad PNM value");
      vals[got++] = pnm_scale(v, maxval, out_max);
      t.clear();
    }
    if (got < total) invalid("truncated plain PNM data");
  }
  uint8_t* o = img.rgb.data();
  for (size_t p = 0; p < size_t(w * h); p++, o += 3) {
    if (ext == 1) {
      const int* v = &vals[4 * p];
      cmyk_to_rgb(o, v[0], v[1], v[2], v[3]);
    } else if (ext == 2) {  // "P" with no palette: black
      o[0] = o[1] = o[2] = 0;
    } else if (bands >= 3) {
      const int* v = &vals[size_t(bands) * p];
      o[0] = uint8_t(v[0]);
      o[1] = uint8_t(v[1]);
      o[2] = uint8_t(v[2]);
    } else {
      int v = std::min(vals[p], 255);  // mode I clips in convert("RGB")
      o[0] = o[1] = o[2] = uint8_t(v);
    }
  }
}

// ---------------------------------------------------------------- BMP

// 16-bit unpackers (Unpack.c BGR;15 / BGR;16): 5 or 6 bits scaled with
// truncation
inline void bgr15(uint32_t p, int& r, int& g, int& b) {
  b = (p & 31) * 255 / 31;
  g = ((p >> 5) & 31) * 255 / 31;
  r = ((p >> 10) & 31) * 255 / 31;
}
inline void bgr16(uint32_t p, int& r, int& g, int& b) {
  b = (p & 31) * 255 / 31;
  g = ((p >> 5) & 63) * 255 / 63;
  r = ((p >> 11) & 31) * 255 / 31;
}

void decode_bmp(const uint8_t* d, size_t n, Image& img) {
  if (n < 18 || d[0] != 'B' || d[1] != 'M') invalid("not a BMP file");
  int64_t offset = le32(d + 10);
  size_t hs = le32(d + 14);
  if (hs < 4 || n - 14 < hs) invalid("truncated BMP header");
  const uint8_t* hd = d + 18;  // the header after its size field
  size_t pos = 14 + hs;
  int64_t w, h;
  int bits, compression;
  int64_t colors = 0;
  int pal_pad;
  bool top_down = false;
  uint32_t masks[4] = {0, 0, 0, 0};
  if (hs == 12) {
    w = le16(hd);
    h = le16(hd + 2);
    bits = int(le16(hd + 6));
    compression = 0;
    pal_pad = 3;
  } else if (hs == 40 || hs == 52 || hs == 56 || hs == 64 || hs == 108 ||
             hs == 124) {
    top_down = hd[7] == 0xFF;
    w = int32_t(le32(hd));
    h = top_down ? int64_t(4294967296LL) - le32(hd + 4) : int64_t(le32(hd + 4));
    bits = int(le16(hd + 10));
    compression = int(le32(hd + 12));
    colors = le32(hd + 28);
    pal_pad = 4;
    if (compression == 3) {
      if (hs - 4 >= 48) {
        for (int i = 0; i < (hs - 4 >= 52 ? 4 : 3); i++)
          masks[i] = le32(hd + 36 + 4 * i);
      } else {
        if (n - pos < 12) invalid("truncated BMP masks");
        for (int i = 0; i < 3; i++) masks[i] = le32(d + pos + 4 * i);
        pos += 12;
      }
    }
  } else {
    invalid("unsupported BMP header");
  }
  if (!colors) colors = int64_t(1) << std::min(bits, 40);
  if (offset == 14 + int64_t(hs) && bits <= 8) offset += 4 * colors;
  if (bits != 1 && bits != 4 && bits != 8 && bits != 16 && bits != 24 &&
      bits != 32)
    invalid("unsupported BMP pixel depth");
  // byte order of a pixel's R, G, B for 24/32 bits; 16-bit formats apart
  int ri = 2, gi = 1, bi = 0, b16 = 15;
  bool rle = false, rle4 = false;
  if (compression == 3) {
    struct Layout {
      int bits;
      uint32_t m[4];
      int r, g, b;
    };
    static const Layout L[] = {
        {32, {0xFF0000, 0xFF00, 0xFF, 0}, 2, 1, 0},            // BGRX
        {32, {0xFF000000, 0xFF0000, 0xFF00, 0}, 3, 2, 1},      // XBGR
        {32, {0xFF000000, 0xFF00, 0xFF, 0}, 3, 1, 0},          // BGXR
        {32, {0xFF000000, 0xFF0000, 0xFF00, 0xFF}, 3, 2, 1},   // ABGR
        {32, {0xFF, 0xFF00, 0xFF0000, 0xFF000000}, 0, 1, 2},   // RGBA
        {32, {0xFF0000, 0xFF00, 0xFF, 0xFF000000}, 2, 1, 0},   // BGRA
        {32, {0xFF000000, 0xFF00, 0xFF, 0xFF0000}, 3, 1, 0},   // BGAR
        {32, {0, 0, 0, 0}, 2, 1, 0},                           // BGRA
        {24, {0xFF0000, 0xFF00, 0xFF, 0}, 2, 1, 0},            // BGR
        {16, {0xF800, 0x7E0, 0x1F, 0}, 0, 0, 0},               // BGR;16
        {16, {0x7C00, 0x3E0, 0x1F, 0}, 0, 0, 0}};              // BGR;15
    bool found = false;
    for (const Layout& l : L) {
      if (l.bits != bits) continue;
      bool same = l.m[0] == masks[0] && l.m[1] == masks[1] &&
                  l.m[2] == masks[2] && (bits != 32 || l.m[3] == masks[3]);
      if (!same) continue;
      b16 = masks[0] == 0xF800 ? 16 : 15;
      ri = l.r;
      gi = l.g;
      bi = l.b;
      found = true;
      break;
    }
    if (!found) invalid("unsupported BMP bitfields layout");
  } else if (compression == 1 || compression == 2) {
    rle = true;
    rle4 = compression == 2;
  } else if (compression != 0) {
    invalid("unsupported BMP compression");
  }
  Palette pal;
  bool gray = false;  // PIL's mode "L" or "1": the palette is the ramp
  if (bits <= 8) {
    if (!(colors > 0 && colors <= 65536)) invalid("bad BMP palette size");
    if ((n - pos) / pal_pad < size_t(colors)) invalid("truncated BMP palette");
    const uint8_t* pp = d + pos;
    gray = true;
    for (int64_t i = 0; i < colors; i++) {
      int want = colors == 2 ? (i == 0 ? 0 : i == 1 ? 255 : -1) : int(i);
      if (colors == 2 && i > 1) break;
      if (want > 255 || pp[i * pal_pad] != want ||
          pp[i * pal_pad + 1] != want || pp[i * pal_pad + 2] != want)
        gray = false;
    }
    for (int64_t i = 0; i < colors && i < 256; i++) {
      pal.rgb[i][0] = pp[i * pal_pad + 2];
      pal.rgb[i][1] = pp[i * pal_pad + 1];
      pal.rgb[i][2] = pp[i * pal_pad];
    }
    pos += size_t(pal_pad * colors);
    if (gray && bits == 4)
      throw Unsupported("4-bit BMP whose palette is the ramp 0-15, which "
                        "PIL reads as 8-bit gray");
    if (gray && rle && colors == 2) invalid("RLE BMP of mode 1");
  }
  size_t start = offset ? size_t(offset) : pos;
  if (start > n) invalid("BMP data offset past the end");
  img.alloc(w, h);
  auto put_index = [&](int64_t x, int64_t y, int v) {
    if (gray && colors != 2)
      img.put(x, y, v, v, v);
    else
      img.put(x, y, pal.rgb[v][0], pal.rgb[v][1], pal.rgb[v][2]);
  };
  if (rle) {
    // PIL's BmpRleDecoder, byte for byte: a delta reads four bytes and
    // uses the last two, an odd absolute RLE4 run drops its last pixel,
    // padding is to an even file offset
    std::vector<uint8_t> data;
    const size_t want = size_t(w) * size_t(h);
    data.reserve(want);
    size_t p = start;
    int64_t x = 0;
    while (data.size() < want) {
      if (n - p < 2) break;
      int count = d[p], byte = d[p + 1];
      p += 2;
      if (count) {
        if (x + count > w) count = int(std::max<int64_t>(0, w - x));
        for (int i = 0; i < count; i++)
          data.push_back(uint8_t(rle4 ? (i % 2 == 0 ? byte >> 4 : byte & 15)
                                      : byte));
        x += count;
      } else if (byte == 0) {
        while (data.size() % size_t(w)) data.push_back(0);
        x = 0;
      } else if (byte == 1) {
        break;
      } else if (byte == 2) {
        if (n - p < 2) break;
        p += 2;
        if (n - p < 2) invalid("truncated BMP delta");
        int right = d[p], up = d[p + 1];
        p += 2;
        data.insert(data.end(), size_t(right + int64_t(up) * w), 0);
        x = int64_t(data.size() % size_t(w));
      } else {
        size_t nb = rle4 ? size_t(byte / 2) : size_t(byte);
        size_t got = std::min(nb, n - p);
        for (size_t i = 0; i < got; i++) {
          if (rle4) {
            data.push_back(uint8_t(d[p + i] >> 4));
            data.push_back(uint8_t(d[p + i] & 15));
          } else {
            data.push_back(d[p + i]);
          }
        }
        p += got;
        if (got < nb) break;
        x += byte;
        if (p % 2) p++;
      }
    }
    if (data.size() < want) invalid("not enough BMP image data");
    for (int64_t r = 0; r < h; r++) {
      int64_t y = top_down ? r : h - 1 - r;
      for (int64_t c = 0; c < w; c++) put_index(c, y, data[size_t(r * w + c)]);
    }
    return;
  }
  const size_t stride = size_t(((w * bits + 31) >> 3) & ~int64_t(3));
  if ((n - start) / stride < size_t(h)) invalid("truncated BMP data");
  for (int64_t r = 0; r < h; r++) {
    const uint8_t* row = d + start + size_t(r) * stride;
    int64_t y = top_down ? r : h - 1 - r;
    for (int64_t x = 0; x < w; x++) {
      if (bits <= 8) {
        size_t bit = size_t(x) * bits;
        int v = (row[bit >> 3] >> (8 - bits - (bit & 7))) & ((1 << bits) - 1);
        put_index(x, y, v);
      } else if (bits == 16) {
        int r_, g_, b_;
        uint32_t p = le16(row + 2 * x);
        if (b16 == 16)
          bgr16(p, r_, g_, b_);
        else
          bgr15(p, r_, g_, b_);
        img.put(x, y, r_, g_, b_);
      } else {
        const uint8_t* s = row + x * (bits / 8);
        img.put(x, y, s[ri], s[gi], s[bi]);
      }
    }
  }
}

// ---------------------------------------------------------------- TGA

void decode_tga(const uint8_t* d, size_t n, Image& img) {
  if (n < 18) invalid("truncated TGA header");
  int id_len = d[0], cmtype = d[1], itype = d[2], depth = d[16],
      flags = d[17];
  int64_t w = le16(d + 12), h = le16(d + 14);
  if (cmtype > 1 || w <= 0 || h <= 0 ||
      (depth != 1 && depth != 8 && depth != 16 && depth != 24 && depth != 32))
    invalid("not a TGA file");
  const int base = itype & 7;
  if (!(itype == 1 || itype == 2 || itype == 3 || itype == 9 || itype == 10 ||
        itype == 11))
    invalid("unknown TGA mode");
  const bool top_down = flags & 0x20;
  const bool mirror = flags & 0x10;
  size_t pos = 18 + size_t(id_len);
  Palette pal;
  if (cmtype) {
    if (n < pos) invalid("truncated TGA");
    int start = int(le16(d + 3)), size = int(le16(d + 5)), md = d[7];
    int eb = md == 16 ? 2 : md == 24 ? 3 : md == 32 ? 4 : 0;
    if (!eb) invalid("unknown TGA map depth");
    size_t avail = std::min(size_t(eb) * size, n - pos);
    for (size_t i = 0; i < avail / eb; i++) {
      size_t e = start + i;
      if (e >= 256) break;
      const uint8_t* s = d + pos + i * eb;
      int r, g, b;
      if (eb == 2)
        bgr15(le16(s), r, g, b);
      else {
        b = s[0];
        g = s[1];
        r = s[2];
      }
      pal.rgb[e][0] = uint8_t(r);
      pal.rgb[e][1] = uint8_t(g);
      pal.rgb[e][2] = uint8_t(b);
    }
    pos += avail;
  }
  // PIL's (imagetype & 7, depth) -> rawmode table
  enum { P8, G1, G8, GA16, BGR15, BGR24, BGRA32 } raw;
  if (base == 1 && depth == 8 && cmtype)
    raw = P8;
  else if (base == 3 && depth == 1)
    raw = G1;
  else if (base == 3 && depth == 8)
    raw = G8;
  else if (base == 3 && depth == 16)
    raw = GA16;
  else if (base == 2 && depth == 16)
    raw = BGR15;
  else if (base == 2 && depth == 24)
    raw = BGR24;
  else if (base == 2 && depth == 32)
    raw = BGRA32;
  else
    invalid("TGA of an undecodable mode");
  // PIL puts a colour map on the image it loads: a gray (L or LA) image
  // turns into a palette image through it; a true-colour or 1-bit image
  // takes none, and no image takes one of 32-bit entries
  if (cmtype && (raw == BGR15 || raw == BGR24 || raw == BGRA32 ||
                 raw == G1 || d[7] == 32))
    invalid("TGA colour map PIL cannot apply");
  img.alloc(w, h);
  const size_t line = size_t((depth * w + 7) / 8);
  std::vector<uint8_t> buf(line * size_t(h));  // rows in file order
  if (itype & 8) {
    // TgaRleDecode.c: a literal packet may run on into the next line; a
    // run packet past the end of its line is an error
    const int px = depth / 8;
    if (px == 0) invalid("1-bit RLE TGA");
    size_t rows = 0, x = 0, p = pos;
    while (rows < size_t(h)) {
      if (p >= n) invalid("truncated TGA data");
      int hdr = d[p];
      size_t cnt = size_t(px) * ((hdr & 0x7F) + 1);
      uint8_t* rowp = &buf[rows * line];
      if (hdr & 0x80) {
        if (n - p < size_t(1 + px)) invalid("truncated TGA data");
        if (x + cnt > line) invalid("TGA run past its line");
        for (size_t i = 0; i < cnt; i += px)
          std::memcpy(rowp + x + i, d + p + 1, px);
        p += 1 + px;
        x += cnt;
        if (x >= line) {
          x = 0;
          rows++;
        }
      } else {
        if (n - p < 1 + cnt) invalid("truncated TGA data");
        const uint8_t* src = d + p + 1;
        p += 1 + cnt;
        while (cnt && rows < size_t(h)) {
          size_t k = std::min(cnt, line - x);
          std::memcpy(&buf[rows * line] + x, src, k);
          src += k;
          cnt -= k;
          x += k;
          if (x >= line) {
            x = 0;
            rows++;
          }
        }
      }
    }
  } else {
    if ((n - pos) / line < size_t(h)) invalid("truncated TGA data");
    std::memcpy(buf.data(), d + pos, line * size_t(h));
  }
  for (int64_t r = 0; r < h; r++) {
    const uint8_t* row = &buf[size_t(r) * line];
    int64_t y = top_down ? r : h - 1 - r;
    for (int64_t c = 0; c < w; c++) {
      int64_t x = mirror ? w - 1 - c : c;
      int rr, gg, bb;
      switch (raw) {
        case P8:
          rr = pal.rgb[row[c]][0];
          gg = pal.rgb[row[c]][1];
          bb = pal.rgb[row[c]][2];
          break;
        case G1:
          rr = gg = bb = (row[c >> 3] >> (7 - (c & 7))) & 1 ? 255 : 0;
          break;
        case G8:
        case GA16: {
          int v = row[raw == G8 ? c : 2 * c];
          if (cmtype) {
            rr = pal.rgb[v][0];
            gg = pal.rgb[v][1];
            bb = pal.rgb[v][2];
          } else {
            rr = gg = bb = v;
          }
          break;
        }
        case BGR15:
          bgr15(le16(row + 2 * c), rr, gg, bb);
          break;
        default: {
          const uint8_t* s = row + c * (raw == BGR24 ? 3 : 4);
          bb = s[0];
          gg = s[1];
          rr = s[2];
        }
      }
      img.put(x, y, rr, gg, bb);
    }
  }
}

// ---------------------------------------------------------------- GIF

void decode_gif(const uint8_t* d, size_t n, Image& img) {
  if (n < 13 || (std::memcmp(d, "GIF87a", 6) && std::memcmp(d, "GIF89a", 6)))
    invalid("not a GIF file");
  int64_t sw = le16(d + 6), sh = le16(d + 8);
  int flags = d[10];
  size_t pos = 13;
  // a palette PIL keeps: not the identity gray ramp of its length
  auto read_palette = [&](int bits, Palette& pal) -> bool {
    size_t len = size_t(3) << bits;
    size_t avail = std::min(len, n - pos);
    bool needed = false;
    for (size_t i = 0; i + 2 < avail; i += 3) {
      if (!(d[pos + i] == i / 3 && d[pos + i + 1] == i / 3 &&
            d[pos + i + 2] == i / 3))
        needed = true;
      if (i / 3 < 256)
        for (int c = 0; c < 3; c++) pal.rgb[i / 3][c] = d[pos + i + c];
    }
    pos += avail;
    return needed;
  };
  Palette global, local;
  bool have_global = false;
  if (flags & 128) have_global = read_palette((flags & 7) + 1, global);
  auto skip_blocks = [&]() {
    while (pos < n && d[pos]) pos += 1 + size_t(d[pos]);
    pos++;
  };
  int transparency = -1;
  for (;;) {
    if (pos >= n || d[pos] == ';') invalid("no image in the GIF");
    int c = d[pos++];
    if (c == '!') {
      if (pos >= n) invalid("truncated GIF");
      int label = d[pos++];
      if (label == 249 && pos < n && d[pos]) {
        int bl = d[pos];
        if (n - pos - 1 < size_t(bl)) invalid("truncated GIF");
        if (bl < 3 || ((d[pos + 1] & 1) && bl < 4))
          invalid("short GIF graphic control block");
        if (d[pos + 1] & 1) transparency = d[pos + 4];
      }
      skip_blocks();
    } else if (c == ',') {
      break;
    }
  }
  if (n - pos < 9) invalid("truncated GIF image descriptor");
  int64_t x0 = le16(d + pos), y0 = le16(d + pos + 2);
  int64_t fw = le16(d + pos + 4), fh = le16(d + pos + 6);
  int iflags = d[pos + 8];
  pos += 9;
  const bool interlace = iflags & 64;
  bool use_palette = have_global;
  const Palette* pal = &global;
  if (iflags & 128) {
    use_palette = read_palette((iflags & 7) + 1, local);
    pal = &local;
  }
  if (pos >= n) invalid("truncated GIF");
  int bits = d[pos++];
  int64_t W = std::max(sw, x0 + fw), H = std::max(sh, y0 + fh);
  img.alloc(W, H);
  std::vector<uint8_t> idx(size_t(W) * H, uint8_t(transparency < 0 ? 0
                                                                   : transparency));
  // the LZW stream's sub-blocks
  std::vector<uint8_t> lzw;
  while (pos < n && d[pos]) {
    size_t l = std::min(size_t(d[pos]), n - pos - 1);
    lzw.insert(lzw.end(), d + pos + 1, d + pos + 1 + l);
    pos += 1 + l;
  }
  if (bits < 1 || bits > 11) invalid("bad GIF code size");
  // interlaced row order
  std::vector<int64_t> rows;
  if (interlace) {
    static const int START[4] = {0, 4, 2, 1}, STEP[4] = {8, 8, 4, 2};
    for (int p = 0; p < 4; p++)
      for (int64_t r = START[p]; r < fh; r += STEP[p]) rows.push_back(r);
  } else {
    for (int64_t r = 0; r < fh; r++) rows.push_back(r);
  }
  const int clear = 1 << bits, eoi = clear + 1;
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), stack(4097);
  for (int i = 0; i < clear; i++) suffix[i] = uint8_t(i);
  int size = bits + 1, next = clear + 2, prev = -1;
  uint8_t first = 0;
  size_t bitpos = 0;
  const size_t nbits = lzw.size() * 8;
  const int64_t npix = fw * fh;
  int64_t out = 0;
  auto emit = [&](uint8_t v) {
    if (out < npix) {
      int64_t fx = out % fw, fy = rows[size_t(out / fw)];
      idx[size_t((y0 + fy) * W + x0 + fx)] = v;
    }
    out++;
  };
  while (out < npix && bitpos + size <= nbits) {
    int code = 0;
    for (int i = 0; i < size; i++, bitpos++)
      code |= ((lzw[bitpos >> 3] >> (bitpos & 7)) & 1) << i;
    if (code == clear) {
      size = bits + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    int sp = 0, cur = code;
    if (prev < 0) {
      if (code >= clear) invalid("bad GIF code");
      first = uint8_t(code);
      emit(first);
      prev = code;
      continue;
    }
    if (code > next || (code == next && next >= 4096)) invalid("bad GIF code");
    if (code == next) {
      stack[sp++] = first;
      cur = prev;
    }
    while (cur >= clear) {
      stack[sp++] = suffix[cur];
      cur = prefix[cur];
    }
    first = uint8_t(cur);
    stack[sp++] = first;
    while (sp) emit(stack[--sp]);
    if (next < 4096) {
      prefix[next] = uint16_t(prev);
      suffix[next] = first;
      next++;
      if (next == (1 << size) && size < 12) size++;
    }
    prev = code;
  }
  for (int64_t i = 0; i < W * H; i++) {
    int v = idx[size_t(i)];
    uint8_t* o = &img.rgb[size_t(i) * 3];
    if (use_palette) {
      o[0] = pal->rgb[v][0];
      o[1] = pal->rgb[v][1];
      o[2] = pal->rgb[v][2];
    } else {
      o[0] = o[1] = o[2] = uint8_t(v);
    }
  }
}

}  // namespace

#include "imgdecode_dds.h"
#include "imgdecode_psd.h"
#include "imgdecode_tiff.h"
#include "imgdecode_webp.h"

namespace {

struct Result {
  int status = 0;
  std::string message;
  Image img;
};

}  // namespace

extern "C" {

// kind: 1 PNG, 2 JPEG, 3 PNM, 4 BMP, 5 TGA, 6 GIF, 7 TIFF, 8 DDS, 9 WebP,
// 10 PSD
void* imgd_decode(int kind, const uint8_t* data, int64_t n) {
  Result* r = new Result;
  try {
    switch (kind) {
      case 1:
        decode_png(data, size_t(n), r->img);
        break;
      case 2: {
        Jpeg j;
        j.d = data;
        j.n = size_t(n);
        j.decode(r->img);
        break;
      }
      case 3:
        decode_pnm(data, size_t(n), r->img);
        break;
      case 4:
        decode_bmp(data, size_t(n), r->img);
        break;
      case 5:
        decode_tga(data, size_t(n), r->img);
        break;
      case 6:
        decode_gif(data, size_t(n), r->img);
        break;
      case 7:
        decode_tiff(data, size_t(n), r->img);
        break;
      case 8:
        decode_dds(data, size_t(n), r->img);
        break;
      case 9:
        decode_webp(data, size_t(n), r->img);
        break;
      case 10:
        decode_psd(data, size_t(n), r->img);
        break;
      default:
        throw Unsupported("unknown image kind");
    }
  } catch (const Unsupported& e) {
    r->status = 1;
    r->message = e.what();
  } catch (const Invalid& e) {
    r->status = 2;
    r->message = e.what();
  } catch (const std::bad_alloc&) {
    r->status = 2;
    r->message = "out of memory";
  }
  return r;
}

int imgd_status(void* h) { return static_cast<Result*>(h)->status; }
const char* imgd_message(void* h) {
  return static_cast<Result*>(h)->message.c_str();
}
int64_t imgd_width(void* h) { return static_cast<Result*>(h)->img.w; }
int64_t imgd_height(void* h) { return static_cast<Result*>(h)->img.h; }
void imgd_copy(void* h, uint8_t* out) {
  const std::vector<uint8_t>& v = static_cast<Result*>(h)->img.rgb;
  std::memcpy(out, v.data(), v.size());
}
void imgd_free(void* h) { delete static_cast<Result*>(h); }

}  // extern "C"
