// The last of PIL's plugins for csrc/imgdecode.cpp, which includes this
// file after its shared helpers (the JPEG, PNG, PNM and BC1 decoders, the
// inflater): SUN, XPM, MSP, DCX, PIXAR, McIdas, IMT, XVThumb, GBR, FITS,
// FTEX, BLP, ICNS, IPTC, FLI and PCD, each to what PIL 12.1's plugin and
// Image.convert("RGB") give.
//
// - SUN: raw 1, 4, 8, 24 and 32 bits in 16-bit padded rows, a planar
//   colour map, and SunRleDecode.c (its rows are not padded; a run that
//   crosses a row carries over).
// - XPM: XpmImagePlugin's palette lines and its Python decoder (keys
//   across the text between a line's first and last quote, pixels as one
//   stream). A key with no colour ("None") fails where a pixel uses it.
// - MSP: v1 raw "1"; v2 MspDecoder's row map and runs, as one stream.
// - DCX: the first PCX page through the PCX decoder.
// - PIXAR, McIdas, IMT, XVThumb, GBR: raw data at the plugin's offset
//   (XVThumb through its 3-3-2 palette); McIdas I;16B clipped, I;32B
//   clipped.
// - FITS: the header cards as FitsImagePlugin reads them, raw L, I;16
//   (little-endian, as PIL reads it), I, F bottom-up; fits_gzip.
// - FTEX: raw RGB or BC1 as PIL's bcn decoder.
// - BLP: BLP1 JPEG (header prepended, the RGB read back as BGR; four
//   layers taken as CMYK, never YCCK), BLP1 and BLP2 palettes, BLP2 DXT1/3/5
//   through BlpImagePlugin's own Python decoders (rows of whole blocks,
//   one stream).
// - ICNS: IcnsFile's best size, read_32 / read_32t runs, read_mk masks,
//   PNG inside; JPEG 2000 inside is not decoded here.
// - IPTC: the (8, 10) fields behind a P5 header (or a JPEG), one band of
//   an RGB or CMYK image.
// - FLI: FliDecode.c on the first frame (COLOR chunks set the palette in
//   the plugin; BLACK, BRUN, COPY, LC, SS2).
// - PCD: PcdDecode.c on the 768x512 base image, UnpackYCC.c's PhotoYCC
//   tables, the orientation's rotation.
//
// A failure inside the plugin's _open that PIL's Image.open answers by
// trying the next plugin is status 3 (HandOnErr); one inside its load is
// status 2 (None).

#include <iterator>
#include <tuple>

namespace {

// Python's bytes.strip / split whitespace
inline bool py_space(int c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

std::string py_rstrip(std::string s) {
  while (!s.empty() && py_space(uint8_t(s.back()))) s.pop_back();
  return s;
}

std::string py_strip_all(std::string s) {
  size_t a = 0;
  while (a < s.size() && py_space(uint8_t(s[a]))) a++;
  s = s.substr(a);
  return py_rstrip(s);
}

std::vector<std::string> py_split(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size()) {
    while (i < s.size() && py_space(uint8_t(s[i]))) i++;
    if (i >= s.size()) break;
    size_t j = i;
    while (j < s.size() && !py_space(uint8_t(s[j]))) j++;
    out.push_back(s.substr(i, j - i));
    i = j;
  }
  return out;
}

// a file object's readline and read over the bytes
struct PyFile {
  const uint8_t* d;
  size_t n, pos = 0;
  std::string readline() {
    size_t e = pos;
    while (e < n && d[e] != '\n') e++;
    if (e < n) e++;
    std::string s(reinterpret_cast<const char*>(d + pos), e - pos);
    pos = e;
    return s;
  }
  std::string read(int64_t k) {  // k < 0: the rest
    size_t e = k < 0 ? n : std::min(n, pos + size_t(k));
    if (pos > n) pos = n;
    std::string s(reinterpret_cast<const char*>(d + pos), e - pos);
    pos = e;
    return s;
  }
};

// PIL's raw decoder: rows of `rowbytes` at offset + y * stride (the last
// row needs only its own bytes), each handed to fn(row, y); a short file
// is PIL's "image file is truncated"
template <class F>
void raw_rows(const uint8_t* d, size_t n, int64_t offset, int64_t stride,
              int64_t rowbytes, int64_t h, bool bottom_up, F&& fn) {
  if (stride == 0) stride = rowbytes;
  if (stride < rowbytes) invalid("raw stride shorter than a row");
  if (offset < 0) invalid("tile offset cannot be negative");
  for (int64_t r = 0; r < h; r++) {
    const int64_t at = offset + r * stride;
    if (at > int64_t(n) || int64_t(n) - at < rowbytes)
      invalid("image file is truncated");
    fn(d + at, bottom_up ? h - 1 - r : r);
  }
}

// Unpack.c for the raw modes of this file ("1;I" inverts, "L;4" scales
// nibbles by 17, "P;4" indexes nibbles; I;16, I and F as convert("RGB")
// clips them)
enum class Raw {
  ONE, ONE_I, L4, P4, L, P, RGB, RGBX, BGR, BGRX, I16, I16B, I32, I32B, F
};

int64_t raw_bits(Raw raw) {
  switch (raw) {
    case Raw::ONE: case Raw::ONE_I: return 1;
    case Raw::L4: case Raw::P4: return 4;
    case Raw::L: case Raw::P: return 8;
    case Raw::I16: case Raw::I16B: return 16;
    case Raw::RGB: case Raw::BGR: return 24;
    default: return 32;
  }
}

// one row of w pixels to RGB
void unpack_row(Raw raw, const uint8_t* s, int64_t w, const Palette* pal,
                Image& img, int64_t y) {
  for (int64_t x = 0; x < w; x++) {
    uint8_t* o = img.px(x, y);
    auto gray = [&](int v) { o[0] = o[1] = o[2] = uint8_t(v); };
    switch (raw) {
      case Raw::ONE: gray(s[x >> 3] & (128 >> (x & 7)) ? 255 : 0); break;
      case Raw::ONE_I: gray(s[x >> 3] & (128 >> (x & 7)) ? 0 : 255); break;
      case Raw::L4: gray(((s[x >> 1] >> (x & 1 ? 0 : 4)) & 15) * 17); break;
      case Raw::P4:
        std::memcpy(o, pal->rgb[(s[x >> 1] >> (x & 1 ? 0 : 4)) & 15], 3);
        break;
      case Raw::L: gray(s[x]); break;
      case Raw::P: std::memcpy(o, pal->rgb[s[x]], 3); break;
      case Raw::RGB: std::memcpy(o, s + 3 * x, 3); break;
      case Raw::RGBX: std::memcpy(o, s + 4 * x, 3); break;
      case Raw::BGR:
      case Raw::BGRX: {
        const uint8_t* q = s + x * (raw == Raw::BGR ? 3 : 4);
        o[0] = q[2], o[1] = q[1], o[2] = q[0];
        break;
      }
      case Raw::I16: gray(std::min<int>(int(le16(s + 2 * x)), 255)); break;
      case Raw::I16B: gray(std::min<int>(int(be16(s + 2 * x)), 255)); break;
      case Raw::I32:
      case Raw::I32B: {
        const int32_t v =
            int32_t(raw == Raw::I32 ? le32(s + 4 * x) : be32(s + 4 * x));
        gray(v < 0 ? 0 : v > 255 ? 255 : v);
        break;
      }
      case Raw::F: {
        float f;
        std::memcpy(&f, s + 4 * x, 4);
        gray(float_to_l(f));
        break;
      }
    }
  }
}

// set_as_raw / frombytes: a flat stream of rows of w pixels in `raw`
void raw_stream(const std::string& data, Raw raw, const Palette* pal,
                Image& img) {
  const int64_t rowbytes = (raw_bits(raw) * img.w + 7) / 8;
  if (int64_t(data.size()) / rowbytes < img.h)
    invalid("not enough image data");
  for (int64_t y = 0; y < img.h; y++)
    unpack_row(raw, reinterpret_cast<const uint8_t*>(data.data()) +
                        y * rowbytes,
               img.w, pal, img, y);
}

// ---------------------------------------------------------------- SUN

void decode_sun(const uint8_t* d, size_t n, Image& img) {
  if (n < 32 || be32(d) != 0x59A66A95) throw HandOnErr("not a SUN file");
  const int64_t w = be32(d + 4), h = be32(d + 8);
  const uint32_t depth = be32(d + 12), ftype = be32(d + 20),
                 ptype = be32(d + 24), plen = be32(d + 28);
  Raw raw;
  switch (depth) {
    case 1: raw = Raw::ONE_I; break;
    case 4: raw = Raw::L4; break;
    case 8: raw = Raw::L; break;
    case 24: raw = ftype == 3 ? Raw::RGB : Raw::BGR; break;
    case 32: raw = ftype == 3 ? Raw::RGBX : Raw::BGRX; break;
    default: throw HandOnErr("Unsupported Mode/Bit Depth");
  }
  Palette pal;
  bool paletted = false;
  size_t offset = 32;
  if (plen) {
    if (plen > 1024) throw HandOnErr("Unsupported Color Palette Length");
    if (ptype != 1) throw HandOnErr("Unsupported Palette Type");
    offset += plen;
    // ImagePalette.raw("RGB;L", ...): the reds, then the greens, blues
    const size_t got = std::min<size_t>(plen, n - 32), k = got / 3;
    for (size_t i = 0; i < k && i < 256; i++)
      for (int c = 0; c < 3; c++) pal.rgb[i][c] = d[32 + c * k + i];
    // putpalette on a 1 or RGB image: "unrecognized image mode"
    if (raw != Raw::L && raw != Raw::L4)
      invalid("SUN colour map on a 1-bit or RGB image");
    paletted = true;
    raw = raw == Raw::L ? Raw::P : Raw::P4;
  }
  if (ftype > 5) throw HandOnErr("Unsupported Sun Raster file type");
  img.alloc(w, h);
  const Palette* pp = paletted ? &pal : nullptr;
  if (ftype != 2) {
    const int64_t stride = (w * depth + 15) / 16 * 2;
    raw_rows(d, n, int64_t(offset), stride, (w * raw_bits(raw) + 7) / 8, h,
             false, [&](const uint8_t* s, int64_t y) {
               unpack_row(raw, s, w, pp, img, y);
             });
    return;
  }
  // SunRleDecode.c over unpadded rows
  const size_t bytes = size_t((int64_t(raw_bits(raw)) * w + 7) / 8);
  std::vector<uint8_t> row(bytes);
  size_t p = offset, x = 0;
  int64_t y = 0;
  auto put = [&](size_t k) -> bool {  // k bytes are in row at x
    x += k;
    if (x >= bytes) {
      unpack_row(raw, row.data(), w, pp, img, y);
      x = 0;
      if (++y >= h) return true;
    }
    return false;
  };
  while (p < n) {
    if (d[p] == 0x80) {
      if (n - p < 2) break;
      size_t k = d[p + 1];
      if (k == 0) {
        row[x] = 0x80;
        p += 2;
        if (put(1)) return;
        continue;
      }
      if (n - p < 3) break;
      k += 1;
      const uint8_t v = d[p + 2];
      p += 3;
      size_t extra = 0;
      if (x + k > bytes) {
        extra = k - (bytes - x);
        k = bytes - x;
      }
      std::memset(row.data() + x, v, k);
      if (put(k)) return;
      while (extra) {  // the run's rest fills whole rows from the start
        const size_t m = std::min(extra, bytes);
        std::memset(row.data(), v, m);
        extra -= m;
        if (put(m)) return;
      }
    } else {
      row[x] = d[p++];
      if (put(1)) return;
    }
  }
  invalid("image file is truncated");
}

// ---------------------------------------------------------------- XPM

// Python's int(s, 16) of an ASCII token: a sign, an optional 0x, hex
// digits with single underscores between them; the low 24 bits of
// two's complement
bool py_hex24(const std::string& t, uint32_t& v) {
  size_t i = 0;
  bool neg = false;
  if (i < t.size() && (t[i] == '+' || t[i] == '-')) neg = t[i++] == '-';
  if (t.size() - i >= 2 && t[i] == '0' && (t[i + 1] == 'x' || t[i + 1] == 'X')) {
    i += 2;
    if (i < t.size() && t[i] == '_') i++;
  }
  if (i >= t.size()) return false;
  uint64_t acc = 0;
  bool digit = false;
  for (; i < t.size(); i++) {
    const char c = t[i];
    if (c == '_') {
      if (!digit || i + 1 >= t.size() || t[i + 1] == '_') return false;
      continue;
    }
    int dv = std::isdigit(uint8_t(c)) ? c - '0'
             : (c >= 'a' && c <= 'f') ? c - 'a' + 10
             : (c >= 'A' && c <= 'F') ? c - 'A' + 10 : -1;
    if (dv < 0) return false;
    acc = (acc << 4 | uint64_t(dv)) & 0xFFFFFF;
    digit = true;
  }
  if (!digit) return false;
  v = uint32_t(neg ? (0x1000000 - acc) & 0xFFFFFF : acc);
  return true;
}

void decode_xpm(const uint8_t* d, size_t n, Image& img) {
  if (n < 9 || std::memcmp(d, "/* XPM */", 9) != 0)
    throw HandOnErr("not an XPM file");
  PyFile f{d, n, 9};
  std::string line;
  int64_t nums[4];
  for (;;) {
    line = f.readline();
    if (line.empty()) throw HandOnErr("broken XPM file");
    // xpm_head: '"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)' at the start
    size_t i = 0;
    bool ok = i < line.size() && line[i] == '"';
    std::string g[4];
    i++;
    for (int k = 0; k < 4 && ok; k++) {
      while (i < line.size() && std::isdigit(uint8_t(line[i]))) g[k] += line[i++];
      if (k < 3) {
        if (i < line.size() && line[i] == ' ')
          i++;
        else
          ok = false;
      }
    }
    if (!ok) continue;
    for (int k = 0; k < 4; k++)
      if (!py_int(g[k], nums[k])) invalid("bad XPM header number");
    break;
  }
  const int64_t w = nums[0], h = nums[1], ncolors = nums[2], bpp = nums[3];
  // the palette: insertion order of the keys, the last colour of each
  std::vector<std::string> keys;
  std::map<std::string, uint32_t> colour;
  for (int64_t c = 0; c < ncolors; c++) {
    line = py_rstrip(f.readline());
    auto slice = [&](int64_t a, int64_t b) {  // line[a:b], Python's rules
      const int64_t L = int64_t(line.size());
      if (a < 0) a = std::max<int64_t>(0, a + L);
      if (b < 0) b = std::max<int64_t>(0, b + L);
      a = std::min(a, L);
      b = std::min(b, L);
      return b > a ? line.substr(size_t(a), size_t(b - a)) : std::string();
    };
    const std::string key = slice(1, bpp + 1);
    const std::vector<std::string> s = py_split(slice(bpp + 1, -2));
    bool found = false;
    for (size_t i = 0; i < s.size(); i += 2) {
      if (s[i] != "c") continue;
      if (i + 1 >= s.size()) throw HandOnErr("XPM colour key with no value");
      const std::string& rgb = s[i + 1];
      if (rgb == "None") {  // info["transparency"]: no palette entry
      } else if (!rgb.empty() && rgb[0] == '#') {
        uint32_t v;
        if (!py_hex24(rgb.substr(1), v)) invalid("cannot read this XPM file");
        if (!colour.count(key)) keys.push_back(key);
        colour[key] = v;
      } else {
        invalid("cannot read this XPM file");
      }
      found = true;
      break;
    }
    if (!found) invalid("cannot read this XPM file");
  }
  if (w <= 0 || h <= 0) throw HandOnErr("XPM of size 0");
  img.alloc(w, h);
  if (bpp <= 0) invalid("XPM of 0 characters a pixel");
  const bool rgb_mode = ncolors > 256;
  const size_t need = size_t(w) * size_t(h) * (rgb_mode ? 3 : 1);
  std::string data;
  bool pixel_header = false;
  while (data.size() < need) {
    line = f.readline();
    if (line.empty()) break;
    if (!pixel_header && py_rstrip(line) == "/* pixels */") {
      pixel_header = true;
      continue;
    }
    const size_t a = line.find('"'), b = line.rfind('"');
    if (a == std::string::npos || b == a) continue;
    const std::string body = line.substr(a + 1, b - a - 1);
    for (size_t i = 0; i < body.size(); i += size_t(bpp)) {
      const std::string key = body.substr(i, size_t(bpp));
      auto it = colour.find(key);
      if (it == colour.end()) invalid("XPM pixel key with no colour");
      if (rgb_mode) {
        data += char(it->second >> 16);
        data += char(it->second >> 8);
        data += char(it->second);
      } else {
        const size_t idx =
            size_t(std::find(keys.begin(), keys.end(), key) - keys.begin());
        data += char(idx);
      }
    }
  }
  Palette pal;
  for (size_t i = 0; i < keys.size() && i < 256; i++) {
    const uint32_t v = colour[keys[i]];
    pal.rgb[i][0] = uint8_t(v >> 16);
    pal.rgb[i][1] = uint8_t(v >> 8);
    pal.rgb[i][2] = uint8_t(v);
  }
  raw_stream(data, rgb_mode ? Raw::RGB : Raw::P, &pal, img);
}

// ---------------------------------------------------------------- MSP

void decode_msp(const uint8_t* d, size_t n, Image& img) {
  if (n < 32 || (std::memcmp(d, "DanM", 4) && std::memcmp(d, "LinS", 4)))
    throw HandOnErr("not an MSP file");
  uint32_t sum = 0;
  for (int i = 0; i < 32; i += 2) sum ^= le16(d + i);
  if (sum) throw HandOnErr("bad MSP checksum");
  const int64_t w = le16(d + 4), h = le16(d + 6);
  if (w <= 0 || h <= 0) throw HandOnErr("MSP of size 0");
  img.alloc(w, h);
  if (!std::memcmp(d, "DanM", 4)) {
    raw_rows(d, n, 32, 0, (w + 7) / 8, h, false,
             [&](const uint8_t* s, int64_t y) {
               unpack_row(Raw::ONE, s, w, nullptr, img, y);
             });
    return;
  }
  if (n - 32 < size_t(2 * h)) invalid("Truncated MSP file in row map");
  std::string out;
  size_t p = 32 + size_t(2 * h);
  for (int64_t r = 0; r < h; r++) {
    const size_t len = le16(d + 32 + 2 * r);
    if (len == 0) {
      out.append(size_t((w + 7) / 8), char(0xFF));
      continue;
    }
    if (n - p < len) invalid("Truncated MSP file");
    const uint8_t* row = d + p;
    p += len;
    size_t i = 0;
    while (i < len) {
      const int type = row[i++];
      if (type == 0) {
        if (len - i < 2) invalid("Corrupted MSP file");
        out.append(row[i], char(row[i + 1]));
        i += 2;
      } else {
        const size_t k = std::min<size_t>(size_t(type), len - i);
        out.append(reinterpret_cast<const char*>(row + i), k);
        i += size_t(type);
      }
    }
  }
  raw_stream(out, Raw::ONE, nullptr, img);
}

// ---------------------------------------------------------------- DCX

void decode_dcx(const uint8_t* d, size_t n, Image& img) {
  if (n < 8 || le32(d) != 0x3ADE68B1) throw HandOnErr("not a DCX file");
  const size_t off = le32(d + 4);
  if (!off) throw HandOnErr("DCX without pages");
  if (off >= n) throw HandOnErr("not a PCX file");
  decode_pcx(d + off, n - off, img);
}

// ------------------------------------------------- PIXAR, McIdas, IMT, ...

void decode_pixar(const uint8_t* d, size_t n, Image& img) {
  if (n < 512 || std::memcmp(d, "\x80\xe8\0\0", 4))
    throw HandOnErr("not a PIXAR file");
  if (le16(d + 424) != 14 || le16(d + 426) != 2) throw HandOnErr("no mode");
  const int64_t w = le16(d + 418), h = le16(d + 416);
  if (w <= 0 || h <= 0) throw HandOnErr("PIXAR of size 0");
  img.alloc(w, h);
  raw_rows(d, n, 1024, 0, 3 * w, h, false, [&](const uint8_t* s, int64_t y) {
    unpack_row(Raw::RGB, s, w, nullptr, img, y);
  });
}

void decode_mcidas(const uint8_t* d, size_t n, Image& img) {
  if (n < 256 || std::memcmp(d, "\0\0\0\0\0\0\0\4", 8))
    throw HandOnErr("not an McIdas area file");
  auto word = [&](int i) { return int64_t(int32_t(be32(d + 4 * (i - 1)))); };
  const int64_t bpp = word(11);
  Raw raw;
  if (bpp == 1)
    raw = Raw::L;
  else if (bpp == 2)
    raw = Raw::I16B;
  else if (bpp == 4)
    raw = Raw::I32B;
  else
    throw HandOnErr("unsupported McIdas format");
  const int64_t w = word(10), h = word(9);
  if (w <= 0 || h <= 0) throw HandOnErr("McIdas of size 0");
  img.alloc(w, h);
  const int64_t offset = word(34) + word(15);
  int64_t stride = word(15) + w * bpp * word(14);
  const int64_t rowbytes = w * bpp;
  if (bpp != 4 && offset >= 0 && offset + h * stride <= int64_t(n)) {
    // L and I;16B are memory-mapped: rows `stride` apart, a stride of 0
    // or less the row's own
    if (stride <= 0) stride = rowbytes;
    if (offset + h * stride > int64_t(n)) invalid("buffer is not large enough");
    if (stride < rowbytes && offset + (h - 1) * stride + rowbytes > int64_t(n))
      invalid("mapped rows past the end of the file");
    for (int64_t y = 0; y < h; y++)
      unpack_row(raw, d + offset + y * stride, w, nullptr, img, y);
    return;
  }
  raw_rows(d, n, offset, stride, rowbytes, h, false,
           [&](const uint8_t* s, int64_t y) {
             unpack_row(raw, s, w, nullptr, img, y);
           });
}

void decode_imt(const uint8_t* d, size_t n, Image& img) {
  PyFile f{d, n};
  std::string buffer = f.read(100);
  if (buffer.find('\n') == std::string::npos) throw HandOnErr("not an IM file");
  int64_t w = 0, h = 0;
  bool gray = false, tile = false;
  size_t offset = 0;
  for (;;) {
    std::string s;
    if (!buffer.empty()) {
      s = buffer.substr(0, 1);
      buffer.erase(0, 1);
    } else {
      s = f.read(1);
    }
    if (s.empty()) break;
    if (s == "\x0c") {
      tile = true;
      offset = f.pos - buffer.size();
      break;
    }
    if (buffer.find('\n') == std::string::npos) buffer += f.read(100);
    const size_t nl = buffer.find('\n');
    s += buffer.substr(0, nl);
    buffer = nl == std::string::npos ? std::string() : buffer.substr(nl + 1);
    if (s.size() == 1 || s.size() > 100) break;
    if (s[0] == '*') continue;
    // field: "([a-z]*) ([^ \r\n]*)" at the start
    size_t i = 0;
    while (i < s.size() && s[i] >= 'a' && s[i] <= 'z') i++;
    if (i >= s.size() || s[i] != ' ') break;
    const std::string k = s.substr(0, i);
    size_t j = i + 1;
    while (j < s.size() && s[j] != ' ' && s[j] != '\r' && s[j] != '\n') j++;
    const std::string v = s.substr(i + 1, j - i - 1);
    if (k == "width") {
      if (!py_int(v, w)) invalid("bad IMT width");
    } else if (k == "height") {
      if (!py_int(v, h)) invalid("bad IMT height");
    } else if (k == "pixel" && v == "n8") {
      gray = true;
    }
  }
  if (!gray || w <= 0 || h <= 0) throw HandOnErr("no mode");
  img.alloc(w, h);
  if (!tile) invalid("cannot load this image");
  if (int64_t(n - offset) / w < h) invalid("buffer is not large enough");
  for (int64_t y = 0; y < h; y++)
    unpack_row(Raw::L, d + offset + size_t(y * w), w, nullptr, img, y);
}

void decode_xvthumb(const uint8_t* d, size_t n, Image& img) {
  if (n < 6 || std::memcmp(d, "P7 332", 6)) throw HandOnErr("not XV");
  PyFile f{d, n, 6};
  f.readline();
  std::string s;
  for (;;) {
    s = f.readline();
    if (s.empty()) throw HandOnErr("Unexpected EOF reading XV thumbnail file");
    if (s[0] != '#') break;
  }
  const std::vector<std::string> t = py_split(s);
  int64_t w, h;
  if (t.size() < 2 || !py_int(t[0], w) || !py_int(t[1], h))
    invalid("bad XV thumbnail size");
  if (w <= 0 || h <= 0) throw HandOnErr("XV thumbnail of size 0");
  img.alloc(w, h);
  Palette pal;
  for (int r = 0, i = 0; r < 8; r++)
    for (int g = 0; g < 8; g++)
      for (int b = 0; b < 4; b++, i++) {
        pal.rgb[i][0] = uint8_t(r * 255 / 7);
        pal.rgb[i][1] = uint8_t(g * 255 / 7);
        pal.rgb[i][2] = uint8_t(b * 255 / 3);
      }
  if (int64_t(n - f.pos) / w < h) invalid("buffer is not large enough");
  for (int64_t y = 0; y < h; y++)
    unpack_row(Raw::P, d + f.pos + size_t(y * w), w, &pal, img, y);
}

void decode_gbr(const uint8_t* d, size_t n, Image& img) {
  if (n < 20) throw HandOnErr("not a GIMP brush");
  const int64_t hs = be32(d), version = be32(d + 4);
  const int64_t w = be32(d + 8), h = be32(d + 12), depth = be32(d + 16);
  if (hs < 20 || (version != 1 && version != 2) || w == 0 || h == 0 ||
      (depth != 1 && depth != 4))
    throw HandOnErr("not a GIMP brush");
  if (version == 2 && (n < 28 || std::memcmp(d + 20, "GIMP", 4)))
    throw HandOnErr("not a GIMP brush, bad magic number");
  img.alloc(w, h);
  // the comment read(header_size - 28) of a short v2 header reads it all
  size_t at = version == 2 && hs < 28 ? n : std::min<size_t>(size_t(hs), n);
  const size_t need = size_t(w * h * depth);
  if (n - at < need) invalid("not enough image data");
  for (int64_t y = 0; y < h; y++)
    unpack_row(depth == 1 ? Raw::L : Raw::RGBX, d + at + size_t(y * w * depth), w,
               nullptr, img, y);
}

// ---------------------------------------------------------------- FITS

// gzip.decompress: every member, CRC and length held, zeros between
std::string gunzip(const uint8_t* d, size_t n) {
  std::string out;
  size_t p = 0;
  for (;;) {
    if (p >= n) return out;
    if (n - p < 2 || d[p] != 0x1f || d[p + 1] != 0x8b)
      invalid("Not a gzipped file");
    if (n - p < 10) invalid("Compressed file ended before the end-of-stream");
    if (d[p + 2] != 8) invalid("Unknown compression method");
    const int flag = d[p + 3];
    size_t q = p + 10;
    if (flag & 4) {
      if (n - q < 2) invalid("truncated gzip header");
      q += 2 + le16(d + q);
    }
    if (flag & 8) {
      while (q < n && d[q]) q++;
      q++;
    }
    if (flag & 16) {
      while (q < n && d[q]) q++;
      q++;
    }
    if (flag & 2) q += 2;
    if (q > n) invalid("truncated gzip header");
    size_t used = 0;
    std::vector<uint8_t> m = raw_inflate(d + q, n - q, used);
    q += used;
    if (n - q < 8) invalid("Compressed file ended before the end-of-stream");
    if (crc32_of(m.data(), m.size()) != le32(d + q))
      invalid("CRC check failed");
    if (le32(d + q + 4) != uint32_t(m.size()))
      invalid("Incorrect length of data produced");
    out.append(m.begin(), m.end());
    p = q + 8;
    while (p < n && d[p] == 0) p++;
  }
}

void decode_fits(const uint8_t* d, size_t n, Image& img) {
  PyFile f{d, n};
  std::map<std::string, std::string> headers;
  bool in_progress = false, found = false, gz = false;
  int64_t w = 0, h = 0, offset = 0, bits = 0;
  Raw mode = Raw::L;
  bool have_mode = false;
  auto get = [&](const std::string& k) -> const std::string& {
    auto it = headers.find(k);
    if (it == headers.end()) throw HandOnErr("FITS header without " + k);
    return it->second;
  };
  auto num = [&](const std::string& k) {
    int64_t v;
    if (!py_int(py_strip_all(get(k)), v)) invalid("bad FITS number " + k);
    return v;
  };
  // _get_size: false where NAXIS is 0
  auto size_of = [&](const std::string& pre, int64_t& sw, int64_t& sh) {
    const int64_t naxis = num(pre + "NAXIS");
    if (naxis == 0) return false;
    if (naxis == 1) {
      sw = 1;
      sh = num(pre + "NAXIS1");
    } else {
      sw = num(pre + "NAXIS1");
      sh = num(pre + "NAXIS2");
    }
    return true;
  };
  for (;;) {
    const std::string card = f.read(80);
    if (card.empty()) invalid("Truncated FITS file");
    const std::string key = py_strip_all(card.substr(0, 8));
    if (key == "SIMPLE" || key == "XTENSION") {
      in_progress = true;
    } else if (!headers.empty() && !in_progress) {
      break;
    } else if (key == "END") {
      f.pos = (f.pos + 2879) / 2880 * 2880;
      if (!found) {  // _parse_headers
        std::string pre;
        gz = false;
        offset = 0;
        auto it = headers.find("XTENSION"), iz = headers.find("ZIMAGE");
        if (it != headers.end() && it->second == "'BINTABLE'" &&
            iz != headers.end() && iz->second == "T" &&
            get("ZCMPTYPE") == "'GZIP_1  '") {
          int64_t tw = 0, th = 0;
          if (!size_of("", tw, th)) tw = th = 0;
          const int64_t b = num("BITPIX");
          offset = tw * th * (b >= 0 ? b / 8 : -((-b + 7) / 8));
          pre = "Z";
          gz = true;
        }
        if (size_of(pre, w, h)) {
          bits = num(pre + "BITPIX");
          have_mode = bits == 8 || bits == 16 || bits == 32 || bits == -32 ||
                      bits == -64;
          mode = bits == 8 ? Raw::L : bits == 16 ? Raw::I16
                 : bits == 32 ? Raw::I32 : Raw::F;
          found = true;
        }
      }
      in_progress = false;
      continue;
    }
    if (found) continue;
    std::string value = card.size() > 8 ? card.substr(8) : std::string();
    value = py_strip_all(value.substr(0, value.find('/')));
    if (!value.empty() && value[0] == '=') value = py_strip_all(value.substr(1));
    if (headers.empty() && (key.compare(0, 6, "SIMPLE") != 0 || value != "T"))
      throw HandOnErr("Not a FITS file");
    headers[key] = value;
  }
  if (!found) invalid("No image data");
  if (!have_mode || w <= 0 || h <= 0) throw HandOnErr("no FITS mode");
  img.alloc(w, h);
  offset += int64_t(f.pos) - 80;
  if (!gz) {
    raw_rows(d, n, offset, 0, (raw_bits(mode) * w + 7) / 8, h, true,
             [&](const uint8_t* s, int64_t y) {
               unpack_row(mode, s, w, nullptr, img, y);
             });
    return;
  }
  // FitsGzipDecoder: the rest of the file, gunzipped; each pixel the last
  // min(BITPIX // 8, 4) bytes of a 4-byte word; rows bottom-up
  if (offset < 0 || offset > int64_t(n)) offset = int64_t(n);
  const std::string v = gunzip(d + offset, n - size_t(offset));
  const int64_t nb = std::min<int64_t>(bits >= 0 ? bits / 8 : -((-bits + 7) / 8), 4);
  std::string data;
  std::vector<std::string> rows(static_cast<size_t>(h));
  size_t o = 0;
  for (int64_t y = 0; y < h; y++)
    for (int64_t x = 0; x < w; x++, o += 4) {
      // value[o + 4 - nb : o + 4], Python's slice
      int64_t a = int64_t(o) + 4 - nb, b = int64_t(o) + 4;
      const int64_t L = int64_t(v.size());
      a = std::min(std::max<int64_t>(a, 0), L);
      b = std::min(b, L);
      if (b > a) rows[size_t(y)] += v.substr(size_t(a), size_t(b - a));
    }
  for (int64_t y = h - 1; y >= 0; y--) data += rows[size_t(y)];
  raw_stream(data, mode, nullptr, img);
}

// ---------------------------------------------------------------- FTEX

void decode_ftex(const uint8_t* d, size_t n, Image& img) {
  if (n < 32 || std::memcmp(d, "FTEX", 4)) throw HandOnErr("not FTEX");
  const int64_t w = int32_t(le32(d + 8)), h = int32_t(le32(d + 12));
  if (int32_t(le32(d + 20)) != 1) invalid("FTEX with more than one format");
  const int32_t fmt = int32_t(le32(d + 24));
  const int64_t where = int32_t(le32(d + 28));
  if (where < 0) invalid("negative seek");
  if (size_t(where) > n || n - size_t(where) < 4)
    throw HandOnErr("truncated FTEX mipmap size");
  const int64_t msize = int32_t(le32(d + where));
  const size_t at = size_t(where) + 4;
  const size_t len = msize < 0 ? n - at : std::min<size_t>(size_t(msize), n - at);
  if (fmt != 0 && fmt != 1) invalid("Invalid texture compression format");
  if (w <= 0 || h <= 0) throw HandOnErr("FTEX of size 0");
  img.alloc(w, h);
  const uint8_t* s = d + at;
  if (fmt == 1) {
    raw_rows(s, len, 0, 0, 3 * w, h, false, [&](const uint8_t* r, int64_t y) {
      unpack_row(Raw::RGB, r, w, nullptr, img, y);
    });
    return;
  }
  const int64_t bw = (w + 3) / 4, bh = (h + 3) / 4;
  if (len / 8 < size_t(bw * bh)) invalid("image file is truncated");
  Rgba col[16];
  for (int64_t by = 0; by < bh; by++)
    for (int64_t bx = 0; bx < bw; bx++, s += 8) {
      bc1_color(col, s, false);
      for (int j = 0; j < 16; j++) {
        const int64_t x = bx * 4 + (j & 3), y = by * 4 + (j >> 2);
        if (x < w && y < h) img.put(x, y, col[j].r, col[j].g, col[j].b);
      }
    }
}

// ---------------------------------------------------------------- BLP

// BlpImagePlugin's Python DXT decoders: four rows of whole blocks, RGB or
// RGBA bytes per pixel (unpack_565 shifts without replicating bits)
void blp_dxt_row(const uint8_t* s, int64_t blocks, int kind, bool alpha,
                 std::string* rows) {
  auto c565 = [](uint32_t c, int& r, int& g, int& b) {
    r = int((c >> 11) & 0x1F) << 3;
    g = int((c >> 5) & 0x3F) << 2;
    b = int(c & 0x1F) << 3;
  };
  for (int64_t k = 0; k < blocks; k++) {
    const uint8_t* blk = s + k * (kind == 1 ? 8 : 16);
    const uint8_t* cb = kind == 1 ? blk : blk + 8;
    const uint32_t c0 = le16(cb), c1 = le16(cb + 2);
    uint32_t code = le32(cb + 4);
    int r0, g0, b0, r1, g1, b1;
    c565(c0, r0, g0, b0);
    c565(c1, r1, g1, b1);
    for (int j = 0; j < 4; j++)
      for (int i = 0; i < 4; i++) {
        const int t = 4 * j + i;
        const int cc = (code >> (2 * t)) & 3;
        int r, g, b, a = 255;
        if (cc == 0) {
          r = r0, g = g0, b = b0;
        } else if (cc == 1) {
          r = r1, g = g1, b = b1;
        } else if (kind != 1 || c0 > c1) {
          if (cc == 2)
            r = (2 * r0 + r1) / 3, g = (2 * g0 + g1) / 3, b = (2 * b0 + b1) / 3;
          else
            r = (2 * r1 + r0) / 3, g = (2 * g1 + g0) / 3, b = (2 * b1 + b0) / 3;
        } else if (cc == 2) {
          r = (r0 + r1) / 2, g = (g0 + g1) / 2, b = (b0 + b1) / 2;
        } else {
          r = g = b = a = 0;
        }
        if (kind == 3) {
          a = ((blk[t / 2] >> (t & 1 ? 4 : 0)) & 15) * 17;
        } else if (kind == 5) {
          const int a0 = blk[0], a1 = blk[1];
          const uint64_t bits = uint64_t(blk[2]) | uint64_t(blk[3]) << 8 |
                                uint64_t(blk[4]) << 16 | uint64_t(blk[5]) << 24 |
                                uint64_t(blk[6]) << 32 | uint64_t(blk[7]) << 40;
          const int ac = int((bits >> (3 * t)) & 7);
          if (ac == 0)
            a = a0;
          else if (ac == 1)
            a = a1;
          else if (a0 > a1)
            a = ((8 - ac) * a0 + (ac - 1) * a1) / 7;
          else if (ac == 6)
            a = 0;
          else if (ac == 7)
            a = 255;
          else
            a = ((6 - ac) * a0 + (ac - 1) * a1) / 5;
        }
        std::string& o = rows[j];
        o += char(r);
        o += char(g);
        o += char(b);
        if (kind != 1 || alpha) o += char(a);
      }
  }
}

void decode_blp(const uint8_t* d, size_t n, Image& img) {
  if (n < 4 || (std::memcmp(d, "BLP1", 4) && std::memcmp(d, "BLP2", 4)))
    invalid("Bad BLP magic");
  const bool v1 = d[3] == '1';
  if (n < size_t(v1 ? 28 : 20)) throw HandOnErr("truncated BLP header");
  const int32_t compression = int32_t(le32(d + 4));
  bool alpha;
  int encoding, alpha_encoding = 0;
  int64_t w, h;
  if (v1) {
    alpha = le32(d + 8) != 0;
    w = le32(d + 12);
    h = le32(d + 16);
    encoding = int32_t(le32(d + 20));
  } else {
    encoding = int8_t(d[8]);
    alpha = int8_t(d[9]) != 0;
    alpha_encoding = int8_t(d[10]);
    w = le32(d + 12);
    h = le32(d + 16);
  }
  if (w <= 0 || h <= 0) throw HandOnErr("BLP of size 0");
  img.alloc(w, h);
  PyFile f{d, n, size_t(v1 ? 28 : 20)};
  auto safe_read = [&](int64_t k) {
    if (k <= 0) return std::string();
    std::string s = f.read(k);
    if (int64_t(s.size()) < k) invalid("Truncated File Read");
    return s;
  };
  auto u32s = [](const std::string& s, int i) {
    return le32(reinterpret_cast<const uint8_t*>(s.data()) + 4 * i);
  };
  const std::string offs = safe_read(64), lens = safe_read(64);
  const Raw raw_mode = alpha ? Raw::RGBX : Raw::RGB;
  // _read_bgra: lengths[0] palette indices
  auto read_bgra = [&](const std::string& pal) {
    const std::string idx = safe_read(u32s(lens, 0));
    std::string out;
    for (unsigned char c : idx) {
      const char* e = pal.data() + 4 * c;
      out += e[2];
      out += e[1];
      out += e[0];
      if (alpha) out += e[3];
    }
    return out;
  };
  if (v1) {
    if (compression == 0) {  // _decode_jpeg_stream
      const std::string hsize = safe_read(4);
      std::string jpeg = safe_read(le32(reinterpret_cast<const uint8_t*>(hsize.data())));
      safe_read(int64_t(u32s(offs, 0)) - int64_t(f.pos));
      jpeg += safe_read(u32s(lens, 0));
      const uint8_t* jd = reinterpret_cast<const uint8_t*>(jpeg.data());
      if (jpeg.size() < 3 || jd[0] != 0xFF || jd[1] != 0xD8 || jd[2] != 0xFF)
        invalid("not a JPEG file");
      Jpeg j;
      j.d = jd;
      j.n = jpeg.size();
      j.feed = true;
      j.force_cmyk = true;  // the tile's jpegmode set to "CMYK"
      Image rgb;
      j.decode(rgb);
      // set_as_raw(image.convert("RGB").tobytes(), "BGR")
      const std::string bytes(rgb.rgb.begin(), rgb.rgb.end());
      raw_stream(bytes, Raw::BGR, nullptr, img);
      return;
    }
    if (compression != 1 || (encoding != 4 && encoding != 5))
      invalid("Unsupported BLP encoding");
    const std::string pal = safe_read(1024);
    raw_stream(read_bgra(pal), raw_mode, nullptr, img);
    return;
  }
  const std::string pal = safe_read(1024);
  f.pos = std::min<size_t>(u32s(offs, 0), n);
  if (compression != 1) invalid("Unknown BLP compression");
  std::string data;
  if (encoding == 1) {
    data = read_bgra(pal);
  } else if (encoding == 2) {
    const int kind = alpha_encoding == 0 ? 1 : alpha_encoding == 1 ? 3
                     : alpha_encoding == 7 ? 5 : 0;
    if (!kind) invalid("Unsupported alpha encoding");
    const int64_t blocks = (w + 3) / 4;
    const int64_t linesize = blocks * (kind == 1 ? 8 : 16);
    for (int64_t yb = 0; yb < (h + 3) / 4; yb++) {
      const std::string line = safe_read(linesize);
      std::string rows[4];
      blp_dxt_row(reinterpret_cast<const uint8_t*>(line.data()), blocks, kind,
                  alpha, rows);
      for (const std::string& r : rows) data += r;
    }
  } else {
    invalid("Unknown BLP encoding");
  }
  raw_stream(data, raw_mode, nullptr, img);
}

// ---------------------------------------------------------------- ICNS

void decode_icns(const uint8_t* d, size_t n, Image& img) {
  if (n < 8 || std::memcmp(d, "icns", 4)) throw HandOnErr("not an icns file");
  const uint64_t filesize = be32(d + 4);
  std::map<std::string, std::pair<uint64_t, int64_t>> dct;
  uint64_t i = 8;
  while (i < filesize) {
    if (i + 8 > n) throw HandOnErr("truncated icns block header");
    const std::string sig(reinterpret_cast<const char*>(d + i), 4);
    const int64_t bs = be32(d + i + 4);
    if (bs <= 0) throw HandOnErr("invalid block header");
    i += 8;
    dct[sig] = {i, bs - 8};
    i += uint64_t(bs - 8);
  }
  struct Slot {
    int w, h, s;
    const char* codes[3];
  };
  static const Slot SIZES[] = {
      {512, 512, 2, {"ic10"}},  {512, 512, 1, {"ic09"}},
      {256, 256, 2, {"ic14"}},  {256, 256, 1, {"ic08"}},
      {128, 128, 2, {"ic13"}},  {128, 128, 1, {"ic07", "it32", "t8mk"}},
      {64, 64, 1, {"icp6"}},    {32, 32, 2, {"ic12"}},
      {48, 48, 1, {"ih32", "h8mk"}}, {32, 32, 1, {"icp5", "il32", "l8mk"}},
      {16, 16, 2, {"ic11"}},    {16, 16, 1, {"icp4", "is32", "s8mk"}}};
  const Slot* best = nullptr;
  std::vector<const Slot*> have;
  for (const Slot& s : SIZES) {
    bool any = false;
    for (const char* c : s.codes)
      if (c && dct.count(c)) any = true;
    if (!any) continue;
    have.push_back(&s);
    if (!best || std::make_tuple(s.w, s.h, s.s) >
                     std::make_tuple(best->w, best->h, best->s))
      best = &s;
  }
  if (!best) throw HandOnErr("No 32bit icon resources found");
  const int64_t pw = int64_t(best->w) * best->s, ph = int64_t(best->h) * best->s;
  const size_t sizesq = size_t(pw * ph);
  bool have_png = false, have_j2k = false, have_rgb = false;
  Image png, rgb;
  for (const char* code : best->codes) {
    if (!code || !dct.count(code)) continue;
    uint64_t start = dct[code].first;
    int64_t length = dct[code].second;
    const std::string c = code;
    if (c.compare(1, 3, "8mk") == 0) {  // read_mk
      if (start > n || n - start < sizesq) invalid("not enough image data");
      continue;
    }
    if (c == "it32" || c[3] == '2') {  // read_32t / read_32
      if (c == "it32") {
        if (start > n || n - start < 4 || be32(d + start) != 0)
          invalid("Unknown signature, expecting 0x00000000");
        start += 4;
        length -= 4;
      }
      rgb.alloc(pw, ph);
      have_rgb = true;
      if (length == int64_t(sizesq * 3)) {
        if (start > n || n - start < sizesq * 3) invalid("not enough image data");
        for (size_t k = 0; k < sizesq; k++)
          std::memcpy(&rgb.rgb[3 * k], d + start + 3 * k, 3);
        continue;
      }
      uint64_t p = start;
      for (int band = 0; band < 3; band++) {
        std::string data;
        int64_t left = int64_t(sizesq);
        while (left > 0) {
          if (p >= n) break;
          const int b = d[p++];
          int64_t bsz;
          if (b & 0x80) {
            bsz = b - 125;
            const bool got = p < n;
            const char v = got ? char(d[p]) : 0;
            if (got) p++;
            if (got) data.append(size_t(bsz), v);
          } else {
            bsz = b + 1;
            const size_t k = size_t(std::min<uint64_t>(uint64_t(bsz), p < n ? n - p : 0));
            data.append(reinterpret_cast<const char*>(d + p), k);
            p += k;
          }
          left -= bsz;
        }
        if (left != 0) invalid("Error reading channel");
        if (data.size() < sizesq) invalid("not enough image data");
        for (size_t k = 0; k < sizesq; k++) rgb.rgb[3 * k + band] = uint8_t(data[k]);
      }
      continue;
    }
    // read_png_or_jpeg2000
    if (start > n) start = n;
    const uint8_t* s = d + start;
    const size_t avail = n - start;
    auto starts = [&](const char* m, size_t k) {
      return avail >= k && std::memcmp(s, m, k) == 0;
    };
    if (starts("\x89PNG\r\n\x1a\n", 8)) {
      decode_png(s, avail, png);
      have_png = true;
    } else if (starts("\xff\x4f\xff\x51", 4) || starts("\x0d\x0a\x87\x0a", 4) ||
               (avail >= 12 && std::memcmp(s, "\0\0\0\x0cjP  \x0d\x0a\x87\x0a", 12) == 0)) {
      have_j2k = true;
    } else {
      invalid("Unsupported icon subimage format");
    }
  }
  if (have_j2k)
    throw Unsupported("ICNS icon holding JPEG 2000 is not decoded by "
                      "craytracer_tpu_torch");
  const Image* out = have_png ? &png : &rgb;
  if (!have_png && !have_rgb) invalid("ICNS size without an RGB icon");
  if (have_png) {  // IcnsImageFile.size's setter holds the PNG's size
    bool ok = false;
    for (const Slot* sl : have) {
      const int64_t sw = int64_t(sl->w) * sl->s, sh = int64_t(sl->h) * sl->s;
      if (png.w == 0 || png.h == 0) break;
      const int64_t scale = sw / png.w;
      if (double(sh) / double(png.h) == double(scale)) ok = true;
    }
    if (!ok) invalid("This is not one of the allowed sizes of this image");
  }
  img = *out;
}

// ---------------------------------------------------------------- IPTC

void decode_iptc(const uint8_t* d, size_t n, Image& img) {
  PyFile f{d, n};
  // field(): tag, size; false at the end (five zero bytes or fewer)
  auto field = [&](int& r, int& ds, int64_t& size, bool in_open) -> bool {
    const std::string s = f.read(5);
    bool blank = true;
    for (char c : s) blank = blank && c == 0;
    if (blank) return false;
    auto fail = [&](const char* why) {
      if (in_open) throw HandOnErr(why);
      invalid(why);
    };
    if (s.size() < 3) fail("IPTC field cut short");
    r = uint8_t(s[1]);
    ds = uint8_t(s[2]);
    static const int RECORDS[] = {1, 2, 3, 4, 5, 6, 7, 8, 9, 240};
    if (uint8_t(s[0]) != 0x1C ||
        std::find(std::begin(RECORDS), std::end(RECORDS), r) == std::end(RECORDS))
      fail("invalid IPTC/NAA file");
    if (s.size() < 4) fail("IPTC field cut short");
    const int k = uint8_t(s[3]);
    if (k > 132) invalid("illegal field length in IPTC/NAA file");
    if (k == 128) {
      size = 0;
    } else if (k > 128) {
      const std::string e = f.read(k - 128);
      uint32_t v = 0;
      for (size_t i = e.size() > 4 ? e.size() - 4 : 0; i < e.size(); i++)
        v = v << 8 | uint8_t(e[i]);
      size = v;
    } else {
      if (s.size() < 5) fail("IPTC field cut short");
      size = int64_t(be16(reinterpret_cast<const uint8_t*>(s.data()) + 3));
    }
    return true;
  };
  std::map<std::pair<int, int>, std::vector<std::string>> info;
  size_t offset = 0;
  int r = 0, ds = 0;
  bool at_image = false;
  for (;;) {
    offset = f.pos;
    int64_t size;
    if (!field(r, ds, size, true)) break;
    if (r == 8 && ds == 10) {
      at_image = true;
      break;
    }
    info[{r, ds}].push_back(size ? f.read(size) : std::string());
  }
  auto first = [&](int a, int b) -> const std::string& {
    auto it = info.find({a, b});
    if (it == info.end()) throw HandOnErr("IPTC without a required field");
    return it->second[0];
  };
  auto getint = [&](int a, int b) {
    const std::string& s = first(a, b);
    uint32_t v = 0;
    for (size_t i = s.size() > 4 ? s.size() - 4 : 0; i < s.size(); i++)
      v = v << 8 | uint8_t(s[i]);
    return int64_t(v);
  };
  const std::string& lc = first(3, 60);
  if (lc.size() < 2) throw HandOnErr("IPTC layer field cut short");
  if (info.at({3, 60}).size() > 1) invalid("IPTC layer field repeated");
  const int layers = uint8_t(lc[0]), component = uint8_t(lc[1]);
  int bands = 0;
  if (layers == 1 && !component)
    bands = 1;
  else if (layers == 3 && component)
    bands = 3;
  else if (layers == 4 && component)
    bands = 4;
  int band = 0;
  if (bands != 1 && info.count({3, 65})) {
    if (info.at({3, 65}).size() > 1) invalid("IPTC band field repeated");
    const std::string& b = first(3, 65);
    if (b.empty()) throw HandOnErr("IPTC band field empty");
    band = uint8_t(b[0]) - 1;
  }
  const int64_t w = getint(3, 20), h = getint(3, 30);
  const int64_t comp = getint(3, 120);
  if (comp != 1 && comp != 5) invalid("Unknown IPTC image compression");
  if (!bands || w <= 0 || h <= 0) throw HandOnErr("no mode");
  if (!at_image) invalid("cannot load this image");
  // load(): the (8, 10) fields from the tile, behind a P5 header if raw
  f.pos = offset;
  std::string o;
  if (comp == 1)
    o = "P5\n" + std::to_string(w) + " " + std::to_string(h) + "\n255\n";
  for (;;) {
    int64_t size;
    if (!field(r, ds, size, false) || !(r == 8 && ds == 10)) break;
    o += f.read(size);
  }
  const uint8_t* od = reinterpret_cast<const uint8_t*>(o.data());
  Image inner;
  bool gray;
  if (comp == 1) {
    decode_pnm(od, o.size(), inner);
    gray = true;
  } else {
    if (o.size() < 3 || od[0] != 0xFF || od[1] != 0xD8 || od[2] != 0xFF)
      throw Unsupported("IPTC image data under compression 5 that is not a "
                        "JPEG is not decoded by craytracer_tpu_torch");
    Jpeg j;
    j.d = od;
    j.n = o.size();
    j.feed = true;
    j.decode(inner);
    gray = j.comps.size() == 1;
  }
  if (bands == 1) {
    img = inner;
    return;
  }
  // Image.merge(mode, bands): the image in one band, the others 0
  if (!gray) invalid("mode mismatch");
  if (band < -bands || band >= bands) invalid("IPTC band out of range");
  if (band < 0) band += bands;
  img.alloc(inner.w, inner.h);
  for (int64_t y = 0; y < inner.h; y++)
    for (int64_t x = 0; x < inner.w; x++) {
      int ch[4] = {0, 0, 0, 0};
      ch[band] = inner.px(x, y)[0];
      if (bands == 3)
        img.put(x, y, ch[0], ch[1], ch[2]);
      else
        cmyk_to_rgb(img.px(x, y), ch[0], ch[1], ch[2], ch[3]);
    }
}

// ---------------------------------------------------------------- FLI

void decode_fli(const uint8_t* d, size_t n, Image& img) {
  if (n < 128) throw HandOnErr("not an FLI/FLC file");
  const int64_t w = le16(d + 8), h = le16(d + 10);
  // the palette of the first COLOR chunk in the first frame, or a ramp
  Palette pal;
  for (int i = 0; i < 256; i++) pal.rgb[i][0] = pal.rgb[i][1] = pal.rgb[i][2] = uint8_t(i);
  {
    PyFile f{d, n, 128};
    std::string s = f.read(16);
    auto u16 = [](const std::string& t, size_t o) {
      if (t.size() < o + 2) throw HandOnErr("FLI header cut short");
      return le16(reinterpret_cast<const uint8_t*>(t.data()) + o);
    };
    auto u32 = [](const std::string& t, size_t o) {
      if (t.size() < o + 4) throw HandOnErr("FLI header cut short");
      return le32(reinterpret_cast<const uint8_t*>(t.data()) + o);
    };
    if (u16(s, 4) == 0xF100) {
      f.pos = 128 + u32(s, 0);
      s = f.read(16);
    }
    if (u16(s, 4) == 0xF1FA) {
      const int subchunks = int(u16(s, 6));
      int64_t chunk_size = -1;
      for (int c = 0; c < subchunks; c++) {
        if (chunk_size >= 0) f.pos = size_t(std::max<int64_t>(0, int64_t(f.pos) + chunk_size - 6));
        s = f.read(6);
        const int type = int(u16(s, 4));
        if (type == 4 || type == 11) {
          const int shift = type == 11 ? 2 : 0;
          int idx = 0;
          const std::string ne = f.read(2);
          const int packets = int(u16(ne, 0));
          for (int e = 0; e < packets; e++) {
            const std::string pk = f.read(2);
            if (pk.size() < 2) throw HandOnErr("FLI palette cut short");
            idx += uint8_t(pk[0]);
            int cnt = uint8_t(pk[1]);
            if (cnt == 0) cnt = 256;
            const std::string rgb = f.read(int64_t(cnt) * 3);
            for (size_t k = 0; k < rgb.size(); k += 3) {
              if (k + 2 >= rgb.size()) throw HandOnErr("FLI palette cut short");
              if (idx >= 256) throw HandOnErr("FLI palette index past 255");
              const int r = uint8_t(rgb[k]) << shift, g = uint8_t(rgb[k + 1]) << shift,
                        b = uint8_t(rgb[k + 2]) << shift;
              if (r > 255 || g > 255 || b > 255)
                invalid("FLI palette entry past 255");
              pal.rgb[idx][0] = uint8_t(r);
              pal.rgb[idx][1] = uint8_t(g);
              pal.rgb[idx][2] = uint8_t(b);
              idx++;
            }
          }
          break;
        }
        chunk_size = u32(s, 0);
        if (!chunk_size) break;
      }
    }
  }
  if (w <= 0 || h <= 0) throw HandOnErr("FLI of size 0");
  img.alloc(w, h);
  // _seek(0): the frame at 128; ImageFile.load reads framesize bytes
  if (n < 132) throw HandOnErr("missing frame size");
  const int64_t framesize = int32_t(le32(d + 128));
  const uint8_t* buf = d + 128;
  int64_t bytes = int64_t(n) - 128;
  if (framesize <= 0) invalid("image file is truncated");
  if (bytes + (bytes % 2) < framesize) invalid("image file is truncated");
  if (bytes < 8) invalid("FLI frame cut short");
  if (le16(buf + 4) != 0xF1FA) invalid("not an FLI frame chunk");
  std::vector<uint8_t> px(size_t(w * h), 0);
  auto row = [&](int64_t y) { return &px[size_t(y * w)]; };
  const int chunks = int(le16(buf + 6));
  const uint8_t* ptr = buf + 16;
  bytes -= 16;
  const uint8_t* end = ptr + bytes;
  auto oob = [&](const uint8_t* data, int64_t k) {
    if (data + k > end) invalid("FLI chunk overruns the frame");
  };
  for (int c = 0; c < chunks; c++) {
    if (bytes < 10) invalid("FLI chunk overruns the frame");
    const uint8_t* data = ptr + 6;
    end = ptr + bytes;
    switch (le16(ptr + 4)) {
      case 4:
      case 11:
      case 18:
        break;
      case 7: {  // SS2
        const int lines = int(le16(data));
        data += 2;
        int l = 0;
        int64_t y = 0;
        for (; l < lines && y < h; l++, y++) {
          uint8_t* out = row(y);
          oob(data, 2);
          uint32_t packets = le16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {
              y += 65536 - packets;
              if (y >= h) invalid("FLI SS2 skips past the image");
              out = row(y);
            } else {
              out[w - 1] = uint8_t(packets);
            }
            oob(data, 2);
            packets = le16(data);
            data += 2;
          }
          uint32_t p = 0;
          int64_t x = 0;
          for (; p < packets; p++) {
            oob(data, 2);
            x += data[0];
            if (data[1] >= 128) {
              oob(data, 4);
              const int64_t i = 256 - data[1];
              if (x + i + i > w) break;
              for (int64_t j = 0; j < i; j++) {
                out[x++] = data[2];
                out[x++] = data[3];
              }
              data += 4;
            } else {
              const int64_t i = 2 * int64_t(data[1]);
              if (x + i > w) break;
              oob(data, 2 + i);
              std::memcpy(out + x, data + 2, size_t(i));
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) invalid("FLI SS2 lines left over");
        break;
      }
      case 12: {  // LC
        int64_t y = le16(data);
        const int64_t ymax = y + le16(data + 2);
        data += 4;
        for (; y < ymax && y < h; y++) {
          uint8_t* out = row(y);
          oob(data, 1);
          const int packets = *data++;
          int p = 0;
          int64_t x = 0, i = 0;
          for (; p < packets; p++, x += i) {
            oob(data, 2);
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > w) break;
              oob(data, 3);
              std::memset(out + x, data[2], size_t(i));
              data += 3;
            } else {
              i = data[1];
              if (x + i > w) break;
              oob(data, 2 + i);
              std::memcpy(out + x, data + 2, size_t(i));
              data += 2 + i;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) invalid("FLI LC lines left over");
        break;
      }
      case 13:
        std::fill(px.begin(), px.end(), 0);
        break;
      case 15: {  // BRUN
        for (int64_t y = 0; y < h; y++) {
          uint8_t* out = row(y);
          data += 1;
          int64_t x = 0, i = 0;
          for (; x < w; x += i) {
            oob(data, 2);
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > w) break;
              oob(data, i + 1);
              std::memcpy(out + x, data + 1, size_t(i));
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > w) break;
              std::memset(out + x, data[1], size_t(i));
              data += 2;
            }
          }
          if (x != w) invalid("FLI BRUN line left short");
        }
        break;
      }
      case 16:  // COPY
        if (data + w * h > end) invalid("image file is truncated");
        std::memcpy(px.data(), data, size_t(w * h));
        break;
      default:
        invalid("unknown FLI chunk");
    }
    const int64_t advance = int32_t(le32(ptr));
    if (advance == 0) invalid("FLI chunk of size 0");
    if (advance < 0 || advance > bytes) invalid("FLI chunk overruns the frame");
    ptr += advance;
    bytes -= advance;
  }
  for (int64_t y = 0; y < h; y++)
    for (int64_t x = 0; x < w; x++)
      std::memcpy(img.px(x, y), pal.rgb[px[size_t(y * w + x)]], 3);
}

// ---------------------------------------------------------------- PCD

void decode_pcd(const uint8_t* d, size_t n, Image& img) {
  if (n < 2048 + 1539 || std::memcmp(d + 2048, "PCD_", 4))
    throw HandOnErr("not a PCD file");
  const int orientation = d[2048 + 1538] & 3;
  // UnpackYCC.c's tables: (int)(f * x + 0.5) of the PhotoYCC formulas
  struct Ycc {
    int L[256], CR[256], CB[256], GR[256], GB[256];
    Ycc() {
      for (int i = 0; i < 256; i++) {
        L[i] = int(1.3584 * i + 0.5);
        CR[i] = int(1.8215 * (i - 137) + 0.5);
        CB[i] = int(2.2179 * (i - 156) + 0.5);
        GR[i] = int(-0.509 * 1.8215 * (i - 137) + 0.5);
        GB[i] = int(-0.194 * 2.2179 * (i - 156) + 0.5);
      }
    }
  };
  static const Ycc t;
  const int W = 768, H = 512;
  const size_t chunk = 3 * W, base = 96 * 2048;
  if (n < base || (n - base) / chunk < size_t(H / 2))
    invalid("image file is truncated");
  std::vector<uint8_t> px(size_t(W) * H * 3);
  auto clip = [](int v) { return uint8_t(v <= 0 ? 0 : v >= 255 ? 255 : v); };
  for (int r = 0; r < H / 2; r++) {
    const uint8_t* p = d + base + size_t(r) * chunk;
    for (int line = 0; line < 2; line++)
      for (int x = 0; x < W; x++) {
        const int y = p[x + line * W], cb = p[(x + 4 * W) / 2],
                  cr = p[(x + 5 * W) / 2];
        const int l = t.L[y];
        uint8_t* o = &px[(size_t(2 * r + line) * W + x) * 3];
        o[0] = clip(l + t.CR[cr]);
        o[1] = clip(l + t.GR[cr] + t.GB[cb]);
        o[2] = clip(l + t.CB[cb]);
      }
  }
  if (orientation == 1 || orientation == 3) {
    // rotate(90 or 270, expand=True): a transpose to 512 x 768
    img.alloc(H, W);
    for (int y = 0; y < W; y++)
      for (int x = 0; x < H; x++) {
        const int sx = orientation == 1 ? W - 1 - y : y;
        const int sy = orientation == 1 ? x : H - 1 - x;
        std::memcpy(img.px(x, y), &px[(size_t(sy) * W + sx) * 3], 3);
      }
    return;
  }
  img.alloc(W, H);
  img.rgb = std::move(px);
}

}  // namespace
