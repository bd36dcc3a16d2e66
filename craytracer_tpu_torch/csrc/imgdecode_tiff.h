// TIFF and BigTIFF for csrc/imgdecode.cpp, which includes this file after
// its shared helpers (the inflater and the JPEG decoder among them): the
// first page as PIL's TiffImagePlugin opens it, then convert("RGB").
//
// PIL reads the tags itself and picks its mode and raw mode from
// OPEN_INFO by (byte order, photometric, sample format, fill order, bits
// per sample, extra samples); a key it lacks, a compression it does not
// name or a file it cannot parse gives status 2. Then:
//
// - Uncompressed files go through PIL's raw decoder, tile by tile from
//   each offset: the raw mode's unpacker over lines of the tile's width
//   (or the tile's full row where it crosses the right edge), reading on
//   past the strip's byte count into whatever follows, as PIL does.
//   Planar files take one character of the raw mode per plane. So an
//   uncompressed YCbCr file is read as RGBX, as PIL reads it.
// - Compressed files go through libtiff: PackBits, LZW (MSB-first codes
//   with early change; old-style LZW is refused), Deflate (8 and 32946)
//   and JPEG (7, with JPEGTables; YCbCr converted by the JPEG decoder's
//   colour path, other photometrics passed through), then predictor 2 (8,
//   16 and 32 bits) or 3 (floating point), the samples swapped to the
//   host's little-endian order, then PIL's unpacker for the raw mode
//   (";16N" for 16-bit samples; float and signed raw modes keep their
//   stated order, as PIL keeps them). Planar files copy plane k into band
//   k (8 bits, or the high byte of 16). YCbCr other than JPEG goes through
//   libtiff's RGBA reader: each subsampling block's chroma shared, then
//   TIFFYCbCrtoRGB with the ReferenceBlackWhite and luma tags.
// - Fill order 2 reverses the bits of each byte before anything else.
// - The Orientation tag is applied at the end, as PIL's exif_transpose
//   applies it on load.
//
// CCITT (2, 3, 4, 32771), old-style JPEG (6), LZMA, ZSTD, WebP, SGILog,
// ThunderScan, old-style LZW and Lab are refused by name (status 1).

namespace {

struct TiffOpen {
  uint8_t order;  // 0 II, 1 MM, 2 either
  uint8_t photo, sf, fill, bps, spp;
  const char* extra;
  const char* mode;
  const char* rawmode;
};
// TiffImagePlugin.OPEN_INFO
const TiffOpen TIFF_OPEN[] = {
    {2, 0, 1, 1, 1, 1, "", "1", "1;I"},
    {2, 0, 1, 2, 1, 1, "", "1", "1;IR"},
    {2, 1, 1, 1, 1, 1, "", "1", "1"},
    {2, 1, 1, 2, 1, 1, "", "1", "1;R"},
    {2, 0, 1, 1, 2, 1, "", "L", "L;2I"},
    {2, 0, 1, 2, 2, 1, "", "L", "L;2IR"},
    {2, 1, 1, 1, 2, 1, "", "L", "L;2"},
    {2, 1, 1, 2, 2, 1, "", "L", "L;2R"},
    {2, 0, 1, 1, 4, 1, "", "L", "L;4I"},
    {2, 0, 1, 2, 4, 1, "", "L", "L;4IR"},
    {2, 1, 1, 1, 4, 1, "", "L", "L;4"},
    {2, 1, 1, 2, 4, 1, "", "L", "L;4R"},
    {2, 0, 1, 1, 8, 1, "", "L", "L;I"},
    {2, 0, 1, 2, 8, 1, "", "L", "L;IR"},
    {2, 1, 1, 1, 8, 1, "", "L", "L"},
    {2, 1, 2, 1, 8, 1, "", "L", "L"},
    {2, 1, 1, 2, 8, 1, "", "L", "L;R"},
    {0, 1, 1, 1, 12, 1, "", "I;16", "I;12"},
    {0, 0, 1, 1, 16, 1, "", "I;16", "I;16"},
    {0, 1, 1, 1, 16, 1, "", "I;16", "I;16"},
    {1, 1, 1, 1, 16, 1, "", "I;16B", "I;16B"},
    {0, 1, 1, 2, 16, 1, "", "I;16", "I;16R"},
    {0, 1, 2, 1, 16, 1, "", "I", "I;16S"},
    {1, 1, 2, 1, 16, 1, "", "I", "I;16BS"},
    {0, 0, 3, 1, 32, 1, "", "F", "F;32F"},
    {1, 0, 3, 1, 32, 1, "", "F", "F;32BF"},
    {0, 1, 1, 1, 32, 1, "", "I", "I;32N"},
    {0, 1, 2, 1, 32, 1, "", "I", "I;32S"},
    {1, 1, 2, 1, 32, 1, "", "I", "I;32BS"},
    {0, 1, 3, 1, 32, 1, "", "F", "F;32F"},
    {1, 1, 3, 1, 32, 1, "", "F", "F;32BF"},
    {2, 1, 1, 1, 8, 2, "2", "LA", "LA"},
    {2, 2, 1, 1, 8, 3, "", "RGB", "RGB"},
    {2, 2, 1, 2, 8, 3, "", "RGB", "RGB;R"},
    {2, 2, 1, 1, 8, 4, "", "RGBA", "RGBA"},
    {2, 2, 1, 1, 8, 4, "0", "RGB", "RGBX"},
    {2, 2, 1, 1, 8, 5, "0,0", "RGB", "RGBXX"},
    {2, 2, 1, 1, 8, 6, "0,0,0", "RGB", "RGBXXX"},
    {2, 2, 1, 1, 8, 4, "1", "RGBA", "RGBa"},
    {2, 2, 1, 1, 8, 5, "1,0", "RGBA", "RGBaX"},
    {2, 2, 1, 1, 8, 6, "1,0,0", "RGBA", "RGBaXX"},
    {2, 2, 1, 1, 8, 4, "2", "RGBA", "RGBA"},
    {2, 2, 1, 1, 8, 5, "2,0", "RGBA", "RGBAX"},
    {2, 2, 1, 1, 8, 6, "2,0,0", "RGBA", "RGBAXX"},
    {2, 2, 1, 1, 8, 4, "999", "RGBA", "RGBA"},
    {0, 2, 1, 1, 16, 3, "", "RGB", "RGB;16L"},
    {1, 2, 1, 1, 16, 3, "", "RGB", "RGB;16B"},
    {0, 2, 1, 1, 16, 4, "", "RGBA", "RGBA;16L"},
    {1, 2, 1, 1, 16, 4, "", "RGBA", "RGBA;16B"},
    {0, 2, 1, 1, 16, 4, "0", "RGB", "RGBX;16L"},
    {1, 2, 1, 1, 16, 4, "0", "RGB", "RGBX;16B"},
    {0, 2, 1, 1, 16, 4, "1", "RGBA", "RGBa;16L"},
    {1, 2, 1, 1, 16, 4, "1", "RGBA", "RGBa;16B"},
    {0, 2, 1, 1, 16, 4, "2", "RGBA", "RGBA;16L"},
    {1, 2, 1, 1, 16, 4, "2", "RGBA", "RGBA;16B"},
    {2, 3, 1, 1, 1, 1, "", "P", "P;1"},
    {2, 3, 1, 2, 1, 1, "", "P", "P;1R"},
    {2, 3, 1, 1, 2, 1, "", "P", "P;2"},
    {2, 3, 1, 2, 2, 1, "", "P", "P;2R"},
    {2, 3, 1, 1, 4, 1, "", "P", "P;4"},
    {2, 3, 1, 2, 4, 1, "", "P", "P;4R"},
    {2, 3, 1, 1, 8, 1, "", "P", "P"},
    {2, 3, 1, 1, 8, 2, "0", "P", "PX"},
    {2, 3, 1, 1, 8, 2, "2", "PA", "PA"},
    {2, 3, 1, 2, 8, 1, "", "P", "P;R"},
    {2, 5, 1, 1, 8, 4, "", "CMYK", "CMYK"},
    {2, 5, 1, 1, 8, 5, "0", "CMYK", "CMYKX"},
    {2, 5, 1, 1, 8, 6, "0,0", "CMYK", "CMYKXX"},
    {0, 5, 1, 1, 16, 4, "", "CMYK", "CMYK;16L"},
    {1, 5, 1, 1, 16, 4, "", "CMYK", "CMYK;16B"},
    {2, 6, 1, 1, 8, 1, "", "L", "L"},
    {2, 6, 1, 1, 8, 3, "", "RGB", "RGBX"},
    {2, 8, 1, 1, 8, 3, "", "LAB", "LAB"},
};

const uint8_t* bit_reverse_table() {
  static const struct T {
    uint8_t v[256];
    T() {
      for (int i = 0; i < 256; i++) {
        int r = 0;
        for (int b = 0; b < 8; b++) r |= ((i >> b) & 1) << (7 - b);
        v[i] = uint8_t(r);
      }
    }
  } t;
  return t.v;
}

// The image in PIL's mode, before convert("RGB"): bytes for the 8-bit
// modes (PIL's 4-byte pixels, band k at byte k), ints for I and I;16,
// floats for F.
struct ModeImage {
  enum Mode { M1, ML, MP, MI16, MI, MF, MLA, MPA, MRGB, MRGBA, MCMYK } mode;
  int64_t w = 0, h = 0;
  std::vector<uint8_t> b;   // w * h * 4
  std::vector<int32_t> iv;  // w * h
  std::vector<float> fv;    // w * h
  int bands() const {
    switch (mode) {
      case MLA: case MPA: return 2;
      case MRGB: return 3;
      case MRGBA: case MCMYK: return 4;
      default: return 1;
    }
  }
  void alloc(int64_t w_, int64_t h_) {
    w = w_;
    h = h_;
    if (mode == MI16 || mode == MI)
      iv.assign(size_t(w * h), 0);
    else if (mode == MF)
      fv.assign(size_t(w * h), 0.0f);
    else
      b.assign(size_t(w * h) * 4, 0);
  }
};

ModeImage::Mode tiff_mode(const std::string& m) {
  if (m == "1") return ModeImage::M1;
  if (m == "L") return ModeImage::ML;
  if (m == "P") return ModeImage::MP;
  if (m == "I;16" || m == "I;16B") return ModeImage::MI16;
  if (m == "I") return ModeImage::MI;
  if (m == "F") return ModeImage::MF;
  if (m == "LA") return ModeImage::MLA;
  if (m == "PA") return ModeImage::MPA;
  if (m == "RGB") return ModeImage::MRGB;
  if (m == "RGBA") return ModeImage::MRGBA;
  if (m == "CMYK") return ModeImage::MCMYK;
  throw Unsupported("Lab TIFF is not decoded by craytracer_tpu_torch");
}

// One of PIL's unpackers (Unpack.c), by raw mode name
struct Unpacker {
  enum Kind { BITS, BYTES, U16, S16, I32, F32, I12, BAND } kind = BYTES;
  int bits = 8;        // per pixel of raw data
  int sub = 8;         // BITS: bits per sample
  int stride = 1;      // BYTES/U16: samples per pixel
  int copy = 1;        // BYTES/U16: leading samples kept
  int band = 0;        // BAND: the byte written
  int sb = 1;          // BAND: bytes per sample (2: the high byte of LE)
  bool big = false, invert = false, reverse = false, premul = false;
  bool scale = false;  // BITS: gray levels widened (L;2, L;4)

  static Unpacker parse(const std::string& r, ModeImage::Mode mode) {
    Unpacker u;
    std::string base = r.substr(0, r.find(';'));
    std::string suf = r.find(';') == std::string::npos
                          ? ""
                          : r.substr(r.find(';') + 1);
    if (r.size() == 1) {  // a plane of PIL's raw decoder: Unpack.c has
      const char c = r[0];  // only these single-band unpackers
      const bool rgb = mode == ModeImage::MRGB || mode == ModeImage::MRGBA;
      if ((rgb && (c == 'R' || c == 'G' || c == 'B')) ||
          (mode == ModeImage::MRGBA && c == 'A')) {
        u.kind = BAND;
        u.band = int(std::strchr("RGBA", c) - "RGBA");
      } else if (mode == ModeImage::MCMYK && std::strchr("CMYK", c)) {
        u.kind = BAND;
        u.band = int(std::strchr("CMYK", c) - "CMYK");
      } else if (mode == ModeImage::MI && c == 'I') {
        u.kind = I32;
        u.bits = 32;
      } else if (mode == ModeImage::MF && c == 'F') {
        u.kind = F32;
        u.bits = 32;
      } else if (mode == ModeImage::M1 && c == '1') {
        u.kind = BITS;
        u.sub = u.bits = 1;
        u.scale = true;
      } else if (!((mode == ModeImage::ML && c == 'L') ||
                   (mode == ModeImage::MP && c == 'P'))) {
        invalid("no unpacker for raw mode " + r);
      }
      return u;
    }
    if (r == "L;IR" || r == "P;1R" || r == "P;2R" || r == "P;4R")
      invalid("no unpacker for raw mode " + r);
    if (r == "LAB") throw Unsupported("Lab TIFF is not decoded by "
                                      "craytracer_tpu_torch");
    if (base == "1" || ((base == "L" || base == "P") &&
                        (suf.rfind("1", 0) == 0 || suf.rfind("2", 0) == 0 ||
                         suf.rfind("4", 0) == 0))) {
      u.kind = BITS;
      u.sub = base == "1" ? 1 : suf[0] - '0';
      u.bits = u.sub;
      std::string fl = base == "1" ? suf : suf.substr(1);
      u.invert = fl.find('I') != std::string::npos;
      u.reverse = fl.find('R') != std::string::npos;
      u.scale = base != "P";
      return u;
    }
    if (base == "L" || base == "P") {
      if (suf != "" && suf != "I" && suf != "R" && suf != "IR")
        invalid("unknown raw mode " + r);
      u.invert = suf.find('I') != std::string::npos;
      u.reverse = suf.find('R') != std::string::npos;
      return u;
    }
    if (base == "PX" || base == "PA" || base == "LA") {
      u.stride = 2;
      u.bits = 16;
      return u;
    }
    if (base == "I") {
      if (suf == "12") {
        u.kind = I12;
        u.bits = 12;
      } else if (suf == "16" || suf == "16N" || suf == "16B" ||
                 suf == "16R") {
        u.kind = U16;
        u.bits = 16;
        u.big = suf == "16B";
        u.reverse = suf == "16R";
      } else if (suf == "16S" || suf == "16BS") {
        u.kind = S16;
        u.bits = 16;
        u.big = suf == "16BS";
      } else if (suf == "32N" || suf == "32S" || suf == "32BS") {
        u.kind = I32;
        u.bits = 32;
        u.big = suf == "32BS";
      } else {
        invalid("unknown raw mode " + r);
      }
      return u;
    }
    if (base == "F") {
      u.kind = F32;
      u.bits = 32;
      u.big = suf == "32BF";
      return u;
    }
    // RGB(A|a|X)(X)(X), CMYK(X)(X), each 8 or 16 bits
    const bool cmyk = base.rfind("CMYK", 0) == 0;
    if (!cmyk && base.rfind("RGB", 0) != 0) invalid("unknown raw mode " + r);
    std::string tail = base.substr(cmyk ? 4 : 3);
    u.copy = cmyk ? 4 : 3;
    u.stride = int(base.size());
    if (!tail.empty() && (tail[0] == 'A' || tail[0] == 'a')) {
      u.copy = 4;
      u.premul = tail[0] == 'a';
    }
    if (suf == "R") {
      u.reverse = true;
    } else if (suf == "16L" || suf == "16B" || suf == "16N") {
      u.kind = U16;
      u.big = suf == "16B";
    } else if (!suf.empty()) {
      invalid("unknown raw mode " + r);
    }
    u.bits = u.stride * (u.kind == U16 ? 16 : 8);
    return u;
  }

  // unpack `npix` pixels of `in` into row y of `im` from column x0
  void run(const uint8_t* in, int64_t npix, ModeImage& im, int64_t x0,
           int64_t y) const {
    const uint8_t* rev = bit_reverse_table();
    const size_t at = size_t(y * im.w + x0);
    auto byte = [&](size_t i) {
      uint8_t v = in[i];
      return reverse ? rev[v] : v;
    };
    switch (kind) {
      case BITS: {
        const int per = 8 / sub, mask = (1 << sub) - 1;
        for (int64_t x = 0; x < npix; x++) {
          int v = (byte(size_t(x / per)) >> (8 - sub * (1 + x % per))) & mask;
          if (invert) v = mask - v;
          if (scale) v = v * 255 / mask;
          im.b[(at + size_t(x)) * 4] = uint8_t(v);
        }
        break;
      }
      case BAND:
        for (int64_t x = 0; x < npix; x++)
          im.b[(at + size_t(x)) * 4 + band] = in[x * sb + sb - 1];
        break;
      case I12:
        for (int64_t x = 0; x < npix; x++) {
          const uint8_t* p = in + (x / 2) * 3;
          im.iv[at + size_t(x)] =
              x & 1 ? (p[1] & 15) << 8 | p[2] : p[0] << 4 | p[1] >> 4;
        }
        break;
      case S16:
        for (int64_t x = 0; x < npix; x++) {
          uint32_t v = big ? be16(in + 2 * x) : le16(in + 2 * x);
          im.iv[at + size_t(x)] = int16_t(uint16_t(v));
        }
        break;
      case I32:
        for (int64_t x = 0; x < npix; x++)
          im.iv[at + size_t(x)] =
              int32_t(big ? be32(in + 4 * x) : le32(in + 4 * x));
        break;
      case F32:
        for (int64_t x = 0; x < npix; x++) {
          uint32_t v = big ? be32(in + 4 * x) : le32(in + 4 * x);
          std::memcpy(&im.fv[at + size_t(x)], &v, 4);
        }
        break;
      case U16:
        if (im.mode == ModeImage::MI16) {
          for (int64_t x = 0; x < npix; x++) {
            uint8_t lo = byte(2 * size_t(x)), hi = byte(2 * size_t(x) + 1);
            im.iv[at + size_t(x)] = big ? lo << 8 | hi : hi << 8 | lo;
          }
          break;
        }
        [[fallthrough]];
      case BYTES: {
        const int sb = kind == U16 ? 2 : 1;
        const int msb = kind == U16 && !big ? 1 : 0;
        for (int64_t x = 0; x < npix; x++) {
          uint8_t* o = &im.b[(at + size_t(x)) * 4];
          const size_t p = size_t(x) * stride * sb;
          for (int c = 0; c < copy; c++) {
            uint8_t v = byte(p + size_t(c) * sb + msb);
            o[c] = invert ? uint8_t(255 - v) : v;
          }
          if (premul) {  // Unpack.c unpackRGBa: to straight alpha
            int a = o[3];
            for (int c = 0; c < 3; c++)
              o[c] = a == 0 ? 0 : a == 255 ? o[c]
                                           : uint8_t(std::min(255, o[c] * 255 / a));
          }
        }
        break;
      }
    }
  }
};

struct TiffTag {
  int type = 0;
  std::vector<int64_t> v;     // integer types
  std::vector<uint8_t> data;  // the raw bytes
};

struct Tiff {
  const uint8_t* d;
  size_t n;
  bool mm = false, big = false;
  std::map<int, TiffTag> tags;
  // libtiff's view only: the directory read whole, and the tags whose
  // data it could not read
  bool whole = true;
  std::vector<int> unread;
  std::map<int, std::pair<int, uint64_t>> entry_of;  // type and count

  uint64_t u(const uint8_t* p, int k) const {
    uint64_t v = 0;
    for (int i = 0; i < k; i++)
      v |= uint64_t(p[mm ? k - 1 - i : i]) << (8 * i);
    return v;
  }

  // ImageFileDirectory_v2.load (`pil`): a directory cut short, or a tag
  // whose data lies past the end, keeps the tags read before it; libtiff
  // skips such a tag and reads on
  void load_ifd(uint64_t off, bool pil) {
    const int cnt_size = big ? 8 : 2, entry = big ? 20 : 12;
    if (off > n || n - off < size_t(cnt_size)) {
      whole = false;
      return;
    }
    uint64_t count = u(d + off, cnt_size);
    size_t p = size_t(off) + cnt_size;
    // TIFFFetchDirectory's sanity check, and a directory cut short
    if (count > 4096 || (n - p) / size_t(entry) < count) whole = false;
    static const int UNIT[19] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8, 4,
                                 0, 0, 8, 8, 8};
    for (uint64_t i = 0; i < count; i++, p += entry) {
      if (n - p < size_t(entry)) return;
      int tag = int(u(d + p, 2)), type = int(u(d + p + 2, 2));
      uint64_t cnt = u(d + p + 4, big ? 8 : 4);
      entry_of[tag] = {type, cnt};
      const uint8_t* val = d + p + (big ? 12 : 8);
      if (type < 1 || type > 18 || !UNIT[type]) {
        unread.push_back(tag);
        continue;
      }
      uint64_t size = cnt * uint64_t(UNIT[type]);
      if (cnt > (uint64_t(1) << 40)) continue;
      const uint8_t* src = val;
      if (size > uint64_t(big ? 8 : 4)) {
        uint64_t at = u(val, big ? 8 : 4);
        if (at > n || n - at < size) {
          if (pil) return;  // _safe_read raises
          unread.push_back(tag);
          continue;
        }
        src = d + at;
      }
      if (!size) continue;
      TiffTag t;
      t.type = type;
      t.data.assign(src, src + size);
      const int us = UNIT[type];
      if (type == 1 || type == 3 || type == 4 || type == 6 || type == 8 ||
          type == 9 || type == 13 || type == 16 || type == 17 || type == 18)
        for (uint64_t k = 0; k < cnt; k++) {
          uint64_t x = u(src + k * us, us);
          int64_t s = int64_t(x);
          if (type == 6) s = int8_t(x);
          if (type == 8) s = int16_t(x);
          if (type == 9) s = int32_t(x);
          t.v.push_back(s);
        }
      tags[tag] = std::move(t);
    }
  }
  bool has(int tag) const {
    auto it = tags.find(tag);
    return it != tags.end() && !it->second.v.empty();
  }
  int64_t get(int tag, int64_t dflt) const {
    return has(tag) ? tags.at(tag).v[0] : dflt;
  }
  std::vector<int64_t> tuple(int tag, std::vector<int64_t> dflt) const {
    return has(tag) ? tags.at(tag).v : dflt;
  }
};

const char* tiff_compression_name(int64_t c) {
  switch (c) {
    case 2: return "CCITT RLE (2)";
    case 3: return "CCITT Group 3 (3)";
    case 4: return "CCITT Group 4 (4)";
    case 6: return "old-style JPEG (6)";
    case 32771: return "CCITT RLEW (32771)";
    case 32809: return "ThunderScan (32809)";
    case 34676: return "SGILog (34676)";
    case 34677: return "SGILog24 (34677)";
    case 34925: return "LZMA (34925)";
    case 50000: return "ZSTD (50000)";
    case 50001: return "WebP (50001)";
    default: return nullptr;
  }
}

// libtiff's LZW decoder (tif_lzw.c): `want` bytes or an error
std::vector<uint8_t> tiff_lzw(const uint8_t* s, size_t n, size_t want,
                              bool lenient = false, bool* cut = nullptr) {
  if (n >= 2 && s[0] == 0 && (s[1] & 1))
    throw Unsupported("TIFF with old-style LZW (LSB-first codes) is not "
                      "decoded by craytracer_tpu_torch");
  std::vector<uint8_t> out;
  out.reserve(want);
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  std::vector<uint16_t> length(4096);
  for (int i = 0; i < 256; i++) {
    suffix[i] = first[i] = uint8_t(i);
    length[i] = 1;
  }
  int nbits = 9, next = 258, old = -1;
  bool cleared = false;
  uint64_t acc = 0;
  int nacc = 0;
  size_t p = 0;
  std::vector<uint8_t> tmp(4096);
  while (out.size() < want) {
    while (nacc < nbits && p < n) {
      acc = acc << 8 | s[p++];
      nacc += 8;
    }
    if (nacc < nbits) break;  // data ran out
    int code = int((acc >> (nacc - nbits)) & ((1u << nbits) - 1));
    nacc -= nbits;
    if (code == 257) break;
    if (code == 256) {
      nbits = 9;
      next = 258;
      old = -1;
      cleared = true;
      continue;
    }
    // libtiff adds no entry before a first clear code; either error ends
    // the segment (the RGBA reader goes on with what was decoded)
    if (!cleared || (old < 0 && code > 255) || (old >= 0 && code > next)) {
      if (!lenient) invalid("bad LZW code");
      break;
    }
    if (old < 0) {
      out.push_back(uint8_t(code));
      old = code;
      continue;
    }
    int emit = code == next ? old : code;
    int len = length[emit];
    for (int c = emit, k = len - 1; k >= 0; k--, c = prefix[c])
      tmp[size_t(k)] = suffix[size_t(c)];
    uint8_t f = first[emit];
    if (code == next) tmp[size_t(len++)] = f;
    // libtiff's table runs 1,023 entries past the 4,096 that codes reach
    // before it calls the stream corrupt
    if (next >= 4096 + 1023) {
      if (!lenient) invalid("LZW table overflow");
      break;
    }
    if (next < 4096) {
      prefix[next] = uint16_t(old);
      suffix[next] = code == next ? f : first[code];
      first[next] = first[old];
      length[next] = uint16_t(length[old] + 1);
    }
    if (++next >= (1 << nbits) - 1 && nbits < 12) nbits++;
    out.insert(out.end(), tmp.begin(), tmp.begin() + len);
    old = code;
  }
  if (out.size() < want && !lenient) invalid("not enough LZW data");
  if (cut) *cut = out.size() < want;
  out.resize(want);  // libtiff zero-fills what is missing
  return out;
}

// libtiff's PackBitsDecode: runs past the buffer are cut short
std::vector<uint8_t> tiff_packbits(const uint8_t* s, size_t n, size_t want,
                                   bool lenient = false,
                                   bool* cut = nullptr) {
  std::vector<uint8_t> out;
  out.reserve(want);
  size_t p = 0;
  while (p < n && out.size() < want) {
    int b = int8_t(s[p++]);
    if (b < 0) {
      if (b == -128) continue;
      if (p >= n) break;
      size_t k = std::min(size_t(1 - b), want - out.size());
      out.insert(out.end(), k, s[p++]);
    } else {
      size_t k = size_t(b) + 1;
      if (n - p < k) {
        if (!lenient) invalid("not enough PackBits data");
        break;
      }
      k = std::min(k, want - out.size());
      out.insert(out.end(), s + p, s + p + k);
      p += size_t(b) + 1;
    }
  }
  if (out.size() < want && !lenient) invalid("not enough PackBits data");
  if (cut) *cut = out.size() < want;
  out.resize(want);
  return out;
}

// libtiff's TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB
struct YccTiff {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y_t[256];
  YccTiff(const float* luma, const float* ref) {
    const int SHIFT = 16;
    auto fix = [](float x) { return int32_t(x * float(1L << SHIFT) + 0.5f); };
    auto clampf = [](float f, float lo, float hi) {
      return f < lo ? lo : f > hi ? hi : f;
    };
    auto code2v = [](int c, float rb, float rw, float cr) {
      return (float(c - int32_t(rb)) * cr) / (rw - rb != 0 ? rw - rb : 1.0f);
    };
    const int32_t ONE_HALF = 1 << (SHIFT - 1);
    float f1 = 2 - 2 * luma[0];
    int32_t D1 = fix(clampf(f1, 0.0f, 2.0f));
    float f2 = luma[0] * f1 / luma[1];
    int32_t D2 = -fix(clampf(f2, 0.0f, 2.0f));
    float f3 = 2 - 2 * luma[2];
    int32_t D3 = fix(clampf(f3, 0.0f, 2.0f));
    float f4 = luma[2] * f3 / luma[1];
    int32_t D4 = -fix(clampf(f4, 0.0f, 2.0f));
    for (int i = 0, x = -128; i < 256; i++, x++) {
      int32_t Cr = int32_t(clampf(code2v(x, ref[4] - 128.0f, ref[5] - 128.0f,
                                         127), -128.0f * 32, 128.0f * 32));
      int32_t Cb = int32_t(clampf(code2v(x, ref[2] - 128.0f, ref[3] - 128.0f,
                                         127), -128.0f * 32, 128.0f * 32));
      cr_r[i] = (D1 * Cr + ONE_HALF) >> SHIFT;
      cb_b[i] = (D3 * Cb + ONE_HALF) >> SHIFT;
      cr_g[i] = D2 * Cr;
      cb_g[i] = D4 * Cb + ONE_HALF;
      y_t[i] = int32_t(clampf(code2v(x + 128, ref[0], ref[1], 255),
                              -128.0f * 32, 128.0f * 32));
    }
  }
  void rgb(int Y, int Cb, int Cr, uint8_t* o) const {
    auto c = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    o[0] = c(y_t[Y] + cr_r[Cr]);
    o[1] = c(y_t[Y] + int((cb_g[Cb] + cr_g[Cr]) >> 16));
    o[2] = c(y_t[Y] + cb_b[Cb]);
  }
};

void tiff_orient(Image& img, int64_t orientation) {
  if (orientation < 2 || orientation > 8) return;
  const int64_t w = img.w, h = img.h;
  const bool swap = orientation >= 5;
  Image out;
  out.alloc(swap ? h : w, swap ? w : h);
  for (int64_t y = 0; y < out.h; y++)
    for (int64_t x = 0; x < out.w; x++) {
      int64_t sx = x, sy = y;
      switch (orientation) {
        case 2: sx = w - 1 - x; break;                      // mirror
        case 3: sx = w - 1 - x, sy = h - 1 - y; break;      // 180
        case 4: sy = h - 1 - y; break;                      // flip
        case 5: sx = y, sy = x; break;                      // transpose
        case 6: sx = y, sy = h - 1 - x; break;              // rotate 270
        case 7: sx = w - 1 - y, sy = h - 1 - x; break;      // transverse
        case 8: sx = w - 1 - y, sy = x; break;              // rotate 90
      }
      std::memcpy(out.px(x, y), img.px(sx, sy), 3);
    }
  img = std::move(out);
}

void decode_tiff(const uint8_t* d, size_t n, Image& img) {
  if (n < 8) invalid("not a TIFF file");
  Tiff t;
  t.d = d;
  t.n = n;
  t.mm = d[0] == 'M';
  t.big = d[2] == 43;  // PIL's test: a big-endian BigTIFF fails it
  if (t.big && n < 16) invalid("truncated BigTIFF header");
  const uint64_t first = t.big ? t.u(d + 8, 8) : t.u(d + 4, 4);
  if (!first) invalid("no image in TIFF file");
  t.load_ifd(first, true);
  Tiff lt = t;  // libtiff's view, for the segments it reads
  lt.tags.clear();
  lt.load_ifd(first, false);
  if (t.tags.count(0xBC01)) invalid("Windows Media Photo in TIFF");
  const int64_t compression = t.get(259, 1);
  static const int64_t KNOWN[] = {1,     2,     3,     4,     5,     6,
                                  7,     8,     32771, 32773, 32809, 32946,
                                  34676, 34677, 34925, 50000, 50001};
  if (std::find(std::begin(KNOWN), std::end(KNOWN), compression) ==
      std::end(KNOWN))
    invalid("TIFF compression PIL does not name");
  const int64_t planar = t.get(284, 1);
  int64_t photo = t.get(262, 0);
  if (compression == 6) photo = 6;
  const int64_t fill = t.get(266, 1);
  if (!t.has(256) || !t.has(257)) invalid("TIFF without dimensions");
  const int64_t xsize = t.get(256, 0), ysize = t.get(257, 0);
  const int64_t orientation = t.get(274, 1);
  std::vector<int64_t> sf = t.tuple(339, {1});
  if (sf.size() > 1 && std::all_of(sf.begin(), sf.end(),
                                   [](int64_t v) { return v == 1; }))
    sf = {1};
  std::vector<int64_t> bps = t.tuple(258, {1});
  std::vector<int64_t> extra = t.has(338) ? t.tags.at(338).v
                                          : std::vector<int64_t>{};
  int bps_count = (photo == 2 || photo == 6 || photo == 8) ? 3
                  : photo == 5                            ? 4
                                                          : 1;
  bps_count += int(extra.size());
  const int64_t spp = t.get(
      277, compression == 6 && (photo == 2 || photo == 6) ? 3 : 1);
  if (spp > 6) invalid("too many TIFF samples per pixel");
  if (spp < int64_t(bps.size()))
    bps.resize(size_t(std::max<int64_t>(spp, 0)));
  else if (spp > int64_t(bps.size()) && bps.size() == 1)
    bps.assign(size_t(spp), bps[0]);
  if (int64_t(bps.size()) != spp) invalid("unknown TIFF data organization");
  std::string ex;
  for (size_t i = 0; i < extra.size(); i++)
    ex += (i ? "," : "") + std::to_string(extra[i]);
  auto lookup = [&](int64_t fo) -> const TiffOpen* {
    if (sf.size() != 1 || bps.empty()) return nullptr;
    for (const TiffOpen& o : TIFF_OPEN)
      if ((o.order == 2 || o.order == (t.mm ? 1 : 0)) && o.photo == photo &&
          o.sf == sf[0] && o.fill == fo && o.spp == int64_t(bps.size()) &&
          std::all_of(bps.begin(), bps.end(),
                      [&](int64_t b) { return b == o.bps; }) &&
          ex == o.extra)
        return &o;
    return nullptr;
  };
  const TiffOpen* info = lookup(fill);
  if (!info) invalid("TIFF pixel layout PIL does not open");
  ModeImage im;
  im.mode = tiff_mode(info->mode);
  std::string rawmode = info->rawmode;
  const bool raw_path = compression == 1;
  if (!raw_path) {
    const char* name = tiff_compression_name(compression);
    if (name)
      throw Unsupported(std::string("TIFF compression ") + name +
                        " is not decoded by craytracer_tpu_torch (none, "
                        "PackBits, LZW, Deflate and JPEG are)");
    if (fill == 2) {  // libtiff undoes the fill order itself
      info = lookup(1);
      if (!info) invalid("TIFF pixel layout PIL does not open");
      rawmode = info->rawmode;
    }
    if (photo == 6 && compression == 7 && planar == 1)
      rawmode = "RGB";
    else if (rawmode == "I;16")
      rawmode = "I;16N";
    else if (rawmode.size() > 4 &&
             (rawmode.compare(rawmode.size() - 4, 4, ";16B") == 0 ||
              rawmode.compare(rawmode.size() - 4, 4, ";16L") == 0))
      rawmode = rawmode.substr(0, rawmode.size() - 1) + "N";
  }
  if (xsize <= 0 || ysize <= 0) invalid("TIFF of size 0");
  if (xsize > MAX_PIXELS || ysize > MAX_PIXELS || xsize * ysize > MAX_PIXELS)
    invalid("image larger than PIL opens");
  uint8_t pal[256][3] = {};
  if (im.mode == ModeImage::MP || im.mode == ModeImage::MPA) {
    if (!t.has(320)) invalid("palette TIFF without a ColorMap");
    const std::vector<int64_t>& cm = t.tags.at(320).v;
    const size_t k = cm.size() / 3;
    for (size_t i = 0; i < k && i < 256; i++)
      for (int c = 0; c < 3; c++)
        pal[i][c] = uint8_t((cm[c * k + i] / 256) & 255);
  }
  im.alloc(xsize, ysize);
  const uint8_t* rev = bit_reverse_table();

  if (raw_path) {
    // PIL's raw decoder, one tile per offset
    std::vector<int64_t> offsets;
    int64_t w, h;
    if (t.tags.count(273)) {
      offsets = t.tags.at(273).v;
      h = t.get(278, ysize);
      w = xsize;
    } else if (t.tags.count(324)) {
      offsets = t.tags.at(324).v;
      if (!t.has(322) || !t.has(323)) invalid("bad TIFF tile dimensions");
      w = t.get(322, 0);
      h = t.get(323, 0);
    } else {
      invalid("unknown TIFF data organization");
    }
    if (w <= 0 || h <= 0) invalid("bad TIFF strip or tile size");
    if (w == xsize && h == ysize && planar != 2 && !offsets.empty())
      offsets = {offsets.back()};
    int bsum = 0;
    for (int64_t b : bps) bsum += int(b);
    struct RawTile {
      int64_t off, x0, y0, x1, y1;
      int layer;
      double stride;
    };
    std::vector<RawTile> tiles;
    int64_t x = 0, y = 0;
    int layer = 0;
    for (int64_t off : offsets) {
      double stride = x + w > xsize ? double(w) * bsum / 8.0 : 0.0;
      if (planar == 2) {
        if (size_t(layer) >= rawmode.size()) invalid("TIFF plane past its mode");
        stride /= bps_count;
      }
      tiles.push_back({off, x, y, std::min(x + w, xsize),
                       std::min(y + h, ysize), layer, stride});
      x += w;
      if (x >= xsize) {
        x = 0;
        y += h;
        if (y >= ysize) {
          y = 0;
          layer++;
        }
      }
    }
    std::stable_sort(tiles.begin(), tiles.end(),
                     [](const RawTile& a, const RawTile& b) {
                       return a.off < b.off;
                     });
    std::vector<uint8_t> line;
    for (const RawTile& tl : tiles) {
      const std::string rm =
          planar == 2 ? std::string(1, rawmode[size_t(tl.layer)]) : rawmode;
      const Unpacker up = Unpacker::parse(rm, im.mode);
      const int64_t tw = tl.x1 - tl.x0;
      const size_t bytes = size_t((tw * up.bits + 7) / 8);
      const int64_t stride = int64_t(tl.stride);
      if (stride && stride < int64_t(bytes)) invalid("bad TIFF stride");
      const size_t skip = stride ? size_t(stride) - bytes : 0;
      if (tl.off < 0) invalid("bad TIFF offset");
      size_t p = size_t(tl.off);
      line.resize(bytes);
      for (int64_t yy = tl.y0; yy < tl.y1; yy++) {
        if (p > n || n - p < bytes) invalid("truncated TIFF image data");
        std::memcpy(line.data(), d + p, bytes);
        up.run(line.data(), tw, im, tl.x0, yy);
        p += bytes;
        if (yy + 1 < tl.y1) p += skip;
      }
    }
  } else {
    // libtiff
    const bool tiled = lt.tags.count(324) && !lt.tags.count(273);
    const int64_t sw = tiled ? lt.get(322, 0) : xsize;
    const int64_t sh = tiled ? lt.get(323, 0) : std::min(lt.get(278, ysize),
                                                         ysize);
    if (sw <= 0 || sh <= 0) invalid("bad TIFF strip or tile size");
    // what makes libtiff's TIFFReadDirectory fail: a directory it cannot
    // read whole, offsets or byte counts it cannot read, a size, layout or
    // compression field that is not one integer
    if (!lt.whole) invalid("TIFF directory libtiff cannot read");
    for (int tag : lt.unread)
      if (tag == 273 || tag == 279 || tag == 324 || tag == 325)
        invalid("TIFF offsets or byte counts libtiff cannot read");
    for (int tag : {256, 257, 259, 277, 278, 284, 322, 323}) {
      auto it = lt.entry_of.find(tag);  // fields libtiff cannot go without
      if (it == lt.entry_of.end()) continue;
      const int ty = it->second.first;
      const bool integer = ty == 1 || ty == 3 || ty == 4 || ty == 6 ||
                           ty == 8 || ty == 9 || ty == 13 || ty == 16 ||
                           ty == 17 || ty == 18;
      if (!integer || it->second.second != 1)
        invalid("TIFF field of a type or count libtiff refuses");
    }
    if (!lt.has(tiled ? 324 : 273)) invalid("TIFF without offsets");
    const std::vector<int64_t>& offs = lt.tags.at(tiled ? 324 : 273).v;
    // without byte counts libtiff estimates them; a segment's decoder
    // stops at its size, so up to the end of the file reads the same
    std::vector<int64_t> cnts;
    if (lt.has(tiled ? 325 : 279)) {
      cnts = lt.tags.at(tiled ? 325 : 279).v;
    } else {
      for (int64_t o : offs)
        cnts.push_back(o >= 0 && size_t(o) <= n ? int64_t(n) - o : 0);
    }
    const int64_t across = (xsize + sw - 1) / sw;
    const int64_t down = (ysize + sh - 1) / sh;
    const int nplanes = planar == 2 ? int(spp) : 1;
    const int64_t per_plane = across * down;
    if (int64_t(offs.size()) < per_plane * nplanes ||
        int64_t(cnts.size()) < per_plane * nplanes)
      invalid("too few TIFF strips or tiles");
    const int64_t predictor = lt.get(317, 1);
    const int bits = int(bps[0]);
    if ((compression == 5 || compression == 8 || compression == 32946) &&
        predictor != 1) {
      if (predictor == 2 && bits != 8 && bits != 16 && bits != 32)
        invalid("horizontal predictor with that sample size");
      if (predictor == 3 && sf[0] != 3)
        invalid("floating-point predictor without float samples");
      if (predictor != 2 && predictor != 3) invalid("bad TIFF predictor");
    }
    const bool ycc_rgba = photo == 6 && !(compression == 7 && planar == 1);
    std::vector<int64_t> sub = lt.tuple(530, {2, 2});
    if (sub.size() < 2) sub = {2, 2};
    const int ssh = ycc_rgba ? int(sub[0]) : 1, ssv = ycc_rgba ? int(sub[1]) : 1;
    if (ycc_rgba) {
      if (spp != 3 || planar != 1) invalid("YCbCr TIFF libtiff cannot size");
      if (bits != 8)
        throw Unsupported("YCbCr TIFF of this layout is not decoded by "
                          "craytracer_tpu_torch");
      // the layouts tif_getimage.c has a routine for: 44 42 41 22 21 12 11
      if (!((ssh == 1 || ssh == 2 || ssh == 4) &&
            (ssv == 1 || ssv == 2 || ssv == 4)) ||
          (ssv == 4 && ssh != 4))
        invalid("YCbCr subsampling libtiff cannot read");
      if (orientation != 1)
        throw Unsupported("YCbCr TIFF with an Orientation tag is not "
                          "decoded by craytracer_tpu_torch");
    }
    // bytes of one decoded row of a segment, and rows per segment
    const int spl = nplanes == 1 ? int(spp) : 1;  // samples per location
    int64_t row_bytes = (sw * spl * bits + 7) / 8;
    if (ycc_rgba)  // rows of subsampling blocks
      row_bytes = (sw + ssh - 1) / ssh * (ssh * ssv + 2);
    const Unpacker up = ycc_rgba ? Unpacker{} : Unpacker::parse(rawmode,
                                                                im.mode);
    if (!ycc_rgba && nplanes == 1 &&
        (std::min(sw, xsize) * up.bits + 7) / 8 > row_bytes)
      invalid("TIFF rows shorter than their raw mode");
    std::vector<Unpacker> plane_up;  // plane k into band k
    if (nplanes > 1 && spp != im.bands())
      invalid("planar TIFF with extra planes");
    if (nplanes > 1 && im.bands() > 1) {
      for (int k = 0; k < 4; k++) {
        Unpacker pu;
        pu.kind = Unpacker::BAND;
        pu.band = k;
        pu.sb = bits / 8;
        pu.bits = bits;
        plane_up.push_back(pu);
      }
    }
    static const float LUMA[3] = {0.299f, 0.587f, 0.114f};
    static const float REF[6] = {0, 255, 128, 255, 128, 255};
    float luma[3], ref[6];
    std::memcpy(luma, LUMA, sizeof luma);
    std::memcpy(ref, REF, sizeof ref);
    auto rationals = [&](int tag, float* outv, int k) {
      if (!lt.tags.count(tag)) return;
      const TiffTag& tg = lt.tags.at(tag);
      if (tg.type != 5 || tg.data.size() < size_t(8 * k)) return;
      for (int i = 0; i < k; i++) {
        double num = double(t.u(tg.data.data() + 8 * i, 4));
        double den = double(t.u(tg.data.data() + 8 * i + 4, 4));
        outv[i] = float(den ? num / den : 0.0);
      }
    };
    if (ycc_rgba) {
      rationals(529, luma, 3);
      rationals(532, ref, 6);
    }
    const YccTiff ycc(luma, ref);
    std::vector<uint8_t> tables;
    if (compression == 7 && lt.tags.count(347))
      tables = lt.tags.at(347).data;
    const bool swab = t.mm && (bits == 16 || bits == 32 || bits == 64);
    Image rgba;  // the RGBA reader's output (RGB kept)
    if (ycc_rgba) rgba.alloc(xsize, ysize);

    for (int plane = 0; plane < nplanes; plane++)
      for (int64_t sy = 0; sy < down; sy++)
        for (int64_t sx = 0; sx < across; sx++) {
          const int64_t idx = plane * per_plane + sy * across + sx;
          const int64_t off = offs[size_t(idx)], cnt = cnts[size_t(idx)];
          const int64_t x0 = sx * sw, y0 = sy * sh;
          const int64_t rows = tiled ? sh : std::min(sh, ysize - y0);
          const int64_t nrow = ycc_rgba ? (rows + ssv - 1) / ssv : rows;
          if (off < 0 || cnt < 0 || size_t(off) > n ||
              n - size_t(off) < size_t(cnt))
            invalid("TIFF strip or tile past the end of the file");
          std::vector<uint8_t> raw(d + off, d + off + cnt);
          if (lt.get(266, 1) == 2)  // libtiff's own reading of FillOrder
            for (uint8_t& b : raw) b = rev[b];
          // libtiff's RGBA reader asks a strip for its block rows at
          // TIFFScanlineSize a row, the block row's size over the vertical
          // subsampling, rounded down: what that cuts off reads as zeros
          const size_t full = size_t(row_bytes * nrow);
          const size_t want =
              ycc_rgba && !tiled ? size_t(nrow * ssv * (row_bytes / ssv))
                                 : full;
          std::vector<uint8_t> buf;
          bool short_seg = false;  // a short segment skips the predictor
          // libtiff's RGBA reader (YCbCr) goes on past a short segment,
          // zero-filled; TIFFReadEncodedStrip fails on it
          if (compression == 5) {
            buf = tiff_lzw(raw.data(), raw.size(), want, ycc_rgba,
                           &short_seg);
          } else if (compression == 8 || compression == 32946) {
            try {
              buf = zlib_inflate(raw.data(), raw.size(), want, ycc_rgba,
                                 true);
            } catch (const Invalid&) {
              if (!ycc_rgba) throw;
              buf.clear();
            }
            short_seg = buf.size() < want;
            buf.resize(want);
          } else if (compression == 32773) {
            buf = tiff_packbits(raw.data(), raw.size(), want, ycc_rgba,
                                &short_seg);
          } else {  // 7: JPEG
            if (bits != 8 || (photo == 6 && spl != 3))
              invalid("improper JPEG data precision or component count");
            std::vector<uint8_t> js;
            if (tables.size() >= 4) {
              js.assign(tables.begin(), tables.end() - 2);  // drop EOI
              if (raw.size() < 2) invalid("short JPEG segment");
              js.insert(js.end(), raw.begin() + 2, raw.end());
            } else {
              js = raw;
            }
            Jpeg j;
            j.d = js.data();
            j.n = js.size();
            j.keep_planes = photo != 6;
            j.force_ycc = photo == 6;
            j.short_ok = true;  // libjpeg only warns, and libtiff goes on
            Image ji;
            j.decode(ji);
            const int nc = int(j.comps.size());
            if (j.keep_planes ? nc != spl : nc != 3)
              invalid("improper JPEG component count");
            for (size_t k = 0; k < j.comps.size(); k++) {
              // YCbCr's luma carries YCbCrSubSampling; all else is 1x1
              const bool luma = photo == 6 && k == 0;
              if (j.comps[k].h != (luma ? int(sub[0]) : 1) ||
                  j.comps[k].v != (luma ? int(sub[1]) : 1))
                invalid("improper JPEG sampling factors");
            }
            const int64_t segw = tiled ? sw : xsize;
            if (j.W > segw || j.H > rows)
              invalid("JPEG strip or tile larger than expected");
            if (j.W < segw || j.H < rows) invalid("JPEG strip or tile short");
            buf.assign(want, 0);
            for (int64_t r = 0; r < rows; r++)
              for (int64_t c = 0; c < sw && c < j.W; c++)
                for (int k = 0; k < (j.keep_planes ? nc : 3); k++)
                  buf[size_t(r * row_bytes + c * (j.keep_planes ? nc : 3) +
                             k)] =
                      j.keep_planes ? j.planes[size_t(k)][size_t(r * j.W + c)]
                                    : ji.rgb[size_t((r * j.W + c) * 3 + k)];
          }
          // libtiff runs the predictor over rows of TIFFScanlineSize: for
          // subsampled YCbCr a block row over its vertical subsampling
          const int64_t prow = ycc_rgba ? row_bytes / ssv : row_bytes;
          const bool pred_ok =
              prow > 0 && int64_t(want) % prow == 0 && !short_seg;
          if (!pred_ok && !ycc_rgba && predictor != 1) invalid("bad rows");
          if (predictor == 2 && compression != 32773 && compression != 7 &&
              pred_ok) {
            const int st = spl;
            const int64_t nsamp = ycc_rgba ? prow : sw * spl;
            for (int64_t r = 0; r < int64_t(want) / prow; r++) {
              uint8_t* rp = buf.data() + r * prow;
              if (bits == 8) {
                for (int64_t i = st; i < nsamp; i++)
                  rp[i] = uint8_t(rp[i] + rp[i - st]);
              } else {
                const int bb = bits / 8;
                auto get = [&](int64_t i) { return t.u(rp + i * bb, bb); };
                auto put = [&](int64_t i, uint64_t v) {
                  for (int k = 0; k < bb; k++)
                    rp[i * bb + (t.mm ? bb - 1 - k : k)] = uint8_t(v >> (8 * k));
                };
                for (int64_t i = st; i < nsamp; i++) put(i, get(i) + get(i - st));
              }
            }
          } else if (predictor == 3 && compression != 32773 &&
                     compression != 7) {
            const int bb = bits / 8;
            const int64_t wc = sw * spl;
            std::vector<uint8_t> tmp(size_t(wc * bb));
            for (int64_t r = 0; r < nrow; r++) {
              uint8_t* rp = buf.data() + r * row_bytes;
              for (int64_t i = spl; i < wc * bb; i++)
                rp[i] = uint8_t(rp[i] + rp[i - spl]);
              std::memcpy(tmp.data(), rp, tmp.size());
              for (int64_t c = 0; c < wc; c++)
                for (int b = 0; b < bb; b++)  // to little-endian
                  rp[c * bb + b] = tmp[size_t((bb - b - 1) * wc + c)];
            }
          }
          if (swab && !(predictor == 3 && compression != 32773 &&
                        compression != 7)) {
            const int bb = bits / 8;
            for (size_t i = 0; i + size_t(bb) <= buf.size(); i += size_t(bb))
              std::reverse(buf.begin() + i, buf.begin() + i + bb);
          }
          if (ycc_rgba) {
            buf.resize(full, 0);
            const int64_t bw = (sw + ssh - 1) / ssh;
            for (int64_t br = 0; br < nrow; br++)
              for (int64_t bc = 0; bc < bw; bc++) {
                const uint8_t* blk =
                    buf.data() + br * row_bytes + bc * (ssh * ssv + 2);
                int cb = blk[ssh * ssv], cr = blk[ssh * ssv + 1];
                for (int yy = 0; yy < ssv; yy++)
                  for (int xx = 0; xx < ssh; xx++) {
                    int64_t px = x0 + bc * ssh + xx, py = y0 + br * ssv + yy;
                    if (px >= xsize || py >= ysize || bc * ssh + xx >= sw ||
                        br * ssv + yy >= rows)
                      continue;
                    ycc.rgb(blk[yy * ssh + xx], cb, cr, rgba.px(px, py));
                  }
              }
            continue;
          }
          const int64_t cw = std::min(sw, xsize - x0);
          for (int64_t r = 0; r < rows && y0 + r < ysize; r++) {
            const uint8_t* rp = buf.data() + r * row_bytes;
            if (nplanes > 1 && im.bands() > 1) {
              if (plane < im.bands()) plane_up[size_t(plane)].run(
                  rp, cw, im, x0, y0 + r);
            } else {
              up.run(rp, cw, im, x0, y0 + r);
            }
          }
        }
    if (ycc_rgba) {
      img = std::move(rgba);
      tiff_orient(img, orientation);
      return;
    }
    // PIL reads a planar RGBA file as associated alpha unless its
    // ExtraSamples says unassociated
    if (nplanes > 1 && im.mode == ModeImage::MRGBA &&
        (extra.empty() || (extra.size() == 1 && extra[0] == 1)))
      for (size_t i = 0; i < im.b.size(); i += 4) {
        const int a = im.b[i + 3];
        for (int c = 0; c < 3; c++)
          im.b[i + c] = a == 0 ? 0 : a == 255 ? im.b[i + c]
                                : uint8_t(std::min(255, im.b[i + c] * 255 / a));
      }
  }

  // convert("RGB")
  img.alloc(xsize, ysize);
  for (int64_t i = 0; i < xsize * ysize; i++) {
    uint8_t* o = &img.rgb[size_t(i) * 3];
    const uint8_t* s = im.b.empty() ? nullptr : &im.b[size_t(i) * 4];
    switch (im.mode) {
      case ModeImage::MI16: {
        int v = im.iv[size_t(i)];
        o[0] = o[1] = o[2] = uint8_t(std::min(v, 255));
        break;
      }
      case ModeImage::MI: {
        int v = im.iv[size_t(i)];
        o[0] = o[1] = o[2] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
        break;
      }
      case ModeImage::MF:
        o[0] = o[1] = o[2] = float_to_l(im.fv[size_t(i)]);
        break;
      case ModeImage::MP:
      case ModeImage::MPA:
        std::memcpy(o, pal[s[0]], 3);
        break;
      case ModeImage::MCMYK:
        cmyk_to_rgb(o, s[0], s[1], s[2], s[3]);
        break;
      case ModeImage::MRGB:
      case ModeImage::MRGBA:
        std::memcpy(o, s, 3);
        break;
      default:  // 1, L, LA
        o[0] = o[1] = o[2] = s[0];
    }
  }
  tiff_orient(img, orientation);
}

}  // namespace
