// DDS (DirectDraw Surface) for csrc/imgdecode.cpp, which includes this
// file after its shared helpers: the top mip as PIL's DdsImagePlugin opens
// it and BcnDecode.c decodes it, then convert("RGB").
//
// - Legacy header by pixel-format flags: DDPF_RGB through PIL's
//   DdsRgbDecoder (each channel mask shifted down and scaled as
//   int(v / max * 255), short reads giving 0), 8-bit luminance, 16-bit
//   luminance-alpha, 8-bit palette (an RGBA table), and the FourCCs DXT1,
//   DXT3, DXT5, ATI1/BC4U, ATI2/BC5U and BC5S.
// - DX10 header: BC1-BC5 (BC5 signed too), BC6H UF16/SF16, BC7 and the
//   R8G8B8A8 formats. Any other DXGI format or FourCC PIL refuses (status
//   2: the JAX loader gives None), BC4 SNORM among them.
// - Blocks decode as BcnDecode.c does: BC1's 565 endpoints widened by bit
//   replication, thirds and halves in integer division; BC3/4/5 alpha
//   ramps of 7 or 5 steps; BC7's 8 modes with its partition and anchor
//   tables and 6-bit weights; BC6H's 14 modes through the half-float
//   mapping (value * 31 / 64, or / 32 signed) and PIL's clamp to [0, 1]
//   truncated to 8 bits.

namespace {

inline uint32_t dds_bit(const uint8_t* s, int bit) {
  return (s[bit >> 3] >> (bit & 7)) & 1;
}

// BcnDecode.c get_bits: at most 8 bits, over at most two bytes
inline uint32_t dds_bits(const uint8_t* s, int bit, int count) {
  if (!count) return 0;
  int by = bit >> 3;
  bit &= 7;
  uint32_t x = s[by];
  if (bit + count > 8) x |= uint32_t(s[by + 1]) << 8;
  return (x >> bit) & ((1u << count) - 1);
}

struct Rgba {
  uint8_t r, g, b, a;
};

inline Rgba dds_565(uint32_t x) {
  int r = (x & 0xf800) >> 8, g = (x & 0x7e0) >> 3, b = (x & 0x1f) << 3;
  return Rgba{uint8_t(r | r >> 5), uint8_t(g | g >> 6), uint8_t(b | b >> 5),
              255};
}

void bc1_color(Rgba* dst, const uint8_t* s, bool separate_alpha) {
  uint32_t c0 = le16(s), c1 = le16(s + 2), lut = le32(s + 4);
  Rgba p[4];
  p[0] = dds_565(c0);
  p[1] = dds_565(c1);
  int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = Rgba{uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3),
                uint8_t((2 * b0 + b1) / 3), 255};
    p[3] = Rgba{uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3),
                uint8_t((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = Rgba{uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2),
                uint8_t((b0 + b1) / 2), 255};
    p[3] = Rgba{0, 0, 0, 0};
  }
  for (int i = 0; i < 16; i++) dst[i] = p[3 & (lut >> (2 * i))];
}

// decode_bc3_alpha: an 8-byte ramp block into byte `o` of each texel
void bc3_alpha(Rgba* dst, const uint8_t* s, int o, bool sign) {
  int a0 = sign ? int(int8_t(s[0])) + 128 : s[0];
  int a1 = sign ? int(int8_t(s[1])) + 128 : s[1];
  int a[8];
  a[0] = a0 & 255;
  a[1] = a1 & 255;
  if (a0 > a1) {
    for (int k = 1; k <= 6; k++) a[k + 1] = ((7 - k) * a0 + k * a1) / 7;
  } else {
    for (int k = 1; k <= 4; k++) a[k + 1] = ((5 - k) * a0 + k * a1) / 5;
    a[6] = 0;
    a[7] = 255;
  }
  uint32_t lut1 = s[2] | s[3] << 8 | s[4] << 16;
  uint32_t lut2 = s[5] | s[6] << 8 | s[7] << 16;
  for (int i = 0; i < 16; i++) {
    uint32_t lut = i < 8 ? lut1 : lut2;
    uint8_t v = uint8_t(a[7 & (lut >> (3 * (i & 7)))]);
    uint8_t* t = &dst[i].r;
    t[o] = v;
  }
}

// ------------------------------------------------------------- BC7 / BC6H

const uint16_t BC7_SI2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800,
    0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e,
    0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce, 0x088c, 0x3110, 0x6666,
    0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa, 0xf0f0, 0x5a5a, 0x33cc,
    0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996,
    0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c,
    0x39c6, 0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744,
    0xee22};
const uint32_t BC7_SI3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};
// anchor texels: the second subset of two, the second and third of three
const uint8_t BC7_AI0[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t BC7_AI1[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t BC7_AI2[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const uint8_t BC7_W2[4] = {0, 21, 43, 64};
const uint8_t BC7_W3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t BC7_W4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                            34, 38, 43, 47, 51, 55, 60, 64};

inline const uint8_t* bc7_weights(int n) {
  return n == 2 ? BC7_W2 : n == 3 ? BC7_W3 : BC7_W4;
}

inline int bc7_subset(int ns, int partition, int i) {
  if (ns == 2) return 1 & (BC7_SI2[partition] >> i);
  if (ns == 3) return 3 & (BC7_SI3[partition] >> (2 * i));
  return 0;
}

struct Bc7Mode {
  uint8_t ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode BC7_MODES[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

inline uint8_t bc7_expand(uint8_t v, int bits) {
  v = uint8_t(v << (8 - bits));
  return uint8_t(v | (v >> bits));
}

void bc7_block(Rgba* col, const uint8_t* s) {
  if (s[0] == 0) {  // no mode bit in the first byte: an invalid block
    for (int i = 0; i < 16; i++) col[i] = Rgba{0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(s[0] & (1 << mode))) mode++;
  int bit = mode + 1;
  const Bc7Mode& m = BC7_MODES[mode];
  int cb = m.cb, ab = m.ab;
  const uint8_t* cw = bc7_weights(m.ib);
  const uint8_t* aw = bc7_weights((ab && m.ib2) ? m.ib2 : m.ib);
  auto load = [&](int n) {
    uint32_t v = dds_bits(s, bit, n);
    bit += n;
    return v;
  };
  int partition = int(load(m.pb)), rotation = int(load(m.rb));
  int index_sel = int(load(m.isb));
  const int numep = m.ns * 2;
  uint8_t ep[6][4];
  for (int c = 0; c < 3; c++)
    for (int i = 0; i < numep; i++) ep[i][c] = uint8_t(load(cb));
  for (int i = 0; i < numep; i++) ep[i][3] = ab ? uint8_t(load(ab)) : 255;
  if (m.epb) {
    for (int i = 0; i < numep; i++) {
      uint32_t v = load(1);
      for (int c = 0; c < 4; c++) ep[i][c] = uint8_t(ep[i][c] << 1 | v);
    }
    cb++;
    if (ab) ab++;
  }
  if (m.spb) {
    for (int i = 0; i < numep; i += 2) {
      uint32_t v = load(1);
      for (int j = 0; j < 2; j++)
        for (int c = 0; c < 4; c++)
          ep[i + j][c] = uint8_t(ep[i + j][c] << 1 | v);
    }
    cb++;
    if (ab) ab++;
  }
  for (int i = 0; i < numep; i++) {
    for (int c = 0; c < 3; c++) ep[i][c] = bc7_expand(ep[i][c], cb);
    if (ab) ep[i][3] = bc7_expand(ep[i][3], ab);
  }
  int cibit = bit, aibit = cibit + 16 * m.ib - m.ns;
  for (int i = 0; i < 16; i++) {
    int sub = bc7_subset(m.ns, partition, i);
    int ib = m.ib;
    if (i == 0) {
      ib--;
    } else if (m.ns == 2) {
      if (i == BC7_AI0[partition]) ib--;
    } else if (m.ns == 3) {
      if (sub == 1 && i == BC7_AI1[partition]) ib--;
      if (sub == 2 && i == BC7_AI2[partition]) ib--;
    }
    int i0 = int(dds_bits(s, cibit, ib));
    cibit += ib;
    int sc, sa;  // colour and alpha weights
    if (ab && m.ib2) {
      int ib2 = m.ib2 - (i == 0 ? 1 : 0);
      int i1 = int(dds_bits(s, aibit, ib2));
      aibit += ib2;
      sc = index_sel ? aw[i1] : cw[i0];
      sa = index_sel ? cw[i0] : aw[i1];
    } else {
      sc = sa = cw[i0];
    }
    const uint8_t* e0 = ep[2 * sub];
    const uint8_t* e1 = ep[2 * sub + 1];
    uint8_t px[4];
    for (int c = 0; c < 4; c++) {
      int w = c < 3 ? sc : sa;
      px[c] = uint8_t(((64 - w) * e0[c] + w * e1[c] + 32) >> 6);
    }
    if (rotation) std::swap(px[rotation - 1], px[3]);
    col[i] = Rgba{px[0], px[1], px[2], px[3]};
  }
}

struct Bc6Mode {
  uint8_t ns, tr, pb, epb, rb, gb, bb;
};
const Bc6Mode BC6_MODES[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},  {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5}, {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},  {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10},
    {1, 1, 0, 11, 9, 9, 9}, {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

// The endpoint bit layouts of the BC6H modes after their mode bits, as
// fields "<channel><endpoint>[hi:lo]" stored from lo to hi; a field written
// [lo:hi] is stored in reverse, from hi down to lo.
const char* const BC6_LAYOUT[14] = {
    "g2[4] b2[4] b3[4] r0[9:0] g0[9:0] b0[9:0] r1[4:0] g3[4] g2[3:0] "
    "g1[4:0] b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] "
    "b3[3]",
    "g2[5] g3[4] g3[5] r0[6:0] b3[0] b3[1] b2[4] g0[6:0] b2[5] b3[2] g2[4] "
    "b0[6:0] b3[3] b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] "
    "b2[3:0] r2[5:0] r3[5:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[4:0] r0[10] g2[3:0] g1[3:0] g0[10] b3[0] "
    "g3[3:0] b1[3:0] b0[10] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] g3[4] g2[3:0] g1[4:0] g0[10] "
    "g3[3:0] b1[3:0] b0[10] b3[1] b2[3:0] r2[3:0] b3[0] b3[2] r3[3:0] "
    "g2[4] b3[3]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] b2[4] g2[3:0] g1[3:0] g0[10] "
    "b3[0] g3[3:0] b1[4:0] b0[10] b2[3:0] r2[3:0] b3[1] b3[2] r3[3:0] "
    "b3[4] b3[3]",
    "r0[8:0] b2[4] g0[8:0] g2[4] b0[8:0] b3[4] r1[4:0] g3[4] g2[3:0] "
    "g1[4:0] b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] "
    "b3[3]",
    "r0[7:0] g3[4] b2[4] g0[7:0] b3[2] g2[4] b0[7:0] b3[3] b3[4] r1[5:0] "
    "g2[3:0] g1[4:0] b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[5:0] r3[5:0]",
    "r0[7:0] b3[0] b2[4] g0[7:0] g2[5] g2[4] b0[7:0] g3[5] b3[4] r1[4:0] "
    "g3[4] g2[3:0] g1[5:0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] "
    "r3[4:0] b3[3]",
    "r0[7:0] b3[1] b2[4] g0[7:0] b2[5] g2[4] b0[7:0] b3[5] b3[4] r1[4:0] "
    "g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] b1[5:0] b2[3:0] r2[4:0] b3[2] "
    "r3[4:0] b3[3]",
    "r0[5:0] g3[4] b3[0] b3[1] b2[4] g0[5:0] g2[5] b2[5] b3[2] g2[4] "
    "b0[5:0] g3[5] b3[3] b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] "
    "b1[5:0] b2[3:0] r2[5:0] r3[5:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[9:0] g1[9:0] b1[9:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[8:0] r0[10] g1[8:0] g0[10] b1[8:0] b0[10]",
    "r0[9:0] g0[9:0] b0[9:0] r1[7:0] r0[10:11] g1[7:0] g0[10:11] b1[7:0] "
    "b0[10:11]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10:15] g1[3:0] g0[10:15] b1[3:0] "
    "b0[10:15]"};

// Each mode's layout as (endpoint value index << 4 | bit), the endpoint
// values ordered r0 g0 b0 r1 g1 b1 r2 g2 b2 r3 g3 b3
struct Bc6Packings {
  uint8_t bits[14][75];
  int count[14];
  Bc6Packings() {
    for (int m = 0; m < 14; m++) {
      int k = 0;
      const char* p = BC6_LAYOUT[m];
      while (*p) {
        while (*p == ' ') p++;
        if (!*p) break;
        int ch = *p == 'r' ? 0 : *p == 'g' ? 1 : 2;
        int ep = p[1] - '0';
        p += 3;  // past "[ "
        int a = int(std::strtol(p, const_cast<char**>(&p), 10)), b = a;
        if (*p == ':') b = int(std::strtol(p + 1, const_cast<char**>(&p), 10));
        p++;  // past "]"
        int step = a >= b ? 1 : -1;  // [hi:lo] stores lo first
        for (int v = b;; v += step) {
          bits[m][k++] = uint8_t((ep * 3 + ch) << 4 | v);
          if (v == a) break;
        }
      }
      count[m] = k;
    }
  }
};

inline void bc6_sign_extend(uint16_t& v, int prec) {
  int x = v;
  if (x & (1 << (prec - 1))) x |= ~((1 << prec) - 1);
  v = uint16_t(x);
}

inline int bc6_unquantize(uint16_t v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xffff;
    return ((int(v) << 16) + 0x8000) >> bits;
  }
  if (bits >= 16) return v;  // as BcnDecode.c: not sign-extended
  int x = int16_t(v);
  bool neg = x < 0;
  if (neg) x = -x;
  if (x != 0) {
    if (x >= (1 << (bits - 1)) - 1)
      x = 0x7fff;
    else
      x = ((x << 15) + 0x4000) >> (bits - 1);
  }
  return neg ? -x : x;
}

// a half float's value (rygorous's half_to_float, as BcnDecode.c)
inline float bc6_half(uint16_t h) {
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = uint32_t(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= uint32_t(h & 0x8000) << 16;
  return o.f;
}

inline uint8_t bc6_channel(int v, bool sign) {
  float f;
  if (sign) {
    if (v < 0)
      f = bc6_half(uint16_t(0x8000 | (((-v) * 31) / 32)));
    else
      f = bc6_half(uint16_t((v * 31) / 32));
  } else {
    f = bc6_half(uint16_t((v * 31) / 64));
  }
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return uint8_t(f * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* s, bool sign) {
  static const Bc6Packings pack;
  int bit = 5, epbits = 72, ib = 3;
  int mode = s[0] & 0x1f;
  if ((mode & 3) == 0 || (mode & 3) == 1) {
    mode &= 3;
    bit = 2;
    epbits = 75;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {
    for (int i = 0; i < 16; i++) col[i] = Rgba{0, 0, 0, 255};
    return;
  }
  const Bc6Mode& m = BC6_MODES[mode];
  const uint8_t* cw = bc7_weights(ib);
  const int numep = m.ns == 2 ? 12 : 6;
  uint16_t ep[12] = {};
  for (int i = 0; i < epbits; i++) {
    int di = pack.bits[mode][i];
    ep[di >> 4] = uint16_t(ep[di >> 4] | dds_bit(s, bit + i) << (di & 15));
  }
  bit += epbits;
  int partition = int(dds_bits(s, bit, m.pb));
  bit += m.pb;
  const int mask = (1 << m.epb) - 1;
  if (sign)
    for (int c = 0; c < 3; c++) bc6_sign_extend(ep[c], m.epb);
  if (sign || m.tr)
    for (int i = 3; i < numep; i += 3) {
      bc6_sign_extend(ep[i], m.rb);
      bc6_sign_extend(ep[i + 1], m.gb);
      bc6_sign_extend(ep[i + 2], m.bb);
    }
  if (m.tr)  // BcnDecode.c leaves the masked sums unextended
    for (int i = 3; i < numep; i++)
      ep[i] = uint16_t((ep[i] + ep[i % 3]) & mask);
  int ue[12];
  for (int i = 0; i < numep; i++) ue[i] = bc6_unquantize(ep[i], m.epb, sign);
  for (int i = 0; i < 16; i++) {
    int sub = bc7_subset(m.ns, partition, i) * 6;
    int ib2 = ib;
    if (i == 0 || (m.ns == 2 && i == BC7_AI0[partition])) ib2--;
    int w = cw[dds_bits(s, bit, ib2)];
    bit += ib2;
    uint8_t px[3];
    for (int c = 0; c < 3; c++)
      px[c] = bc6_channel((ue[sub + c] * (64 - w) + ue[sub + 3 + c] * w) >> 6,
                          sign);
    col[i] = Rgba{px[0], px[1], px[2], 255};
  }
}

// ------------------------------------------------------------- the file

void decode_dds(const uint8_t* d, size_t n, Image& img) {
  if (n < 8 || std::memcmp(d, "DDS ", 4) != 0) invalid("not a DDS file");
  if (le32(d + 4) != 124) invalid("unsupported DDS header size");
  if (n < 128) invalid("incomplete DDS header");
  const uint8_t* hd = d + 8;
  const int64_t h = le32(hd + 4), w = le32(hd + 8);
  const uint32_t pfflags = le32(hd + 72), fourcc = le32(hd + 76);
  const uint32_t bitcount = le32(hd + 80);
  enum { ALPHAPIXELS = 1, FOURCC = 4, PAL8 = 0x20, RGB = 0x40,
         LUMINANCE = 0x20000 };
  auto cc = [](const char* s) { return le32(reinterpret_cast<const uint8_t*>(s)); };
  img.alloc(w, h);
  size_t pos = 128;
  if (pfflags & RGB) {  // DdsRgbDecoder
    const int nm = pfflags & ALPHAPIXELS ? 4 : 3;
    uint32_t mask[4], off[4], total[4];
    for (int i = 0; i < nm; i++) {
      mask[i] = le32(hd + 84 + 4 * i);
      off[i] = 0;
      if (mask[i])  // stops at 31, as PIL's loop over Python ints does
        while (off[i] < 31 &&
               ((mask[i] >> (off[i] + 1)) << (off[i] + 1)) == mask[i])
          off[i]++;
      total[i] = mask[i] >> off[i];
    }
    const size_t bytes = bitcount / 8;
    for (int64_t p = 0; p < w * h; p++) {
      uint64_t v = 0;  // the masks see the low 32 bits only
      for (size_t k = 0; k < bytes && pos < n; k++, pos++)
        if (k < 4) v |= uint64_t(d[pos]) << (8 * k);
      uint8_t* o = &img.rgb[size_t(p) * 3];
      for (int c = 0; c < 3; c++)
        o[c] = total[c] ? uint8_t(int(double((v & mask[c]) >> off[c]) /
                                      double(total[c]) * 255.0))
                        : 0;
    }
    return;
  }
  auto raw = [&](int bpp, auto&& put) {
    if ((n - pos) / size_t(bpp) < size_t(w * h)) invalid("truncated DDS data");
    for (int64_t p = 0; p < w * h; p++) put(&img.rgb[size_t(p) * 3],
                                             d + pos + size_t(p) * bpp);
  };
  if (pfflags & LUMINANCE) {
    if (bitcount == 8) {
      raw(1, [](uint8_t* o, const uint8_t* s) { o[0] = o[1] = o[2] = s[0]; });
    } else if (bitcount == 16 && (pfflags & ALPHAPIXELS)) {
      raw(2, [](uint8_t* o, const uint8_t* s) { o[0] = o[1] = o[2] = s[0]; });
    } else {
      invalid("DDS luminance of that bit count");
    }
    return;
  }
  if (pfflags & PAL8) {
    uint8_t pal[256][4] = {};
    size_t got = std::min<size_t>(1024, n - pos);
    std::memcpy(pal, d + pos, got);
    pos += got;
    raw(1, [&](uint8_t* o, const uint8_t* s) {
      std::memcpy(o, pal[s[0]], 3);
    });
    return;
  }
  if (!(pfflags & FOURCC)) invalid("unknown DDS pixel format flags");
  int kind = 0;  // BcnDecode.c's n; 8 = R8G8B8A8
  bool sign = false;
  if (fourcc == cc("DXT1")) {
    kind = 1;
  } else if (fourcc == cc("DXT3")) {
    kind = 2;
  } else if (fourcc == cc("DXT5")) {
    kind = 3;
  } else if (fourcc == cc("BC4U") || fourcc == cc("ATI1")) {
    kind = 4;
  } else if (fourcc == cc("BC5S")) {
    kind = 5;
    sign = true;
  } else if (fourcc == cc("BC5U") || fourcc == cc("ATI2")) {
    kind = 5;
  } else if (fourcc == cc("DX10")) {
    if (n < 148) invalid("truncated DX10 header");
    const uint32_t f = le32(d + 128);
    pos = 148;
    if (f == 70 || f == 71) kind = 1;        // BC1 TYPELESS, UNORM
    else if (f == 73 || f == 74) kind = 2;   // BC2
    else if (f == 76 || f == 77) kind = 3;   // BC3
    else if (f == 79 || f == 80) kind = 4;   // BC4 (not SNORM)
    else if (f == 82 || f == 83) kind = 5;   // BC5
    else if (f == 84) kind = 5, sign = true; // BC5 SNORM
    else if (f == 95) kind = 6;              // BC6H UF16
    else if (f == 96) kind = 6, sign = true; // BC6H SF16
    else if (f >= 97 && f <= 99) kind = 7;   // BC7
    else if (f >= 27 && f <= 29) kind = 8;   // R8G8B8A8
    else invalid("DXGI format PIL does not open");
  } else {
    invalid("DDS FourCC PIL does not open");
  }
  if (kind == 8) {
    raw(4, [](uint8_t* o, const uint8_t* s) { std::memcpy(o, s, 3); });
    return;
  }
  const size_t bsize = kind == 1 || kind == 4 ? 8 : 16;
  const int64_t bw = (w + 3) / 4, bh = (h + 3) / 4;
  if ((n - pos) / bsize < size_t(bw * bh)) invalid("truncated DDS data");
  Rgba col[16];
  for (int64_t by = 0; by < bh; by++)
    for (int64_t bx = 0; bx < bw; bx++, pos += bsize) {
      const uint8_t* s = d + pos;
      std::memset(col, 0, sizeof col);
      switch (kind) {
        case 1: bc1_color(col, s, false); break;
        case 2:
          bc1_color(col, s + 8, true);
          break;
        case 3:
          bc1_color(col, s + 8, true);
          bc3_alpha(col, s, 3, false);
          break;
        case 4:
          bc3_alpha(col, s, 0, false);
          for (Rgba& c : col) c.g = c.b = c.r;
          break;
        case 5:
          bc3_alpha(col, s, 0, sign);
          bc3_alpha(col, s + 8, 1, sign);
          if (sign)  // PIL fills the signed format's blue with 128
            for (Rgba& c : col) c.b = 128;
          break;
        case 6: bc6_block(col, s, sign); break;
        default: bc7_block(col, s); break;
      }
      for (int j = 0; j < 16; j++) {
        int64_t x = bx * 4 + (j & 3), y = by * 4 + (j >> 2);
        if (x < w && y < h) img.put(x, y, col[j].r, col[j].g, col[j].b);
      }
    }
}

}  // namespace
