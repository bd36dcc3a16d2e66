// The CCITT bilevel TIFF compressions for csrc/imgdecode_tiff.h, as
// libtiff's tif_fax3.c decodes them: modified Huffman RLE (2, rows
// byte-aligned), Group 3 (3: an EOL before each row, 1D or, with
// T4Options bit 0, a tag bit choosing 1D or 2D per row), Group 4 (4:
// T.6's 2D coding against the previous row, an all-white row before the
// first) and RLEW (32771, rows aligned to 16-bit words).
//
// The code tables are T.4's: white and black terminating codes (runs
// 0-63), their make-up codes (64-1728), the shared extended make-up codes
// (1792-2560) and EOL; T.4/T.6's 2D modes (pass, horizontal, vertical
// 0 to +-3). They are laid out as libtiff's mkg3states lays them out
// (12- and 13-bit white and black lookups, a 7-bit mode lookup; eleven
// zeros read as EOL), and read through libtiff's bit accumulator (low bit
// first, bytes bit-reversed for FillOrder 1, zeros past the end), so that
// bad codes, EOLs and short data end rows where libtiff ends them. The
// decoded rows have 1 for black, as libtiff's runs fill them.

namespace {

struct FaxEnt {
  uint8_t state = 0, width = 0;
  uint32_t param = 0;
};
enum FaxState : uint8_t {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct FaxTables {
  FaxEnt white[4096], black[8192], main[128];
  // a code written first bit first, as in T.4
  static void fill(FaxEnt* t, int wbits, const char* code, uint8_t state,
                   uint32_t param) {
    const int len = int(std::strlen(code));
    uint32_t v = 0;  // the code's bits, first bit lowest
    for (int i = 0; i < len; i++)
      if (code[i] == '1') v |= uint32_t(1) << i;
    for (uint32_t hi = 0; hi < (uint32_t(1) << (wbits - len)); hi++) {
      FaxEnt& e = t[(hi << len) | v];
      e.state = state;
      e.width = uint8_t(len);
      e.param = param;
    }
  }
  FaxTables() {
    static const char* const TERM_W[64] = {
        "00110101", "000111",   "0111",     "1000",     "1011",
        "1100",     "1110",     "1111",     "10011",    "10100",
        "00111",    "01000",    "001000",   "000011",   "110100",
        "110101",   "101010",   "101011",   "0100111",  "0001100",
        "0001000",  "0010111",  "0000011",  "0000100",  "0101000",
        "0101011",  "0010011",  "0100100",  "0011000",  "00000010",
        "00000011", "00011010", "00011011", "00010010", "00010011",
        "00010100", "00010101", "00010110", "00010111", "00101000",
        "00101001", "00101010", "00101011", "00101100", "00101101",
        "00000100", "00000101", "00001010", "00001011", "01010010",
        "01010011", "01010100", "01010101", "00100100", "00100101",
        "01011000", "01011001", "01011010", "01011011", "01001010",
        "01001011", "00110010", "00110011", "00110100"};
    static const char* const MAKEUP_W[27] = {
        "11011",     "10010",     "010111",    "0110111",   "00110110",
        "00110111",  "01100100",  "01100101",  "01101000",  "01100111",
        "011001100", "011001101", "011010010", "011010011", "011010100",
        "011010101", "011010110", "011010111", "011011000", "011011001",
        "011011010", "011011011", "010011000", "010011001", "010011010",
        "011000",    "010011011"};
    static const char* const TERM_B[64] = {
        "0000110111",   "010",          "11",           "10",
        "011",          "0011",         "0010",         "00011",
        "000101",       "000100",       "0000100",      "0000101",
        "0000111",      "00000100",     "00000111",     "000011000",
        "0000010111",   "0000011000",   "0000001000",   "00001100111",
        "00001101000",  "00001101100",  "00000110111",  "00000101000",
        "00000010111",  "00000011000",  "000011001010", "000011001011",
        "000011001100", "000011001101", "000001101000", "000001101001",
        "000001101010", "000001101011", "000011010010", "000011010011",
        "000011010100", "000011010101", "000011010110", "000011010111",
        "000001101100", "000001101101", "000011011010", "000011011011",
        "000001010100", "000001010101", "000001010110", "000001010111",
        "000001100100", "000001100101", "000001010010", "000001010011",
        "000000100100", "000000110111", "000000111000", "000000100111",
        "000000101000", "000001011000", "000001011001", "000000101011",
        "000000101100", "000001011010", "000001100110", "000001100111"};
    static const char* const MAKEUP_B[27] = {
        "0000001111",    "000011001000",  "000011001001",  "000001011011",
        "000000110011",  "000000110100",  "000000110101",  "0000001101100",
        "0000001101101", "0000001001010", "0000001001011", "0000001001100",
        "0000001001101", "0000001110010", "0000001110011", "0000001110100",
        "0000001110101", "0000001110110", "0000001110111", "0000001010010",
        "0000001010011", "0000001010100", "0000001010101", "0000001011010",
        "0000001011011", "0000001100100", "0000001100101"};
    static const char* const MAKEUP_X[13] = {
        "00000001000",  "00000001100",  "00000001101",  "000000010010",
        "000000010011", "000000010100", "000000010101", "000000010110",
        "000000010111", "000000011100", "000000011101", "000000011110",
        "000000011111"};
    for (int i = 0; i < 64; i++) {
      fill(white, 12, TERM_W[i], S_TermW, uint32_t(i));
      fill(black, 13, TERM_B[i], S_TermB, uint32_t(i));
    }
    for (int i = 0; i < 27; i++) {
      fill(white, 12, MAKEUP_W[i], S_MakeUpW, uint32_t(64 * (i + 1)));
      fill(black, 13, MAKEUP_B[i], S_MakeUpB, uint32_t(64 * (i + 1)));
    }
    for (int i = 0; i < 13; i++) {
      fill(white, 12, MAKEUP_X[i], S_MakeUp, uint32_t(1792 + 64 * i));
      fill(black, 13, MAKEUP_X[i], S_MakeUp, uint32_t(1792 + 64 * i));
    }
    fill(white, 12, "00000000000", S_EOL, 0);
    fill(black, 13, "00000000000", S_EOL, 0);
    fill(main, 7, "0001", S_Pass, 0);
    fill(main, 7, "001", S_Horiz, 0);
    fill(main, 7, "1", S_V0, 0);
    fill(main, 7, "011", S_VR, 1);
    fill(main, 7, "000011", S_VR, 2);
    fill(main, 7, "0000011", S_VR, 3);
    fill(main, 7, "010", S_VL, 1);
    fill(main, 7, "000010", S_VL, 2);
    fill(main, 7, "0000010", S_VL, 3);
    fill(main, 7, "0000001", S_Ext, 0);
    fill(main, 7, "0000000", S_EOL, 0);
  }
};

// One strip or tile of `rows` rows of `width` pixels, packed 1 bit a
// pixel (1 black) into `out` (rows * ((width + 7) / 8) bytes, zeroed by
// the caller). Returns libtiff's result: false where TIFFReadEncodedStrip
// fails.
bool ccitt_decode(const uint8_t* s, size_t n, int64_t compression,
                  int64_t t4options, int64_t width, int64_t rows,
                  std::vector<uint8_t>& out) {
  static const FaxTables tables;
  // libtiff's bitmap for FillOrder 1 (the caller reversed FillOrder 2)
  static const struct Rev {
    uint8_t v[256];
    Rev() {
      for (int i = 0; i < 256; i++) {
        int r = 0;
        for (int b = 0; b < 8; b++) r |= ((i >> b) & 1) << (7 - b);
        v[i] = uint8_t(r);
      }
    }
  } rev_table;
  const uint8_t* rev = rev_table.v;
  const int64_t rowbytes = (width + 7) / 8;
  const int64_t lastx = width;
  const bool g4 = compression == 4;
  const bool is2d = g4 || (compression == 3 && (t4options & 1));
  const bool rle = compression == 2 || compression == 32771;
  // Fax3SetupState's run arrays
  const int64_t nruns0 = (lastx + 1 + 31) / 32 * 32;
  const int64_t nruns = is2d ? 2 * nruns0 : nruns0;
  std::vector<uint32_t> runs(size_t(2 * nruns), 0);
  uint32_t* curruns = runs.data();
  uint32_t* refruns = is2d ? runs.data() + nruns : nullptr;
  if (refruns) {
    refruns[0] = uint32_t(lastx);
    refruns[1] = 0;
  }
  size_t cp = 0;
  uint32_t acc = 0;
  int avail = 0;
  int eolcnt = 0;
  int64_t line = 0;

  // libtiff's NeedBits8 / NeedBits16: false where no bits are left
  auto need8 = [&](int k) -> bool {
    if (avail < k) {
      if (cp >= n) {
        if (avail == 0) return false;
        avail = k;  // zeros past the end
      } else {
        acc |= uint32_t(rev[s[cp++]]) << avail;
        avail += 8;
      }
    }
    return true;
  };
  auto need16 = [&](int k) -> bool {
    if (avail < k) {
      if (cp >= n) {
        if (avail == 0) return false;
        avail = k;
      } else {
        acc |= uint32_t(rev[s[cp++]]) << avail;
        if ((avail += 8) < k) {
          if (cp >= n) {
            avail = k;
          } else {
            acc |= uint32_t(rev[s[cp++]]) << avail;
            avail += 8;
          }
        }
      }
    }
    return true;
  };
  auto get = [&](int k) { return acc & ((uint32_t(1) << k) - 1); };
  auto clr = [&](int k) {
    avail -= k;
    acc = k >= 32 ? 0 : acc >> k;
  };

  // _TIFFFax3fillruns: white runs clear, black runs set
  auto fillruns = [&](uint8_t* buf, uint32_t* r, uint32_t* erun) {
    if ((erun - r) & 1) *erun++ = 0;
    int64_t x = 0;
    for (; r < erun; r += 2) {
      for (int k = 0; k < 2; k++) {
        int64_t run = r[k];
        if (x + run > lastx || run > lastx) run = r[k] = uint32_t(lastx - x);
        if (k == 1)
          for (int64_t i = x; i < x + run; i++)
            buf[i >> 3] = uint8_t(buf[i >> 3] | (0x80 >> (i & 7)));
        else
          for (int64_t i = x; i < x + run; i++)
            buf[i >> 3] = uint8_t(buf[i >> 3] & ~(0x80 >> (i & 7)));
        x += run;
      }
    }
  };

  for (int64_t row = 0; row < rows; row++) {
    uint8_t* buf = out.data() + row * rowbytes;
    int64_t a0 = 0, run_length = 0;
    uint32_t* thisrun = curruns;
    uint32_t* pa = thisrun;
    bool overflow = false;
    auto setvalue = [&](int64_t x) {
      if (pa >= thisrun + nruns) {
        overflow = true;
        return;
      }
      *pa++ = uint32_t(run_length + x);
      a0 += x;
      run_length = 0;
    };
    auto cleanup = [&]() {  // CLEANUP_RUNS
      if (run_length) setvalue(0);
      if (overflow) return;
      if (a0 != lastx) {
        while (a0 > lastx && pa > thisrun) a0 -= *--pa;
        if (a0 < lastx) {
          if (a0 < 0) a0 = 0;
          if ((pa - thisrun) & 1) setvalue(0);
          if (!overflow) setvalue(lastx - a0);
        } else if (a0 > lastx) {
          setvalue(lastx);
          if (!overflow) setvalue(0);
        }
      }
    };
    // EXPAND1D: 0 the row ended, 1 premature end of data (runs cleaned)
    auto expand1d = [&]() -> int {
      for (;;) {
        for (int color = 0; color < 2; color++) {
          const FaxEnt* tab = color ? tables.black : tables.white;
          const int w = color ? 13 : 12;
          for (;;) {
            if (!need16(w)) {
              cleanup();
              return 1;
            }
            const FaxEnt& e = tab[get(w)];
            clr(e.width);
            if (e.state == S_EOL) {
              eolcnt = 1;
              cleanup();
              return 0;
            }
            if (e.state == (color ? S_TermB : S_TermW)) {
              setvalue(e.param);
              if (overflow) return 0;
              break;
            }
            if (e.state == (color ? S_MakeUpB : S_MakeUpW) ||
                e.state == S_MakeUp) {
              a0 += e.param;
              run_length += e.param;
              continue;
            }
            cleanup();  // a bad code word ends the row
            return 0;
          }
          if (a0 >= lastx) {
            cleanup();
            return 0;
          }
        }
        if (pa - thisrun >= 2 && pa[-1] == 0 && pa[-2] == 0) pa -= 2;
      }
    };
    // EXPAND2D against the reference runs
    auto expand2d = [&]() -> int {
      uint32_t* pb = refruns;
      int64_t b1 = *pb++;
      auto check_b1 = [&]() -> bool {
        if (pa != thisrun)
          while (b1 <= a0 && b1 < lastx) {
            if (pb + 1 >= refruns + nruns) return false;
            b1 += int64_t(pb[0]) + pb[1];
            pb += 2;
          }
        return true;
      };
      while (a0 < lastx) {
        if (pa >= thisrun + nruns) {
          overflow = true;
          return 0;
        }
        if (!need8(7)) {
          cleanup();
          return 1;
        }
        const FaxEnt& e = tables.main[get(7)];
        clr(e.width);
        switch (e.state) {
          case S_Pass:
            if (!check_b1() || pb + 1 >= refruns + nruns) {
              overflow = true;
              return 0;
            }
            b1 += *pb++;
            run_length += b1 - a0;
            a0 = b1;
            b1 += *pb++;
            break;
          case S_Horiz: {
            const bool black_first = (pa - thisrun) & 1;
            for (int k = 0; k < 2; k++) {
              const bool black = black_first ? k == 0 : k == 1;
              const FaxEnt* tab = black ? tables.black : tables.white;
              const int w = black ? 13 : 12;
              for (;;) {
                if (!need16(w)) {
                  cleanup();
                  return 1;
                }
                const FaxEnt& h = tab[get(w)];
                clr(h.width);
                if (h.state == (black ? S_TermB : S_TermW)) {
                  setvalue(h.param);
                  if (overflow) return 0;
                  break;
                }
                if (h.state == (black ? S_MakeUpB : S_MakeUpW) ||
                    h.state == S_MakeUp) {
                  a0 += h.param;
                  run_length += h.param;
                  continue;
                }
                cleanup();  // bad code word
                return 0;
              }
            }
            if (!check_b1()) {
              overflow = true;
              return 0;
            }
            break;
          }
          case S_V0:
          case S_VR:
            if (!check_b1()) {
              overflow = true;
              return 0;
            }
            setvalue(b1 - a0 + (e.state == S_VR ? int64_t(e.param) : 0));
            if (overflow) return 0;
            if (pb >= refruns + nruns) {
              overflow = true;
              return 0;
            }
            b1 += *pb++;
            break;
          case S_VL:
            if (!check_b1()) {
              overflow = true;
              return 0;
            }
            if (b1 < a0 + int64_t(e.param)) {
              cleanup();
              return 0;
            }
            setvalue(b1 - a0 - int64_t(e.param));
            if (overflow) return 0;
            if (pb == refruns) {  // before the reference row: corrupt data
              cleanup();
              return 0;
            }
            b1 -= *--pb;
            break;
          case S_Ext:  // uncompressed mode: libtiff reports it, ends the row
            *pa++ = uint32_t(lastx - a0);
            cleanup();
            return 0;
          case S_EOL:
            *pa++ = uint32_t(lastx - a0);
            if (!need8(4)) {
              cleanup();
              return 1;
            }
            clr(4);
            eolcnt = 1;
            cleanup();
            return 0;
          default:  // a bad mode code
            cleanup();
            return 0;
        }
      }
      if (run_length) {
        if (run_length + a0 < lastx) {  // a final V0 is expected
          if (!need8(1)) {
            cleanup();
            return 1;
          }
          if (!get(1)) {
            cleanup();
            return 0;
          }
          clr(1);
        }
        setvalue(0);
        if (overflow) return 0;
      }
      cleanup();
      return 0;
    };

    if (g4) {
      const int r = expand2d();
      if (overflow) return false;
      if (r == 1 || eolcnt) {  // EOFB or the end of the data
        need16(13);
        clr(std::min(13, std::max(avail, 0)));
        fillruns(buf, thisrun, pa);
        return line > 0;  // rows past it keep their zeros
      }
      fillruns(buf, thisrun, pa);
      setvalue(0);  // an imaginary change for the reference row
      if (overflow) return false;
      std::swap(curruns, refruns);
      line++;
      continue;
    }
    if (!rle) {
      // SYNC_EOL: find an EOL unless the last row ended on one
      bool eof = false;
      if (eolcnt == 0)
        for (;;) {
          if (!need16(11)) {
            eof = true;
            break;
          }
          if (get(11) == 0) break;
          clr(1);
        }
      if (!eof)
        for (;;) {
          if (!need8(8)) {
            eof = true;
            break;
          }
          if (get(8)) break;
          clr(8);
        }
      if (eof) {
        cleanup();
        fillruns(buf, thisrun, pa);
        return false;
      }
      while (get(1) == 0) clr(1);
      clr(1);
      eolcnt = 0;
    }
    int r;
    if (is2d) {
      if (!need8(1)) {
        cleanup();
        fillruns(buf, thisrun, pa);
        return false;
      }
      const bool one_d = get(1);
      clr(1);
      r = one_d ? expand1d() : expand2d();
    } else {
      r = expand1d();
    }
    if (overflow) return false;
    fillruns(buf, thisrun, pa);
    if (r == 1) return false;
    if (is2d) {
      if (pa < thisrun + nruns) setvalue(0);
      std::swap(curruns, refruns);
    }
    if (compression == 2) {
      clr(avail - (avail & ~7));
    } else if (compression == 32771) {
      clr(avail - (avail & ~15));
      if (avail == 0 && (cp & 1)) cp++;
    }
    line++;
  }
  return true;
}

}  // namespace
