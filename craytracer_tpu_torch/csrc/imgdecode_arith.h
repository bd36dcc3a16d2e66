// Arithmetic-coded JPEG (T.81 Annex D and F.1.4, SOF9 sequential and
// SOF10 progressive) as libjpeg-turbo 3.1 decodes it (jdarith.c,
// jaricom.c), into the Jpeg struct's coefficient store: output() then
// runs as for Huffman data. Included by imgdecode.cpp.
//
// What libjpeg does with bad data is kept: a magnitude category that
// overflows (m == 0x8000) or a run past Se sets ct = -1 ("corrupt data",
// a warning PIL ignores), and every later MCU of the scan decodes as
// zeros up to the next restart. A marker inside the data is legal: the
// decoder feeds zeros from there on.
//
// PIL hands libjpeg a file in reads of 65536 bytes (ImageFile.MAXBLOCK)
// and its source manager can only suspend; jdarith.c cannot suspend and
// fails when a scan needs a byte past what PIL has read so far. With
// `feed` set the decoder fails the same way (see `arith_limit`).

namespace {

// T.81 Table D.2: Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS; row
// 113 is the fixed 0x5A1D bin that neither index leaves
struct AriRow {
  uint16_t qe;
  uint8_t nlps, nmps, sw;
};
const AriRow ARITAB[114] = {
    {0x5a1d, 1, 1, 1}, {0x2586, 14, 2, 0}, {0x1114, 16, 3, 0},
    {0x080b, 18, 4, 0}, {0x03d8, 20, 5, 0}, {0x01da, 23, 6, 0},
    {0x00e5, 25, 7, 0}, {0x006f, 28, 8, 0}, {0x0036, 30, 9, 0},
    {0x001a, 33, 10, 0}, {0x000d, 35, 11, 0}, {0x0006, 9, 12, 0},
    {0x0003, 10, 13, 0}, {0x0001, 12, 13, 0}, {0x5a7f, 15, 15, 1},
    {0x3f25, 36, 16, 0}, {0x2cf2, 38, 17, 0}, {0x207c, 39, 18, 0},
    {0x17b9, 40, 19, 0}, {0x1182, 42, 20, 0}, {0x0cef, 43, 21, 0},
    {0x09a1, 45, 22, 0}, {0x072f, 46, 23, 0}, {0x055c, 48, 24, 0},
    {0x0406, 49, 25, 0}, {0x0303, 51, 26, 0}, {0x0240, 52, 27, 0},
    {0x01b1, 54, 28, 0}, {0x0144, 56, 29, 0}, {0x00f5, 57, 30, 0},
    {0x00b7, 59, 31, 0}, {0x008a, 60, 32, 0}, {0x0068, 62, 33, 0},
    {0x004e, 63, 34, 0}, {0x003b, 32, 35, 0}, {0x002c, 33, 9, 0},
    {0x5ae1, 37, 37, 1}, {0x484c, 64, 38, 0}, {0x3a0d, 65, 39, 0},
    {0x2ef1, 67, 40, 0}, {0x261f, 68, 41, 0}, {0x1f33, 69, 42, 0},
    {0x19a8, 70, 43, 0}, {0x1518, 72, 44, 0}, {0x1177, 73, 45, 0},
    {0x0e74, 74, 46, 0}, {0x0bfb, 75, 47, 0}, {0x09f8, 77, 48, 0},
    {0x0861, 78, 49, 0}, {0x0706, 79, 50, 0}, {0x05cd, 48, 51, 0},
    {0x04de, 50, 52, 0}, {0x040f, 50, 53, 0}, {0x0363, 51, 54, 0},
    {0x02d4, 52, 55, 0}, {0x025c, 53, 56, 0}, {0x01f8, 54, 57, 0},
    {0x01a4, 55, 58, 0}, {0x0160, 56, 59, 0}, {0x0125, 57, 60, 0},
    {0x00f6, 58, 61, 0}, {0x00cb, 59, 62, 0}, {0x00ab, 61, 63, 0},
    {0x008f, 61, 32, 0}, {0x5b12, 65, 65, 1}, {0x4d04, 80, 66, 0},
    {0x412c, 81, 67, 0}, {0x37d8, 82, 68, 0}, {0x2fe8, 83, 69, 0},
    {0x293c, 84, 70, 0}, {0x2379, 86, 71, 0}, {0x1edf, 87, 72, 0},
    {0x1aa9, 87, 73, 0}, {0x174e, 72, 74, 0}, {0x1424, 72, 75, 0},
    {0x119c, 74, 76, 0}, {0x0f6b, 74, 77, 0}, {0x0d51, 75, 78, 0},
    {0x0bb6, 77, 79, 0}, {0x0a40, 77, 48, 0}, {0x5832, 80, 81, 1},
    {0x4d1c, 88, 82, 0}, {0x438e, 89, 83, 0}, {0x3bdd, 90, 84, 0},
    {0x34ee, 91, 85, 0}, {0x2eae, 92, 86, 0}, {0x299a, 93, 87, 0},
    {0x2516, 86, 71, 0}, {0x5570, 88, 89, 1}, {0x4ca9, 95, 90, 0},
    {0x44d9, 96, 91, 0}, {0x3e22, 97, 92, 0}, {0x3824, 99, 93, 0},
    {0x32b4, 99, 94, 0}, {0x2e17, 93, 86, 0}, {0x56a8, 95, 96, 1},
    {0x4f46, 101, 97, 0}, {0x47e5, 102, 98, 0}, {0x41cf, 103, 99, 0},
    {0x3c3d, 104, 100, 0}, {0x375e, 99, 93, 0}, {0x5231, 105, 102, 0},
    {0x4c0f, 106, 103, 0}, {0x4639, 107, 104, 0}, {0x415e, 103, 99, 0},
    {0x5627, 105, 106, 1}, {0x50e7, 108, 107, 0}, {0x4b85, 109, 103, 0},
    {0x5597, 110, 109, 0}, {0x504f, 111, 107, 0}, {0x5a10, 110, 111, 1},
    {0x5522, 112, 109, 0}, {0x59eb, 112, 111, 1}, {0x5a1d, 113, 113, 0}};

// jdarith.c's A and C registers, bit counter and byte source
struct JArith {
  const uint8_t* d;
  size_t n, pos, limit;  // bytes at or past `limit` fail (PIL's read)
  int64_t c = 0, a = 0;
  int ct = -16;     // -16: two bytes to read; -1: corrupt data seen
  int unread = 0;   // a marker the data ran into (its code)
  size_t mark = 0;  // ... and the position of its last FF
  int get_byte() {
    if (pos >= limit) {
      if (limit < n)
        invalid("arithmetic-coded JPEG scan that reads past PIL's "
                "65536-byte read: libjpeg cannot suspend in it");
      invalid("truncated JPEG data");
    }
    return d[pos++];
  }
  // arith_decode: one binary decision with the state byte *st
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (!unread) {
          data = get_byte();
          if (data == 0xFF) {
            do data = get_byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread = data;
              mark = pos - 2;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    const AriRow& r = ARITAB[sv & 0x7F];
    const int64_t qe = r.qe;
    const int nl = r.sw << 7 | r.nlps, nm = r.nmps;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // jdmarker.c next_marker from pos: the marker code, unread set
  void next_marker() {
    for (;;) {
      int b = get_byte();
      while (b != 0xFF) b = get_byte();
      do b = get_byte();
      while (b == 0xFF);
      if (b) {
        unread = b;
        mark = pos - 2;
        return;
      }
    }
  }
  // jdmarker.c read_restart_marker with jpeg_resync_to_restart
  void read_restart(int& next_rst) {
    if (!unread) next_marker();
    if (unread == 0xD0 + next_rst) {
      unread = 0;
    } else {
      for (;;) {
        int m = unread, action;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((next_rst + 1) & 7) ||
                   m == 0xD0 + ((next_rst + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((next_rst - 1) & 7) ||
                   m == 0xD0 + ((next_rst - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          unread = 0;
          break;
        }
        if (action == 3) break;
        unread = 0;
        next_marker();
      }
    }
    next_rst = (next_rst + 1) & 7;
    c = a = 0;
    ct = -16;
  }
};

void Jpeg::read_dac() {
  size_t len = segment();
  if (len % 2) invalid("bad DAC length");
  for (size_t i = 0; i < len; i += 2) {
    int index = d[pos + i], val = d[pos + i + 1];
    if (index >= 32) invalid("bad DAC table index");
    if (index >= 16) {
      arith_K[index - 16] = uint8_t(val);
    } else {
      arith_L[index] = uint8_t(val & 15);
      arith_U[index] = uint8_t(val >> 4);
      if (arith_L[index] > arith_U[index]) invalid("bad DAC value");
    }
  }
  pos += len;
}

// the end of what PIL has handed libjpeg when a scan's data starts at
// `at`: reads of 65536 bytes, one more each time the marker reader
// suspends, which it does only at a byte it does not have yet
size_t Jpeg::arith_limit(size_t at) const {
  if (!feed) return n;
  const size_t block = 65536;
  return std::min(n, (at + block - 1) / block * block);
}

void Jpeg::read_scan_arith(std::vector<JComp*>& sc, int Ss, int Se, int Ah,
                           int Al) {
  const int ns = int(sc.size());
  const bool dc_scan = !progressive || (Ss == 0 && Ah == 0);
  const bool ac_scan = !progressive || Ss != 0;
  // jdarith.c start_pass: the statistics of the tables this scan uses,
  // cleared, as are the DC predictions and contexts
  std::vector<uint8_t> dc_stats(16 * 64), ac_stats(16 * 256);
  std::vector<int> last_dc(ns), dc_ctx(ns);
  auto clear = [&]() {
    for (int i = 0; i < ns; i++) {
      if (dc_scan) {
        std::memset(&dc_stats[size_t(sc[i]->td) * 64], 0, 64);
        last_dc[i] = dc_ctx[i] = 0;
      }
      if (ac_scan) std::memset(&ac_stats[size_t(sc[i]->ta) * 256], 0, 256);
    }
  };
  clear();
  uint8_t fixed = 113;
  JArith e{d, n, pos, arith_limit(pos)};
  int next_rst = 0;
  const int p1 = 1 << Al, m1 = -1 * (1 << Al);

  // Figures F.19, F.21-F.24: one DC difference of component i, or false
  // where the magnitude overflowed (ct = -1)
  auto dc_diff = [&](int i, int& v) {
    const int tbl = sc[i]->td;
    uint8_t* s0 = &dc_stats[size_t(tbl) * 64];
    uint8_t* st = s0 + dc_ctx[i];
    v = 0;
    if (e.decode(st) == 0) {
      dc_ctx[i] = 0;
      return true;
    }
    int sign = e.decode(st + 1);
    st += 2 + sign;
    int m = e.decode(st);
    if (m) {
      st = s0 + 20;
      while (e.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          e.ct = -1;
          return false;
        }
        st++;
      }
    }
    if (m < ((1 << arith_L[tbl]) >> 1))
      dc_ctx[i] = 0;
    else if (m > ((1 << arith_U[tbl]) >> 1))
      dc_ctx[i] = 12 + sign * 4;
    else
      dc_ctx[i] = 4 + sign * 4;
    v = m;
    st += 14;
    while (m >>= 1)
      if (e.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    return true;
  };
  // Figure F.20 over k = ks..ke; false where the data is corrupt
  auto ac_run = [&](int tbl, int16_t* blk, int ks, int ke, int shift) {
    uint8_t* base = &ac_stats[size_t(tbl) * 256];
    for (int k = ks; k <= ke; k++) {
      uint8_t* st = base + 3 * (k - 1);
      if (e.decode(st)) break;  // EOB
      while (e.decode(st + 1) == 0) {
        st += 3;
        if (++k > ke) {
          e.ct = -1;
          return false;
        }
      }
      int sign = e.decode(&fixed);
      st += 2;
      int m = e.decode(st);
      if (m && e.decode(st)) {
        m <<= 1;
        st = base + (k <= arith_K[tbl] ? 189 : 217);
        while (e.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            e.ct = -1;
            return false;
          }
          st++;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (e.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[NATURAL[k]] = int16_t(int(unsigned(v) << shift));
    }
    return true;
  };

  auto block_seq = [&](int i, int16_t* blk) {
    int v;
    if (!dc_diff(i, v)) return false;
    last_dc[i] = (last_dc[i] + v) & 0xFFFF;
    blk[0] = int16_t(last_dc[i]);
    return ac_run(sc[i]->ta, blk, 1, 63, 0);
  };
  auto block_dc_first = [&](int i, int16_t* blk) {
    int v;
    if (!dc_diff(i, v)) return false;
    last_dc[i] = (last_dc[i] + v) & 0xFFFF;
    blk[0] = int16_t(int(unsigned(last_dc[i]) << Al));
    return true;
  };
  auto block_dc_refine = [&](int, int16_t* blk) {
    if (e.decode(&fixed)) blk[0] = int16_t(blk[0] | p1);
    return true;
  };
  auto block_ac_first = [&](int i, int16_t* blk) {
    return ac_run(sc[i]->ta, blk, Ss, Se, Al);
  };
  auto block_ac_refine = [&](int i, int16_t* blk) {
    uint8_t* base = &ac_stats[size_t(sc[i]->ta) * 256];
    int kex = Se;  // the previous stage's end of block
    for (; kex > 0; kex--)
      if (blk[NATURAL[kex]]) break;
    for (int k = Ss; k <= Se; k++) {
      uint8_t* st = base + 3 * (k - 1);
      if (k > kex && e.decode(st)) break;  // EOB
      for (;;) {
        int16_t& co = blk[NATURAL[k]];
        if (co) {
          if (e.decode(st + 2)) co = int16_t(co < 0 ? co + m1 : co + p1);
          break;
        }
        if (e.decode(st + 1)) {
          co = int16_t(e.decode(&fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > Se) {
          e.ct = -1;
          return false;
        }
      }
    }
    return true;
  };

  // jdcoefct.c's MCU walk; an MCU after corrupt data is left as it is
  // (its blocks keep zeros, or the earlier scans' values), as is the
  // rest of the MCU where the data went bad
  auto run = [&](auto&& fn) {
    const int64_t total = ns == 1 ? int64_t(sc[0]->wib) * sc[0]->hib
                                   : int64_t(mcux) * mcuy;
    for (int64_t m = 0; m < total; m++) {
      if (restart && m > 0 && m % restart == 0) {
        e.read_restart(next_rst);
        clear();
      }
      // jdcoefct.c: no decoder here runs short of data
      if (ns == 1) {
        JComp& c = *sc[0];
        last_good = int(m / c.wib) / c.v;
        if (e.ct != -1) fn(0, c.block(int(m / c.wib), int(m % c.wib)));
        continue;
      }
      const int my = int(m / mcux), mx = int(m % mcux);
      last_good = my;
      if (e.ct == -1) continue;
      bool ok = true;
      for (int i = 0; i < ns && ok; i++) {
        JComp* c = sc[i];
        for (int y = 0; y < c->v && ok; y++)
          for (int x = 0; x < c->h && ok; x++)
            ok = fn(i, c->block(my * c->v + y, mx * c->h + x));
      }
    }
  };
  if (!progressive)
    run(block_seq);
  else if (Ss == 0 && Ah == 0)
    run(block_dc_first);
  else if (Ss == 0)
    run(block_dc_refine);
  else if (Ah == 0)
    run(block_ac_first);
  else
    run(block_ac_refine);
  pos = e.unread ? e.mark : e.pos;
}

}  // namespace
