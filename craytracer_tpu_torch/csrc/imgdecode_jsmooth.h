// Block smoothing of progressive JPEG (libjpeg-turbo 3.1 jdcoefct.c
// smoothing_ok and decompress_smooth_data), included by imgdecode.cpp.
//
// PIL reads a progressive file without buffered-image mode, so libjpeg
// absorbs every scan first and makes one output pass, with the final
// coef_bits. Where some coefficient 1-9 of some component is not fully
// known, each block's unknown zero coefficients among 1-9 are predicted
// from the 5x5 neighbourhood of DC values (limited by the bits the scans
// left out), and, where no AC data at all has come, DC itself is
// interpolated; the block is then transformed as usual.

namespace {

// zigzag positions 1-9 in natural order
const int SMOOTH_POS[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

}  // namespace

// smoothing_ok: every component's quantizers 0-9 non-zero and its DC at
// least partly known, and some coefficient 1-9 not fully refined.
// latch[ci][0] holds the final coef_bits, latch[ci][1] those before each
// component's latest scan (-1 after a single scan), used below the last
// iMCU row decoded with data in hand.
bool Jpeg::smoothing_ok(int (*latch)[2][10]) const {
  if (!progressive) return false;
  bool useful = false;
  for (size_t ci = 0; ci < comps.size(); ci++) {
    const JComp& c = comps[ci];
    if (!c.latched) return false;
    for (int i = 0; i < 10; i++)
      if (c.q[SMOOTH_POS[i]] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    latch[ci][0][0] = c.coef_bits[0];
    latch[ci][1][0] = 0;
    for (int k = 1; k < 10; k++) {
      latch[ci][1][k] = scan_no > 1 ? c.prev_bits[k] : -1;
      latch[ci][0][k] = c.coef_bits[k];
      if (c.coef_bits[k] != 0) useful = true;
    }
  }
  return useful;
}

// decompress_smooth_data for the block (by, bx) of component c into ws.
// The neighbour rows follow libjpeg's indexing by iMCU rows of
// c.v block rows (block_rows is the count in the last one), the columns
// are clamped to the blocks that hold image samples.
void Jpeg::smooth_block(const JComp& c, const int (&bits)[10], int by,
                        int bx, int16_t* ws) const {
  const int T = mcuy, r = by / c.v, b = by % c.v;
  int block_rows = c.v;
  if (r == T - 1) {
    block_rows = c.hib % c.v;
    if (block_rows == 0) block_rows = c.v;
  }
  const int rows = block_rows * T, ibr = r * block_rows + b;
  const int prev = ibr > 0 ? by - 1 : by;
  const int pprev = ibr > 1 ? by - 2 : prev;
  const int next = ibr < rows - 1 ? by + 1 : by;
  const int nnext = ibr < rows - 2 ? by + 2 : next;
  const int row_of[5] = {pprev, prev, by, next, nnext};
  int DC[26];  // DC[1..25]: libjpeg's DC01..DC25, row by row
  for (int i = 0; i < 5; i++)
    for (int j = 0; j < 5; j++) {
      const int x = std::min(std::max(bx + j - 2, 0), c.wib - 1);
      DC[1 + 5 * i + j] =
          c.coef[(size_t(row_of[i]) * c.bw + x) * 64];
    }
  std::memcpy(ws, &c.coef[(size_t(by) * c.bw + bx) * 64], 64 * sizeof(int16_t));
  const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 &&
                         bits[4] == -1 && bits[5] == -1 && bits[6] == -1 &&
                         bits[7] == -1 && bits[8] == -1 && bits[9] == -1;
  const int64_t Q00 = uint16_t(c.q[0]);
  // the prediction of coefficient k (zigzag 1-9) from num, rounded,
  // limited to the bits Al that are still to come
  auto predict = [&](int k, int64_t sum) {
    const int pos = SMOOTH_POS[k];
    const int Al = bits[k];
    if (Al == 0 || ws[pos] != 0) return;
    const int64_t q = uint16_t(c.q[pos]);
    const int64_t num = Q00 * sum;
    int pred;
    if (num >= 0) {
      pred = int(((q << 7) + num) / (q << 8));
      if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
    } else {
      pred = int(((q << 7) - num) / (q << 8));
      if (Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
      pred = -pred;
    }
    ws[pos] = int16_t(pred);
  };
  const int* D = DC;
  predict(1, change_dc ? -D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] -
                             13 * D[9] + 3 * D[10] - 3 * D[11] + 38 * D[12] -
                             38 * D[14] + 3 * D[15] - 3 * D[16] +
                             13 * D[17] - 13 * D[19] + 3 * D[20] - D[21] -
                             D[22] + D[24] + D[25]
                       : -7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]);
  predict(2, change_dc ? -D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] -
                             D[6] + 13 * D[7] + 38 * D[8] + 13 * D[9] -
                             D[10] + D[16] - 13 * D[17] - 38 * D[18] -
                             13 * D[19] + D[20] + D[21] + 3 * D[22] +
                             3 * D[23] + 3 * D[24] + D[25]
                       : -7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]);
  predict(3, change_dc ? D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] -
                             14 * D[13] - 5 * D[14] + 2 * D[17] +
                             7 * D[18] + 2 * D[19] + D[23]
                       : -D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]);
  predict(4, change_dc ? -D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] +
                             9 * D[19] + D[21] - D[25]
                       : D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] -
                             D[20] + D[22] - D[24] + D[4] - D[6] +
                             10 * D[7] - 10 * D[9]);
  predict(5, change_dc ? 2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] -
                             14 * D[13] + 7 * D[14] + D[15] + 2 * D[17] -
                             5 * D[18] + 2 * D[19]
                       : -D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] -
                             D[15]);
  if (!change_dc) return;
  predict(6, D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]);
  predict(7, D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]);
  predict(8, D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]);
  predict(9, D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]);
  const int64_t num =
      Q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] -
             6 * D[6] + 6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] -
             8 * D[11] + 42 * D[12] + 152 * D[13] + 42 * D[14] - 8 * D[15] -
             6 * D[16] + 6 * D[17] + 42 * D[18] + 6 * D[19] - 6 * D[20] -
             2 * D[21] - 6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25]);
  const int pred = num >= 0 ? int(((Q00 << 7) + num) / (Q00 << 8))
                            : -int(((Q00 << 7) - num) / (Q00 << 8));
  ws[0] = int16_t(pred);
}
