// Lossless JPEG scans (SOF3, ITU T.81 Annex H) as libjpeg-turbo 3.1
// decodes them under Pillow 12.1, at the 8-bit precision Pillow takes:
// jdlhuff.c's Huffman-coded differences (SSSS 16 is 32768 with no extra
// bits), jddiffct.c's rows of MCUs with restarts every whole MCU row, and
// jdlossls.c's undifferencing with the predictor Ss (1-7): the first row
// of a scan or restart interval predicted from the left and its first
// sample from 2^(P-Pt-1), the first column from above, the sums kept to
// 16 bits, then the point transform Al undone by a left shift and the
// sample cut to 8 bits.  The samples go into each component's plane; the
// upsampling and the colour conversion are image_decode.cpp's.
//
// Corrupt data is what libjpeg makes of it: a marker in the data gives
// zero bits for the rest of that MCU row, and every later row of the
// restart interval decodes as zero differences from a reset predictor.

#include <algorithm>
#include <vector>

#include "image_codec.h"

namespace mrt {

void lossless_scan(const uint8_t* d, int64_t n, int64_t pos, int psv, int pt,
                   int restart_interval, int mcux, int mcuy, bool pillow,
                   std::vector<LosslessComp>& comps, int64_t& end) {
  const size_t nc = comps.size();
  // one component alone: an MCU is one sample (its own grid)
  if (nc == 1) {
    comps[0].h = comps[0].v = 1;
    mcux = comps[0].cw;
    mcuy = comps[0].ch;
  }
  if (restart_interval % mcux != 0)
    corrupt("JPEG: a lossless restart interval of " + std::to_string(restart_interval) +
            " MCUs is no whole number of MCU rows of " + std::to_string(mcux));
  const int restart_rows = restart_interval / mcux;
  const int initial = 1 << (8 - pt - 1);

  struct State {
    std::vector<int> diff, undiff;  // v rows of mcux * h each
    bool first_row = true;
  };
  std::vector<State> st(nc);
  for (size_t c = 0; c < nc; c++) {
    const size_t w = static_cast<size_t>(mcux) * comps[c].h;
    st[c].diff.assign(w * comps[c].v, 0);
    st[c].undiff.assign(w * comps[c].v, 0);
  }
  auto reset = [&] {
    for (State& s : st) s.first_row = true;
  };

  Bits bits(d, n, pos, pillow);
  int next_restart_num = 0;
  int rows_to_go = restart_rows;
  for (int mrow = 0; mrow < mcuy; mrow++) {
    if (restart_interval && rows_to_go == 0) {
      bits.restart(next_restart_num);
      reset();
      rows_to_go = restart_rows;
    }
    // jdlhuff.c decode_mcus over one MCU row
    if (bits.insufficient) {
      for (State& s : st) std::fill(s.diff.begin(), s.diff.end(), 0);
      reset();
    } else {
      for (int mx = 0; mx < mcux; mx++) {
        for (size_t c = 0; c < nc; c++) {
          const LosslessComp& k = comps[c];
          const size_t w = static_cast<size_t>(mcux) * k.h;
          for (int y = 0; y < k.v; y++) {
            for (int x = 0; x < k.h; x++) {
              int s = bits.decode(*k.table);
              if (s == 16) {
                s = 32768;
              } else if (s) {
                s = extend(bits.get(s), s);
              }
              st[c].diff[y * w + static_cast<size_t>(mx) * k.h + x] = s;
            }
          }
        }
      }
    }
    if (restart_interval) rows_to_go--;
    // jdlossls.c: undifference and scale each real row
    for (size_t c = 0; c < nc; c++) {
      const LosslessComp& k = comps[c];
      State& s = st[c];
      const size_t w = static_cast<size_t>(mcux) * k.h;
      for (int r = 0; r < k.v; r++) {
        const int64_t row = static_cast<int64_t>(mrow) * k.v + r;
        if (row >= k.ch) break;
        const int* df = s.diff.data() + r * w;
        const int* prev = s.undiff.data() + (r == 0 ? k.v - 1 : r - 1) * w;
        int* out = s.undiff.data() + r * w;
        if (s.first_row) {
          int ra = (df[0] + initial) & 0xFFFF;
          out[0] = ra;
          for (int x = 1; x < k.cw; x++) out[x] = ra = (df[x] + ra) & 0xFFFF;
          s.first_row = false;
        } else {
          int rb = prev[0];
          int ra = (df[0] + rb) & 0xFFFF;
          out[0] = ra;
          for (int x = 1; x < k.cw; x++) {
            const int rc = rb;
            rb = prev[x];
            int64_t p;
            switch (psv) {
              case 1: p = ra; break;
              case 2: p = rb; break;
              case 3: p = rc; break;
              case 4: p = static_cast<int64_t>(ra) + rb - rc; break;
              case 5: p = ra + ((static_cast<int64_t>(rb) - rc) >> 1); break;
              case 6: p = rb + ((static_cast<int64_t>(ra) - rc) >> 1); break;
              default: p = (static_cast<int64_t>(ra) + rb) >> 1; break;
            }
            out[x] = ra = static_cast<int>((df[x] + p) & 0xFFFF);
          }
        }
        uint8_t* o = k.plane + row * k.cw;
        for (int x = 0; x < k.cw; x++) o[x] = static_cast<uint8_t>(out[x] << pt);
      }
    }
  }
  end = bits.pos;
}

}  // namespace mrt
