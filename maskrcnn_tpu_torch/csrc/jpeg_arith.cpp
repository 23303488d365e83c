// Arithmetic-coded JPEG scans (SOF9 sequential, SOF10 progressive) as
// libjpeg-turbo 3.1's jdarith.c decodes them under Pillow 12.1: the QM
// decoder of ITU T.81 Annex D (its Qe table below, T.81 Table D.2 as
// jaricom.c packs it), the DC and AC statistics areas of each table
// (T.81 F.1.4.4), the DAC conditioning L, U and Kx (defaults 0, 1, 5,
// reset at SOI), restarts that reset the statistics, the DC prediction
// and context and the decoder, and the four progressive scan kinds of
// T.81 G.1.3.  What the scans decode goes into the same coefficient
// blocks the Huffman scans fill (image_decode.cpp); from there on the
// decode is shared.
//
// Corrupt data is what libjpeg makes of it, which Pillow takes, since
// libjpeg only warns: a marker in the data gives zero bytes from there on,
// and a magnitude or spectral overflow leaves the rest of the restart
// interval as it is.  What libjpeg cannot do under Pillow is suspend an
// arithmetic scan: a scan that reads past the 65536-byte block of the
// file Pillow's decoder holds is an error (JpegSource, image_codec.h).

#include <algorithm>
#include <cstring>

#include "image_codec.h"

namespace mrt {

namespace {

// jaricom.c jpeg_aritab: Qe << 16 | next index after an MPS << 8 | the
// switch flag << 7 | next index after an LPS; entry 113 is the fixed
// probability 0.5 of the sign and refinement bits
#define V(qe, lps, mps, sw) \
  ((static_cast<int64_t>(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const int64_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1), V(0x2586, 14, 2, 0), V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0), V(0x03d8, 20, 5, 0), V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0), V(0x006f, 28, 8, 0), V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0), V(0x000d, 35, 11, 0), V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0), V(0x0001, 12, 13, 0), V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0), V(0x2cf2, 38, 17, 0), V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0), V(0x1182, 42, 20, 0), V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0), V(0x072f, 46, 23, 0), V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0), V(0x0303, 51, 26, 0), V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0), V(0x0144, 56, 29, 0), V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0), V(0x008a, 60, 32, 0), V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0), V(0x003b, 32, 35, 0), V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1), V(0x484c, 64, 38, 0), V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0), V(0x261f, 68, 41, 0), V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0), V(0x1518, 72, 44, 0), V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0), V(0x0bfb, 75, 47, 0), V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0), V(0x0706, 79, 50, 0), V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0), V(0x040f, 50, 53, 0), V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0), V(0x025c, 53, 56, 0), V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0), V(0x0160, 56, 59, 0), V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0), V(0x00cb, 59, 62, 0), V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0), V(0x5b12, 65, 65, 1), V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0), V(0x37d8, 82, 68, 0), V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0), V(0x2379, 86, 71, 0), V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0), V(0x174e, 72, 74, 0), V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0), V(0x0f6b, 74, 77, 0), V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0), V(0x0a40, 77, 48, 0), V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0), V(0x438e, 89, 83, 0), V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0), V(0x2eae, 92, 86, 0), V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0), V(0x5570, 88, 89, 1), V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0), V(0x3e22, 97, 92, 0), V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0), V(0x2e17, 93, 86, 0), V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0), V(0x47e5, 102, 98, 0), V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0), V(0x375e, 99, 93, 0), V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0), V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0), V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0),
};
#undef V

}  // namespace

void JpegSource::next_marker() {
  for (;;) {
    int c = get_byte();
    while (c != 0xFF) c = get_byte();
    do c = get_byte(); while (c == 0xFF);
    if (c != 0) {
      unread_marker = c;
      return;
    }
  }
}

void JpegSource::read_restart_marker(int& next_restart_num) {
  if (unread_marker == 0) next_marker();
  if (unread_marker == 0xD0 + next_restart_num) {
    unread_marker = 0;
  } else {
    // jpeg_resync_to_restart
    const int desired = next_restart_num;
    for (;;) {
      const int m = unread_marker;
      int action = 1;
      if (m < 0xC0) {
        action = 2;  // not a valid marker
      } else if (m < 0xD0 || m > 0xD7) {
        action = 3;  // a valid marker that is no restart
      } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
        action = 3;  // one of the next two restarts
      } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
        action = 2;  // an earlier restart: scan on
      }
      if (action == 1) {
        unread_marker = 0;  // discard it, and decode on
        break;
      }
      if (action == 3) break;  // the next segment decodes as empty
      next_marker();
    }
  }
  next_restart_num = (next_restart_num + 1) & 7;
}

int64_t JpegSource::marker_pos() const {
  if (!unread_marker) return pos;
  return std::min(pos - 2, n);
}

// arith_decode: one binary decision in statistics bin *st
int ArithScan::decode(uint8_t* st) {
  while (a_ < 0x8000) {
    if (--ct_ < 0) {
      int data = 0;
      if (!src.unread_marker) {
        data = src.get_byte();
        if (data == 0xFF) {
          do data = src.get_byte(); while (data == 0xFF);
          if (data == 0) {
            data = 0xFF;  // a stuffed zero
          } else {
            // a marker in the data is legal: zero data from here on
            src.unread_marker = data;
            data = 0;
          }
        }
      }
      c_ = (c_ << 8) | data;
      if ((ct_ += 8) < 0) {
        if (++ct_ == 0) a_ = 0x8000;  // the two first bytes are in
      }
    }
    a_ <<= 1;
  }
  int sv = *st;
  int64_t qe = kAritab[sv & 0x7F];
  const int nl = static_cast<int>(qe & 0xFF);
  qe >>= 8;
  const int nm = static_cast<int>(qe & 0xFF);
  qe >>= 8;
  int64_t temp = a_ - qe;
  a_ = temp;
  temp <<= ct_;
  if (c_ >= temp) {
    c_ -= temp;
    if (a_ < qe) {
      a_ = qe;
      *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
    } else {
      a_ = qe;
      *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
      sv ^= 0x80;
    }
  } else if (a_ < 0x8000) {
    if (a_ < qe) {
      *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
      sv ^= 0x80;
    } else {
      *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
    }
  }
  return sv >> 7;
}

void ArithScan::start() {
  std::memset(dc_stats_, 0, sizeof(dc_stats_));
  std::memset(ac_stats_, 0, sizeof(ac_stats_));
  std::memset(last_dc_, 0, sizeof(last_dc_));
  std::memset(dc_context_, 0, sizeof(dc_context_));
  c_ = 0;
  a_ = 0;
  ct_ = -16;
  next_restart_num_ = 0;
  restarts_to_go_ = restart_interval;
}

// process_restart
void ArithScan::restart() {
  src.read_restart_marker(next_restart_num_);
  for (int ci = 0; ci < ncomp; ci++) {
    if (!progressive || (ss == 0 && ah == 0)) {
      std::memset(dc_stats_[dc_tbl[ci]], 0, 64);
      last_dc_[ci] = 0;
      dc_context_[ci] = 0;
    }
    if (!progressive || ss) std::memset(ac_stats_[ac_tbl[ci]], 0, 256);
  }
  c_ = 0;
  a_ = 0;
  ct_ = -16;
  restarts_to_go_ = restart_interval;
}

// An AC coefficient's magnitude (F.23, F.24) from bin st of the table's
// statistics `stats` on: kx is the bin of its magnitude categories past
// the first (189 up to coefficient Kx, 217 past it); false on an
// overflow.
bool ArithScan::magnitude(uint8_t* stats, uint8_t* st, int kx, int& v) {
  int m = decode(st);
  if (m && decode(st)) {
    m <<= 1;
    st = stats + kx;
    while (decode(st)) {
      if ((m <<= 1) == 0x8000) return false;
      st += 1;
    }
  }
  v = m;
  st += 14;
  while (m >>= 1)
    if (decode(st)) v |= m;
  v += 1;
  return true;
}

// F.19 Decode_DC_DIFF with F.1.4.4.1.2's context; false on an overflow
bool ArithScan::dc_diff(int ci, int& v) {
  const int tbl = dc_tbl[ci];
  uint8_t* st = dc_stats_[tbl] + dc_context_[ci];
  v = 0;
  if (decode(st) == 0) {
    dc_context_[ci] = 0;
    return true;
  }
  const int sign = decode(st + 1);
  st += 2 + sign;
  int m = decode(st);
  if (m) {
    st = dc_stats_[tbl] + 20;
    while (decode(st)) {
      if ((m <<= 1) == 0x8000) return false;
      st += 1;
    }
  }
  if (m < ((1 << dc_L[tbl]) >> 1))
    dc_context_[ci] = 0;
  else if (m > ((1 << dc_U[tbl]) >> 1))
    dc_context_[ci] = 12 + sign * 4;
  else
    dc_context_[ci] = 4 + sign * 4;
  v = m;
  st += 14;
  while (m >>= 1)
    if (decode(st)) v |= m;
  v += 1;
  if (sign) v = -v;
  return true;
}

void ArithScan::decode_mcu(int16_t* const* blocks, const int* comp, int nblocks) {
  if (restart_interval) {
    if (restarts_to_go_ == 0) restart();
    restarts_to_go_--;
  }
  const bool dc_refine = progressive && ss == 0 && ah != 0;
  if (ct_ == -1 && !dc_refine) return;  // after an error: nothing
  if (!progressive || ss == 0) {
    for (int b = 0; b < nblocks; b++) {
      const int ci = comp[b];
      int16_t* blk = blocks[b];
      if (dc_refine) {
        if (decode(fixed_bin_)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        continue;
      }
      int v;
      if (!dc_diff(ci, v)) {
        ct_ = -1;  // magnitude overflow
        return;
      }
      last_dc_[ci] = (last_dc_[ci] + v) & 0xFFFF;
      if (progressive) {
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(last_dc_[ci]) << al);
        continue;
      }
      blk[0] = static_cast<int16_t>(last_dc_[ci]);
      // F.20 Decode_AC_coefficients over the whole band
      uint8_t* const stats = ac_stats_[ac_tbl[ci]];
      for (int k = 1; k <= 63; k++) {
        uint8_t* st = stats + 3 * (k - 1);
        if (decode(st)) break;  // EOB
        while (decode(st + 1) == 0) {
          st += 3;
          if (++k > 63) {
            ct_ = -1;  // spectral overflow
            return;
          }
        }
        const int sign = decode(fixed_bin_);
        int mag;
        if (!magnitude(stats, st + 2, k <= ac_K[ac_tbl[ci]] ? 189 : 217, mag)) {
          ct_ = -1;
          return;
        }
        blk[kNatural[k]] = static_cast<int16_t>(sign ? -mag : mag);
      }
    }
    return;
  }
  // progressive AC scans: one component, one block an MCU
  int16_t* blk = blocks[0];
  uint8_t* const stats = ac_stats_[ac_tbl[0]];
  if (ah == 0) {
    for (int k = ss; k <= se; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (decode(st)) break;  // EOB
      while (decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ct_ = -1;
          return;
        }
      }
      const int sign = decode(fixed_bin_);
      int mag;
      if (!magnitude(stats, st + 2, k <= ac_K[ac_tbl[0]] ? 189 : 217, mag)) {
        ct_ = -1;
        return;
      }
      const int v = sign ? -mag : mag;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
    }
    return;
  }
  const int p1 = 1 << al;
  const int m1 = -1 * (1 << al);
  int kex = se;
  for (; kex > 0; kex--)
    if (blk[kNatural[kex]]) break;
  for (int k = ss; k <= se; k++) {
    uint8_t* st = stats + 3 * (k - 1);
    if (k > kex && decode(st)) break;  // EOB
    for (;;) {
      int16_t* coef = blk + kNatural[k];
      if (*coef) {
        if (decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
        break;
      }
      if (decode(st + 1)) {
        *coef = static_cast<int16_t>(decode(fixed_bin_) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) {
        ct_ = -1;
        return;
      }
    }
  }
}

}  // namespace mrt
