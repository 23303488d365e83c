// Host AV1 decoder of the port's AVIF reader: the key frame (or the
// first, intra-only frame) of 8-bit AV1 in profiles 0, 1 and 2 (4:0:0,
// 4:2:0, 4:4:4 and 4:2:2), the YUV planes a conformant decoder (dav1d,
// under Pillow 12.1's libavif 1.3) gives.
//
// Written from the AV1 specification (AV1 Bitstream & Decoding Process
// Specification, version 1.0.0 with errata 1): OBUs (5.3), the sequence
// header (5.5) with the reduced still-picture header, the uncompressed
// header of an intra frame (5.9: quantization, segmentation, delta q and
// delta lf, loop filter, CDEF and loop-restoration parameters, the tile
// info), tile groups (5.11) over the symbol decoder (8.2) with CDF
// adaptation reset at each tile, the partition and intra mode info (y and
// uv modes, angle deltas, CFL alphas, filter intra, palette with its
// colour cache and colour-index contexts, skip, segment id, cdef index,
// delta q and lf, tx size, the intra tx sets), the coefficients (7.12.3:
// dequantization with quantizer matrices), the inverse transforms (7.13:
// DCT 4-64, ADST 4/8/16, identity, flips, rectangular scaling, WHT), intra
// prediction (7.11.2: DC, V, H, directional with edge filter and
// upsampling, the smooth modes, Paeth, CFL, filter intra, palette) and the
// in-loop filters (7.14 deblocking, 7.15 CDEF, 7.17 loop restoration with
// its stripes over the deblocked rows). The default CDFs and constant
// tables are the specification's, in av1_tables.h.
//
// Refused by name (NotImplementedError): more than 8 bits a sample, film
// grain, superres, IntraBC, inter frames and a first frame that is not
// shown.
//
// Host C++17: compiled with avif_decode.cpp into the AVIF library
// (maskrcnn_tpu_torch/data/native_image.py).

#include "av1_decode.h"

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "av1_tables.h"

namespace mrt {
namespace av1 {
namespace {

// ------------------------------------------------------------ helpers

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline uint8_t clip1(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int round2(int x, int n) { return n == 0 ? x : (x + (1 << (n - 1))) >> n; }
inline int64_t round2_64(int64_t x, int n) { return n == 0 ? x : (x + (int64_t(1) << (n - 1))) >> n; }
inline int round2signed(int x, int n) { return x >= 0 ? round2(x, n) : -round2(-x, n); }
inline int floor_log2(uint32_t x) { return x ? 31 - __builtin_clz(x) : 0; }
inline int ceil_log2(uint32_t x) {
  if (x < 2) return 0;
  int i = 1;
  uint32_t p = 2;
  while (p < x) {
    i++;
    p <<= 1;
  }
  return i;
}

// ------------------------------------------------------------ sizes

enum {
  BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8,
  BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64,
  BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, BLOCK_128X128,
  BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64, BLOCK_64X16,
  BLOCK_INVALID = 22
};
const uint8_t kNum4x4W[22] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16};
const uint8_t kNum4x4H[22] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4};
const uint8_t kMiWLog2[22] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4};
const uint8_t kMiHLog2[22] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2};
// get_plane_residual_size: [bsize][ss_x][ss_y]
const uint8_t kSubsampled[22][2][2] = {
    {{BLOCK_4X4, BLOCK_4X4}, {BLOCK_4X4, BLOCK_4X4}},
    {{BLOCK_4X8, BLOCK_4X4}, {BLOCK_INVALID, BLOCK_4X4}},
    {{BLOCK_8X4, BLOCK_INVALID}, {BLOCK_4X4, BLOCK_4X4}},
    {{BLOCK_8X8, BLOCK_8X4}, {BLOCK_4X8, BLOCK_4X4}},
    {{BLOCK_8X16, BLOCK_8X8}, {BLOCK_INVALID, BLOCK_4X8}},
    {{BLOCK_16X8, BLOCK_INVALID}, {BLOCK_8X8, BLOCK_8X4}},
    {{BLOCK_16X16, BLOCK_16X8}, {BLOCK_8X16, BLOCK_8X8}},
    {{BLOCK_16X32, BLOCK_16X16}, {BLOCK_INVALID, BLOCK_8X16}},
    {{BLOCK_32X16, BLOCK_INVALID}, {BLOCK_16X16, BLOCK_16X8}},
    {{BLOCK_32X32, BLOCK_32X16}, {BLOCK_16X32, BLOCK_16X16}},
    {{BLOCK_32X64, BLOCK_32X32}, {BLOCK_INVALID, BLOCK_16X32}},
    {{BLOCK_64X32, BLOCK_INVALID}, {BLOCK_32X32, BLOCK_32X16}},
    {{BLOCK_64X64, BLOCK_64X32}, {BLOCK_32X64, BLOCK_32X32}},
    {{BLOCK_64X128, BLOCK_64X64}, {BLOCK_INVALID, BLOCK_32X64}},
    {{BLOCK_128X64, BLOCK_INVALID}, {BLOCK_64X64, BLOCK_64X32}},
    {{BLOCK_128X128, BLOCK_128X64}, {BLOCK_64X128, BLOCK_64X64}},
    {{BLOCK_4X16, BLOCK_4X8}, {BLOCK_INVALID, BLOCK_4X8}},
    {{BLOCK_16X4, BLOCK_INVALID}, {BLOCK_8X4, BLOCK_8X4}},
    {{BLOCK_8X32, BLOCK_8X16}, {BLOCK_INVALID, BLOCK_4X16}},
    {{BLOCK_32X8, BLOCK_INVALID}, {BLOCK_16X8, BLOCK_16X4}},
    {{BLOCK_16X64, BLOCK_16X32}, {BLOCK_INVALID, BLOCK_8X32}},
    {{BLOCK_64X16, BLOCK_INVALID}, {BLOCK_32X16, BLOCK_32X8}},
};

enum {
  TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16,
  TX_16X8, TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16, TX_16X4,
  TX_8X32, TX_32X8, TX_16X64, TX_64X16
};
const uint8_t kTxW[19] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64};
const uint8_t kTxH[19] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16};
const uint8_t kTxWLog2[19] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6};
const uint8_t kTxHLog2[19] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4};
const uint8_t kTxSqr[19] = {0, 1, 2, 3, 4, 0, 0, 1, 1, 2, 2, 3, 3, 0, 0, 1, 1, 2, 2};
const uint8_t kTxSqrUp[19] = {0, 1, 2, 3, 4, 1, 1, 2, 2, 3, 3, 4, 4, 2, 2, 3, 3, 4, 4};
const uint8_t kSplitTx[19] = {TX_4X4, TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_4X4, TX_4X4,
                              TX_8X8, TX_8X8, TX_16X16, TX_16X16, TX_32X32, TX_32X32,
                              TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32, TX_32X16};
const uint8_t kMaxTxRect[22] = {TX_4X4, TX_4X8, TX_8X4, TX_8X8, TX_8X16, TX_16X8, TX_16X16,
                                TX_16X32, TX_32X16, TX_32X32, TX_32X64, TX_64X32, TX_64X64,
                                TX_64X64, TX_64X64, TX_64X64, TX_4X16, TX_16X4, TX_8X32,
                                TX_32X8, TX_16X64, TX_64X16};
const uint8_t kMaxTxDepth[22] = {0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4, 2, 2, 3, 3, 4, 4};
// the coded (at most 32x32) part of each transform size
const uint8_t kAdjustedTx[19] = {TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_32X32, TX_4X8, TX_8X4,
                                 TX_8X16, TX_16X8, TX_16X32, TX_32X16, TX_32X32, TX_32X32,
                                 TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X32, TX_32X16};
const uint8_t kTxRowShift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};

enum {
  DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
  D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED,
  UV_CFL_PRED
};
enum {
  DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
  FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
  V_ADST, H_ADST, V_FLIPADST, H_FLIPADST
};
enum { PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
       PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B,
       PARTITION_HORZ_4, PARTITION_VERT_4 };
enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

const uint8_t kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
const uint8_t kFilterIntraDir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
const uint8_t kModeToTxfm[14] = {DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST,
                                 ADST_DCT, DCT_ADST, DCT_ADST, ADST_DCT, ADST_ADST,
                                 ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT};
const uint8_t kTxSet1Inv[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const uint8_t kTxSet2Inv[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};

int subsize(int partition, int bsize) {
  // square sizes only: 8x8 .. 128x128
  static const uint8_t sq[6] = {BLOCK_4X4, BLOCK_8X8, BLOCK_16X16, BLOCK_32X32,
                                BLOCK_64X64, BLOCK_128X128};
  static const uint8_t horz[6] = {BLOCK_INVALID, BLOCK_8X4, BLOCK_16X8, BLOCK_32X16,
                                  BLOCK_64X32, BLOCK_128X64};
  static const uint8_t vert[6] = {BLOCK_INVALID, BLOCK_4X8, BLOCK_8X16, BLOCK_16X32,
                                  BLOCK_32X64, BLOCK_64X128};
  static const uint8_t horz4[6] = {BLOCK_INVALID, BLOCK_INVALID, BLOCK_16X4, BLOCK_32X8,
                                   BLOCK_64X16, BLOCK_INVALID};
  static const uint8_t vert4[6] = {BLOCK_INVALID, BLOCK_INVALID, BLOCK_4X16, BLOCK_8X32,
                                   BLOCK_16X64, BLOCK_INVALID};
  int i = 0;
  while (i < 6 && sq[i] != bsize) i++;
  if (i == 6) return BLOCK_INVALID;
  switch (partition) {
    case PARTITION_NONE: return bsize;
    case PARTITION_HORZ: case PARTITION_HORZ_A: case PARTITION_HORZ_B: return horz[i];
    case PARTITION_VERT: case PARTITION_VERT_A: case PARTITION_VERT_B: return vert[i];
    case PARTITION_SPLIT: return i ? sq[i - 1] : BLOCK_INVALID;
    case PARTITION_HORZ_4: return horz4[i];
    case PARTITION_VERT_4: return vert4[i];
  }
  return BLOCK_INVALID;
}

// ------------------------------------------------------------ bits

struct BitReader {
  const uint8_t* d;
  int64_t n;
  int64_t pos = 0;  // in bits
  BitReader(const uint8_t* data, int64_t size) : d(data), n(size) {}
  int bit() {
    if ((pos >> 3) >= n) corrupt("AVIF: the AV1 data ends inside a header");
    const int b = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  uint32_t f(int bits) {
    uint32_t x = 0;
    for (int i = 0; i < bits; i++) x = (x << 1) | bit();
    return x;
  }
  int su(int bits) {
    int v = static_cast<int>(f(bits));
    const int sign = 1 << (bits - 1);
    if (v & sign) v -= 2 * sign;
    return v;
  }
  uint32_t ns(uint32_t nv) {
    const int w = floor_log2(nv) + 1;
    const uint32_t m = (1u << w) - nv;
    const uint32_t v = f(w - 1);
    if (v < m) return v;
    return (v << 1) - m + f(1);
  }
  uint64_t leb128() {
    uint64_t value = 0;
    for (int i = 0; i < 8; i++) {
      const uint32_t byte = f(8);
      value |= static_cast<uint64_t>(byte & 0x7f) << (i * 7);
      if (!(byte & 0x80)) return value;
    }
    return value;
  }
  uint32_t uvlc() {
    int zeros = 0;
    while (!bit()) {
      if (++zeros >= 32) return 0xFFFFFFFFu;
    }
    if (zeros >= 32) return 0xFFFFFFFFu;
    return f(zeros) + ((1u << zeros) - 1);
  }
  void byte_align() { pos = (pos + 7) & ~int64_t(7); }
};

// ------------------------------------------------------------ headers

struct SequenceHeader {
  int profile = 0, still = 0, reduced = 0;
  int decoder_model_info = 0, equal_picture_interval = 0;
  int buffer_removal_time_length = 0, frame_presentation_time_length = 0;
  int op_count = 1;
  int op_idc[32] = {0};
  int decoder_model_present[32] = {0};
  int frame_width_bits = 0, frame_height_bits = 0;
  int max_w = 0, max_h = 0;
  int frame_id_numbers = 0, delta_frame_id_length = 0, frame_id_length = 0;
  int sb128 = 0, filter_intra = 0, intra_edge = 0;
  int order_hint_bits = 0;
  int force_screen_content = 2, force_integer_mv = 2;
  int superres = 0, cdef = 0, restoration = 0;
  ColorConfig color;
  int separate_uv_delta_q = 0;
  int film_grain = 0;
  bool seen = false;
};

void parse_sequence_header(BitReader& b, SequenceHeader& s) {
  s = SequenceHeader();
  s.profile = static_cast<int>(b.f(3));
  if (s.profile > 2) corrupt("AVIF: AV1 sequence header: profile above 2");
  s.still = b.bit();
  s.reduced = b.bit();
  if (s.reduced && !s.still) corrupt("AVIF: AV1 sequence header: a reduced header of a sequence");
  if (s.reduced) {
    b.f(5);  // seq_level_idx[0]
  } else {
    const int timing = b.bit();
    if (timing) {
      b.f(32);
      b.f(32);
      s.equal_picture_interval = b.bit();
      if (s.equal_picture_interval && b.uvlc() == 0xFFFFFFFFu)
        corrupt("AVIF: AV1 sequence header: bad num_ticks_per_picture");
      s.decoder_model_info = b.bit();
      if (s.decoder_model_info) {
        s.buffer_removal_time_length = 0;
        const int delay_length = static_cast<int>(b.f(5)) + 1;
        b.f(32);
        s.buffer_removal_time_length = static_cast<int>(b.f(5)) + 1;
        s.frame_presentation_time_length = static_cast<int>(b.f(5)) + 1;
        s.frame_id_length = delay_length;  // (kept below as delay bits)
      }
    }
    const int delay_bits = s.frame_id_length;
    s.frame_id_length = 0;
    const int initial_display_delay = b.bit();
    s.op_count = static_cast<int>(b.f(5)) + 1;
    for (int i = 0; i < s.op_count; i++) {
      s.op_idc[i] = static_cast<int>(b.f(12));
      // (dav1d: an operating point of layers needs a temporal and a
      // spatial one)
      if (s.op_idc[i] && (!(s.op_idc[i] & 0xff) || !(s.op_idc[i] & 0xf00)))
        corrupt("AVIF: AV1 sequence header: a bad operating point");
      const int level = static_cast<int>(b.f(5));
      if (level > 7) b.f(1);
      if (s.decoder_model_info) {
        s.decoder_model_present[i] = b.bit();
        if (s.decoder_model_present[i]) {
          b.f(delay_bits);
          b.f(delay_bits);
          b.f(1);
        }
      }
      if (initial_display_delay && b.bit()) b.f(4);
    }
  }
  s.frame_width_bits = static_cast<int>(b.f(4)) + 1;
  s.frame_height_bits = static_cast<int>(b.f(4)) + 1;
  s.max_w = static_cast<int>(b.f(s.frame_width_bits)) + 1;
  s.max_h = static_cast<int>(b.f(s.frame_height_bits)) + 1;
  if (!s.reduced) s.frame_id_numbers = b.bit();
  if (s.frame_id_numbers) {
    s.delta_frame_id_length = static_cast<int>(b.f(4)) + 2;
    s.frame_id_length = static_cast<int>(b.f(3)) + s.delta_frame_id_length + 1;
  }
  s.sb128 = b.bit();
  s.filter_intra = b.bit();
  s.intra_edge = b.bit();
  if (!s.reduced) {
    b.f(4);  // interintra, masked, warped, dual filter
    const int order_hint = b.bit();
    if (order_hint) b.f(2);  // jnt_comp, ref_frame_mvs
    if (b.bit()) {
      s.force_screen_content = 2;
    } else {
      s.force_screen_content = b.bit();
    }
    if (s.force_screen_content > 0) {
      if (b.bit()) s.force_integer_mv = 2;
      else s.force_integer_mv = b.bit();
    } else {
      s.force_integer_mv = 2;
    }
    if (order_hint) s.order_hint_bits = static_cast<int>(b.f(3)) + 1;
  }
  s.superres = b.bit();
  s.cdef = b.bit();
  s.restoration = b.bit();
  // color_config()
  ColorConfig& c = s.color;
  const int high = b.bit();
  c.bit_depth = 8;
  if (s.profile == 2 && high) c.bit_depth = b.bit() ? 12 : 10;
  else if (high) c.bit_depth = 10;
  c.mono = s.profile == 1 ? 0 : b.bit();
  if (b.bit()) {
    c.primaries = static_cast<int>(b.f(8));
    c.transfer = static_cast<int>(b.f(8));
    c.matrix = static_cast<int>(b.f(8));
  } else {
    c.primaries = c.transfer = c.matrix = 2;
  }
  if (c.mono) {
    c.full_range = b.bit();
    c.ss_x = c.ss_y = 1;
    c.chroma_sample_position = 0;
    s.separate_uv_delta_q = 0;
  } else {
    if (c.primaries == 1 && c.transfer == 13 && c.matrix == 0) {
      c.full_range = 1;
      c.ss_x = c.ss_y = 0;
      if (s.profile != 1 && !(s.profile == 2 && c.bit_depth == 12))
        corrupt("AVIF: AV1 sequence header: sRGB identity colour outside profile 1");
    } else {
      c.full_range = b.bit();
      if (s.profile == 0) {
        c.ss_x = c.ss_y = 1;
      } else if (s.profile == 1) {
        c.ss_x = c.ss_y = 0;
      } else if (c.bit_depth == 12) {
        c.ss_x = b.bit();
        c.ss_y = c.ss_x ? b.bit() : 0;
      } else {
        c.ss_x = 1;
        c.ss_y = 0;
      }
      if (c.ss_x && c.ss_y) c.chroma_sample_position = static_cast<int>(b.f(2));
    }
    s.separate_uv_delta_q = b.bit();
  }
  s.film_grain = b.bit();
  b.bit();  // the trailing one bit (within the OBU, as dav1d reads it)
  s.seen = true;
}

struct FrameHeader {
  int frame_type = 0, show_frame = 1, showable = 0, error_resilient = 1;
  int intra = 1;
  int disable_cdf_update = 0, allow_screen_content = 0, force_integer_mv = 0;
  int width = 0, height = 0, upscaled_width = 0;
  int use_superres = 0;
  int mi_cols = 0, mi_rows = 0;
  int allow_intrabc = 0;
  int disable_frame_end_update_cdf = 1;
  // tiles
  int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0;
  int mi_col_starts[65] = {0}, mi_row_starts[65] = {0};
  int context_update_tile_id = 0, tile_size_bytes = 4;
  // quantization
  int base_q_idx = 0;
  int dq_y_dc = 0, dq_u_dc = 0, dq_u_ac = 0, dq_v_dc = 0, dq_v_ac = 0;
  int using_qmatrix = 0, qm_y = 15, qm_u = 15, qm_v = 15;
  // segmentation
  int seg_enabled = 0;
  int feature_enabled[8][8] = {{0}};
  int feature_data[8][8] = {{0}};
  int seg_id_pre_skip = 0, last_active_seg_id = 0;
  // deltas
  int delta_q_present = 0, delta_q_res = 0;
  int delta_lf_present = 0, delta_lf_res = 0, delta_lf_multi = 0;
  int coded_lossless = 0, all_lossless = 0;
  int lossless[8] = {0};
  int seg_qm_level[3][8] = {{0}};
  // loop filter
  int lf_level[4] = {0, 0, 0, 0};
  int lf_sharpness = 0, lf_delta_enabled = 0;
  int lf_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1};
  int lf_mode_deltas[2] = {0, 0};
  // cdef
  int cdef_damping = 3, cdef_bits = 0;
  int cdef_y_pri[8] = {0}, cdef_y_sec[8] = {0}, cdef_uv_pri[8] = {0}, cdef_uv_sec[8] = {0};
  // loop restoration
  int lr_type[3] = {RESTORE_NONE, RESTORE_NONE, RESTORE_NONE};
  int lr_size[3] = {64, 64, 64};
  int uses_lr = 0;
  int tx_mode_select = 0, only_4x4 = 0;
  int reduced_tx_set = 0;
};

// ------------------------------------------------------------ symbols

struct SymbolDecoder {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t dif = 0;
  uint32_t rng = 0;
  int cnt = 0;
  bool no_update = false;
  int64_t bits = 0;      // the tile's data, in bits
  int64_t consumed = 0;  // the bits normalization has shifted out

  void refill() {
    int s = 64 - 9 - (cnt + 15);
    for (; s >= 0 && p < end; s -= 8, p++) {
      dif ^= static_cast<uint64_t>(p[0]) << s;
      cnt += 8;
    }
    if (p >= end) cnt = 0x4000;
  }
  void init(const uint8_t* d, int64_t n, bool disable_update) {
    p = d;
    end = d + n;
    dif = (uint64_t(1) << 63) - 1;
    rng = 0x8000;
    cnt = -15;
    no_update = disable_update;
    bits = n * 8;
    consumed = 0;
    refill();
  }
  // dav1d's check after each superblock row of a tile ("error out on
  // symbol decoder overread"): its msac count, the bits of the data not
  // yet shifted into the 15-bit window, at -15 or below
  bool overread() const { return bits - 15 - consumed <= -15; }
  void normalize(uint64_t d, uint32_t r) {
    const int s = 15 - floor_log2(r);
    consumed += s;
    cnt -= s;
    dif = ((d + 1) << s) - 1;
    rng = r << s;
    if (cnt < 0) refill();
  }
  // cdf: n cumulative values (32768 last) and the counter
  int read(uint16_t* cdf, int n) {
    const uint32_t c = static_cast<uint32_t>(dif >> 48);
    uint32_t u, v = rng;
    int ret = -1;
    do {
      u = v;
      ret++;
      v = ((rng >> 8) * (static_cast<uint32_t>(32768 - cdf[ret]) >> 6) >> 1) +
          4 * static_cast<uint32_t>(n - ret - 1);
    } while (c < v);
    normalize(dif - (static_cast<uint64_t>(v) << 48), u - v);
    if (!no_update) {
      const int rate = 3 + (cdf[n] > 15) + (cdf[n] > 31) + std::min(floor_log2(n), 2);
      int tmp = 0;
      for (int i = 0; i < n - 1; i++) {
        if (i == ret) tmp = 32768;
        if (tmp < cdf[i]) cdf[i] = static_cast<uint16_t>(cdf[i] - ((cdf[i] - tmp) >> rate));
        else cdf[i] = static_cast<uint16_t>(cdf[i] + ((tmp - cdf[i]) >> rate));
      }
      cdf[n] = static_cast<uint16_t>(cdf[n] + (cdf[n] < 32));
    }
    return ret;
  }
  // a symbol of a CDF that is not adapted
  int read_fixed(const uint16_t* cdf, int n) {
    uint16_t tmp[17];
    std::memcpy(tmp, cdf, sizeof(uint16_t) * (n + 1));
    const bool keep = no_update;
    no_update = true;
    const int r = read(tmp, n);
    no_update = keep;
    return r;
  }
  int bool_() {
    static const uint16_t half[3] = {16384, 32768, 0};
    return read_fixed(half, 2);
  }
  int literal(int bits) {
    int x = 0;
    for (int i = 0; i < bits; i++) x = 2 * x + bool_();
    return x;
  }
  int ns(int nv) {
    const int w = floor_log2(nv) + 1;
    const int m = (1 << w) - nv;
    const int v = literal(w - 1);
    if (v < m) return v;
    return (v << 1) - m + literal(1);
  }
};

// ------------------------------------------------------------ CDFs

struct Cdfs {
  uint16_t kf_y[5][5][14];
  uint16_t uv[2][13][15];
  uint16_t partition[20][11];
  uint16_t intra_tx[3][4][13][17];
  uint16_t pal_y_color[7][5][9], pal_uv_color[7][5][9];
  uint16_t txb_skip[5][13][3];
  uint16_t eob_extra[5][2][9][3];
  uint16_t dc_sign[2][3][3];
  uint16_t eob16[2][2][6], eob32[2][2][7], eob64[2][2][8], eob128[2][2][9];
  uint16_t eob256[2][2][10], eob512[2][2][11], eob1024[2][2][12];
  uint16_t base_eob[5][2][4][4];
  uint16_t base[5][2][42][5];
  uint16_t br[5][2][21][5];
  uint16_t angle[8][8];
  uint16_t tx_size[4][3][4];
  uint16_t delta_q[5], delta_lf_multi[4][5], delta_lf[5];
  uint16_t cfl_sign[9], cfl_alpha[6][17];
  uint16_t skip[3][3], intrabc[3], seg[3][9], filter_intra[22][3], filter_intra_mode[6];
  uint16_t restore_sw[4], wiener[3], sgrproj[3];
  uint16_t pal_y_size[7][8], pal_uv_size[7][8], pal_y_mode[7][3][3], pal_uv_mode[2][3];

  void init(int base_q_idx) {
    const int q = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1 : base_q_idx <= 120 ? 2 : 3;
#define COPY(dst, src) std::memcpy(dst, src, sizeof(dst))
    COPY(kf_y, kKfYModeCdf);
    COPY(uv, kUvModeCdf);
    COPY(partition, kPartitionCdf);
    COPY(intra_tx, kIntraTxTypeCdf);
    COPY(pal_y_color, kPaletteYColorCdf);
    COPY(pal_uv_color, kPaletteUvColorCdf);
    COPY(txb_skip, kTxbSkipCdf[q]);
    COPY(eob_extra, kEobExtraCdf[q]);
    COPY(dc_sign, kDcSignCdf[q]);
    COPY(eob16, kEobPt16Cdf[q]);
    COPY(eob32, kEobPt32Cdf[q]);
    COPY(eob64, kEobPt64Cdf[q]);
    COPY(eob128, kEobPt128Cdf[q]);
    COPY(eob256, kEobPt256Cdf[q]);
    COPY(eob512, kEobPt512Cdf[q]);
    COPY(eob1024, kEobPt1024Cdf[q]);
    COPY(base_eob, kCoeffBaseEobCdf[q]);
    COPY(base, kCoeffBaseCdf[q]);
    COPY(br, kCoeffBrCdf[q]);
    COPY(angle, kAngleDeltaCdf);
    COPY(tx_size, kTxSizeCdf);
    COPY(delta_q, kDeltaQCdf);
    COPY(delta_lf_multi, kDeltaLfMultiCdf);
    COPY(delta_lf, kDeltaLfCdf);
    COPY(cfl_sign, kCflSignCdf);
    COPY(cfl_alpha, kCflAlphaCdf);
    COPY(skip, kSkipCdf);
    COPY(intrabc, kIntrabcCdf);
    COPY(seg, kSegmentIdCdf);
    COPY(filter_intra, kFilterIntraCdf);
    COPY(filter_intra_mode, kFilterIntraModeCdf);
    COPY(restore_sw, kRestoreSwitchableCdf);
    COPY(wiener, kRestoreWienerCdf);
    COPY(sgrproj, kRestoreSgrprojCdf);
    COPY(pal_y_size, kPaletteYSizeCdf);
    COPY(pal_uv_size, kPaletteUvSizeCdf);
    COPY(pal_y_mode, kPaletteYModeCdf);
    COPY(pal_uv_mode, kPaletteUvModeCdf);
#undef COPY
  }
};

// ------------------------------------------------------------ transforms

inline int32_t clamp_bits(int64_t v, int bits) {
  const int64_t hi = (int64_t(1) << (bits - 1)) - 1;
  const int64_t lo = -(int64_t(1) << (bits - 1));
  return static_cast<int32_t>(v < lo ? lo : (v > hi ? hi : v));
}

inline int cos128(int angle) {
  const int a = angle & 255;
  if (a <= 64) return kCosPi[a];
  if (a <= 128) return -kCosPi[128 - a];
  if (a <= 192) return -kCosPi[a - 128];
  return kCosPi[256 - a];
}
inline int sin128(int angle) { return cos128(angle - 64); }

// the butterfly rotation B( a, b, angle, flip )
inline void bfly(int32_t* t, int a, int b, int angle, int flip) {
  const int64_t x = int64_t(t[a]) * cos128(angle) - int64_t(t[b]) * sin128(angle);
  const int64_t y = int64_t(t[a]) * sin128(angle) + int64_t(t[b]) * cos128(angle);
  t[a] = static_cast<int32_t>(round2_64(x, 12));
  t[b] = static_cast<int32_t>(round2_64(y, 12));
  if (flip) std::swap(t[a], t[b]);
}
// the Hadamard rotation H( a, b, flip, r )
inline void hada(int32_t* t, int a, int b, int flip, int r) {
  if (flip) std::swap(a, b);
  const int32_t x = t[a], y = t[b];
  t[a] = clamp_bits(int64_t(x) + y, r);
  t[b] = clamp_bits(int64_t(x) - y, r);
}

inline int brev(int bits, int x) {
  int r = 0;
  for (int i = 0; i < bits; i++) r |= ((x >> i) & 1) << (bits - 1 - i);
  return r;
}

// the inverse DCT of 2^n values (7.13.2.3)
void idct(int32_t* t, int n, int r) {
  const int n0 = 1 << n;
  int32_t c[64];
  std::memcpy(c, t, sizeof(int32_t) * n0);
  // brev(n, i) for n = 2..6
  static const struct Perm {
    uint8_t p[7][64];
    Perm() {
      for (int b = 2; b <= 6; b++)
        for (int i = 0; i < (1 << b); i++) p[b][i] = static_cast<uint8_t>(brev(b, i));
    }
  } perm;
  for (int i = 0; i < n0; i++) t[i] = c[perm.p[n][i]];
  if (n == 6)
    for (int i = 0; i < 16; i++) bfly(t, 32 + i, 63 - i, 63 - 4 * brev(4, i), 0);
  if (n >= 5)
    for (int i = 0; i < 8; i++) bfly(t, 16 + i, 31 - i, 6 + (brev(3, 7 - i) << 3), 0);
  if (n == 6)
    for (int i = 0; i < 16; i++) hada(t, 32 + i * 2, 33 + i * 2, i & 1, r);
  if (n >= 4)
    for (int i = 0; i < 4; i++) bfly(t, 8 + i, 15 - i, 12 + (brev(2, 3 - i) << 4), 0);
  if (n >= 5)
    for (int i = 0; i < 8; i++) hada(t, 16 + 2 * i, 17 + 2 * i, i & 1, r);
  if (n == 6)
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 2; j++) bfly(t, 62 - i * 4 - j, 33 + i * 4 + j, 60 - 16 * brev(2, i) + 64 * j, 1);
  if (n >= 3)
    for (int i = 0; i < 2; i++) bfly(t, 4 + i, 7 - i, 56 - 32 * i, 0);
  if (n >= 4)
    for (int i = 0; i < 4; i++) hada(t, 8 + 2 * i, 9 + 2 * i, i & 1, r);
  if (n >= 5)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++) bfly(t, 30 - 4 * i - j, 17 + 4 * i + j, 24 + (j << 6) + ((1 - i) << 5), 1);
  if (n == 6)
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 2; j++) hada(t, 32 + i * 4 + j, 35 + i * 4 - j, i & 1, r);
  for (int i = 0; i < 2; i++) bfly(t, 2 * i, 2 * i + 1, 32 + 16 * i, 1 - i);
  if (n >= 3)
    for (int i = 0; i < 2; i++) hada(t, 4 + 2 * i, 5 + 2 * i, i, r);
  if (n >= 4)
    for (int i = 0; i < 2; i++) bfly(t, 14 - i, 9 + i, 48 + 64 * i, 1);
  if (n >= 5)
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 2; j++) hada(t, 16 + 4 * i + j, 19 + 4 * i - j, i & 1, r);
  if (n == 6)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 4; j++) bfly(t, 61 - i * 8 - j, 34 + i * 8 + j, 56 - i * 32 + (j >> 1) * 64, 1);
  for (int i = 0; i < 2; i++) hada(t, i, 3 - i, 0, r);
  if (n >= 3) bfly(t, 6, 5, 32, 1);
  if (n >= 4)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 2; j++) hada(t, 8 + 4 * i + j, 11 + 4 * i - j, i, r);
  if (n >= 5)
    for (int i = 0; i < 4; i++) bfly(t, 29 - i, 18 + i, 48 + (i >> 1) * 64, 1);
  if (n == 6)
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) hada(t, 32 + 8 * i + j, 39 + 8 * i - j, i & 1, r);
  if (n >= 3)
    for (int i = 0; i < 4; i++) hada(t, i, 7 - i, 0, r);
  if (n >= 4)
    for (int i = 0; i < 2; i++) bfly(t, 13 - i, 10 + i, 32, 1);
  if (n >= 5)
    for (int i = 0; i < 2; i++)
      for (int j = 0; j < 4; j++) hada(t, 16 + 8 * i + j, 23 + 8 * i - j, i, r);
  if (n == 6)
    for (int i = 0; i < 8; i++) bfly(t, 59 - i, 36 + i, i < 4 ? 48 : 112, 1);
  if (n >= 4)
    for (int i = 0; i < 8; i++) hada(t, i, 15 - i, 0, r);
  if (n >= 5)
    for (int i = 0; i < 4; i++) bfly(t, 27 - i, 20 + i, 32, 1);
  if (n == 6) {
    for (int i = 0; i < 8; i++) hada(t, 32 + i, 47 - i, 0, r);
    for (int i = 0; i < 8; i++) hada(t, 48 + i, 63 - i, 1, r);
  }
  if (n >= 5)
    for (int i = 0; i < 16; i++) hada(t, i, 31 - i, 0, r);
  if (n == 6)
    for (int i = 0; i < 8; i++) bfly(t, 55 - i, 40 + i, 32, 1);
  if (n == 6)
    for (int i = 0; i < 32; i++) hada(t, i, 63 - i, 0, r);
}

// libaom's half_btf: round2(w0 * in0 + w1 * in1, 12)
inline int32_t hbtf(int w0, int32_t in0, int w1, int32_t in1) {
  return static_cast<int32_t>(round2_64(int64_t(w0) * in0 + int64_t(w1) * in1, 12));
}

void iadst4(int32_t* t) {
  const int64_t s1 = kSinPi[1], s2 = kSinPi[2], s3 = kSinPi[3], s4 = kSinPi[4];
  const int64_t x0 = t[0], x1 = t[1], x2 = t[2], x3 = t[3];
  int64_t a0 = s1 * x0, a1 = s2 * x0, a2 = s3 * x1, a3 = s4 * x2;
  const int64_t a4 = s1 * x2, a5 = s2 * x3, a6 = s4 * x3;
  const int64_t a7 = (x0 - x2) + x3;
  a0 = a0 + a3;
  a1 = a1 - a4;
  a3 = a2;
  a2 = s3 * a7;
  a0 = a0 + a5;
  a1 = a1 - a6;
  const int64_t o0 = a0 + a3, o1 = a1 + a3, o2 = a2;
  int64_t o3 = a0 + a1;
  o3 = o3 - a3;
  t[0] = static_cast<int32_t>(round2_64(o0, 12));
  t[1] = static_cast<int32_t>(round2_64(o1, 12));
  t[2] = static_cast<int32_t>(round2_64(o2, 12));
  t[3] = static_cast<int32_t>(round2_64(o3, 12));
}

// the inverse ADST of 8 or 16 values (libaom's av1_iadst8, av1_iadst16)
void iadst(int32_t* t, int n0, int r) {
  int32_t b[16], c[16];
  const int* cp = kCosPi;
  for (int i = 0; i < n0; i++) b[i] = t[(i & 1) ? i - 1 : n0 - 1 - i];
  // rotations of the input pairs
  const int step = 128 / n0, start = 32 / n0;
  for (int i = 0; i < n0 / 2; i++) {
    const int a = start + step * i;
    c[2 * i] = hbtf(cp[a], b[2 * i], cp[64 - a], b[2 * i + 1]);
    c[2 * i + 1] = hbtf(cp[64 - a], b[2 * i], -cp[a], b[2 * i + 1]);
  }
  const int h = n0 / 2;
  for (int i = 0; i < h; i++) {
    b[i] = clamp_bits(int64_t(c[i]) + c[i + h], r);
    b[i + h] = clamp_bits(int64_t(c[i]) - c[i + h], r);
  }
  if (n0 == 16) {
    for (int i = 0; i < 8; i++) c[i] = b[i];
    c[8] = hbtf(cp[8], b[8], cp[56], b[9]);
    c[9] = hbtf(cp[56], b[8], -cp[8], b[9]);
    c[10] = hbtf(cp[40], b[10], cp[24], b[11]);
    c[11] = hbtf(cp[24], b[10], -cp[40], b[11]);
    c[12] = hbtf(-cp[56], b[12], cp[8], b[13]);
    c[13] = hbtf(cp[8], b[12], cp[56], b[13]);
    c[14] = hbtf(-cp[24], b[14], cp[40], b[15]);
    c[15] = hbtf(cp[40], b[14], cp[24], b[15]);
    for (int g = 0; g < 16; g += 8)
      for (int i = 0; i < 4; i++) {
        b[g + i] = clamp_bits(int64_t(c[g + i]) + c[g + i + 4], r);
        b[g + i + 4] = clamp_bits(int64_t(c[g + i]) - c[g + i + 4], r);
      }
  }
  // rotations by 16/48 of each group of 8's upper half
  for (int i = 0; i < n0; i++) c[i] = b[i];
  for (int g = 0; g < n0; g += 8) {
    c[g + 4] = hbtf(cp[16], b[g + 4], cp[48], b[g + 5]);
    c[g + 5] = hbtf(cp[48], b[g + 4], -cp[16], b[g + 5]);
    c[g + 6] = hbtf(-cp[48], b[g + 6], cp[16], b[g + 7]);
    c[g + 7] = hbtf(cp[16], b[g + 6], cp[48], b[g + 7]);
  }
  for (int g = 0; g < n0; g += 4) {
    b[g] = clamp_bits(int64_t(c[g]) + c[g + 2], r);
    b[g + 1] = clamp_bits(int64_t(c[g + 1]) + c[g + 3], r);
    b[g + 2] = clamp_bits(int64_t(c[g]) - c[g + 2], r);
    b[g + 3] = clamp_bits(int64_t(c[g + 1]) - c[g + 3], r);
  }
  for (int i = 0; i < n0; i++) c[i] = b[i];
  for (int g = 0; g < n0; g += 4) {
    c[g + 2] = hbtf(cp[32], b[g + 2], cp[32], b[g + 3]);
    c[g + 3] = hbtf(cp[32], b[g + 2], -cp[32], b[g + 3]);
  }
  if (n0 == 8) {
    static const int8_t idx[8] = {0, 4, 6, 2, 3, 7, 5, 1};
    for (int i = 0; i < 8; i++) t[i] = (i & 1) ? -c[idx[i]] : c[idx[i]];
  } else {
    static const int8_t idx[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
    for (int i = 0; i < 16; i++) t[i] = (i & 1) ? -c[idx[i]] : c[idx[i]];
  }
}

void iidentity(int32_t* t, int n) {
  const int n0 = 1 << n;
  for (int i = 0; i < n0; i++) {
    const int64_t v = t[i];
    if (n == 2) t[i] = static_cast<int32_t>(round2_64(v * 5793, 12));
    else if (n == 3) t[i] = static_cast<int32_t>(v * 2);
    else if (n == 4) t[i] = static_cast<int32_t>(round2_64(v * 11586, 12));
    else t[i] = static_cast<int32_t>(v * 4);
  }
}

enum { KIND_DCT, KIND_ADST, KIND_FLIPADST, KIND_IDENTITY };
void tx_kinds(int type, int* vert, int* horz) {
  static const uint8_t v[16] = {KIND_DCT, KIND_ADST, KIND_DCT, KIND_ADST, KIND_FLIPADST, KIND_DCT,
                                KIND_FLIPADST, KIND_ADST, KIND_FLIPADST, KIND_IDENTITY, KIND_DCT,
                                KIND_IDENTITY, KIND_ADST, KIND_IDENTITY, KIND_FLIPADST, KIND_IDENTITY};
  static const uint8_t h[16] = {KIND_DCT, KIND_DCT, KIND_ADST, KIND_ADST, KIND_DCT, KIND_FLIPADST,
                                KIND_FLIPADST, KIND_FLIPADST, KIND_ADST, KIND_IDENTITY, KIND_IDENTITY,
                                KIND_DCT, KIND_IDENTITY, KIND_ADST, KIND_IDENTITY, KIND_FLIPADST};
  *vert = v[type];
  *horz = h[type];
}

void tx_1d(int32_t* t, int n, int kind, int r) {
  if (kind == KIND_DCT) idct(t, n, r);
  else if (kind == KIND_IDENTITY) iidentity(t, n);
  else if (n == 2) iadst4(t);
  else iadst(t, 1 << n, r);
}

// the 2D inverse transform (7.13.3) of coefficients [min(h, 32)][min(w,
// 32)] (row-major), added to dst
void inverse_transform_add(const int32_t* coef, int tx, int type, bool lossless,
                           uint8_t* dst, int stride, bool dc_only = false) {
  const int log2w = kTxWLog2[tx], log2h = kTxHLog2[tx];
  const int w = 1 << log2w, h = 1 << log2h;
  const int cw = std::min(w, 32), ch = std::min(h, 32);
  static thread_local int32_t res[64 * 64];
  int32_t t[64];
  if (lossless) {
    // the Walsh-Hadamard transform of 4x4
    for (int i = 0; i < 4; i++) {
      int32_t a = coef[i * 4 + 0] >> 2, c = coef[i * 4 + 1] >> 2;
      int32_t d = coef[i * 4 + 2] >> 2, b = coef[i * 4 + 3] >> 2;
      a += c;
      d -= b;
      const int32_t e = (a - d) >> 1;
      b = e - b;
      c = e - c;
      a -= b;
      d += c;
      res[i * 4 + 0] = a;
      res[i * 4 + 1] = b;
      res[i * 4 + 2] = c;
      res[i * 4 + 3] = d;
    }
    for (int j = 0; j < 4; j++) {
      int32_t a = res[0 * 4 + j], c = res[1 * 4 + j], d = res[2 * 4 + j], b = res[3 * 4 + j];
      a += c;
      d -= b;
      const int32_t e = (a - d) >> 1;
      b = e - b;
      c = e - c;
      a -= b;
      d += c;
      dst[0 * stride + j] = clip1(dst[0 * stride + j] + a);
      dst[1 * stride + j] = clip1(dst[1 * stride + j] + b);
      dst[2 * stride + j] = clip1(dst[2 * stride + j] + c);
      dst[3 * stride + j] = clip1(dst[3 * stride + j] + d);
    }
    return;
  }
  int vk, hk;
  tx_kinds(type, &vk, &hk);
  const int row_shift = kTxRowShift[tx];
  const int row_clamp = 8 + 8, col_clamp = 16;
  const bool rect = std::abs(log2w - log2h) == 1;
  if (type == DCT_DCT && dc_only) {
    // the DC alone: its row's DCT is one value, so is every column's
    // input and output (the general path's values)
    for (int j = 0; j < w; j++) t[j] = 0;
    int64_t v = coef[0];
    if (rect) v = round2_64(v * 2896, 12);
    t[0] = clamp_bits(v, row_clamp);
    idct(t, log2w, row_clamp);
    const int32_t r0 = round2(t[0], row_shift);
    for (int i = 0; i < h; i++) t[i] = 0;
    t[0] = clamp_bits(r0, col_clamp);
    idct(t, log2h, col_clamp);
    for (int i = 0; i < h; i++) {
      const int d = round2(t[i], 4);
      uint8_t* row = dst + i * stride;
      for (int j = 0; j < w; j++) row[j] = clip1(row[j] + d);
    }
    return;
  }
  for (int i = 0; i < h; i++) {
    if (i >= ch) {
      for (int j = 0; j < w; j++) res[i * w + j] = 0;
      continue;
    }
    bool any = false;
    for (int j = 0; j < w; j++) {
      int64_t v = j < cw ? coef[i * cw + j] : 0;
      if (rect) v = round2_64(v * 2896, 12);
      t[j] = clamp_bits(v, row_clamp);
      any |= t[j] != 0;
    }
    if (!any) {
      for (int j = 0; j < w; j++) res[i * w + j] = 0;
      continue;
    }
    tx_1d(t, log2w, hk == KIND_FLIPADST ? KIND_ADST : hk, row_clamp);
    for (int j = 0; j < w; j++) res[i * w + j] = round2(t[j], row_shift);
  }
  const bool flip_lr = hk == KIND_FLIPADST, flip_ud = vk == KIND_FLIPADST;
  for (int j = 0; j < w; j++) {
    const int src = flip_lr ? w - 1 - j : j;
    for (int i = 0; i < h; i++) t[i] = clamp_bits(res[i * w + src], col_clamp);
    tx_1d(t, log2h, vk == KIND_FLIPADST ? KIND_ADST : vk, col_clamp);
    for (int i = 0; i < h; i++) {
      const int v = round2(t[flip_ud ? h - 1 - i : i], 4);
      uint8_t& px = dst[i * stride + j];
      px = clip1(px + v);
    }
  }
}

// ------------------------------------------------------------ the decoder

struct LrUnit {
  uint8_t type = RESTORE_NONE;
  int8_t wiener[2][3] = {{0}};
  uint8_t set = 0;
  int16_t xqd[2] = {0, 0};
};

struct Decoder {
  SequenceHeader seq;
  FrameHeader fh;
  int planes = 3;
  int ss_x = 1, ss_y = 1;

  // CurrFrame: each plane from (0, 0), padded to whole superblocks
  std::vector<uint8_t> cur[3];
  int pstride[3] = {0, 0, 0}, prows[3] = {0, 0, 0};
  uint8_t* px(int plane, int x, int y) { return &cur[plane][size_t(y) * pstride[plane] + x]; }

  // per 4x4 (mode info) unit of the frame
  int mi_stride = 0, mi_alloc_rows = 0;
  std::vector<uint8_t> mi_sizes, y_modes, uv_modes, skips, seg_ids, tx_sizes;
  std::vector<uint8_t> pal_sizes[2], pal_colors[2];
  std::vector<int8_t> delta_lfs;
  std::vector<uint8_t> lf_tx[3];  // LoopfilterTxSizes, per 4x4 of each plane
  std::vector<int8_t> cdef_idx;   // per 64x64
  int cdef_stride = 0;
  std::vector<LrUnit> lr[3];
  int lr_cols[3] = {0, 0, 0}, lr_rows[3] = {0, 0, 0};

  // entropy contexts
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
  Cdfs frame_cdfs, cdf;
  SymbolDecoder sd;

  // the tile
  int mi_row_start = 0, mi_row_end = 0, mi_col_start = 0, mi_col_end = 0;
  int current_q = 0;
  int delta_lf[4] = {0, 0, 0, 0};
  int read_deltas = 0;
  int ref_sgr_xqd[3][2];
  int ref_wiener[3][2][3];
  uint8_t block_decoded[3][35][35];  // [plane][y + 1][x + 1]

  // the block
  int mi_row = 0, mi_col = 0, mi_size = 0;
  int bw4 = 1, bh4 = 1;
  int has_chroma = 0, avail_u = 0, avail_l = 0, avail_u_chroma = 0, avail_l_chroma = 0;
  int skip = 0, segment_id = 0, lossless = 0;
  int y_mode = 0, uv_mode = 0, angle_delta_y = 0, angle_delta_uv = 0;
  int cfl_alpha_u = 0, cfl_alpha_v = 0;
  int use_filter_intra = 0, filter_intra_mode = 0;
  int pal_size_y = 0, pal_size_uv = 0;
  uint8_t pal_y[8], pal_u[8], pal_v[8];
  uint8_t color_map_y[64][64], color_map_uv[64][64];
  int tx_size = 0;
  int max_luma_w = 0, max_luma_h = 0;
  // the transform block
  int plane_tx_type = 0;
  int32_t quant[1024];
  std::vector<uint8_t> tx_type_map;  // TxTypes: per luma 4x4 of the frame

  // ------------------------------------------------------------ set-up

  bool is_inside(int r, int c) const {
    return c >= mi_col_start && c < mi_col_end && r >= mi_row_start && r < mi_row_end;
  }
  size_t mi(int r, int c) const { return size_t(r) * mi_stride + c; }

  void allocate() {
    const ColorConfig& cc = seq.color;
    planes = cc.mono ? 1 : 3;
    ss_x = cc.ss_x;
    ss_y = cc.ss_y;
    const int sb = seq.sb128 ? 32 : 16;
    mi_stride = (fh.mi_cols + sb - 1) / sb * sb + sb;
    mi_alloc_rows = (fh.mi_rows + sb - 1) / sb * sb + sb;
    const size_t n = size_t(mi_stride) * mi_alloc_rows;
    mi_sizes.assign(n, 0);
    y_modes.assign(n, 0);
    uv_modes.assign(n, 0);
    skips.assign(n, 0);
    seg_ids.assign(n, 0);
    tx_sizes.assign(n, 0);
    tx_type_map.assign(n, 0);
    for (int p = 0; p < 2; p++) {
      pal_sizes[p].assign(n, 0);
      pal_colors[p].assign(n * 8, 0);
    }
    delta_lfs.assign(n * 4, 0);
    for (int p = 0; p < planes; p++) {
      const int sx = p ? ss_x : 0, sy = p ? ss_y : 0;
      pstride[p] = (mi_stride * 4) >> sx;
      prows[p] = (mi_alloc_rows * 4) >> sy;
      cur[p].assign(size_t(pstride[p]) * prows[p], 0);
      lf_tx[p].assign(n, 0);
      above_level[p].assign(mi_stride + 32, 0);
      above_dc[p].assign(mi_stride + 32, 0);
      left_level[p].assign(mi_alloc_rows + 32, 0);
      left_dc[p].assign(mi_alloc_rows + 32, 0);
    }
    cdef_stride = (fh.mi_cols + 15) / 16 + 2;
    cdef_idx.assign(size_t(cdef_stride) * ((fh.mi_rows + 15) / 16 + 2), -1);
  }

  // ------------------------------------------------------------ tiles

  void decode_tile(const uint8_t* data, int64_t size, int tile_row, int tile_col) {
    mi_row_start = fh.mi_row_starts[tile_row];
    mi_row_end = fh.mi_row_starts[tile_row + 1];
    mi_col_start = fh.mi_col_starts[tile_col];
    mi_col_end = fh.mi_col_starts[tile_col + 1];
    current_q = fh.base_q_idx;
    cdf = frame_cdfs;
    sd.init(data, size, fh.disable_cdf_update != 0);
    // clear_above_context
    for (int p = 0; p < planes; p++) {
      std::fill(above_level[p].begin(), above_level[p].end(), 0);
      std::fill(above_dc[p].begin(), above_dc[p].end(), 0);
    }
    for (int i = 0; i < 4; i++) delta_lf[i] = 0;
    for (int p = 0; p < planes; p++) {
      ref_sgr_xqd[p][0] = -32;
      ref_sgr_xqd[p][1] = 31;
      for (int pass = 0; pass < 2; pass++) {
        ref_wiener[p][pass][0] = 3;
        ref_wiener[p][pass][1] = -7;
        ref_wiener[p][pass][2] = 15;
      }
    }
    const int sb_size = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    const int sb4 = kNum4x4W[sb_size];
    for (int r = mi_row_start; r < mi_row_end; r += sb4) {
      for (int p = 0; p < planes; p++) {
        std::fill(left_level[p].begin(), left_level[p].end(), 0);
        std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
      }
      for (int c = mi_col_start; c < mi_col_end; c += sb4) {
        read_deltas = fh.delta_q_present;
        clear_cdef(r, c);
        clear_block_decoded(r, c, sb4);
        read_lr(r, c, sb_size);
        decode_partition(r, c, sb_size);
      }
      if (sd.overread()) corrupt("AVIF: AV1 data: a tile's symbols read past its data");
    }
  }

  void clear_cdef(int r, int c) {
    cdef_at(r, c) = -1;
    if (seq.sb128) {
      cdef_at(r, c + 16) = -1;
      cdef_at(r + 16, c) = -1;
      cdef_at(r + 16, c + 16) = -1;
    }
  }
  int8_t& cdef_at(int r, int c) { return cdef_idx[size_t(r >> 4) * cdef_stride + (c >> 4)]; }

  void clear_block_decoded(int r, int c, int sb4) {
    for (int p = 0; p < planes; p++) {
      const int sx = p ? ss_x : 0, sy = p ? ss_y : 0;
      const int sbw4 = (mi_col_end - c) >> sx, sbh4 = (mi_row_end - r) >> sy;
      for (int y = -1; y <= (sb4 >> sy); y++)
        for (int x = -1; x <= (sb4 >> sx); x++) {
          uint8_t v;
          if (y < 0 && x < sbw4) v = 1;
          else if (x < 0 && y < sbh4) v = 1;
          else v = 0;
          block_decoded[p][y + 1][x + 1] = v;
        }
      block_decoded[p][(sb4 >> sy) + 1][0] = 0;
    }
  }

  // ------------------------------------------------------------ loop restoration units

  static int count_units(int unit, int size) { return std::max((size + (unit >> 1)) / unit, 1); }

  void read_lr(int r, int c, int bsize) {
    if (fh.allow_intrabc) return;
    const int w = kNum4x4W[bsize], h = kNum4x4H[bsize];
    for (int p = 0; p < planes; p++) {
      if (fh.lr_type[p] == RESTORE_NONE) continue;
      const int sx = p ? ss_x : 0, sy = p ? ss_y : 0;
      const int unit = fh.lr_size[p];
      const int rows = lr_rows[p], cols = lr_cols[p];
      const int row_start = (r * (4 >> sy) + unit - 1) / unit;
      const int row_end = std::min(rows, ((r + h) * (4 >> sy) + unit - 1) / unit);
      const int num = 4 >> sx, den = unit;
      const int col_start = (c * num + den - 1) / den;
      const int col_end = std::min(cols, ((c + w) * num + den - 1) / den);
      for (int ur = row_start; ur < row_end; ur++)
        for (int uc = col_start; uc < col_end; uc++) read_lr_unit(p, ur, uc);
    }
  }

  int decode_subexp(int num_syms, int k) {
    int i = 0, mk = 0;
    while (true) {
      const int b2 = i ? k + i - 1 : k;
      const int a = 1 << b2;
      if (num_syms <= mk + 3 * a) return sd.ns(num_syms - mk) + mk;
      if (sd.literal(1)) {
        i++;
        mk += a;
      } else {
        return sd.literal(b2) + mk;
      }
    }
  }
  static int inverse_recenter(int r, int v) {
    if (v > 2 * r) return v;
    if (v & 1) return r - ((v + 1) >> 1);
    return r + (v >> 1);
  }
  int decode_signed_subexp_with_ref(int low, int high, int k, int r) {
    const int mx = high - low;
    r -= low;
    const int v = decode_subexp(mx, k);
    const int x = (r << 1) <= mx ? inverse_recenter(r, v) : mx - 1 - inverse_recenter(mx - 1 - r, v);
    return x + low;
  }

  void read_lr_unit(int p, int ur, int uc) {
    LrUnit& u = lr[p][size_t(ur) * lr_cols[p] + uc];
    int type;
    if (fh.lr_type[p] == RESTORE_WIENER) {
      type = sd.read(cdf.wiener, 2) ? RESTORE_WIENER : RESTORE_NONE;
    } else if (fh.lr_type[p] == RESTORE_SGRPROJ) {
      type = sd.read(cdf.sgrproj, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
    } else {
      type = sd.read(cdf.restore_sw, 3);  // 0 none, 1 wiener, 2 sgrproj
    }
    u.type = static_cast<uint8_t>(type);
    static const int kMin[3] = {-5, -23, -17}, kMax[3] = {10, 8, 46}, kK[3] = {1, 2, 3};
    if (type == RESTORE_WIENER) {
      for (int pass = 0; pass < 2; pass++) {
        int first = 0;
        if (p) {
          first = 1;
          u.wiener[pass][0] = 0;
        }
        for (int j = first; j < 3; j++) {
          const int v = decode_signed_subexp_with_ref(kMin[j], kMax[j] + 1, kK[j], ref_wiener[p][pass][j]);
          u.wiener[pass][j] = static_cast<int8_t>(v);
          ref_wiener[p][pass][j] = v;
        }
      }
    } else if (type == RESTORE_SGRPROJ) {
      const int set = sd.literal(4);
      u.set = static_cast<uint8_t>(set);
      static const int xmin[2] = {-96, -32}, xmax[2] = {31, 95};
      for (int i = 0; i < 2; i++) {
        const int radius = kSgrParams[set][i];
        int v;
        if (radius) {
          v = decode_signed_subexp_with_ref(xmin[i], xmax[i] + 1, 4, ref_sgr_xqd[p][i]);
        } else {
          v = 0;
          if (i == 1) v = clip3(xmin[i], xmax[i], (1 << 7) - ref_sgr_xqd[p][0]);
        }
        u.xqd[i] = static_cast<int16_t>(v);
        ref_sgr_xqd[p][i] = v;
      }
    }
  }

  // ------------------------------------------------------------ partition

  void decode_partition(int r, int c, int bsize) {
    if (r >= fh.mi_rows || c >= fh.mi_cols) return;
    const int au = is_inside(r - 1, c), al = is_inside(r, c - 1);
    const int num4 = kNum4x4W[bsize];
    const int half = num4 >> 1, quarter = half >> 1;
    const bool has_rows = (r + half) < fh.mi_rows;
    const bool has_cols = (c + half) < fh.mi_cols;
    int partition;
    if (bsize < BLOCK_8X8) {
      partition = PARTITION_NONE;
    } else {
      const int bsl = kMiWLog2[bsize];
      const int above = au && kMiWLog2[mi_sizes[mi(r - 1, c)]] < bsl;
      const int left = al && kMiHLog2[mi_sizes[mi(r, c - 1)]] < bsl;
      const int ctx = left * 2 + above;
      uint16_t* pcdf = cdf.partition[(bsl - 1) * 4 + ctx];
      const int nsym = bsize == BLOCK_8X8 ? 4 : bsize == BLOCK_128X128 ? 8 : 10;
      auto prob = [&](int s) { return int(pcdf[s]) - (s ? int(pcdf[s - 1]) : 0); };
      if (has_rows && has_cols) {
        partition = sd.read(pcdf, nsym);
      } else if (has_cols) {
        int psum = prob(PARTITION_VERT) + prob(PARTITION_SPLIT);
        if (bsize != BLOCK_8X8) psum += prob(PARTITION_HORZ_A) + prob(PARTITION_VERT_A) + prob(PARTITION_VERT_B);
        if (bsize != BLOCK_8X8 && bsize != BLOCK_128X128) psum += prob(PARTITION_VERT_4);
        const uint16_t bin[3] = {static_cast<uint16_t>(32768 - psum), 32768, 0};
        partition = sd.read_fixed(bin, 2) ? PARTITION_SPLIT : PARTITION_HORZ;
      } else if (has_rows) {
        int psum = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT);
        if (bsize != BLOCK_8X8) psum += prob(PARTITION_HORZ_A) + prob(PARTITION_HORZ_B) + prob(PARTITION_VERT_A);
        if (bsize != BLOCK_8X8 && bsize != BLOCK_128X128) psum += prob(PARTITION_HORZ_4);
        const uint16_t bin[3] = {static_cast<uint16_t>(32768 - psum), 32768, 0};
        partition = sd.read_fixed(bin, 2) ? PARTITION_SPLIT : PARTITION_VERT;
      } else {
        partition = PARTITION_SPLIT;
      }
    }
    const int sub = subsize(partition, bsize);
    const int split = subsize(PARTITION_SPLIT, bsize);
    switch (partition) {
      case PARTITION_NONE: decode_block(r, c, sub); break;
      case PARTITION_HORZ:
        decode_block(r, c, sub);
        if (has_rows) decode_block(r + half, c, sub);
        break;
      case PARTITION_VERT:
        decode_block(r, c, sub);
        if (has_cols) decode_block(r, c + half, sub);
        break;
      case PARTITION_SPLIT:
        decode_partition(r, c, sub);
        decode_partition(r, c + half, sub);
        decode_partition(r + half, c, sub);
        decode_partition(r + half, c + half, sub);
        break;
      case PARTITION_HORZ_A:
        decode_block(r, c, split);
        decode_block(r, c + half, split);
        decode_block(r + half, c, sub);
        break;
      case PARTITION_HORZ_B:
        decode_block(r, c, sub);
        decode_block(r + half, c, split);
        decode_block(r + half, c + half, split);
        break;
      case PARTITION_VERT_A:
        decode_block(r, c, split);
        decode_block(r + half, c, split);
        decode_block(r, c + half, sub);
        break;
      case PARTITION_VERT_B:
        decode_block(r, c, sub);
        decode_block(r, c + half, split);
        decode_block(r + half, c + half, split);
        break;
      case PARTITION_HORZ_4:
        for (int i = 0; i < 4; i++)
          if (i == 0 || r + quarter * i < fh.mi_rows) decode_block(r + quarter * i, c, sub);
        break;
      case PARTITION_VERT_4:
        for (int i = 0; i < 4; i++)
          if (i == 0 || c + quarter * i < fh.mi_cols) decode_block(r, c + quarter * i, sub);
        break;
    }
  }

  // ------------------------------------------------------------ the block

  void decode_block(int r, int c, int bsize) {
    if (bsize == BLOCK_INVALID) corrupt("AVIF: AV1 data: an invalid block size");
    mi_row = r;
    mi_col = c;
    mi_size = bsize;
    bw4 = kNum4x4W[bsize];
    bh4 = kNum4x4H[bsize];
    if (bh4 == 1 && ss_y && (mi_row & 1) == 0) has_chroma = 0;
    else if (bw4 == 1 && ss_x && (mi_col & 1) == 0) has_chroma = 0;
    else has_chroma = planes > 1;
    avail_u = is_inside(r - 1, c);
    avail_l = is_inside(r, c - 1);
    avail_u_chroma = avail_u;
    avail_l_chroma = avail_l;
    if (has_chroma) {
      if (ss_y && bh4 == 1) avail_u_chroma = is_inside(r - 2, c);
      if (ss_x && bw4 == 1) avail_l_chroma = is_inside(r, c - 2);
    } else {
      avail_u_chroma = avail_l_chroma = 0;
    }
    if (has_chroma && kSubsampled[bsize][ss_x][ss_y] == BLOCK_INVALID)
      corrupt("AVIF: AV1 data: a block size the chroma subsampling does not allow");
    intra_frame_mode_info();
    palette_tokens();
    read_block_tx_size();
    if (skip) reset_block_context();
    // store the mode info
    const int rows = std::min(bh4, fh.mi_rows - r), cols = std::min(bw4, fh.mi_cols - c);
    for (int y = 0; y < rows; y++)
      for (int x = 0; x < cols; x++) {
        const size_t m = mi(r + y, c + x);
        mi_sizes[m] = static_cast<uint8_t>(bsize);
        y_modes[m] = static_cast<uint8_t>(y_mode);
        uv_modes[m] = static_cast<uint8_t>(uv_mode);
        skips[m] = static_cast<uint8_t>(skip);
        seg_ids[m] = static_cast<uint8_t>(segment_id);
        tx_sizes[m] = static_cast<uint8_t>(tx_size);
        pal_sizes[0][m] = static_cast<uint8_t>(pal_size_y);
        pal_sizes[1][m] = static_cast<uint8_t>(pal_size_uv);
        std::memcpy(&pal_colors[0][m * 8], pal_y, 8);
        std::memcpy(&pal_colors[1][m * 8], pal_u, 8);
        for (int i = 0; i < 4; i++) delta_lfs[m * 4 + i] = static_cast<int8_t>(delta_lf[i]);
      }
    residual();
  }

  void reset_block_context() {
    for (int p = 0; p < 1 + 2 * has_chroma; p++) {
      const int sx = p ? ss_x : 0, sy = p ? ss_y : 0;
      for (int i = mi_col >> sx; i < ((mi_col + bw4 - 1) >> sx) + 1; i++) {
        above_level[p][i] = 0;
        above_dc[p][i] = 0;
      }
      for (int i = mi_row >> sy; i < ((mi_row + bh4 - 1) >> sy) + 1; i++) {
        left_level[p][i] = 0;
        left_dc[p][i] = 0;
      }
    }
  }

  int get_qidx(int ignore_delta, int seg) const {
    if (fh.seg_enabled && fh.feature_enabled[seg][0]) {
      const int data = fh.feature_data[seg][0];
      int q = fh.base_q_idx + data;
      if (!ignore_delta && fh.delta_q_present) q = current_q + data;
      return clip3(0, 255, q);
    }
    if (!ignore_delta && fh.delta_q_present) return current_q;
    return fh.base_q_idx;
  }

  void intra_frame_mode_info() {
    skip = 0;
    if (fh.seg_id_pre_skip) intra_segment_id();
    // read_skip
    if (fh.seg_id_pre_skip && fh.seg_enabled && fh.feature_enabled[segment_id][6]) {
      skip = 1;
    } else {
      int ctx = 0;
      if (avail_u) ctx += skips[mi(mi_row - 1, mi_col)];
      if (avail_l) ctx += skips[mi(mi_row, mi_col - 1)];
      skip = sd.read(cdf.skip[ctx], 2);
    }
    if (!fh.seg_id_pre_skip) intra_segment_id();
    read_cdef();
    read_delta_qindex();
    read_delta_lf();
    read_deltas = 0;
    int use_intrabc = 0;
    if (fh.allow_intrabc) use_intrabc = sd.read(cdf.intrabc, 2);
    if (use_intrabc) refuse("AVIF: AV1 IntraBC (intra block copy), which the port does not decode");
    // intra_frame_y_mode
    const int above = avail_u ? y_modes[mi(mi_row - 1, mi_col)] : DC_PRED;
    const int left = avail_l ? y_modes[mi(mi_row, mi_col - 1)] : DC_PRED;
    y_mode = sd.read(cdf.kf_y[kIntraModeContext[above]][kIntraModeContext[left]], 13);
    angle_delta_y = 0;
    if (mi_size >= BLOCK_8X8 && y_mode >= V_PRED && y_mode <= D67_PRED)
      angle_delta_y = sd.read(cdf.angle[y_mode - V_PRED], 7) - 3;
    uv_mode = DC_PRED;
    angle_delta_uv = 0;
    cfl_alpha_u = cfl_alpha_v = 0;
    if (has_chroma) {
      int cfl_allowed;
      if (lossless && kSubsampled[mi_size][ss_x][ss_y] == BLOCK_4X4) cfl_allowed = 1;
      else if (!lossless && std::max(kNum4x4W[mi_size], kNum4x4H[mi_size]) * 4 <= 32) cfl_allowed = 1;
      else cfl_allowed = 0;
      uv_mode = sd.read(cdf.uv[cfl_allowed][y_mode], cfl_allowed ? 14 : 13);
      if (uv_mode == UV_CFL_PRED) read_cfl_alphas();
      if (mi_size >= BLOCK_8X8 && uv_mode >= V_PRED && uv_mode <= D67_PRED)
        angle_delta_uv = sd.read(cdf.angle[uv_mode - V_PRED], 7) - 3;
    }
    pal_size_y = pal_size_uv = 0;
    std::memset(pal_y, 0, 8);
    std::memset(pal_u, 0, 8);
    std::memset(pal_v, 0, 8);
    if (mi_size >= BLOCK_8X8 && bw4 <= 16 && bh4 <= 16 && fh.allow_screen_content) palette_mode_info();
    use_filter_intra = 0;
    if (seq.filter_intra && y_mode == DC_PRED && pal_size_y == 0 && std::max(bw4, bh4) <= 8) {
      use_filter_intra = sd.read(cdf.filter_intra[mi_size], 2);
      if (use_filter_intra) filter_intra_mode = sd.read(cdf.filter_intra_mode, 5);
    }
  }

  static int neg_deinterleave(int diff, int ref, int max) {
    if (!ref) return diff;
    if (ref >= max - 1) return max - diff - 1;
    if (2 * ref < max) {
      if (diff <= 2 * ref) {
        if (diff & 1) return ref + ((diff + 1) >> 1);
        return ref - (diff >> 1);
      }
      return diff;
    }
    if (diff <= 2 * (max - ref - 1)) {
      if (diff & 1) return ref + ((diff + 1) >> 1);
      return ref - (diff >> 1);
    }
    return max - (diff + 1);
  }

  void intra_segment_id() {
    if (fh.seg_enabled) {
      const int prev_ul = avail_u && avail_l ? seg_ids[mi(mi_row - 1, mi_col - 1)] : -1;
      const int prev_u = avail_u ? seg_ids[mi(mi_row - 1, mi_col)] : -1;
      const int prev_l = avail_l ? seg_ids[mi(mi_row, mi_col - 1)] : -1;
      int pred;
      if (prev_u == -1) pred = prev_l == -1 ? 0 : prev_l;
      else if (prev_l == -1) pred = prev_u;
      else pred = prev_ul == prev_u ? prev_u : prev_l;
      if (skip) {
        segment_id = pred;
      } else {
        int ctx;
        if (prev_ul < 0) ctx = 0;
        else if (prev_ul == prev_u && prev_ul == prev_l) ctx = 2;
        else if (prev_ul == prev_u || prev_ul == prev_l || prev_u == prev_l) ctx = 1;
        else ctx = 0;
        const int v = sd.read(cdf.seg[ctx], 8);
        segment_id = clip3(0, fh.last_active_seg_id, neg_deinterleave(v, pred, fh.last_active_seg_id + 1));
      }
    } else {
      segment_id = 0;
    }
    lossless = fh.lossless[segment_id];
  }

  void read_cdef() {
    if (skip || fh.coded_lossless || !seq.cdef || fh.allow_intrabc) return;
    const int r = mi_row & ~15, c = mi_col & ~15;
    if (cdef_at(r, c) == -1) {
      const int v = sd.literal(fh.cdef_bits);
      for (int y = r; y < r + bh4; y += 16)
        for (int x = c; x < c + bw4; x += 16) cdef_at(y, x) = static_cast<int8_t>(v);
      cdef_at(r, c) = static_cast<int8_t>(v);
    }
  }

  void read_delta_qindex() {
    const int sb_size = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_size == sb_size && skip) return;
    if (!read_deltas) return;
    int abs = sd.read(cdf.delta_q, 4);
    if (abs == 3) {
      const int rem = sd.literal(3) + 1;
      abs = sd.literal(rem) + (1 << rem) + 1;
    }
    if (abs) {
      const int sign = sd.literal(1);
      const int reduced = sign ? -abs : abs;
      current_q = clip3(1, 255, current_q + (reduced << fh.delta_q_res));
    }
  }

  void read_delta_lf() {
    const int sb_size = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_size == sb_size && skip) return;
    if (!read_deltas || !fh.delta_lf_present) return;
    const int count = fh.delta_lf_multi ? (planes > 1 ? 4 : 2) : 1;
    for (int i = 0; i < count; i++) {
      int abs = sd.read(fh.delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf, 4);
      if (abs == 3) {
        const int n = sd.literal(3) + 1;
        abs = sd.literal(n) + (1 << n) + 1;
      }
      if (abs) {
        const int sign = sd.literal(1);
        const int reduced = sign ? -abs : abs;
        delta_lf[i] = clip3(-63, 63, delta_lf[i] + (reduced << fh.delta_lf_res));
      }
    }
  }

  void read_cfl_alphas() {
    const int signs = sd.read(cdf.cfl_sign, 8);
    const int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
    if (sign_u) {
      const int a = sd.read(cdf.cfl_alpha[(sign_u - 1) * 3 + sign_v], 16) + 1;
      cfl_alpha_u = sign_u == 1 ? -a : a;
    } else {
      cfl_alpha_u = 0;
    }
    if (sign_v) {
      const int a = sd.read(cdf.cfl_alpha[(sign_v - 1) * 3 + sign_u], 16) + 1;
      cfl_alpha_v = sign_v == 1 ? -a : a;
    } else {
      cfl_alpha_v = 0;
    }
  }

  int palette_cache(int plane, uint8_t* cache) {
    int above_n = 0, left_n = 0;
    if ((mi_row * 4) % 64 && avail_u) above_n = pal_sizes[plane][mi(mi_row - 1, mi_col)];
    if (avail_l) left_n = pal_sizes[plane][mi(mi_row, mi_col - 1)];
    const uint8_t* above = above_n ? &pal_colors[plane][mi(mi_row - 1, mi_col) * 8] : nullptr;
    const uint8_t* left = left_n ? &pal_colors[plane][mi(mi_row, mi_col - 1) * 8] : nullptr;
    int ai = 0, li = 0, n = 0;
    while (ai < above_n && li < left_n) {
      const int a = above[ai], l = left[li];
      if (l < a) {
        if (n == 0 || l != cache[n - 1]) cache[n++] = static_cast<uint8_t>(l);
        li++;
      } else {
        if (n == 0 || a != cache[n - 1]) cache[n++] = static_cast<uint8_t>(a);
        ai++;
        if (l == a) li++;
      }
    }
    while (ai < above_n) {
      const int v = above[ai++];
      if (n == 0 || v != cache[n - 1]) cache[n++] = static_cast<uint8_t>(v);
    }
    while (li < left_n) {
      const int v = left[li++];
      if (n == 0 || v != cache[n - 1]) cache[n++] = static_cast<uint8_t>(v);
    }
    return n;
  }

  void palette_mode_info() {
    const int bsize_ctx = kMiWLog2[mi_size] + kMiHLog2[mi_size] - 2;
    const int bd = 8;
    if (y_mode == DC_PRED) {
      int ctx = 0;
      if (avail_u && pal_sizes[0][mi(mi_row - 1, mi_col)] > 0) ctx++;
      if (avail_l && pal_sizes[0][mi(mi_row, mi_col - 1)] > 0) ctx++;
      if (sd.read(cdf.pal_y_mode[bsize_ctx][ctx], 2)) {
        pal_size_y = sd.read(cdf.pal_y_size[bsize_ctx], 7) + 2;
        uint8_t cache[16];
        const int n = palette_cache(0, cache);
        int idx = 0;
        for (int i = 0; i < n && idx < pal_size_y; i++)
          if (sd.literal(1)) pal_y[idx++] = cache[i];
        if (idx < pal_size_y) pal_y[idx++] = static_cast<uint8_t>(sd.literal(bd));
        int bits = 0;
        if (idx < pal_size_y) bits = bd - 3 + sd.literal(2);
        while (idx < pal_size_y) {
          const int delta = sd.literal(bits) + 1;
          pal_y[idx] = clip1(pal_y[idx - 1] + delta);
          const int range = (1 << bd) - pal_y[idx] - 1;
          bits = std::min(bits, ceil_log2(range));
          idx++;
        }
        std::sort(pal_y, pal_y + pal_size_y);
      }
    }
    if (has_chroma && uv_mode == DC_PRED) {
      const int ctx = pal_size_y > 0;
      if (sd.read(cdf.pal_uv_mode[ctx], 2)) {
        pal_size_uv = sd.read(cdf.pal_uv_size[bsize_ctx], 7) + 2;
        uint8_t cache[16];
        const int n = palette_cache(1, cache);
        int idx = 0;
        for (int i = 0; i < n && idx < pal_size_uv; i++)
          if (sd.literal(1)) pal_u[idx++] = cache[i];
        if (idx < pal_size_uv) pal_u[idx++] = static_cast<uint8_t>(sd.literal(bd));
        int bits = 0;
        if (idx < pal_size_uv) bits = bd - 3 + sd.literal(2);
        while (idx < pal_size_uv) {
          const int delta = sd.literal(bits);
          pal_u[idx] = clip1(pal_u[idx - 1] + delta);
          const int range = (1 << bd) - pal_u[idx];
          bits = std::min(bits, ceil_log2(range));
          idx++;
        }
        std::sort(pal_u, pal_u + pal_size_uv);
        if (sd.literal(1)) {
          const int min_bits = bd - 4;
          const int max_val = 1 << bd;
          const int vbits = min_bits + sd.literal(2);
          pal_v[0] = static_cast<uint8_t>(sd.literal(bd));
          for (int i = 1; i < pal_size_uv; i++) {
            int delta = sd.literal(vbits);
            if (delta && sd.literal(1)) delta = -delta;
            int val = pal_v[i - 1] + delta;
            if (val < 0) val += max_val;
            if (val >= max_val) val -= max_val;
            pal_v[i] = clip1(val);
          }
        } else {
          for (int i = 0; i < pal_size_uv; i++) pal_v[i] = static_cast<uint8_t>(sd.literal(bd));
        }
      }
    }
  }

  void color_context(uint8_t (*map)[64], int r, int c, int n, uint8_t* order, int* hash) {
    int scores[8] = {0};
    for (int i = 0; i < 8; i++) order[i] = static_cast<uint8_t>(i);
    if (c > 0) scores[map[r][c - 1]] += 2;
    if (r > 0 && c > 0) scores[map[r - 1][c - 1]] += 1;
    if (r > 0) scores[map[r - 1][c]] += 2;
    for (int i = 0; i < 3; i++) {
      int max_score = scores[i], max_idx = i;
      for (int j = i + 1; j < n; j++)
        if (scores[j] > max_score) {
          max_score = scores[j];
          max_idx = j;
        }
      if (max_idx != i) {
        max_score = scores[max_idx];
        const uint8_t max_order = order[max_idx];
        for (int k = max_idx; k > i; k--) {
          scores[k] = scores[k - 1];
          order[k] = order[k - 1];
        }
        scores[i] = max_score;
        order[i] = max_order;
      }
    }
    *hash = scores[0] * 1 + scores[1] * 2 + scores[2] * 2;
  }

  void read_color_map(uint8_t (*map)[64], int n, int bw, int bh, int onw, int onh, bool uv) {
    map[0][0] = static_cast<uint8_t>(sd.ns(n));
    for (int i = 1; i < onh + onw - 1; i++) {
      for (int j = std::min(i, onw - 1); j >= std::max(0, i - onh + 1); j--) {
        uint8_t order[8];
        int hash;
        color_context(map, i - j, j, n, order, &hash);
        const int ctx = kPaletteColorContext[hash];
        if (ctx < 0) corrupt("AVIF: AV1 data: a bad palette colour context");
        uint16_t* c = uv ? cdf.pal_uv_color[n - 2][ctx] : cdf.pal_y_color[n - 2][ctx];
        map[i - j][j] = order[sd.read(c, n)];
      }
    }
    for (int i = 0; i < onh; i++)
      for (int j = onw; j < bw; j++) map[i][j] = map[i][onw - 1];
    for (int i = onh; i < bh; i++)
      for (int j = 0; j < bw; j++) map[i][j] = map[onh - 1][j];
  }

  void palette_tokens() {
    int bh = bh4 * 4, bw = bw4 * 4;
    int onh = std::min(bh, (fh.mi_rows - mi_row) * 4);
    int onw = std::min(bw, (fh.mi_cols - mi_col) * 4);
    if (pal_size_y) read_color_map(color_map_y, pal_size_y, bw, bh, onw, onh, false);
    if (pal_size_uv) {
      bh >>= ss_y;
      bw >>= ss_x;
      onh >>= ss_y;
      onw >>= ss_x;
      if (bw < 4) {
        bw += 2;
        onw += 2;
      }
      if (bh < 4) {
        bh += 2;
        onh += 2;
      }
      read_color_map(color_map_uv, pal_size_uv, bw, bh, onw, onh, true);
    }
  }

  void read_block_tx_size() {
    if (lossless) {
      tx_size = TX_4X4;
      return;
    }
    const int max_rect = kMaxTxRect[mi_size];
    tx_size = max_rect;
    if (mi_size > BLOCK_4X4 && fh.tx_mode_select) {
      const int max_w = kTxW[max_rect], max_h = kTxH[max_rect];
      const int above_w = avail_u ? kTxW[tx_sizes[mi(mi_row - 1, mi_col)]] : 0;
      const int left_h = avail_l ? kTxH[tx_sizes[mi(mi_row, mi_col - 1)]] : 0;
      const int ctx = (above_w >= max_w) + (left_h >= max_h);
      int depth_cat = 0;
      for (int t = max_rect; t != TX_4X4; t = kSplitTx[t]) depth_cat++;
      const int max_depth = kMaxTxDepth[mi_size];
      const int depth = sd.read(cdf.tx_size[depth_cat - 1][ctx], max_depth > 1 ? 3 : 2);
      for (int i = 0; i < depth; i++) tx_size = kSplitTx[tx_size];
    }
  }

  // ------------------------------------------------------------ residual

  int plane_tx_size(int plane) const {
    if (plane == 0) return tx_size;
    const int uv_tx = kMaxTxRect[kSubsampled[mi_size][ss_x][ss_y]];
    if (kTxW[uv_tx] == 64 || kTxH[uv_tx] == 64) {
      if (kTxW[uv_tx] == 16) return TX_16X32;
      if (kTxH[uv_tx] == 16) return TX_32X16;
      return TX_32X32;
    }
    return uv_tx;
  }

  void residual() {
    const int width_chunks = std::max(1, (bw4 * 4) >> 6);
    const int height_chunks = std::max(1, (bh4 * 4) >> 6);
    for (int cy = 0; cy < height_chunks; cy++)
      for (int cx = 0; cx < width_chunks; cx++) {
        for (int p = 0; p < 1 + has_chroma * 2; p++) {
          const int txs = lossless ? TX_4X4 : plane_tx_size(p);
          const int step_x = kTxW[txs] >> 2, step_y = kTxH[txs] >> 2;
          const int sx = p ? ss_x : 0, sy = p ? ss_y : 0;
          const int plane_sz = kSubsampled[mi_size][sx][sy];
          const int n4w = kNum4x4W[plane_sz], n4h = kNum4x4H[plane_sz];
          const int base_x = (mi_col >> sx) * 4, base_y = (mi_row >> sy) * 4;
          for (int y = 0; y < std::min(n4h, 16 >> sy); y += step_y)
            for (int x = 0; x < std::min(n4w, 16 >> sx); x += step_x)
              transform_block(p, base_x, base_y, txs, x + ((cx << 4) >> sx), y + ((cy << 4) >> sy));
        }
      }
  }

  void transform_block(int plane, int base_x, int base_y, int txs, int x, int y) {
    const int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
    const int sx = plane ? ss_x : 0, sy = plane ? ss_y : 0;
    const int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
    const int sb_mask = seq.sb128 ? 31 : 15;
    const int sub_row = row & sb_mask, sub_col = col & sb_mask;
    const int step_x = kTxW[txs] >> 2, step_y = kTxH[txs] >> 2;
    const int max_x = fh.mi_cols * 4 - 1, max_y = fh.mi_rows * 4 - 1;
    if (start_x >= (max_x >> sx) + 1 || start_y >= (max_y >> sy) + 1) return;
    const int bx = (sub_col >> sx) + 1, by = (sub_row >> sy) + 1;  // block_decoded index
    if ((plane == 0 && pal_size_y) || (plane != 0 && pal_size_uv)) {
      predict_palette(plane, start_x, start_y, x, y, txs);
    } else {
      const bool is_cfl = plane > 0 && uv_mode == UV_CFL_PRED;
      const int mode = plane == 0 ? y_mode : (is_cfl ? DC_PRED : uv_mode);
      const int have_left = (plane == 0 ? avail_l : avail_l_chroma) || x > 0;
      const int have_above = (plane == 0 ? avail_u : avail_u_chroma) || y > 0;
      const int above_rt = block_decoded[plane][by - 1][bx + step_x];
      const int below_lt = block_decoded[plane][by + step_y][bx - 1];
      predict_intra(plane, start_x, start_y, have_left, have_above, above_rt, below_lt, mode,
                    kTxWLog2[txs], kTxHLog2[txs]);
      if (is_cfl) predict_cfl(plane, start_x, start_y, txs);
    }
    if (plane == 0) {
      max_luma_w = start_x + step_x * 4;
      max_luma_h = start_y + step_y * 4;
    }
    if (!skip) {
      const int eob = coeffs(plane, start_x, start_y, txs);
      if (eob > 0) reconstruct(plane, start_x, start_y, txs, eob == 1);
    }
    for (int i = 0; i < step_y; i++)
      for (int j = 0; j < step_x; j++) {
        lf_tx[plane][size_t((row >> sy) + i) * mi_stride + (col >> sx) + j] = static_cast<uint8_t>(txs);
        if (by + i < 35 && bx + j < 35) block_decoded[plane][by + i][bx + j] = 1;
      }
  }

  int tx_set(int txs) const {
    if (kTxSqrUp[txs] > TX_32X32) return 0;
    if (kTxSqrUp[txs] == TX_32X32) return 0;
    if (fh.reduced_tx_set) return 2;
    if (kTxSqr[txs] == TX_16X16) return 2;
    return 1;
  }

  int compute_tx_type(int plane, int txs, int x4, int y4) const {
    if (lossless || kTxSqrUp[txs] > TX_32X32) return DCT_DCT;
    if (plane == 0) return tx_type_map[size_t(y4) * mi_stride + x4];
    const int set = tx_set(txs);
    const int t = kModeToTxfm[uv_mode];
    if (set == 0) return t == DCT_DCT ? t : DCT_DCT;
    if (set == 1) {
      for (int i = 0; i < 7; i++)
        if (kTxSet1Inv[i] == t) return t;
      return DCT_DCT;
    }
    for (int i = 0; i < 5; i++)
      if (kTxSet2Inv[i] == t) return t;
    return DCT_DCT;
  }

  const int16_t* scan_of(int txs) const {
    if (txs == TX_16X64) return kDefaultScan16x32;
    if (txs == TX_64X16) return kDefaultScan32x16;
    if (kTxSqrUp[txs] == TX_64X64) return kDefaultScan32x32;
    const int t = plane_tx_type;
    const bool row = t == V_DCT || t == V_ADST || t == V_FLIPADST;
    const bool colm = t == H_DCT || t == H_ADST || t == H_FLIPADST;
#define SCANS(kind)                                                                      \
  switch (txs) {                                                                         \
    case TX_4X4: return k##kind##Scan4x4;                                                \
    case TX_8X8: return k##kind##Scan8x8;                                                \
    case TX_16X16: return k##kind##Scan16x16;                                            \
    case TX_32X32: return k##kind##Scan32x32;                                            \
    case TX_4X8: return k##kind##Scan4x8;                                                \
    case TX_8X4: return k##kind##Scan8x4;                                                \
    case TX_8X16: return k##kind##Scan8x16;                                              \
    case TX_16X8: return k##kind##Scan16x8;                                              \
    case TX_16X32: return k##kind##Scan16x32;                                            \
    case TX_32X16: return k##kind##Scan32x16;                                            \
    case TX_4X16: return k##kind##Scan4x16;                                              \
    case TX_16X4: return k##kind##Scan16x4;                                              \
    case TX_8X32: return k##kind##Scan8x32;                                              \
    case TX_32X8: return k##kind##Scan32x8;                                              \
  }
    if (t != IDTX && row) { SCANS(Mrow) }
    if (t != IDTX && colm) { SCANS(Mcol) }
    SCANS(Default)
#undef SCANS
    return kDefaultScan4x4;
  }

  static int tx_class(int t) {
    if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return 2;  // vertical
    if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return 1;  // horizontal
    return 0;
  }

  void read_tx_type(int x4, int y4, int txs) {
    const int set = tx_set(txs);
    int t = DCT_DCT;
    const int qidx = fh.seg_enabled ? get_qidx(1, segment_id) : fh.base_q_idx;
    if (set > 0 && qidx > 0) {
      const int dir = use_filter_intra ? kFilterIntraDir[filter_intra_mode] : y_mode;
      const int sqr = kTxSqr[txs];
      if (set == 1) t = kTxSet1Inv[sd.read(cdf.intra_tx[1][sqr][dir], 7)];
      else t = kTxSet2Inv[sd.read(cdf.intra_tx[2][sqr][dir], 5)];
    }
    const int w4 = kTxW[txs] >> 2, h4 = kTxH[txs] >> 2;
    for (int j = 0; j < h4; j++)
      for (int i = 0; i < w4; i++)
        if (y4 + j < mi_alloc_rows && x4 + i < mi_stride)
          tx_type_map[size_t(y4 + j) * mi_stride + x4 + i] = static_cast<uint8_t>(t);
  }

  int coeffs(int plane, int start_x, int start_y, int txs) {
    const int x4 = start_x >> 2, y4 = start_y >> 2;
    const int w4 = kTxW[txs] >> 2, h4 = kTxH[txs] >> 2;
    const int tx_ctx = (kTxSqr[txs] + kTxSqrUp[txs] + 1) >> 1;
    const int ptype = plane > 0;
    const int seg_eob = (txs == TX_16X64 || txs == TX_64X16) ? 512 : std::min(1024, kTxW[txs] * kTxH[txs]);
    std::memset(quant, 0, sizeof(int32_t) * seg_eob);
    const int sx = plane ? ss_x : 0, sy = plane ? ss_y : 0;
    const int max_x4 = fh.mi_cols >> sx, max_y4 = fh.mi_rows >> sy;
    // all_zero's context
    int ctx;
    const int w = kTxW[txs], h = kTxH[txs];
    if (plane == 0) {
      int top = 0, left = 0;
      for (int k = 0; k < w4; k++)
        if (x4 + k < max_x4) top = std::max(top, int(above_level[plane][x4 + k]));
      for (int k = 0; k < h4; k++)
        if (y4 + k < max_y4) left = std::max(left, int(left_level[plane][y4 + k]));
      top = std::min(top, 255);
      left = std::min(left, 255);
      const int bsize = mi_size;
      if (kNum4x4W[bsize] * 4 == w && kNum4x4H[bsize] * 4 == h) ctx = 0;
      else if (top == 0 && left == 0) ctx = 1;
      else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
      else if (std::max(top, left) <= 3) ctx = 4;
      else if (std::min(top, left) <= 3) ctx = 5;
      else ctx = 6;
    } else {
      int above = 0, left = 0;
      for (int i = 0; i < w4; i++)
        if (x4 + i < max_x4) above |= above_level[plane][x4 + i] | above_dc[plane][x4 + i];
      for (int i = 0; i < h4; i++)
        if (y4 + i < max_y4) left |= left_level[plane][y4 + i] | left_dc[plane][y4 + i];
      ctx = (above != 0) + (left != 0) + 7;
      const int psz = kSubsampled[mi_size][ss_x][ss_y];
      if (kNum4x4W[psz] * kNum4x4H[psz] * 16 > w * h) ctx += 3;
    }
    int eob = 0, cul_level = 0, dc_category = 0;
    const int all_zero = sd.read(cdf.txb_skip[tx_ctx][ctx], 2);
    if (all_zero) {
      if (plane == 0)
        for (int j = 0; j < h4; j++)
          for (int i = 0; i < w4; i++)
            if (y4 + j < mi_alloc_rows && x4 + i < mi_stride)
              tx_type_map[size_t(y4 + j) * mi_stride + x4 + i] = DCT_DCT;
    } else {
      if (plane == 0) read_tx_type(x4, y4, txs);
      plane_tx_type = compute_tx_type(plane, txs, x4, y4);
      const int16_t* scan = scan_of(txs);
      const int cls = tx_class(plane_tx_type);
      const int eob_multisize = std::min<int>(kTxWLog2[txs], 5) + std::min<int>(kTxHLog2[txs], 5) - 4;
      const int ectx = cls == 0 ? 0 : 1;
      int eob_pt;
      switch (eob_multisize) {
        case 0: eob_pt = sd.read(cdf.eob16[ptype][ectx], 5) + 1; break;
        case 1: eob_pt = sd.read(cdf.eob32[ptype][ectx], 6) + 1; break;
        case 2: eob_pt = sd.read(cdf.eob64[ptype][ectx], 7) + 1; break;
        case 3: eob_pt = sd.read(cdf.eob128[ptype][ectx], 8) + 1; break;
        case 4: eob_pt = sd.read(cdf.eob256[ptype][ectx], 9) + 1; break;
        case 5: eob_pt = sd.read(cdf.eob512[ptype][0], 10) + 1; break;
        default: eob_pt = sd.read(cdf.eob1024[ptype][0], 11) + 1; break;
      }
      eob = eob_pt < 2 ? eob_pt : ((1 << (eob_pt - 2)) + 1);
      int eob_shift = eob_pt - 3;
      if (eob_shift >= 0) {
        if (sd.read(cdf.eob_extra[tx_ctx][ptype][eob_pt - 3], 2)) eob += 1 << eob_shift;
        for (int i = 1; i < std::max(0, eob_pt - 2); i++) {
          eob_shift = std::max(0, eob_pt - 2) - 1 - i;
          if (sd.literal(1)) eob += 1 << eob_shift;
        }
      }
      const int adj = kAdjustedTx[txs];
      const int bwl = kTxWLog2[adj];
      const int txw = kTxW[adj], txh = kTxH[adj];
      const int8_t(*offsets)[5] = kCoeffBaseCtxOffset[txs];
      static const int8_t kSigRef[3][5][2] = {
          {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
          {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
          {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
      static const int8_t kMagRef[3][3][2] = {
          {{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}}, {{0, 1}, {1, 0}, {2, 0}}};
      for (int c = eob - 1; c >= 0; c--) {
        const int pos = scan[c];
        const int row = pos >> bwl, col = pos - (row << bwl);
        int level;
        if (c == eob - 1) {
          int ectx2;
          if (c == 0) ectx2 = 0;
          else if (c <= (txh << bwl) / 8) ectx2 = 1;
          else if (c <= (txh << bwl) / 4) ectx2 = 2;
          else ectx2 = 3;
          level = sd.read(cdf.base_eob[tx_ctx][ptype][ectx2], 3) + 1;
        } else {
          int mag = 0;
          for (int k = 0; k < 5; k++) {
            const int rr = row + kSigRef[cls][k][0], cc = col + kSigRef[cls][k][1];
            if (rr < txh && cc < txw) mag += std::min(std::abs(quant[(rr << bwl) + cc]), 3);
          }
          int bctx = std::min((mag + 1) >> 1, 4);
          if (cls == 0) {
            if (row == 0 && col == 0) bctx = 0;
            else bctx += offsets[std::min(row, 4)][std::min(col, 4)];
          } else {
            const int idx = cls == 2 ? row : col;
            bctx += 26 + 5 * std::min(idx, 2);
          }
          level = sd.read(cdf.base[tx_ctx][ptype][bctx], 4);
        }
        if (level > 2) {
          int mag = 0;
          for (int k = 0; k < 3; k++) {
            const int rr = row + kMagRef[cls][k][0], cc = col + kMagRef[cls][k][1];
            if (rr < txh && cc < txw) mag += std::min(quant[(rr << bwl) + cc], 15);
          }
          mag = std::min((mag + 1) >> 1, 6);
          int brctx;
          if (pos == 0) brctx = mag;
          else if (cls == 0) brctx = (row < 2 && col < 2) ? mag + 7 : mag + 14;
          else if (cls == 1) brctx = col == 0 ? mag + 7 : mag + 14;
          else brctx = row == 0 ? mag + 7 : mag + 14;
          for (int idx = 0; idx < 4; idx++) {
            const int br = sd.read(cdf.br[std::min(tx_ctx, 3)][ptype][brctx], 4);
            level += br;
            if (br < 3) break;
          }
        }
        quant[pos] = level;
      }
      for (int c = 0; c < eob; c++) {
        const int pos = scan[c];
        int sign = 0;
        if (quant[pos] != 0) {
          if (c == 0) {
            int dc_sign = 0;
            for (int k = 0; k < w4; k++)
              if (x4 + k < max_x4) {
                const int s = above_dc[plane][x4 + k];
                if (s == 1) dc_sign--;
                else if (s == 2) dc_sign++;
              }
            for (int k = 0; k < h4; k++)
              if (y4 + k < max_y4) {
                const int s = left_dc[plane][y4 + k];
                if (s == 1) dc_sign--;
                else if (s == 2) dc_sign++;
              }
            const int dctx = dc_sign < 0 ? 1 : dc_sign > 0 ? 2 : 0;
            sign = sd.read(cdf.dc_sign[ptype][dctx], 2);
          } else {
            sign = sd.literal(1);
          }
        }
        if (quant[pos] > 14) {
          // the Golomb code, at most 32 leading zeros as dav1d reads it
          int zeros = 0;
          while (!sd.literal(1) && zeros < 32) zeros++;
          uint32_t x = 1;
          while (zeros--) x = (x << 1) + static_cast<uint32_t>(sd.literal(1));
          quant[pos] = static_cast<int32_t>((x + 14) & 0xFFFFF);
        }
        if (pos == 0 && quant[pos] > 0) dc_category = sign ? 1 : 2;
        quant[pos] &= 0xFFFFF;
        cul_level += quant[pos];
        if (sign) quant[pos] = -quant[pos];
      }
      cul_level = std::min(63, cul_level);
    }
    for (int i = 0; i < w4; i++) {
      above_level[plane][x4 + i] = static_cast<uint8_t>(cul_level);
      above_dc[plane][x4 + i] = static_cast<uint8_t>(dc_category);
    }
    for (int i = 0; i < h4; i++) {
      left_level[plane][y4 + i] = static_cast<uint8_t>(cul_level);
      left_dc[plane][y4 + i] = static_cast<uint8_t>(dc_category);
    }
    return eob;
  }

  int dc_q(int b) const { return kDcQLookup[clip3(0, 255, get_qidx(0, segment_id) + b)]; }
  int ac_q(int b) const { return kAcQLookup[clip3(0, 255, get_qidx(0, segment_id) + b)]; }

  void reconstruct(int plane, int start_x, int start_y, int txs, bool dc_only) {
    const int pels = kTxW[txs] * kTxH[txs];
    const int dq_shift = (pels > 256) + (pels > 1024);
    const int adj = kAdjustedTx[txs];
    const int tw = kTxW[adj], th = kTxH[adj];
    const int dcq = plane == 0 ? dc_q(fh.dq_y_dc) : plane == 1 ? dc_q(fh.dq_u_dc) : dc_q(fh.dq_v_dc);
    const int acq = plane == 0 ? ac_q(0) : plane == 1 ? ac_q(fh.dq_u_ac) : ac_q(fh.dq_v_ac);
    const int qm_level = (lossless || !fh.using_qmatrix) ? 15 : fh.seg_qm_level[plane][segment_id];
    const uint8_t* qm = nullptr;
    if (qm_level < 15 && plane_tx_type < IDTX) qm = quantizer_matrix(qm_level, plane > 0, adj);
    static thread_local int32_t dq[32 * 32];
    const int32_t lo = -(1 << 15), hi = (1 << 15) - 1;
    for (int i = 0; i < th; i++)
      for (int j = 0; j < tw; j++) {
        const int pos = i * tw + j;
        const int32_t q = quant[pos];
        if (!q) {
          dq[pos] = 0;
          continue;
        }
        int64_t qv = pos == 0 ? dcq : acq;
        if (qm) qv = round2_64(qv * qm[pos], 5);
        int64_t v = (int64_t(std::abs(q)) * qv) & 0xFFFFFF;
        v >>= dq_shift;
        if (q < 0) v = -v;
        dq[pos] = static_cast<int32_t>(v < lo ? lo : (v > hi ? hi : v));
      }
    inverse_transform_add(dq, txs, plane_tx_type, lossless != 0, px(plane, start_x, start_y),
                          pstride[plane], dc_only);
  }

  const uint8_t* quantizer_matrix(int level, int chroma, int adj_tx);

  // ------------------------------------------------------------ prediction

  void predict_palette(int plane, int start_x, int start_y, int x, int y, int txs) {
    const int w = kTxW[txs], h = kTxH[txs];
    const uint8_t* pal = plane == 0 ? pal_y : plane == 1 ? pal_u : pal_v;
    uint8_t(*map)[64] = plane == 0 ? color_map_y : color_map_uv;
    for (int i = 0; i < h; i++) {
      uint8_t* d = px(plane, start_x, start_y + i);
      for (int j = 0; j < w; j++) d[j] = pal[map[y * 4 + i][x * 4 + j]];
    }
  }

  int is_smooth(int row, int col, int plane) const {
    const int mode = plane == 0 ? y_modes[mi(row, col)] : uv_modes[mi(row, col)];
    return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED;
  }

  int filter_type(int plane) const {
    int above_smooth = 0, left_smooth = 0;
    if (plane == 0 ? avail_u : avail_u_chroma) {
      int r = mi_row - 1, c = mi_col;
      if (plane > 0) {
        if (ss_x && !(mi_col & 1)) c++;
        if (ss_y && (mi_row & 1)) r--;
      }
      above_smooth = is_smooth(r, c, plane);
    }
    if (plane == 0 ? avail_l : avail_l_chroma) {
      int r = mi_row, c = mi_col - 1;
      if (plane > 0) {
        if (ss_x && (mi_col & 1)) c--;
        if (ss_y && !(mi_row & 1)) r++;
      }
      left_smooth = is_smooth(r, c, plane);
    }
    return above_smooth || left_smooth;
  }

  static int edge_strength(int w, int h, int type, int delta) {
    const int d = std::abs(delta);
    const int wh = w + h;
    int s = 0;
    if (type == 0) {
      if (wh <= 8) {
        if (d >= 56) s = 1;
      } else if (wh <= 12) {
        if (d >= 40) s = 1;
      } else if (wh <= 16) {
        if (d >= 40) s = 1;
      } else if (wh <= 24) {
        if (d >= 8) s = 1;
        if (d >= 16) s = 2;
        if (d >= 32) s = 3;
      } else if (wh <= 32) {
        if (d >= 1) s = 1;
        if (d >= 4) s = 2;
        if (d >= 32) s = 3;
      } else {
        if (d >= 1) s = 3;
      }
    } else {
      if (wh <= 8) {
        if (d >= 40) s = 1;
        if (d >= 64) s = 2;
      } else if (wh <= 16) {
        if (d >= 20) s = 1;
        if (d >= 48) s = 2;
      } else if (wh <= 24) {
        if (d >= 4) s = 3;
      } else {
        if (d >= 1) s = 3;
      }
    }
    return s;
  }

  static int use_upsample(int w, int h, int type, int delta) {
    const int d = std::abs(delta);
    const int wh = w + h;
    if (d <= 0 || d >= 40) return 0;
    return type == 0 ? wh <= 16 : wh <= 8;
  }

  // buf points at index 0 of an edge whose index -1 exists
  static void filter_edge(int* buf, int sz, int strength) {
    if (!strength) return;
    static const int kernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
    int edge[300];
    for (int i = 0; i < sz; i++) edge[i] = buf[i - 1];
    for (int i = 1; i < sz; i++) {
      int s = 0;
      for (int j = 0; j < 5; j++) {
        const int k = clip3(0, sz - 1, i - 2 + j);
        s += kernel[strength - 1][j] * edge[k];
      }
      buf[i - 1] = (s + 8) >> 4;
    }
  }

  static void upsample_edge(int* buf, int num_px) {
    int dup[300];
    dup[0] = buf[-1];
    for (int i = -1; i < num_px; i++) dup[i + 2] = buf[i];
    dup[num_px + 2] = buf[num_px - 1];
    buf[-2] = dup[0];
    for (int i = 0; i < num_px; i++) {
      int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      s = clip1(round2(s, 4));
      buf[2 * i - 1] = s;
      buf[2 * i] = dup[i + 2];
    }
  }

  void predict_intra(int plane, int x, int y, int have_left, int have_above, int have_above_rt,
                     int have_below_lt, int mode, int log2w, int log2h) {
    const int w = 1 << log2w, h = 1 << log2h;
    const int sx = plane ? ss_x : 0, sy = plane ? ss_y : 0;
    const int max_x = ((fh.mi_cols * 4) >> sx) - 1, max_y = ((fh.mi_rows * 4) >> sy) - 1;
    int above_buf[320], left_buf[320];
    int* above = above_buf + 16;
    int* left = left_buf + 16;
    const int n = w + h;
    if (!have_above && have_left) {
      const int v = *px(plane, x - 1, y);
      for (int i = 0; i < n; i++) above[i] = v;
    } else if (!have_above && !have_left) {
      for (int i = 0; i < n; i++) above[i] = 127;
    } else {
      const int limit = std::min(max_x, x + (have_above_rt ? 2 * w : w) - 1);
      const uint8_t* row = px(plane, 0, y - 1);
      for (int i = 0; i < n; i++) above[i] = row[std::min(limit, x + i)];
    }
    if (!have_left && have_above) {
      const int v = *px(plane, x, y - 1);
      for (int i = 0; i < n; i++) left[i] = v;
    } else if (!have_left && !have_above) {
      for (int i = 0; i < n; i++) left[i] = 129;
    } else {
      const int limit = std::min(max_y, y + (have_below_lt ? 2 * h : h) - 1);
      for (int i = 0; i < n; i++) left[i] = *px(plane, x - 1, std::min(limit, y + i));
    }
    int corner;
    if (have_above && have_left) corner = *px(plane, x - 1, y - 1);
    else if (have_above) corner = *px(plane, x, y - 1);
    else if (have_left) corner = *px(plane, x - 1, y);
    else corner = 128;
    above[-1] = corner;
    left[-1] = corner;
    uint8_t* dst = px(plane, x, y);
    const int stride = pstride[plane];
    if (plane == 0 && use_filter_intra) {
      recursive_intra(dst, stride, above, left, w, h);
    } else if (mode >= V_PRED && mode <= D67_PRED) {
      directional(plane, dst, stride, above, left, w, h, x, y, max_x, max_y, have_left, have_above,
                  mode);
    } else if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
      const uint8_t* wx = kSmoothWeights + (w - 4);
      const uint8_t* wy = kSmoothWeights + (h - 4);
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          int v;
          if (mode == SMOOTH_PRED) {
            v = wy[i] * above[j] + (256 - wy[i]) * left[h - 1] + wx[j] * left[i] +
                (256 - wx[j]) * above[w - 1];
            v = round2(v, 9);
          } else if (mode == SMOOTH_V_PRED) {
            v = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
          } else {
            v = round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
          }
          dst[i * stride + j] = static_cast<uint8_t>(v);
        }
    } else if (mode == DC_PRED) {
      int avg;
      if (have_left && have_above) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += above[k];
        for (int k = 0; k < h; k++) sum += left[k];
        avg = (sum + ((w + h) >> 1)) / (w + h);
      } else if (have_left) {
        int sum = 0;
        for (int k = 0; k < h; k++) sum += left[k];
        avg = (sum + (h >> 1)) >> log2h;
      } else if (have_above) {
        int sum = 0;
        for (int k = 0; k < w; k++) sum += above[k];
        avg = (sum + (w >> 1)) >> log2w;
      } else {
        avg = 128;
      }
      for (int i = 0; i < h; i++) std::memset(dst + i * stride, avg, w);
    } else {  // PAETH
      for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++) {
          const int base = above[j] + left[i] - corner;
          const int pl = std::abs(base - left[i]), pt = std::abs(base - above[j]),
                    ptl = std::abs(base - corner);
          int v;
          if (pl <= pt && pl <= ptl) v = left[i];
          else if (pt <= ptl) v = above[j];
          else v = corner;
          dst[i * stride + j] = static_cast<uint8_t>(v);
        }
    }
  }

  void recursive_intra(uint8_t* dst, int stride, const int* above, const int* left, int w, int h) {
    const int w4 = w >> 2, h2 = h >> 1;
    for (int i2 = 0; i2 < h2; i2++)
      for (int j4 = 0; j4 < w4; j4++) {
        int p[7];
        for (int i = 0; i < 7; i++) {
          if (i < 5) {
            if (i2 == 0) p[i] = above[(j4 << 2) + i - 1];
            else if (j4 == 0 && i == 0) p[i] = left[(i2 << 1) - 1];
            else p[i] = dst[((i2 << 1) - 1) * stride + (j4 << 2) + i - 1];
          } else {
            if (j4 == 0) p[i] = left[(i2 << 1) + i - 5];
            else p[i] = dst[((i2 << 1) + i - 5) * stride + (j4 << 2) - 1];
          }
        }
        for (int i = 0; i < 8; i++) {
          int pr = 0;
          for (int j = 0; j < 7; j++) pr += kFilterIntraTaps[filter_intra_mode][i][j] * p[j];
          dst[((i2 << 1) + (i >> 2)) * stride + (j4 << 2) + (i & 3)] = clip1(round2signed(pr, 4));
        }
      }
  }

  void directional(int plane, uint8_t* dst, int stride, int* above, int* left, int w, int h, int x,
                   int y, int max_x, int max_y, int have_left, int have_above, int mode) {
    const int angle_delta = plane == 0 ? angle_delta_y : angle_delta_uv;
    const int p_angle = kModeToAngle[mode] + angle_delta * 3;
    int up_above = 0, up_left = 0;
    if (seq.intra_edge) {
      if (p_angle != 90 && p_angle != 180) {
        if (p_angle > 90 && p_angle < 180 && (w + h) >= 24) {
          const int v = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
          left[-1] = above[-1] = v;
        }
        const int type = filter_type(plane);
        if (have_above) {
          const int strength = edge_strength(w, h, type, p_angle - 90);
          const int num_px = std::min(w, max_x - x + 1) + (p_angle < 90 ? h : 0) + 1;
          filter_edge(above, num_px, strength);
        }
        if (have_left) {
          const int strength = edge_strength(w, h, type, p_angle - 180);
          const int num_px = std::min(h, max_y - y + 1) + (p_angle > 180 ? w : 0) + 1;
          filter_edge(left, num_px, strength);
        }
      }
      const int type = filter_type(plane);
      up_above = use_upsample(w, h, type, p_angle - 90);
      if (up_above) upsample_edge(above, w + (p_angle < 90 ? h : 0));
      up_left = use_upsample(w, h, type, p_angle - 180);
      if (up_left) upsample_edge(left, h + (p_angle > 180 ? w : 0));
    }
    int dx = 0, dy = 0;
    if (p_angle < 90) dx = kDrIntraDerivative[p_angle];
    else if (p_angle > 90 && p_angle < 180) dx = kDrIntraDerivative[180 - p_angle];
    if (p_angle > 90 && p_angle < 180) dy = kDrIntraDerivative[p_angle - 90];
    else if (p_angle > 180) dy = kDrIntraDerivative[270 - p_angle];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int v;
        if (p_angle < 90) {
          const int idx = (i + 1) * dx;
          const int base = (idx >> (6 - up_above)) + (j << up_above);
          const int shift = ((idx << up_above) >> 1) & 0x1F;
          const int max_base = (w + h - 1) << up_above;
          if (base < max_base) v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
          else v = above[max_base];
        } else if (p_angle > 90 && p_angle < 180) {
          const int idx = (j << 6) - (i + 1) * dx;
          const int base = idx >> (6 - up_above);
          if (base >= -(1 << up_above)) {
            const int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
            v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
          } else {
            const int idy = (i << 6) - (j + 1) * dy;
            const int b2 = idy >> (6 - up_left);
            const int shift = ((idy * (1 << up_left)) >> 1) & 0x1F;
            v = round2(left[b2] * (32 - shift) + left[b2 + 1] * shift, 5);
          }
        } else if (p_angle > 180) {
          const int idx = (j + 1) * dy;
          const int base = (idx >> (6 - up_left)) + (i << up_left);
          const int shift = ((idx << up_left) >> 1) & 0x1F;
          const int max_base = (w + h - 1) << up_left;
          if (base < max_base) v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
          else v = left[max_base];
        } else if (p_angle == 90) {
          v = above[j];
        } else {
          v = left[i];
        }
        dst[i * stride + j] = static_cast<uint8_t>(v);
      }
  }

  void predict_cfl(int plane, int start_x, int start_y, int txs) {
    const int w = kTxW[txs], h = kTxH[txs];
    const int alpha = plane == 1 ? cfl_alpha_u : cfl_alpha_v;
    static thread_local int lbuf[64 * 64];
    int sum = 0;
    for (int i = 0; i < h; i++) {
      const int luma_y = std::min((start_y + i) << ss_y, max_luma_h - (1 << ss_y));
      for (int j = 0; j < w; j++) {
        const int luma_x = std::min((start_x + j) << ss_x, max_luma_w - (1 << ss_x));
        int t = 0;
        for (int dy = 0; dy <= ss_y; dy++)
          for (int dx = 0; dx <= ss_x; dx++) t += *px(0, luma_x + dx, luma_y + dy);
        const int v = t << (3 - ss_x - ss_y);
        lbuf[i * w + j] = v;
        sum += v;
      }
    }
    const int avg = round2(sum, kTxWLog2[txs] + kTxHLog2[txs]);
    for (int i = 0; i < h; i++) {
      uint8_t* d = px(plane, start_x, start_y + i);
      for (int j = 0; j < w; j++) d[j] = clip1(d[j] + round2signed(alpha * (lbuf[i * w + j] - avg), 6));
    }
  }

  // ------------------------------------------------------------ frame header

  void parse_frame_header(BitReader& b) {
    fh = FrameHeader();
    if (seq.frame_id_numbers && seq.frame_id_length <= 0) corrupt("AVIF: AV1 data: bad frame id length");
    if (seq.reduced) {
      fh.frame_type = 0;
      fh.show_frame = 1;
    } else {
      if (b.bit()) refuse("AVIF: an AV1 shown existing frame first, which the port does not decode");
      fh.frame_type = static_cast<int>(b.f(2));
      fh.show_frame = b.bit();
      if (fh.show_frame && seq.decoder_model_info && !seq.equal_picture_interval)
        b.f(seq.frame_presentation_time_length);
      if (!fh.show_frame) refuse("AVIF: an AV1 frame that is not shown first, which the port does not decode");
      fh.error_resilient = (fh.frame_type == 3 || (fh.frame_type == 0 && fh.show_frame)) ? 1 : b.bit();
    }
    if (fh.frame_type != 0 && fh.frame_type != 2)
      refuse("AVIF: an AV1 inter frame first, which the port does not decode");
    fh.intra = 1;
    fh.disable_cdf_update = b.bit();
    if (seq.force_screen_content == 2) fh.allow_screen_content = b.bit();
    else fh.allow_screen_content = seq.force_screen_content;
    if (fh.allow_screen_content && seq.force_integer_mv == 2) b.bit();
    if (seq.frame_id_numbers) b.f(seq.frame_id_length);
    int size_override = 0;
    if (fh.frame_type == 3) size_override = 1;
    else if (!seq.reduced) size_override = b.bit();
    b.f(seq.order_hint_bits);
    if (!(fh.intra || fh.error_resilient)) b.f(3);
    if (seq.decoder_model_info) {
      if (b.bit()) {
        for (int op = 0; op < seq.op_count; op++)
          if (seq.decoder_model_present[op]) {
            const int idc = seq.op_idc[op];
            const int in_t = (idc >> 0) & 1, in_s = (idc >> 8) & 1;
            if (idc == 0 || (in_t && in_s)) b.f(seq.buffer_removal_time_length);
          }
      }
    }
    int refresh = 0xFF;
    if (!(fh.frame_type == 3 || (fh.frame_type == 0 && fh.show_frame))) refresh = static_cast<int>(b.f(8));
    if (refresh != 0xFF && fh.error_resilient && seq.order_hint_bits)
      for (int i = 0; i < 8; i++) b.f(seq.order_hint_bits);
    // frame_size()
    if (size_override) {
      fh.width = static_cast<int>(b.f(seq.frame_width_bits)) + 1;
      fh.height = static_cast<int>(b.f(seq.frame_height_bits)) + 1;
    } else {
      fh.width = seq.max_w;
      fh.height = seq.max_h;
    }
    fh.upscaled_width = fh.width;
    if (seq.superres && b.bit()) refuse("AVIF: AV1 superres, which the port does not decode");
    fh.mi_cols = 2 * ((fh.width + 7) >> 3);
    fh.mi_rows = 2 * ((fh.height + 7) >> 3);
    if (b.bit()) {  // render_and_frame_size_different
      b.f(16);
      b.f(16);
    }
    if (fh.allow_screen_content && fh.upscaled_width == fh.width) fh.allow_intrabc = b.bit();
    if (seq.reduced || fh.disable_cdf_update) fh.disable_frame_end_update_cdf = 1;
    else fh.disable_frame_end_update_cdf = b.bit();
    tile_info(b);
    // quantization_params()
    fh.base_q_idx = static_cast<int>(b.f(8));
    auto delta_q = [&]() { return b.bit() ? b.su(7) : 0; };
    fh.dq_y_dc = delta_q();
    if (!seq.color.mono) {
      const int diff_uv = seq.separate_uv_delta_q ? b.bit() : 0;
      fh.dq_u_dc = delta_q();
      fh.dq_u_ac = delta_q();
      if (diff_uv) {
        fh.dq_v_dc = delta_q();
        fh.dq_v_ac = delta_q();
      } else {
        fh.dq_v_dc = fh.dq_u_dc;
        fh.dq_v_ac = fh.dq_u_ac;
      }
    }
    fh.using_qmatrix = b.bit();
    if (fh.using_qmatrix) {
      fh.qm_y = static_cast<int>(b.f(4));
      fh.qm_u = static_cast<int>(b.f(4));
      fh.qm_v = seq.separate_uv_delta_q ? static_cast<int>(b.f(4)) : fh.qm_u;
    }
    // segmentation_params()
    fh.seg_enabled = b.bit();
    if (fh.seg_enabled) {
      static const int bits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
      static const int sgn[8] = {1, 1, 1, 1, 1, 0, 0, 0};
      static const int mx[8] = {255, 63, 63, 63, 63, 7, 0, 0};
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
          int value = 0;
          const int enabled = b.bit();
          fh.feature_enabled[i][j] = enabled;
          if (enabled) {
            if (sgn[j]) value = clip3(-mx[j], mx[j], b.su(1 + bits[j]));
            else value = clip3(0, mx[j], static_cast<int>(b.f(bits[j])));
          }
          fh.feature_data[i][j] = value;
        }
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++)
          if (fh.feature_enabled[i][j]) {
            fh.last_active_seg_id = i;
            if (j >= 5) fh.seg_id_pre_skip = 1;
          }
    }
    // delta_q_params(), delta_lf_params()
    if (fh.base_q_idx > 0) fh.delta_q_present = b.bit();
    if (fh.delta_q_present) fh.delta_q_res = static_cast<int>(b.f(2));
    if (fh.delta_q_present) {
      if (!fh.allow_intrabc) fh.delta_lf_present = b.bit();
      if (fh.delta_lf_present) {
        fh.delta_lf_res = static_cast<int>(b.f(2));
        fh.delta_lf_multi = b.bit();
      }
    }
    fh.coded_lossless = 1;
    for (int s = 0; s < 8; s++) {
      int q = fh.base_q_idx;
      if (fh.seg_enabled && fh.feature_enabled[s][0]) q = clip3(0, 255, q + fh.feature_data[s][0]);
      fh.lossless[s] = q == 0 && fh.dq_y_dc == 0 && fh.dq_u_ac == 0 && fh.dq_u_dc == 0 &&
                       fh.dq_v_ac == 0 && fh.dq_v_dc == 0;
      if (!fh.lossless[s]) fh.coded_lossless = 0;
      if (fh.using_qmatrix) {
        if (fh.lossless[s]) {
          fh.seg_qm_level[0][s] = fh.seg_qm_level[1][s] = fh.seg_qm_level[2][s] = 15;
        } else {
          fh.seg_qm_level[0][s] = fh.qm_y;
          fh.seg_qm_level[1][s] = fh.qm_u;
          fh.seg_qm_level[2][s] = fh.qm_v;
        }
      }
    }
    fh.all_lossless = fh.coded_lossless && fh.width == fh.upscaled_width;
    // loop_filter_params()
    if (!(fh.coded_lossless || fh.allow_intrabc)) {
      fh.lf_level[0] = static_cast<int>(b.f(6));
      fh.lf_level[1] = static_cast<int>(b.f(6));
      if (!seq.color.mono && (fh.lf_level[0] || fh.lf_level[1])) {
        fh.lf_level[2] = static_cast<int>(b.f(6));
        fh.lf_level[3] = static_cast<int>(b.f(6));
      }
      fh.lf_sharpness = static_cast<int>(b.f(3));
      fh.lf_delta_enabled = b.bit();
      if (fh.lf_delta_enabled && b.bit()) {
        for (int i = 0; i < 8; i++)
          if (b.bit()) fh.lf_ref_deltas[i] = b.su(7);
        for (int i = 0; i < 2; i++)
          if (b.bit()) fh.lf_mode_deltas[i] = b.su(7);
      }
    }
    // cdef_params()
    if (!(fh.coded_lossless || fh.allow_intrabc || !seq.cdef)) {
      fh.cdef_damping = static_cast<int>(b.f(2)) + 3;
      fh.cdef_bits = static_cast<int>(b.f(2));
      for (int i = 0; i < (1 << fh.cdef_bits); i++) {
        fh.cdef_y_pri[i] = static_cast<int>(b.f(4));
        fh.cdef_y_sec[i] = static_cast<int>(b.f(2));
        if (fh.cdef_y_sec[i] == 3) fh.cdef_y_sec[i]++;
        if (!seq.color.mono) {
          fh.cdef_uv_pri[i] = static_cast<int>(b.f(4));
          fh.cdef_uv_sec[i] = static_cast<int>(b.f(2));
          if (fh.cdef_uv_sec[i] == 3) fh.cdef_uv_sec[i]++;
        }
      }
    }
    // lr_params()
    if (!(fh.all_lossless || fh.allow_intrabc || !seq.restoration)) {
      static const int remap[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ};
      int uses_chroma = 0;
      for (int p = 0; p < (seq.color.mono ? 1 : 3); p++) {
        fh.lr_type[p] = remap[b.f(2)];
        if (fh.lr_type[p] != RESTORE_NONE) {
          fh.uses_lr = 1;
          if (p) uses_chroma = 1;
        }
      }
      if (fh.uses_lr) {
        int shift;
        if (seq.sb128) {
          shift = b.bit() + 1;
        } else {
          shift = b.bit();
          if (shift) shift += b.bit();
        }
        fh.lr_size[0] = 256 >> (2 - shift);
        const int uv_shift = (seq.color.ss_x && seq.color.ss_y && uses_chroma) ? b.bit() : 0;
        fh.lr_size[1] = fh.lr_size[2] = fh.lr_size[0] >> uv_shift;
      }
    }
    // read_tx_mode()
    if (fh.coded_lossless) fh.only_4x4 = 1;
    else fh.tx_mode_select = b.bit();
    fh.reduced_tx_set = b.bit();
    // film_grain_params()
    if (seq.film_grain && (fh.show_frame || fh.showable)) {
      if (b.bit()) refuse("AVIF: AV1 film grain, which the port does not synthesize");
    }
  }

  static int tile_log2(int blk, int target) {
    int k = 0;
    while ((blk << k) < target) k++;
    return k;
  }

  void tile_info(BitReader& b) {
    const int sb_cols = seq.sb128 ? (fh.mi_cols + 31) >> 5 : (fh.mi_cols + 15) >> 4;
    const int sb_rows = seq.sb128 ? (fh.mi_rows + 31) >> 5 : (fh.mi_rows + 15) >> 4;
    const int sb_shift = seq.sb128 ? 5 : 4;
    const int sb_size = sb_shift + 2;
    const int max_tile_width_sb = 4096 >> sb_size;
    int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
    const int min_log2_cols = tile_log2(max_tile_width_sb, sb_cols);
    const int max_log2_cols = tile_log2(1, std::min(sb_cols, 64));
    const int max_log2_rows = tile_log2(1, std::min(sb_rows, 64));
    const int min_log2_tiles = std::max(min_log2_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
    if (b.bit()) {  // uniform
      fh.tile_cols_log2 = min_log2_cols;
      while (fh.tile_cols_log2 < max_log2_cols) {
        if (b.bit()) fh.tile_cols_log2++;
        else break;
      }
      const int w_sb = (sb_cols + (1 << fh.tile_cols_log2) - 1) >> fh.tile_cols_log2;
      int i = 0;
      for (int start = 0; start < sb_cols; start += w_sb) fh.mi_col_starts[i++] = start << sb_shift;
      fh.mi_col_starts[i] = fh.mi_cols;
      fh.tile_cols = i;
      const int min_log2_rows = std::max(min_log2_tiles - fh.tile_cols_log2, 0);
      fh.tile_rows_log2 = min_log2_rows;
      while (fh.tile_rows_log2 < max_log2_rows) {
        if (b.bit()) fh.tile_rows_log2++;
        else break;
      }
      const int h_sb = (sb_rows + (1 << fh.tile_rows_log2) - 1) >> fh.tile_rows_log2;
      i = 0;
      for (int start = 0; start < sb_rows; start += h_sb) fh.mi_row_starts[i++] = start << sb_shift;
      fh.mi_row_starts[i] = fh.mi_rows;
      fh.tile_rows = i;
    } else {
      int widest = 0, start = 0, i;
      for (i = 0; start < sb_cols; i++) {
        if (i >= 64) corrupt("AVIF: AV1 data: more than 64 tile columns");
        fh.mi_col_starts[i] = start << sb_shift;
        const int max_width = std::min(sb_cols - start, max_tile_width_sb);
        const int size = static_cast<int>(b.ns(max_width)) + 1;
        widest = std::max(size, widest);
        start += size;
      }
      fh.mi_col_starts[i] = fh.mi_cols;
      fh.tile_cols = i;
      fh.tile_cols_log2 = tile_log2(1, fh.tile_cols);
      if (min_log2_tiles > 0) max_tile_area_sb = (sb_rows * sb_cols) >> (min_log2_tiles + 1);
      else max_tile_area_sb = sb_rows * sb_cols;
      const int max_tile_height_sb = std::max(max_tile_area_sb / widest, 1);
      start = 0;
      for (i = 0; start < sb_rows; i++) {
        if (i >= 64) corrupt("AVIF: AV1 data: more than 64 tile rows");
        fh.mi_row_starts[i] = start << sb_shift;
        const int max_height = std::min(sb_rows - start, max_tile_height_sb);
        const int size = static_cast<int>(b.ns(max_height)) + 1;
        start += size;
      }
      fh.mi_row_starts[i] = fh.mi_rows;
      fh.tile_rows = i;
      fh.tile_rows_log2 = tile_log2(1, fh.tile_rows);
    }
    if (fh.tile_cols_log2 > 0 || fh.tile_rows_log2 > 0) {
      fh.context_update_tile_id = static_cast<int>(b.f(fh.tile_rows_log2 + fh.tile_cols_log2));
      if (fh.context_update_tile_id >= fh.tile_cols * fh.tile_rows)
        corrupt("AVIF: AV1 frame header: a bad context_update_tile_id");
      fh.tile_size_bytes = static_cast<int>(b.f(2)) + 1;
    }
  }

  // ------------------------------------------------------------ deblocking

  int filter_level(int row, int col, int plane, int pass) const {
    const int idx = plane == 0 ? pass : plane + 1;
    const size_t m = mi(row, col);
    const int seg = seg_ids[m];
    const int dlf = fh.delta_lf_multi ? delta_lfs[m * 4 + idx] : delta_lfs[m * 4];
    int base = fh.lf_level[idx];
    if (plane > 0 && !base) return 0;
    int lvl = clip3(0, 63, dlf + base);
    if (fh.seg_enabled && fh.feature_enabled[seg][1 + idx]) lvl = clip3(0, 63, lvl + fh.feature_data[seg][1 + idx]);
    if (fh.lf_delta_enabled) {
      const int shift = lvl >> 5;
      lvl = clip3(0, 63, lvl + (fh.lf_ref_deltas[0] * (1 << shift)));
    }
    return lvl;
  }

  static void filter4(uint8_t* s, int step, int hev_thr, int mask) {
    if (!mask) return;
    const int p1 = s[-2 * step], p0 = s[-step], q0 = s[0], q1 = s[step];
    auto sc = [](int t) { return clip3(-128, 127, t); };
    const int ps1 = p1 - 128, ps0 = p0 - 128, qs0 = q0 - 128, qs1 = q1 - 128;
    const int hev = std::abs(p1 - p0) > hev_thr || std::abs(q1 - q0) > hev_thr;
    int f = hev ? sc(ps1 - qs1) : 0;
    f = sc(f + 3 * (qs0 - ps0));
    const int f1 = sc(f + 4) >> 3;
    const int f2 = sc(f + 3) >> 3;
    s[0] = static_cast<uint8_t>(sc(qs0 - f1) + 128);
    s[-step] = static_cast<uint8_t>(sc(ps0 + f2) + 128);
    if (!hev) {
      const int f3 = (f1 + 1) >> 1;
      s[step] = static_cast<uint8_t>(sc(qs1 - f3) + 128);
      s[-2 * step] = static_cast<uint8_t>(sc(ps1 + f3) + 128);
    }
  }

  // one sample position across an edge: size 4, 6, 8 or 14 taps
  static void filter_sample(uint8_t* s, int step, int size, int limit, int blimit, int thresh) {
    auto P = [&](int i) { return int(s[-(i + 1) * step]); };
    auto Q = [&](int i) { return int(s[i * step]); };
    const int p0 = P(0), p1 = P(1), q0 = Q(0), q1 = Q(1);
    bool mask = std::abs(p1 - p0) <= limit && std::abs(q1 - q0) <= limit &&
                std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 <= blimit;
    if (size == 4) {
      filter4(s, step, thresh, mask);
      return;
    }
    const int p2 = P(2), q2 = Q(2);
    mask = mask && std::abs(p2 - p1) <= limit && std::abs(q2 - q1) <= limit;
    if (size == 6) {
      if (!mask) return;
      const bool flat = std::abs(p1 - p0) <= 1 && std::abs(q1 - q0) <= 1 && std::abs(p2 - p0) <= 1 &&
                        std::abs(q2 - q0) <= 1;
      if (flat) {
        s[-2 * step] = static_cast<uint8_t>(round2(p2 * 3 + p1 * 2 + p0 * 2 + q0, 3));
        s[-step] = static_cast<uint8_t>(round2(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1, 3));
        s[0] = static_cast<uint8_t>(round2(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2, 3));
        s[step] = static_cast<uint8_t>(round2(p0 + q0 * 2 + q1 * 2 + q2 * 3, 3));
      } else {
        filter4(s, step, thresh, 1);
      }
      return;
    }
    const int p3 = P(3), q3 = Q(3);
    mask = mask && std::abs(p3 - p2) <= limit && std::abs(q3 - q2) <= limit;
    if (!mask) return;
    const bool flat = std::abs(p1 - p0) <= 1 && std::abs(q1 - q0) <= 1 && std::abs(p2 - p0) <= 1 &&
                      std::abs(q2 - q0) <= 1 && std::abs(p3 - p0) <= 1 && std::abs(q3 - q0) <= 1;
    if (size == 14 && flat) {
      const int p4 = P(4), p5 = P(5), p6 = P(6), q4 = Q(4), q5 = Q(5), q6 = Q(6);
      const bool flat2 = std::abs(p4 - p0) <= 1 && std::abs(q4 - q0) <= 1 && std::abs(p5 - p0) <= 1 &&
                         std::abs(q5 - q0) <= 1 && std::abs(p6 - p0) <= 1 && std::abs(q6 - q0) <= 1;
      if (flat2) {
        const int o[12] = {
            round2(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0, 4),
            round2(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1, 4),
            round2(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2, 4),
            round2(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3, 4),
            round2(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4, 4),
            round2(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5, 4),
            round2(p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6, 4),
            round2(p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2, 4),
            round2(p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3, 4),
            round2(p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4, 4),
            round2(p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5, 4),
            round2(p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7, 4)};
        for (int i = 0; i < 6; i++) s[-(6 - i) * step] = static_cast<uint8_t>(o[i]);
        for (int i = 0; i < 6; i++) s[i * step] = static_cast<uint8_t>(o[6 + i]);
        return;
      }
    }
    if (flat) {
      s[-3 * step] = static_cast<uint8_t>(round2(p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0, 3));
      s[-2 * step] = static_cast<uint8_t>(round2(p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1, 3));
      s[-step] = static_cast<uint8_t>(round2(p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2, 3));
      s[0] = static_cast<uint8_t>(round2(p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3, 3));
      s[step] = static_cast<uint8_t>(round2(p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3, 3));
      s[2 * step] = static_cast<uint8_t>(round2(p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3, 3));
    } else {
      filter4(s, step, thresh, 1);
    }
  }

  void loop_filter() {
    if (!fh.lf_level[0] && !fh.lf_level[1]) return;
    for (int p = 0; p < planes; p++) {
      if (p > 0 && !fh.lf_level[p + 1]) continue;
      const int sx = p ? ss_x : 0, sy = p ? ss_y : 0;
      for (int pass = 0; pass < 2; pass++) {
        const int row_step = p == 0 ? 1 : 1 << sy, col_step = p == 0 ? 1 : 1 << sx;
        for (int row = 0; row < fh.mi_rows; row += row_step)
          for (int col = 0; col < fh.mi_cols; col += col_step) edge_filter(p, pass, row, col, sx, sy);
      }
    }
  }

  void edge_filter(int plane, int pass, int row0, int col0, int sx, int sy) {
    const int dx = pass == 0, dy = pass == 1;
    const int x = col0 * 4, y = row0 * 4;
    if (x >= fh.width || y >= fh.height) return;
    if (pass == 0 && x == 0) return;
    if (pass == 1 && y == 0) return;
    const int row = row0 | sy, col = col0 | sx;
    const int xp = x >> sx, yp = y >> sy;
    const int prev_row = row - (dy << sy), prev_col = col - (dx << sx);
    const int txs = lf_tx[plane][size_t(row >> sy) * mi_stride + (col >> sx)];
    const int prev_txs = lf_tx[plane][size_t(prev_row >> sy) * mi_stride + (prev_col >> sx)];
    // (every transform edge of an intra frame is filtered, its blocks' and
    // the others)
    const bool is_tx_edge = pass == 0 ? xp % kTxW[txs] == 0 : yp % kTxH[txs] == 0;
    if (!is_tx_edge) return;
    const int base_size = pass == 0 ? std::min(kTxW[prev_txs], kTxW[txs]) : std::min(kTxH[prev_txs], kTxH[txs]);
    const int filter_size = plane == 0 ? std::min(16, base_size) : std::min(8, base_size);
    int lvl = filter_level(row, col, plane, pass);
    if (lvl == 0) lvl = filter_level(prev_row, prev_col, plane, pass);
    if (lvl == 0) return;
    const int shift = fh.lf_sharpness > 4 ? 2 : (fh.lf_sharpness > 0 ? 1 : 0);
    const int limit = fh.lf_sharpness > 0 ? clip3(1, 9 - fh.lf_sharpness, lvl >> shift) : std::max(1, lvl >> shift);
    const int blimit = 2 * (lvl + 2) + limit;
    const int thresh = lvl >> 4;
    const int size = filter_size == 4 ? 4 : filter_size == 8 ? (plane == 0 ? 8 : 6) : 14;
    const int step = pass == 0 ? 1 : pstride[plane];
    for (int i = 0; i < 4; i++) {
      uint8_t* s = px(plane, xp + dy * i, yp + dx * i);
      filter_sample(s, step, size, limit, blimit, thresh);
    }
  }

  // ------------------------------------------------------------ CDEF

  std::vector<uint8_t> pre_cdef[3];  // the deblocked frame (UpscaledCurrFrame)

  void cdef_direction(int r, int c, int* dir_out, int* var_out) {
    int cost[8] = {0};
    int partial[8][15] = {{0}};
    const int x0 = c << 2, y0 = r << 2;
    for (int i = 0; i < 8; i++) {
      const uint8_t* row = &pre_cdef[0][size_t(y0 + i) * pstride[0] + x0];
      for (int j = 0; j < 8; j++) {
        const int x = row[j] - 128;
        partial[0][i + j] += x;
        partial[1][i + j / 2] += x;
        partial[2][i] += x;
        partial[3][3 + i - j / 2] += x;
        partial[4][7 + i - j] += x;
        partial[5][3 - i / 2 + j] += x;
        partial[6][j] += x;
        partial[7][i / 2 + j] += x;
      }
    }
    static const int div[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
    for (int i = 0; i < 8; i++) {
      cost[2] += partial[2][i] * partial[2][i];
      cost[6] += partial[6][i] * partial[6][i];
    }
    cost[2] *= div[8];
    cost[6] *= div[8];
    for (int i = 0; i < 7; i++) {
      cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) * div[i + 1];
      cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) * div[i + 1];
    }
    cost[0] += partial[0][7] * partial[0][7] * div[8];
    cost[4] += partial[4][7] * partial[4][7] * div[8];
    for (int i = 1; i < 8; i += 2) {
      for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
      cost[i] *= div[8];
      for (int j = 0; j < 3; j++)
        cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) * div[2 * j + 2];
    }
    int best = 0, dir = 0;
    for (int d = 0; d < 8; d++)
      if (cost[d] > best) {
        best = cost[d];
        dir = d;
      }
    *dir_out = dir;
    *var_out = (best - cost[(dir + 4) & 7]) >> 10;
  }

  static int constrain(int diff, int threshold, int damping) {
    if (!threshold) return 0;
    const int adj = std::max(0, damping - floor_log2(threshold));
    const int val = std::min(std::abs(diff), std::max(0, threshold - (std::abs(diff) >> adj)));
    return diff < 0 ? -val : val;
  }

  void cdef_filter(int plane, int r, int c, int pri, int sec, int damping, int dir) {
    const int sx = plane ? ss_x : 0, sy = plane ? ss_y : 0;
    const int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy;
    const int w = 8 >> sx, h = 8 >> sy;
    static const int pri_taps[2][2] = {{4, 2}, {3, 3}};
    static const int sec_taps[2][2] = {{2, 1}, {2, 1}};
    const uint8_t* src = pre_cdef[plane].data();
    const int stride = pstride[plane];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        const int x = src[size_t(y0 + i) * stride + x0 + j];
        int sum = 0, mx = x, mn = x;
        for (int k = 0; k < 2; k++)
          for (int sign = -1; sign <= 1; sign += 2) {
            auto get = [&](int d, int* out) {
              const int yy = y0 + i + sign * kCdefDirections[d][k][0];
              const int xx = x0 + j + sign * kCdefDirections[d][k][1];
              const int cr = (yy << sy) >> 2, cc = (xx << sx) >> 2;
              if (yy < 0 || xx < 0 || cr >= fh.mi_rows || cc >= fh.mi_cols) return false;
              *out = src[size_t(yy) * stride + xx];
              return true;
            };
            int p;
            if (get(dir, &p)) {
              sum += pri_taps[pri & 1][k] * constrain(p - x, pri, damping);
              mx = std::max(p, mx);
              mn = std::min(p, mn);
            }
            for (int off = -2; off <= 2; off += 4) {
              int s;
              if (get((dir + off) & 7, &s)) {
                sum += sec_taps[pri & 1][k] * constrain(s - x, sec, damping);
                mx = std::max(s, mx);
                mn = std::min(s, mn);
              }
            }
          }
        cur[plane][size_t(y0 + i) * stride + x0 + j] =
            static_cast<uint8_t>(clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4)));
      }
  }

  void cdef() {
    for (int p = 0; p < planes; p++) pre_cdef[p] = cur[p];
    if (fh.coded_lossless || fh.allow_intrabc || !seq.cdef) return;
    static const int uv_dir[2][2][8] = {
        {{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
        {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};
    for (int fbr = 0; fbr < fh.mi_rows; fbr += 16)
      for (int fbc = 0; fbc < fh.mi_cols; fbc += 16) {
        const int idx = cdef_at(fbr, fbc);
        if (idx == -1) continue;
        for (int r = fbr; r < std::min(fbr + 16, fh.mi_rows); r += 2)
          for (int c = fbc; c < std::min(fbc + 16, fh.mi_cols); c += 2) {
            const bool all_skip = skips[mi(r, c)] && skips[mi(r + 1, c)] && skips[mi(r, c + 1)] &&
                                  skips[mi(r + 1, c + 1)];
            if (all_skip) continue;
            int ydir, var;
            cdef_direction(r, c, &ydir, &var);
            int pri = fh.cdef_y_pri[idx], sec = fh.cdef_y_sec[idx];
            int dir = pri == 0 ? 0 : ydir;
            const int var_str = (var >> 6) ? std::min(floor_log2(var >> 6), 12) : 0;
            const int pri_adj = var ? (pri * (4 + var_str) + 8) >> 4 : 0;
            if (pri || sec) cdef_filter(0, r, c, pri_adj, sec, fh.cdef_damping, dir);
            if (planes == 1) continue;
            pri = fh.cdef_uv_pri[idx];
            sec = fh.cdef_uv_sec[idx];
            dir = pri == 0 ? 0 : uv_dir[ss_x][ss_y][ydir];
            if (pri || sec) {
              cdef_filter(1, r, c, pri, sec, fh.cdef_damping - 1, dir);
              cdef_filter(2, r, c, pri, sec, fh.cdef_damping - 1, dir);
            }
          }
      }
  }

  // ------------------------------------------------------------ loop restoration

  // 7.17 on whole stripes: each stripe's rows of the CDEF output (and the
  // deblocked rows, two at most, above and below it) padded three samples
  // each way, then each restoration unit's part of the stripe filtered at
  // once. Every sample a 4x4 block's filter reads (get_source_sample) is
  // the same within a stripe, so this gives the specification's values.
  void loop_restoration() {
    if (!fh.uses_lr) return;
    for (int p = 0; p < planes; p++) {
      if (fh.lr_type[p] == RESTORE_NONE) continue;
      const int sx = p ? ss_x : 0, sy = p ? ss_y : 0;
      const int unit = fh.lr_size[p];
      const int pw = (fh.upscaled_width + sx) >> sx, ph = (fh.height + sy) >> sy;
      const std::vector<uint8_t> cd = cur[p];
      const int stride = pstride[p];
      const int sh = 64 >> sy, off = 8 >> sy;
      const int padw = pw + 6;
      std::vector<int> pad;
      for (int s0 = -off; s0 < ph; s0 += sh) {
        const int y0 = std::max(0, s0), y1 = std::min(ph, s0 + sh);
        if (y0 >= y1) continue;
        const int se = s0 + sh - 1;
        // rows y0 - 3 .. y1 + 2, columns -3 .. pw + 2
        const int rows = y1 - y0 + 6;
        pad.assign(size_t(rows) * padw, 0);
        for (int k = 0; k < rows; k++) {
          int y = std::max(0, std::min(ph - 1, y0 - 3 + k));
          const uint8_t* src;
          if (y < s0) src = &pre_cdef[p][size_t(std::max(s0 - 2, y)) * stride];
          else if (y > se) src = &pre_cdef[p][size_t(std::min(se + 2, y)) * stride];
          else src = &cd[size_t(y) * stride];
          int* d = &pad[size_t(k) * padw];
          for (int x = -3; x < pw + 3; x++) d[x + 3] = src[std::max(0, std::min(pw - 1, x))];
        }
        const int unit_row = std::min(lr_rows[p] - 1, (y0 + off) / unit);
        for (int uc = 0; uc < lr_cols[p]; uc++) {
          const int x0 = uc * unit;
          const int x1 = uc == lr_cols[p] - 1 ? pw : std::min(pw, (uc + 1) * unit);
          if (x0 >= x1) continue;
          const LrUnit& u = lr[p][size_t(unit_row) * lr_cols[p] + uc];
          // pad's sample (x, y) of the plane
          auto at = [&](int x, int y) { return pad[size_t(y - y0 + 3) * padw + x + 3]; };
          if (u.type == RESTORE_WIENER) wiener(p, u, x0, x1, y0, y1, at);
          else if (u.type == RESTORE_SGRPROJ) self_guided(p, u, x0, x1, y0, y1, at);
        }
      }
    }
  }

  template <class At>
  void wiener(int p, const LrUnit& u, int x0, int x1, int y0, int y1, At at) {
    int vf[7], hf[7];
    for (int pass = 0; pass < 2; pass++) {
      int* f = pass == 0 ? vf : hf;
      f[3] = 128;
      for (int i = 0; i < 3; i++) {
        const int c = u.wiener[pass][i];
        f[i] = c;
        f[6 - i] = c;
        f[3] -= 2 * c;
      }
    }
    const int round0 = 3, round1 = 11;
    const int offset = 1 << (8 + 7 - round0 - 1);
    const int limit = (1 << (8 + 1 + 7 - round0)) - 1;
    const int w = x1 - x0, h = y1 - y0;
    std::vector<int> inter(size_t(h + 6) * w);
    for (int r = 0; r < h + 6; r++)
      for (int c = 0; c < w; c++) {
        int sum = 0;
        for (int t = 0; t < 7; t++) sum += hf[t] * at(x0 + c + t - 3, y0 + r - 3);
        inter[size_t(r) * w + c] = clip3(-offset, limit - offset, round2(sum, round0));
      }
    for (int r = 0; r < h; r++) {
      uint8_t* dst = px(p, x0, y0 + r);
      for (int c = 0; c < w; c++) {
        int sum = 0;
        for (int t = 0; t < 7; t++) sum += vf[t] * inter[size_t(r + t) * w + c];
        dst[c] = clip1(round2(sum, round1));
      }
    }
  }

  // A and B of one radius over [x0 - 1, x1] x [y0 - 1, y1] (7.17.3)
  template <class At>
  void box_sums(int r, int s, int x0, int x1, int y0, int y1, At at, std::vector<int>& A,
                std::vector<int>& B) {
    const int w = x1 - x0 + 2, h = y1 - y0 + 2;
    const int n = (2 * r + 1) * (2 * r + 1);
    const uint32_t one_over_n = static_cast<uint32_t>(kOneByX[n - 1]);
    A.assign(size_t(w) * h, 0);
    B.assign(size_t(w) * h, 0);
    // column sums over 2r + 1 rows, then row sums over 2r + 1 columns
    const int cw = w + 2 * r;
    std::vector<int> colsum(cw), colsq(cw);
    for (int i = 0; i < h; i++) {
      const int y = y0 - 1 + i;
      for (int k = 0; k < cw; k++) {
        const int x = x0 - 1 - r + k;
        int sum = 0, sq = 0;
        for (int dy = -r; dy <= r; dy++) {
          const int c = at(x, y + dy);
          sum += c;
          sq += c * c;
        }
        colsum[k] = sum;
        colsq[k] = sq;
      }
      for (int j = 0; j < w; j++) {
        int a = 0, b = 0;
        for (int k = 0; k <= 2 * r; k++) {
          a += colsq[j + k];
          b += colsum[j + k];
        }
        const uint32_t pv = static_cast<uint32_t>(std::max(0, a * n - b * b));
        const uint32_t z = (pv * static_cast<uint32_t>(s) + (1u << 19)) >> 20;
        const int a2 = kXByXPlus1[std::min<uint32_t>(z, 255)];
        const uint32_t b2 = uint32_t(256 - a2) * uint32_t(b) * one_over_n;
        A[size_t(i) * w + j] = a2;
        B[size_t(i) * w + j] = static_cast<int>((b2 + (1 << 11)) >> 12);
      }
    }
  }

  template <class At>
  void self_guided(int p, const LrUnit& u, int x0, int x1, int y0, int y1, At at) {
    const int set = u.set;
    const int r0 = kSgrParams[set][0], r1 = kSgrParams[set][1];
    const int w = x1 - x0, h = y1 - y0, aw = w + 2;
    std::vector<int> A0, B0, A1, B1;
    if (r0) box_sums(r0, kSgrParams[set][2], x0, x1, y0, y1, at, A0, B0);
    if (r1) box_sums(r1, kSgrParams[set][3], x0, x1, y0, y1, at, A1, B1);
    const int w0 = u.xqd[0], w1 = u.xqd[1], w2 = (1 << 7) - w0 - w1;
    for (int i = 0; i < h; i++) {
      const int y = y0 + i;
      uint8_t* dst = px(p, x0, y);
      for (int j = 0; j < w; j++) {
        const int src = at(x0 + j, y);
        const int uu = src << 4;
        int v = w1 * uu;
        // (A and B are indexed from (x0 - 1, y0 - 1))
        auto idx = [&](int di, int dj) { return size_t(i + 1 + di) * aw + j + 1 + dj; };
        if (r0) {
          int a = 0, b = 0, shift;
          if (y & 1) {
            shift = 4;
            for (int dj = -1; dj <= 1; dj++) {
              const int wt = dj == 0 ? 6 : 5;
              a += wt * A0[idx(0, dj)];
              b += wt * B0[idx(0, dj)];
            }
          } else {
            shift = 5;
            for (int di = -1; di <= 1; di += 2)
              for (int dj = -1; dj <= 1; dj++) {
                const int wt = dj == 0 ? 6 : 5;
                a += wt * A0[idx(di, dj)];
                b += wt * B0[idx(di, dj)];
              }
          }
          v += w0 * round2(a * src + b, 8 + shift - 4);
        } else {
          v += w0 * uu;
        }
        if (r1) {
          int a = 0, b = 0;
          for (int di = -1; di <= 1; di++)
            for (int dj = -1; dj <= 1; dj++) {
              const int wt = (di == 0 || dj == 0) ? 4 : 3;
              a += wt * A1[idx(di, dj)];
              b += wt * B1[idx(di, dj)];
            }
          v += w2 * round2(a * src + b, 8 + 5 - 4);
        } else {
          v += w2 * uu;
        }
        dst[j] = clip1(round2(v, 4 + 7));
      }
    }
  }

  // ------------------------------------------------------------ the frame

  void decode_tile_group(BitReader& b, const uint8_t* data, int64_t size) {
    const int num_tiles = fh.tile_cols * fh.tile_rows;
    int flag = 0;
    if (num_tiles > 1) flag = b.bit();
    int tg_start = 0, tg_end = num_tiles - 1;
    if (num_tiles > 1 && flag) {
      const int bits = fh.tile_cols_log2 + fh.tile_rows_log2;
      tg_start = static_cast<int>(b.f(bits));
      tg_end = static_cast<int>(b.f(bits));
    }
    b.byte_align();
    int64_t pos = b.pos / 8;
    int64_t remaining = size - pos;
    if (remaining < 0 || tg_end < tg_start || tg_end >= num_tiles || tg_start != tiles_done)
      corrupt("AVIF: AV1 data: a bad tile group");
    for (int t = tg_start; t <= tg_end; t++) {
      int64_t tile_size;
      if (t == tg_end) {
        tile_size = remaining;
      } else {
        if (remaining < fh.tile_size_bytes) corrupt("AVIF: AV1 data: a tile group ends inside a tile size");
        tile_size = 0;
        for (int i = 0; i < fh.tile_size_bytes; i++) tile_size |= int64_t(data[pos + i]) << (8 * i);
        tile_size += 1;
        pos += fh.tile_size_bytes;
        remaining -= fh.tile_size_bytes;
        if (tile_size > remaining) corrupt("AVIF: AV1 data: a tile runs past its tile group");
      }
      if (tile_size <= 0) corrupt("AVIF: AV1 data: an empty tile");
      decode_tile(data + pos, tile_size, t / fh.tile_cols, t % fh.tile_cols);
      pos += tile_size;
      remaining -= tile_size;
      tiles_done++;
    }
  }

  int tiles_done = 0;
  bool frame_started = false;

  void start_frame() {
    allocate();
    frame_cdfs.init(fh.base_q_idx);
    for (int p = 0; p < planes; p++) {
      if (fh.lr_type[p] == RESTORE_NONE) continue;
      const int sx = p ? ss_x : 0, sy = p ? ss_y : 0;
      lr_rows[p] = count_units(fh.lr_size[p], (fh.height + sy) >> sy);
      lr_cols[p] = count_units(fh.lr_size[p], (fh.upscaled_width + sx) >> sx);
      lr[p].assign(size_t(lr_rows[p]) * lr_cols[p], LrUnit());
    }
    tiles_done = 0;
    frame_started = true;
  }

  void finish_frame(Frame& out) {
    loop_filter();
    cdef();
    loop_restoration();
    out.width = fh.width;
    out.height = fh.height;
    out.color = seq.color;
    for (int p = 0; p < 3; p++) {
      out.plane[p].clear();
      out.stride[p] = out.plane_w[p] = out.plane_h[p] = 0;
    }
    for (int p = 0; p < planes; p++) {
      const int sx = p ? ss_x : 0, sy = p ? ss_y : 0;
      const int w = (fh.width + sx) >> sx, h = (fh.height + sy) >> sy;
      out.plane_w[p] = w;
      out.plane_h[p] = h;
      out.stride[p] = w;
      out.plane[p].resize(size_t(w) * h);
      for (int y = 0; y < h; y++) std::memcpy(&out.plane[p][size_t(y) * w], px(p, 0, y), w);
    }
  }

  // walks the OBUs; decode = false stops after the first frame header
  void run(const uint8_t* data, int64_t n, Frame& out, bool decode) {
    int64_t pos = 0;
    bool have_header = false;
    while (pos < n) {
      BitReader h(data + pos, n - pos);
      h.bit();  // the forbidden bit (dav1d reads past it)
      const int type = static_cast<int>(h.f(4));
      const int ext = h.bit();
      const int has_size = h.bit();
      h.bit();
      int temporal_id = 0, spatial_id = 0;
      if (ext) {
        temporal_id = static_cast<int>(h.f(3));
        spatial_id = static_cast<int>(h.f(2));
        h.f(3);
      }
      int64_t size;
      if (has_size) {
        size = static_cast<int64_t>(h.leb128());
      } else {
        size = n - pos - 1 - ext;
      }
      const int64_t body = pos + h.pos / 8;
      if (size < 0 || size > n - body) corrupt("AVIF: AV1 data: an OBU runs past the data");
      const uint8_t* obu = data + body;
      // OBUs of layers outside operating point 0 are dropped (dav1d)
      const int idc = seq.seen ? seq.op_idc[0] : 0;
      const bool dropped = ext && type != 1 && type != 2 && idc &&
                           (!((idc >> temporal_id) & 1) || !((idc >> (spatial_id + 8)) & 1));
      if (dropped) {
        // skipped
      } else if (type == 1) {
        BitReader b(obu, size);
        parse_sequence_header(b, seq);
      } else if (type == 3 || type == 6 || (type == 7 && !have_header)) {
        if (!seq.seen) corrupt("AVIF: AV1 data: a frame header before the sequence header");
        if (have_header && type == 3) {
          // a redundant copy of the header
        } else {
          if (seq.color.bit_depth != 8)
            refuse("AVIF: " + std::to_string(seq.color.bit_depth) +
                   "-bit AV1, which the port does not decode");
          BitReader b(obu, size);
          parse_frame_header(b);
          if (type != 6) b.bit();  // a frame header OBU's trailing bit
          have_header = true;
          if (!decode) {
            out.width = fh.width;
            out.height = fh.height;
            out.color = seq.color;
            return;
          }
          start_frame();
          if (type == 6) {
            b.byte_align();
            const int64_t hdr = b.pos / 8;
            BitReader tg(obu + hdr, size - hdr);
            decode_tile_group(tg, obu + hdr, size - hdr);
          }
        }
      } else if (type == 4) {
        if (!frame_started) corrupt("AVIF: AV1 data: a tile group before the frame header");
        BitReader tg(obu, size);
        decode_tile_group(tg, obu, size);
      }
      pos = body + size;
      if (frame_started && tiles_done == fh.tile_cols * fh.tile_rows) {
        finish_frame(out);
        return;
      }
    }
    if (!have_header) corrupt("AVIF: AV1 data: no frame");
    corrupt("AVIF: AV1 data: the frame's tiles are missing");
  }
};

// the matrix of a level (0-14), luma or chroma, and a transform size of
// at most 32x32: kQuantizerMatrix holds them one after the other, square
// sizes first
const uint8_t* Decoder::quantizer_matrix(int level, int chroma, int adj_tx) {
  static const int16_t kOffset[19] = {0,    16,   80,   336,  336,  1360, 1392, 1424, 1552, 1680,
                                      2192, 336,  336,  2704, 2768, 2832, 3088, 1680, 2192};
  return &kQuantizerMatrix[level][chroma][kOffset[adj_tx]];
}

}  // namespace

void probe(const uint8_t* data, int64_t n, Frame& out) {
  Decoder d;
  d.run(data, n, out, false);
}

void decode(const uint8_t* data, int64_t n, Frame& out) {
  std::unique_ptr<Decoder> d(new Decoder());
  d->run(data, n, out, true);
}

namespace {
}  // namespace
}  // namespace av1
}  // namespace mrt
