// The HT (High-Throughput, ISO 15444-15) code-block decoder as OpenJPEG
// 2.5.4's ht_dec.c decodes a code-block (opj_t1_ht_decode_cblk), for
// jpeg2000_decode.cpp's tier 1: the cleanup pass (the MEL decoder and its
// 13-state exponent table; the VLC stream read backwards from the
// segment's end and the MagSgn stream forwards, each with its bit
// unstuffing; the UVLC with the initial row's rule for two u-prefixes; the
// quad scan with the exponent and kappa predictions of later rows), then
// the SigProp and MagRef refinement passes in stripes of four rows, and the
// Scup, Lcup and Pcup fields where OpenJPEG reads them. OpenJPEG's checks of
// a malformed code-block are kept where it keeps them: each error ends the
// decode (an Error here, a failed tile there); its two warnings go on with
// the cleanup pass alone.
//
// The samples come out as OpenJPEG's tier 1 hands them to dequantization:
// int32 sign and magnitude turned into two's complement, the magnitude in
// units of half a quantization step (the bin centre in the low bit).
//
// One of OpenJPEG's readers depends on where the code-block's bytes lie:
// the MEL reader checks its first 1 to 4 bytes (up to a 4-byte boundary)
// for a stuffing fault and no byte after. The caller passes that address's
// remainder mod 4 (OpenJPEG's buffers are malloc'd, 16-byte aligned).

#include <cstdint>
#include <cstring>
#include <vector>

#include "htj2k_tables.h"
#include "image_codec.h"

namespace mrt {
namespace {

[[noreturn]] void fail(const char* m) { corrupt(std::string("JPEG2000: ") + m); }

inline uint32_t population_count(uint32_t v) { return uint32_t(__builtin_popcount(v)); }
inline uint32_t count_leading_zeros(uint32_t v) { return v ? uint32_t(__builtin_clz(v)) : 32u; }
inline uint32_t read_le_uint32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}

// ------------------------------------------------------------------- MEL
struct Mel {
  const uint8_t* data;
  uint64_t tmp;
  int bits, size;
  bool unstuff;
  int k, num_runs;
  uint64_t runs;

  void read() {
    if (bits > 32) return;
    uint32_t val = 0xFFFFFFFFu;
    if (size > 4) {
      val = read_le_uint32(data);
      data += 4;
      size -= 4;
    } else if (size > 0) {
      int i = 0;
      while (size > 1) {
        const uint32_t v = *data++;
        const uint32_t m = ~(0xFFu << i);
        val = (val & m) | (v << i);
        --size;
        i += 8;
      }
      // the last byte: MEL and VLC segments overlap in its low nibble
      uint32_t v = *data++;
      v |= 0xF;
      const uint32_t m = ~(0xFFu << i);
      val = (val & m) | (v << i);
      --size;
    }
    int nbits = 32 - int(unstuff);
    uint32_t t = val & 0xFF;
    bool u = (val & 0xFF) == 0xFF;
    nbits -= int(u);
    t = t << (8 - int(u));
    t |= (val >> 8) & 0xFF;
    u = ((val >> 8) & 0xFF) == 0xFF;
    nbits -= int(u);
    t = t << (8 - int(u));
    t |= (val >> 16) & 0xFF;
    u = ((val >> 16) & 0xFF) == 0xFF;
    nbits -= int(u);
    t = t << (8 - int(u));
    t |= (val >> 24) & 0xFF;
    unstuff = ((val >> 24) & 0xFF) == 0xFF;
    tmp |= uint64_t(t) << (64 - nbits - bits);
    bits += nbits;
  }

  void decode() {
    static const int kMelExp[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};
    if (bits < 6) read();
    while (bits >= 6 && num_runs < 8) {
      const int eval = kMelExp[k];
      int run;
      if (tmp & (uint64_t(1) << 63)) {
        run = (1 << eval) - 1;
        k = k + 1 < 12 ? k + 1 : 12;
        tmp <<= 1;
        bits -= 1;
        run = run << 1;
      } else {
        run = int(tmp >> (63 - eval)) & ((1 << eval) - 1);
        k = k - 1 > 0 ? k - 1 : 0;
        tmp <<= eval + 1;
        bits -= eval + 1;
        run = (run << 1) + 1;
      }
      const int at = num_runs * 7;
      runs &= ~(uint64_t(0x3F) << at);
      runs |= uint64_t(run) << at;
      num_runs++;
    }
  }

  // mel_init: false where a byte after 0xFF in the first bytes up to the
  // 4-byte boundary is above 0x8F ("Incorrect MEL segment sequence")
  bool init(const uint8_t* bbuf, int lcup, int scup, uint32_t align) {
    data = bbuf + lcup - scup;
    bits = 0;
    tmp = 0;
    unstuff = false;
    size = scup - 1;
    k = 0;
    num_runs = 0;
    runs = 0;
    const int num = 4 - int((align + uint32_t(lcup - scup)) & 3);
    for (int i = 0; i < num; ++i) {
      if (unstuff && data[0] > 0x8F) return false;
      uint64_t d = size > 0 ? *data : 0xFF;
      if (size == 1) d |= 0xF;
      data += size-- > 0;
      const int d_bits = 8 - int(unstuff);
      tmp = (tmp << d_bits) | d;
      bits += d_bits;
      unstuff = (d & 0xFF) == 0xFF;
    }
    tmp <<= (64 - bits);
    return true;
  }

  int get_run() {
    if (num_runs == 0) decode();
    const int t = int(runs & 0x7F);
    runs >>= 7;
    num_runs--;
    return t;
  }
};

// ------------------------------------------------ backwards: VLC, MagRef
struct Rev {
  const uint8_t* data;
  uint64_t tmp;
  uint32_t bits;
  int size;
  bool unstuff;

  // rev_read and rev_read_mrp (the same arithmetic): 4 bytes backwards, a
  // byte after one above 0x8F giving 7 bits where its low 7 are ones
  void read() {
    if (bits > 32) return;
    uint32_t val = 0;
    if (size > 3) {
      val = read_le_uint32(data - 3);
      data -= 4;
      size -= 4;
    } else if (size > 0) {
      int i = 24;
      while (size > 0) {
        const uint32_t v = *data--;
        val |= v << i;
        --size;
        i -= 8;
      }
    }
    uint32_t t = val >> 24;
    uint32_t nbits = 8u - ((unstuff && (((val >> 24) & 0x7F) == 0x7F)) ? 1u : 0u);
    bool u = (val >> 24) > 0x8F;
    t |= ((val >> 16) & 0xFF) << nbits;
    nbits += 8u - ((u && (((val >> 16) & 0x7F) == 0x7F)) ? 1u : 0u);
    u = ((val >> 16) & 0xFF) > 0x8F;
    t |= ((val >> 8) & 0xFF) << nbits;
    nbits += 8u - ((u && (((val >> 8) & 0x7F) == 0x7F)) ? 1u : 0u);
    u = ((val >> 8) & 0xFF) > 0x8F;
    t |= (val & 0xFF) << nbits;
    nbits += 8u - ((u && ((val & 0x7F) == 0x7F)) ? 1u : 0u);
    u = (val & 0xFF) > 0x8F;
    tmp |= uint64_t(t) << bits;
    bits += nbits;
    unstuff = u;
  }

  // rev_init: the VLC from byte lcup - 2 down, its upper nibble first.
  // (OpenJPEG reads 1-4 bytes one at a time up to an address boundary
  // first: the same bits as reading on.)
  void init_vlc(const uint8_t* d, int lcup, int scup) {
    data = d + lcup - 2;
    size = scup - 2;
    const uint32_t first = *data--;
    tmp = first >> 4;
    bits = 4 - ((tmp & 7) == 7);
    unstuff = (first | 0xF) > 0x8F;
    read();
  }

  // rev_init_mrp: the MagRef from the refinement segment's last byte
  // down, its first byte read as after one above 0x8F
  void init_mrp(const uint8_t* d, int lcup, int len2) {
    data = d + lcup + len2 - 1;
    size = len2;
    unstuff = true;
    bits = 0;
    tmp = 0;
    read();
  }

  uint32_t fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return uint32_t(tmp);
  }
  uint32_t advance(uint32_t n) {
    tmp >>= n;
    bits -= n;
    return uint32_t(tmp);
  }
};

// --------------------------------------------- forwards: MagSgn, SigProp
struct Frwd {
  const uint8_t* data;
  uint64_t tmp;
  uint32_t bits;
  bool unstuff;
  int size;
  uint32_t x;  // what is read past the end: 0xFF (MagSgn) or 0 (SigProp)

  void read() {
    uint32_t val;
    if (size > 3) {
      val = read_le_uint32(data);
      data += 4;
      size -= 4;
    } else if (size > 0) {
      int i = 0;
      val = x != 0 ? 0xFFFFFFFFu : 0;
      while (size > 0) {
        const uint32_t v = *data++;
        const uint32_t m = ~(0xFFu << i);
        val = (val & m) | (v << i);
        --size;
        i += 8;
      }
    } else {
      val = x != 0 ? 0xFFFFFFFFu : 0;
    }
    uint32_t nbits = 8u - (unstuff ? 1u : 0u);
    uint32_t t = val & 0xFF;
    bool u = (val & 0xFF) == 0xFF;
    t |= ((val >> 8) & 0xFF) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    u = ((val >> 8) & 0xFF) == 0xFF;
    t |= ((val >> 16) & 0xFF) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    u = ((val >> 16) & 0xFF) == 0xFF;
    t |= ((val >> 24) & 0xFF) << nbits;
    nbits += 8u - (u ? 1u : 0u);
    unstuff = ((val >> 24) & 0xFF) == 0xFF;
    tmp |= uint64_t(t) << bits;
    bits += nbits;
  }

  // frwd_init (its first 1-4 bytes read one at a time up to an address
  // boundary: the same bits as reading on)
  void init(const uint8_t* d, int n, uint32_t fill) {
    data = d;
    tmp = 0;
    bits = 0;
    unstuff = false;
    size = n;
    x = fill;
    read();
  }

  uint32_t fetch() {
    if (bits < 32) {
      read();
      if (bits < 32) read();
    }
    return uint32_t(tmp);
  }
  void advance(uint32_t n) {
    tmp >>= n;
    bits -= n;
  }
};

// ------------------------------------------------------------------ UVLC
// the prefix codewords: 2 bits of prefix length, 3 of suffix length, 3 of
// prefix value, by the stream's next 3 bits
constexpr uint8_t kUvlc[8] = {
    3 | (5 << 2) | (5 << 5), 1 | (0 << 2) | (1 << 5), 2 | (0 << 2) | (2 << 5),
    1 | (0 << 2) | (1 << 5), 3 | (1 << 2) | (3 << 5), 1 | (0 << 2) | (1 << 5),
    2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5)};

// decode_init_uvlc: u + 1 of the quad pair of the first row (`mode` 4: both
// u_off 1 and the MEL event 1)
uint32_t decode_init_uvlc(uint32_t vlc, uint32_t mode, uint32_t* u) {
  uint32_t consumed = 0;
  if (mode == 0) {
    u[0] = u[1] = 1;
  } else if (mode <= 2) {
    uint32_t d = kUvlc[vlc & 0x7];
    vlc >>= d & 0x3;
    consumed += d & 0x3;
    const uint32_t suffix_len = (d >> 2) & 0x7;
    consumed += suffix_len;
    d = (d >> 5) + (vlc & ((1U << suffix_len) - 1));
    u[0] = mode == 1 ? d + 1 : 1;
    u[1] = mode == 1 ? 1 : d + 1;
  } else if (mode == 3) {
    uint32_t d1 = kUvlc[vlc & 0x7];
    vlc >>= d1 & 0x3;
    consumed += d1 & 0x3;
    if ((d1 & 0x3) > 2) {
      // the first u-prefix 3 or more: the second u is 1 or 2, one bit
      u[1] = (vlc & 1) + 1 + 1;
      ++consumed;
      vlc >>= 1;
      const uint32_t suffix_len = (d1 >> 2) & 0x7;
      consumed += suffix_len;
      d1 = (d1 >> 5) + (vlc & ((1U << suffix_len) - 1));
      u[0] = d1 + 1;
    } else {
      uint32_t d2 = kUvlc[vlc & 0x7];
      vlc >>= d2 & 0x3;
      consumed += d2 & 0x3;
      uint32_t suffix_len = (d1 >> 2) & 0x7;
      consumed += suffix_len;
      d1 = (d1 >> 5) + (vlc & ((1U << suffix_len) - 1));
      u[0] = d1 + 1;
      vlc >>= suffix_len;
      suffix_len = (d2 >> 2) & 0x7;
      consumed += suffix_len;
      d2 = (d2 >> 5) + (vlc & ((1U << suffix_len) - 1));
      u[1] = d2 + 1;
    }
  } else if (mode == 4) {
    uint32_t d1 = kUvlc[vlc & 0x7];
    vlc >>= d1 & 0x3;
    consumed += d1 & 0x3;
    uint32_t d2 = kUvlc[vlc & 0x7];
    vlc >>= d2 & 0x3;
    consumed += d2 & 0x3;
    uint32_t suffix_len = (d1 >> 2) & 0x7;
    consumed += suffix_len;
    d1 = (d1 >> 5) + (vlc & ((1U << suffix_len) - 1));
    u[0] = d1 + 3;
    vlc >>= suffix_len;
    suffix_len = (d2 >> 2) & 0x7;
    consumed += suffix_len;
    d2 = (d2 >> 5) + (vlc & ((1U << suffix_len) - 1));
    u[1] = d2 + 3;
  }
  return consumed;
}

// decode_noninit_uvlc: u + 1 of a quad pair of a later row
uint32_t decode_noninit_uvlc(uint32_t vlc, uint32_t mode, uint32_t* u) {
  uint32_t consumed = 0;
  if (mode == 0) {
    u[0] = u[1] = 1;
  } else if (mode <= 2) {
    uint32_t d = kUvlc[vlc & 0x7];
    vlc >>= d & 0x3;
    consumed += d & 0x3;
    const uint32_t suffix_len = (d >> 2) & 0x7;
    consumed += suffix_len;
    d = (d >> 5) + (vlc & ((1U << suffix_len) - 1));
    u[0] = mode == 1 ? d + 1 : 1;
    u[1] = mode == 1 ? 1 : d + 1;
  } else if (mode == 3) {
    uint32_t d1 = kUvlc[vlc & 0x7];
    vlc >>= d1 & 0x3;
    consumed += d1 & 0x3;
    uint32_t d2 = kUvlc[vlc & 0x7];
    vlc >>= d2 & 0x3;
    consumed += d2 & 0x3;
    uint32_t suffix_len = (d1 >> 2) & 0x7;
    consumed += suffix_len;
    d1 = (d1 >> 5) + (vlc & ((1U << suffix_len) - 1));
    u[0] = d1 + 1;
    vlc >>= suffix_len;
    suffix_len = (d2 >> 2) & 0x7;
    consumed += suffix_len;
    d2 = (d2 >> 5) + (vlc & ((1U << suffix_len) - 1));
    u[1] = d2 + 1;
  }
  return consumed;
}

// ------------------------------------------------------------ the block
// One significant sample's value from the MagSgn stream: its sign in bit
// 31, (2 mu + 1) << (p - 1) below; `v_out` gets v_n with its centre bit
uint32_t magsgn_sample(Frwd& ms, uint32_t u_q, uint32_t qinf, int n, uint32_t p, uint32_t* v_out) {
  const uint32_t ms_val = ms.fetch();
  const uint32_t m_n = u_q - ((qinf >> (12 + n)) & 1);
  ms.advance(m_n);
  const uint32_t val = ms_val << 31;
  uint32_t v_n = ms_val & ((1U << m_n) - 1);
  v_n |= ((qinf & (0x100u << n)) >> (8 + n)) << m_n;
  v_n |= 1;
  *v_out = v_n;
  return val | ((v_n + 2) << (p - 1));
}

// The significance-propagation scan of one stripe's 8-column word (the
// main loop's and the last stripes', `pattern` the rows that exist):
// returns the samples that became significant.
uint32_t sigprop_word(Frwd& sigprop, uint32_t* dpp, int32_t stride, int32_t width, int32_t i,
                      uint32_t mbr, uint32_t cur_sig, uint32_t pattern, uint32_t* next_mbr,
                      uint32_t next_sig, uint32_t val) {
  uint32_t new_sig = 0;
  if (!mbr) return 0;
  for (int32_t n = 0; n < 8; n += 4) {
    uint32_t cwd = sigprop.fetch();
    uint32_t cnt = 0;
    uint32_t* dp = dpp + i + n;
    uint32_t col_mask = 0xFu << (4 * n);
    const uint32_t inv_sig = ~cur_sig & pattern;
    const int32_t end = n + 4 + i < width ? n + 4 : width - i;
    for (int32_t j = n; j < end; ++j, ++dp, col_mask <<= 4) {
      if ((col_mask & mbr) == 0) continue;
      uint32_t sample_mask = 0x11111111u & col_mask;
      static const uint32_t kSpread[4] = {0x32u, 0x74u, 0xE8u, 0xC0u};
      for (int r = 0; r < 4; r++, sample_mask += sample_mask) {
        if (mbr & sample_mask) {
          if (cwd & 1) {
            new_sig |= sample_mask;
            mbr |= (kSpread[r] << (j * 4)) & inv_sig;
          }
          cwd >>= 1;
          ++cnt;
        }
      }
    }
    if (new_sig & (0xFFFFu << (4 * n))) {
      dp = dpp + i + n;
      col_mask = 0xFu << (4 * n);
      for (int32_t j = n; j < end; ++j, ++dp, col_mask <<= 4) {
        if ((col_mask & new_sig) == 0) continue;
        uint32_t sample_mask = 0x11111111u & col_mask;
        for (int r = 0; r < 4; r++, sample_mask += sample_mask) {
          if (new_sig & sample_mask) {
            dp[r * stride] |= ((cwd & 1) << 31) | val;
            cwd >>= 1;
            ++cnt;
          }
        }
      }
    }
    sigprop.advance(cnt);
    if (n == 4) {
      // the next word's first column
      uint32_t t = new_sig >> 28;
      t |= ((t & 0xE) >> 1) | ((t & 7) << 1);
      *next_mbr |= t & ~next_sig;
    }
  }
  return new_sig;
}

// the MagRef pass over one stripe (`cur_sig` its cleanup significance)
void magref_stripe(Rev& magref, uint32_t* dpp, int32_t stride, int32_t width, const uint32_t* cur_sig,
                   uint32_t p) {
  const uint32_t half = 1u << (p - 2);
  for (int32_t i = 0; i < width; i += 8) {
    uint32_t cwd = magref.fetch();
    const uint32_t sig = *cur_sig++;
    uint32_t col_mask = 0xFu;
    uint32_t* dp = dpp + i;
    if (sig) {
      for (int j = 0; j < 8; ++j, dp++) {
        if (sig & col_mask) {
          uint32_t sample_mask = 0x11111111u & col_mask;
          for (int r = 0; r < 4; r++, sample_mask += sample_mask) {
            if (sig & sample_mask) {
              const uint32_t sym = cwd & 1;
              dp[r * stride] ^= (1 - sym) << (p - 1);
              dp[r * stride] |= half;
              cwd >>= 1;
            }
          }
        }
        col_mask <<= 4;
      }
    }
    magref.advance(population_count(sig));
  }
}

// a stripe's membership from its own cleanup significance (3x3 within it)
void stripe_membership(const uint32_t* sig, uint32_t* mbr, int32_t width) {
  uint32_t prev = 0;
  for (int32_t i = 0; i < width; i += 8, mbr++, sig++) {
    mbr[0] = sig[0];
    mbr[0] |= prev >> 28;
    mbr[0] |= sig[0] << 4;
    mbr[0] |= sig[0] >> 4;
    mbr[0] |= sig[1] << 28;
    prev = sig[0];
    const uint32_t t = mbr[0];
    uint32_t z = mbr[0];
    z |= (t & 0x77777777) << 1;
    z |= (t & 0xEEEEEEEE) >> 1;
    mbr[0] = z & ~sig[0];
  }
}

// membership from the next stripe's first row (unless VSC), already
// significant samples removed
void next_membership(uint32_t* cur_mbr, const uint32_t* cur_sig, const uint32_t* nxt_sig, int32_t width,
                     bool causal) {
  uint32_t prev = 0;
  for (int32_t i = 0; i < width; i += 8, cur_mbr++, cur_sig++, nxt_sig++) {
    uint32_t t = nxt_sig[0];
    t |= prev >> 28;
    t |= nxt_sig[0] << 4;
    t |= nxt_sig[0] >> 4;
    t |= nxt_sig[1] << 28;
    prev = nxt_sig[0];
    if (!causal) cur_mbr[0] |= (t & 0x11111111u) << 3;
    cur_mbr[0] &= ~cur_sig[0];
  }
}

// one stripe's SigProp scan, then its last row's significance carried to
// the next stripe's membership
void sigprop_stripe(Frwd& sigprop, uint32_t* dpp, int32_t stride, int32_t width, const uint32_t* cur_sig,
                    uint32_t* cur_mbr, const uint32_t* nxt_sig, uint32_t* nxt_mbr, uint32_t pattern,
                    uint32_t p) {
  const uint32_t val = 3u << (p - 2);
  for (int32_t i = 0; i < width; i += 8, cur_sig++, cur_mbr++, nxt_sig++, nxt_mbr++) {
    uint32_t new_sig = sigprop_word(sigprop, dpp, stride, width, i, *cur_mbr & pattern, cur_sig[0], pattern,
                                    cur_mbr + 1, cur_sig[1], val);
    new_sig |= cur_sig[0];
    const uint32_t ux = (new_sig & 0x88888888) >> 3;
    const uint32_t tx = ux | (ux << 4) | (ux >> 4);
    if (i > 0) nxt_mbr[-1] |= (ux << 28) & ~nxt_sig[-1];
    nxt_mbr[0] |= tx & ~nxt_sig[0];
    nxt_mbr[1] |= (ux >> 28) & ~nxt_sig[1];
  }
}

}  // namespace

void jpeg2000_ht_block(const HtBlock& b, std::vector<int32_t>& out) {
  if (b.roishift != 0) fail("We do not support ROI in decoding HT codeblocks");
  const int32_t width = int32_t(b.width), height = int32_t(b.height), stride = width;
  out.assign(size_t(b.width) * b.height, 0);
  if (b.mb == 0) return;
  const uint32_t zero_bplanes = (b.mb + 1) - b.numbps;
  if (b.nchunks == 0) return;
  const uint8_t* coded = b.data;
  const uint32_t cblk_len = b.len;
  uint32_t num_passes = b.numsegs > 0 ? b.seg_passes[0] : 0;
  num_passes += b.numsegs > 1 ? b.seg_passes[1] : 0;
  const uint32_t lengths1 = num_passes > 0 ? b.seg_len[0] : 0;
  const uint32_t lengths2 = num_passes > 1 ? b.seg_len[1] : 0;
  // "A malformed codeblock that has more than one coding pass, but zero
  // length for 2nd and potentially the 3rd pass": a warning
  if (num_passes > 1 && lengths2 == 0) num_passes = 1;
  if (num_passes > 3) fail("We do not support more than 3 coding passes in an HT codeblock");
  if (b.mb > 30) fail("32 bits are not enough to decode this codeblock");
  if (zero_bplanes > b.mb) {
    fail("Malformed HT codeblock. Decoding this codeblock is stopped.");
  } else if (zero_bplanes == b.mb && num_passes > 1) {
    // "only the cleanup pass will be decoded": a warning
    num_passes = 1;
  }
  const uint32_t p = b.numbps;
  const uint32_t zero_bplanes_p1 = zero_bplanes + 1;
  if (lengths1 < 2 || lengths1 > cblk_len || lengths1 + lengths2 > cblk_len)
    fail("Malformed HT codeblock. Invalid codeblock length values.");
  const int lcup = int(lengths1);
  const int scup = (int(coded[lcup - 1]) << 4) + (coded[lcup - 2] & 0xF);
  if (scup < 2 || scup > lcup || scup > 4079)
    fail("Malformed HT codeblock. One of the following condition is not met: 2 <= Scup <= min(Lcup, 4079)");

  Mel mel;
  if (!mel.init(coded, lcup, scup, b.align)) fail("Malformed HT codeblock. Incorrect MEL segment sequence.");
  Rev vlc;
  vlc.init_vlc(coded, lcup, scup);
  Frwd magsgn;
  magsgn.init(coded, lcup - scup, 0xFF);
  Frwd sigprop;
  Rev magref;
  if (num_passes > 1) sigprop.init(coded + lengths1, int(lengths2), 0);
  if (num_passes > 2) magref.init_mrp(coded, int(lengths1), int(lengths2));

  // sigma1, sigma2: 4 rows x 8 columns of significance a word (a nibble a
  // column, its low bit the stripe's first row); mbr1, mbr2 the samples
  // SigProp visits; line_state a byte a quad boundary: bit 7 the
  // significance, the low 7 bits the largest exponent of the row above
  uint32_t sigma1[132] = {}, sigma2[132] = {}, mbr1[132] = {}, mbr2[132] = {};
  uint8_t line_state[528] = {};
  uint32_t* decoded = reinterpret_cast<uint32_t*>(out.data());
  uint32_t* sip = sigma1;
  uint32_t sip_shift = 0;
  const bool stripe_causal = b.causal;

  // the initial row pair
  uint8_t* lsp = line_state;
  lsp[0] = 0;
  int run = mel.get_run();
  uint32_t qinf[2] = {0, 0};
  uint32_t c_q = 0;
  uint32_t* sp = decoded;
  for (int32_t x = 0; x < width; x += 4) {
    uint32_t U_q[2];
    uint32_t vlc_val = vlc.fetch();
    qinf[0] = kHtVlcTable0[(c_q << 7) | (vlc_val & 0x7F)];
    if (c_q == 0) {
      run -= 2;
      qinf[0] = run == -1 ? qinf[0] : 0;
      if (run < 0) run = mel.get_run();
    }
    c_q = ((qinf[0] & 0x10) >> 4) | ((qinf[0] & 0xE0) >> 5);
    vlc_val = vlc.advance(qinf[0] & 0x7);
    *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2)) << sip_shift;
    qinf[1] = 0;
    if (x + 2 < width) {
      qinf[1] = kHtVlcTable0[(c_q << 7) | (vlc_val & 0x7F)];
      if (c_q == 0) {
        run -= 2;
        qinf[1] = run == -1 ? qinf[1] : 0;
        if (run < 0) run = mel.get_run();
      }
      c_q = ((qinf[1] & 0x10) >> 4) | ((qinf[1] & 0xE0) >> 5);
      vlc_val = vlc.advance(qinf[1] & 0x7);
    }
    *sip |= ((qinf[1] & 0x30) | ((qinf[1] & 0xC0) << 2)) << (4 + sip_shift);
    sip += x & 0x7 ? 1 : 0;
    sip_shift ^= 0x10;

    uint32_t uvlc_mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
    if (uvlc_mode == 3) {
      run -= 2;
      uvlc_mode += run == -1 ? 1 : 0;
      if (run < 0) run = mel.get_run();
    }
    const uint32_t consumed = decode_init_uvlc(vlc_val, uvlc_mode, U_q);
    if (U_q[0] > zero_bplanes_p1 || U_q[1] > zero_bplanes_p1)
      fail("Malformed HT codeblock. Decoding this codeblock is stopped. U_q is larger than zero bitplanes + 1");
    vlc_val = vlc.advance(consumed);

    uint32_t locs = 0xFF;
    if (x + 4 > width) locs >>= (x + 4 - width) << 1;
    locs = height > 1 ? locs : (locs & 0x55);
    if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs)
      fail("Malformed HT codeblock. VLC code produces significant samples outside the codeblock area.");

    uint32_t v_n;
    for (int q = 0; q < 2; q++) {
      const uint32_t qi = qinf[q];
      const uint32_t lo = q * 4;  // the quad's bits in locs
      if (qi & 0x10) {
        sp[0] = magsgn_sample(magsgn, U_q[q], qi, 0, p, &v_n);
      } else if (locs & (0x1u << lo)) {
        sp[0] = 0;
      }
      if (qi & 0x20) {
        sp[stride] = magsgn_sample(magsgn, U_q[q], qi, 1, p, &v_n);
        const uint32_t t = lsp[0] & 0x7F;
        v_n = 32 - count_leading_zeros(v_n);
        lsp[0] = uint8_t(0x80 | (t > v_n ? t : v_n));
      } else if (locs & (0x2u << lo)) {
        sp[stride] = 0;
      }
      ++lsp;
      ++sp;
      if (qi & 0x40) {
        sp[0] = magsgn_sample(magsgn, U_q[q], qi, 2, p, &v_n);
      } else if (locs & (0x4u << lo)) {
        sp[0] = 0;
      }
      lsp[0] = 0;
      if (qi & 0x80) {
        sp[stride] = magsgn_sample(magsgn, U_q[q], qi, 3, p, &v_n);
        lsp[0] = uint8_t(0x80 | (32 - count_leading_zeros(v_n)));
      } else if (locs & (0x8u << lo)) {
        sp[stride] = 0;
      }
      ++sp;
    }
  }

  // the later row pairs, SigProp and MagRef behind them a stripe at a time
  for (int32_t y = 2; y < height;) {
    sip_shift ^= 0x2;
    sip_shift &= 0xFFFFFFEFU;
    sip = y & 0x4 ? sigma2 : sigma1;
    lsp = line_state;
    uint8_t ls0 = lsp[0];
    lsp[0] = 0;
    sp = decoded + y * stride;
    c_q = 0;
    for (int32_t x = 0; x < width; x += 4) {
      uint32_t U_q[2];
      c_q |= ls0 >> 7;
      c_q |= (lsp[1] >> 5) & 0x4;
      uint32_t vlc_val = vlc.fetch();
      qinf[0] = kHtVlcTable1[(c_q << 7) | (vlc_val & 0x7F)];
      if (c_q == 0) {
        run -= 2;
        qinf[0] = run == -1 ? qinf[0] : 0;
        if (run < 0) run = mel.get_run();
      }
      c_q = ((qinf[0] & 0x40) >> 5) | ((qinf[0] & 0x80) >> 6);
      vlc_val = vlc.advance(qinf[0] & 0x7);
      *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2)) << sip_shift;
      qinf[1] = 0;
      if (x + 2 < width) {
        c_q |= lsp[1] >> 7;
        c_q |= (lsp[2] >> 5) & 0x4;
        qinf[1] = kHtVlcTable1[(c_q << 7) | (vlc_val & 0x7F)];
        if (c_q == 0) {
          run -= 2;
          qinf[1] = run == -1 ? qinf[1] : 0;
          if (run < 0) run = mel.get_run();
        }
        c_q = ((qinf[1] & 0x40) >> 5) | ((qinf[1] & 0x80) >> 6);
        vlc_val = vlc.advance(qinf[1] & 0x7);
      }
      *sip |= ((qinf[1] & 0x30) | ((qinf[1] & 0xC0) << 2)) << (4 + sip_shift);
      sip += x & 0x7 ? 1 : 0;
      sip_shift ^= 0x10;

      const uint32_t uvlc_mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
      const uint32_t consumed = decode_noninit_uvlc(vlc_val, uvlc_mode, U_q);
      vlc_val = vlc.advance(consumed);
      // kappa from the row above where the quad holds two or more
      // significant samples (U_q already holds u + 1)
      if ((qinf[0] & 0xF0) & ((qinf[0] & 0xF0) - 1)) {
        uint32_t E = ls0 & 0x7Fu;
        E = E > (lsp[1] & 0x7Fu) ? E : (lsp[1] & 0x7Fu);
        U_q[0] += E > 2 ? E - 2 : 0;
      }
      if ((qinf[1] & 0xF0) & ((qinf[1] & 0xF0) - 1)) {
        uint32_t E = lsp[1] & 0x7Fu;
        E = E > (lsp[2] & 0x7Fu) ? E : (lsp[2] & 0x7Fu);
        U_q[1] += E > 2 ? E - 2 : 0;
      }
      if (U_q[0] > zero_bplanes_p1 || U_q[1] > zero_bplanes_p1)
        fail("Malformed HT codeblock. Decoding this codeblock is stopped. U_q is larger than bitplanes + 1");
      ls0 = lsp[2];
      lsp[1] = lsp[2] = 0;

      uint32_t locs = 0xFF;
      if (x + 4 > width) locs >>= (x + 4 - width) << 1;
      locs = y + 2 <= height ? locs : (locs & 0x55);
      if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs)
        fail("Malformed HT codeblock. VLC code produces significant samples outside the codeblock area.");

      uint32_t v_n;
      for (int q = 0; q < 2; q++) {
        const uint32_t qi = qinf[q];
        const uint32_t lo = q * 4;
        if (qi & 0x10) {
          sp[0] = magsgn_sample(magsgn, U_q[q], qi, 0, p, &v_n);
        } else if (locs & (0x1u << lo)) {
          sp[0] = 0;
        }
        if (qi & 0x20) {
          sp[stride] = magsgn_sample(magsgn, U_q[q], qi, 1, p, &v_n);
          const uint32_t t = lsp[0] & 0x7F;
          v_n = 32 - count_leading_zeros(v_n);
          lsp[0] = uint8_t(0x80 | (t > v_n ? t : v_n));
        } else if (locs & (0x2u << lo)) {
          sp[stride] = 0;
        }
        ++lsp;
        ++sp;
        if (qi & 0x40) {
          sp[0] = magsgn_sample(magsgn, U_q[q], qi, 2, p, &v_n);
        } else if (locs & (0x4u << lo)) {
          sp[0] = 0;
        }
        if (qi & 0x80) {
          sp[stride] = magsgn_sample(magsgn, U_q[q], qi, 3, p, &v_n);
          lsp[0] = uint8_t(0x80 | (32 - count_leading_zeros(v_n)));
        } else if (locs & (0x8u << lo)) {
          sp[stride] = 0;
        }
        ++sp;
      }
    }
    y += 2;

    if (num_passes > 1 && (y & 3) == 0) {
      if (num_passes > 2) magref_stripe(magref, decoded + (y - 4) * stride, stride, width,
                                        y & 0x4 ? sigma1 : sigma2, p);
      if (y >= 4) stripe_membership(y & 0x4 ? sigma1 : sigma2, y & 0x4 ? mbr1 : mbr2, width);
      if (y >= 8) {
        uint32_t* cur_sig = y & 0x4 ? sigma2 : sigma1;
        uint32_t* cur_mbr = y & 0x4 ? mbr2 : mbr1;
        uint32_t* nxt_sig = y & 0x4 ? sigma1 : sigma2;
        uint32_t* nxt_mbr = y & 0x4 ? mbr1 : mbr2;
        next_membership(cur_mbr, cur_sig, nxt_sig, width, stripe_causal);
        sigprop_stripe(sigprop, decoded + (y - 8) * stride, stride, width, cur_sig, cur_mbr, nxt_sig,
                       nxt_mbr, 0xFFFFFFFFu, p);
        std::memset(cur_sig, 0, (((uint32_t(width) + 7u) >> 3) + 1u) << 2);
      }
    }
  }

  // the last stripes
  if (num_passes > 1) {
    if (num_passes > 2 && ((height & 3) == 1 || (height & 3) == 2))
      magref_stripe(magref, decoded + (height & 0xFFFFFC) * stride, stride, width,
                    height & 0x4 ? sigma2 : sigma1, p);
    if ((height & 3) == 1 || (height & 3) == 2)
      stripe_membership(height & 0x4 ? sigma2 : sigma1, height & 0x4 ? mbr2 : mbr1, width);
    int32_t st = height;
    st -= height > 6 ? (((height + 1) & 3) + 3) : height;
    for (int32_t y = st; y < height; y += 4) {
      uint32_t pattern = 0xFFFFFFFFu;
      if (height - y == 3) {
        pattern = 0x77777777u;
      } else if (height - y == 2) {
        pattern = 0x33333333u;
      } else if (height - y == 1) {
        pattern = 0x11111111u;
      }
      uint32_t* cur_sig = y & 0x4 ? sigma2 : sigma1;
      uint32_t* cur_mbr = y & 0x4 ? mbr2 : mbr1;
      uint32_t* nxt_sig = y & 0x4 ? sigma1 : sigma2;
      uint32_t* nxt_mbr = y & 0x4 ? mbr1 : mbr2;
      if (height - y > 4) next_membership(cur_mbr, cur_sig, nxt_sig, width, stripe_causal);
      sigprop_stripe(sigprop, decoded + y * stride, stride, width, cur_sig, cur_mbr, nxt_sig, nxt_mbr,
                     pattern, p);
    }
  }

  for (int32_t i = 0; i < width * height; ++i) {
    const int32_t v = int32_t(decoded[i] & 0x7FFFFFFF);
    out[size_t(i)] = (decoded[i] & 0x80000000u) ? -v : v;
  }
}

}  // namespace mrt
