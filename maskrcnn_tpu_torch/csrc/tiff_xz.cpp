// TIFF's LZMA compression (34925): one strip or tile, an .xz stream, as
// libtiff 4.7's LZMADecode reads it over liblzma 5.8 (Pillow 12.1's
// libraries).
//
// libtiff opens a stream decoder for each strip (lzma_stream_decoder(...,
// UINT64_MAX, 0): no memory limit, no flags) and calls lzma_code until the
// stream ends, an error comes or the strip's bytes are out; the strip fails
// only when its bytes are not all out, so nothing the stream holds after
// them is looked at, and decoding here stops there too. Before that, what
// liblzma reads and checks:
//
// * the stream header: magic, flags (check ID, reserved bits) and their
//   CRC32;
// * each block header: its size byte, CRC32, flags, the optional
//   compressed and uncompressed sizes (variable-length integers, the
//   shortest form only), one to four filter flags (LZMA2's dictionary
//   size and its lc/lp/pb limits, Delta's distance, a chain of Delta and
//   BCJ filters then LZMA2; the BCJ filters x86, PowerPC, IA-64, ARM, ARM-Thumb, SPARC,
//   ARM64 and RISC-V with their start offsets), zero padding;
// * LZMA2: uncompressed and LZMA chunks, the dictionary, state and
//   property resets and the chunks that must come first, lc + lp <= 4,
//   each chunk's sizes, the range decoder's end; LZMA as liblzma decodes
//   it (distances within the dictionary, lengths within the chunk); the
//   Delta and BCJ filters after it;
// * the block's end: its sizes against the header's, its padding, and its
//   check (none, CRC32, CRC64 or SHA-256 verified; another ID skipped
//   unverified, as liblzma does without LZMA_TELL_UNSUPPORTED_CHECK).
//
// The index, the stream footer and anything after the stream hold no data,
// so a strip whose bytes are all out never reaches them, and one whose bytes
// are not fails whatever they hold.

#include <algorithm>
#include <cstring>
#include <vector>

#include "image_codec.h"

namespace mrt {
namespace {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;

[[noreturn]] void fail(const std::string& what) { corrupt("TIFF: LZMA data: " + what); }

// the input ends before the strip is full
struct Starved {};
// the strip is full: what follows is not read
struct Full {};

inline u32 le32(const u8* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<u32>(p[3]) << 24);
}
inline u64 le64(const u8* p) {
  u64 v = 0;
  for (int i = 7; i >= 0; i--) v = (v << 8) | p[i];
  return v;
}

// --------------------------------------------------------------- checks

u32 crc32(const u8* p, size_t n) {
  static u32 table[256];
  static bool init = false;
  if (!init) {
    for (u32 i = 0; i < 256; i++) {
      u32 c = i;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1)));
      table[i] = c;
    }
    init = true;
  }
  u32 c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

u64 crc64(const u8* p, size_t n) {
  static u64 table[256];
  static bool init = false;
  if (!init) {
    for (u64 i = 0; i < 256; i++) {
      u64 c = i;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0xC96C5795D7870F42ULL & (0 - (c & 1)));
      table[i] = c;
    }
    init = true;
  }
  u64 c = ~u64{0};
  for (size_t i = 0; i < n; i++) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return ~c;
}

void sha256(const u8* p, size_t n, u8 digest[32]) {
  static const u32 k[64] = {
      0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4,
      0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe,
      0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc, 0x2de92c6f,
      0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
      0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
      0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
      0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116,
      0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
      0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7,
      0xc67178f2};
  u32 h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
              0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  auto rotr = [](u32 x, int r) { return (x >> r) | (x << (32 - r)); };
  std::vector<u8> m(p, p + n);
  m.push_back(0x80);
  while (m.size() % 64 != 56) m.push_back(0);
  const u64 bits = static_cast<u64>(n) * 8;
  for (int i = 7; i >= 0; i--) m.push_back(static_cast<u8>(bits >> (8 * i)));
  for (size_t off = 0; off < m.size(); off += 64) {
    u32 w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (u32{m[off + 4 * i]} << 24) | (u32{m[off + 4 * i + 1]} << 16) |
             (u32{m[off + 4 * i + 2]} << 8) | m[off + 4 * i + 3];
    for (int i = 16; i < 64; i++) {
      const u32 s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      const u32 s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    u32 a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      const u32 t1 = hh + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) + k[i] + w[i];
      const u32 t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
      hh = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = b;
      b = a;
      a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 4; j++) digest[4 * i + j] = static_cast<u8>(h[i] >> (24 - 8 * j));
}

// lzma_check_size
const int kCheckSize[16] = {0, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64};

// ----------------------------------------------------------------- LZMA

constexpr int kStates = 12, kPosStatesMax = 16, kLiteralCoderSize = 0x300;
constexpr int kDistStates = 4, kDistSlots = 64, kDistModelStart = 4, kDistModelEnd = 14;
constexpr int kFullDistances = 128, kAlignBits = 4;
constexpr int kLenLow = 8, kLenMid = 8, kLenHigh = 256;
constexpr u32 kTop = 1u << 24;

struct LenCoder {
  u16 choice, choice2;
  u16 low[kPosStatesMax][kLenLow];
  u16 mid[kPosStatesMax][kLenMid];
  u16 high[kLenHigh];
};

// A block's LZMA2 decoder and its Delta filters, writing to the strip.
struct Lzma2 {
  const u8* in;
  size_t pos = 0, stop = 0;   // input read, and where the block's input ends
  // the block's LZMA2 output (the dictionary), and where the last
  // dictionary reset was
  std::vector<u8> dict;
  size_t dict_start = 0;
  size_t dict_size = 0;       // liblzma's, rounded
  // out: the strip, got: its bytes written, cap: its size; limit: the
  // block's declared uncompressed size or none
  u8* out;
  size_t cap;
  size_t* got;
  u64 produced = 0, limit = ~u64{0};
  std::vector<int> deltas;    // distances, in the order they undo
  std::vector<std::vector<u8>> delta_hist;
  std::vector<u8> delta_pos;

  // LZMA state
  int lc = 0, lp = 0, pb = 0;
  int state = 0;
  u32 rep[4] = {0, 0, 0, 0};
  std::vector<u16> literal;
  u16 is_match[kStates][kPosStatesMax], is_rep[kStates], is_rep0[kStates], is_rep1[kStates],
      is_rep2[kStates], is_rep0_long[kStates][kPosStatesMax];
  u16 dist_slot[kDistStates][kDistSlots];
  u16 dist_special[kFullDistances - kDistModelEnd];
  u16 dist_align[1 << kAlignBits];
  LenCoder match_len, rep_len;
  u32 range = 0, code = 0;
  // LZMA2
  bool need_dict_reset = true, need_props = true;

  // the strip takes one more byte (Delta filters first); Full once the strip is full
  void emit(u8 b) {
    // the block's declared uncompressed size reached: liblzma's block
    // decoder gives the filters no more room, and the block fails
    if (produced == limit) fail("corrupt block (more data than its uncompressed size)");
    dict.push_back(b);
    produced++;
    for (size_t k = 0; k < deltas.size(); k++) {
      std::vector<u8>& h = delta_hist[k];
      u8& p = delta_pos[k];
      b = static_cast<u8>(b + h[(deltas[k] + p) & 0xFF]);
      h[p-- & 0xFF] = b;
    }
    out[(*got)++] = b;
    if (*got == cap) throw Full{};
  }

  u8 byte() {
    if (pos >= stop) throw Starved{};
    return in[pos++];
  }

  void reset_state() {
    state = 0;
    rep[0] = rep[1] = rep[2] = rep[3] = 0;
    literal.assign(static_cast<size_t>(kLiteralCoderSize) << (lc + lp), 1024);
    auto fill = [](u16* p, size_t n) { std::fill(p, p + n, u16{1024}); };
    fill(&is_match[0][0], sizeof(is_match) / 2);
    fill(is_rep, kStates);
    fill(is_rep0, kStates);
    fill(is_rep1, kStates);
    fill(is_rep2, kStates);
    fill(&is_rep0_long[0][0], sizeof(is_rep0_long) / 2);
    fill(&dist_slot[0][0], sizeof(dist_slot) / 2);
    fill(dist_special, sizeof(dist_special) / 2);
    fill(dist_align, sizeof(dist_align) / 2);
    fill(reinterpret_cast<u16*>(&match_len), sizeof(LenCoder) / 2);
    fill(reinterpret_cast<u16*>(&rep_len), sizeof(LenCoder) / 2);
  }

  // the range decoder: normalized before each bit, as liblzma does
  void normalize() {
    if (range < kTop) {
      range <<= 8;
      code = (code << 8) | byte();
    }
  }
  int bit(u16& p) {
    normalize();
    const u32 bound = (range >> 11) * p;
    if (code < bound) {
      range = bound;
      p = static_cast<u16>(p + ((2048 - p) >> 5));
      return 0;
    }
    range -= bound;
    code -= bound;
    p = static_cast<u16>(p - (p >> 5));
    return 1;
  }
  u32 tree(u16* probs, int bits) {
    u32 m = 1;
    for (int i = 0; i < bits; i++) m = (m << 1) | bit(probs[m]);
    return m - (1u << bits);
  }
  u32 reverse(u16* probs, int bits) {
    u32 m = 1, sym = 0;
    for (int i = 0; i < bits; i++) {
      const int b = bit(probs[m]);
      m = (m << 1) | b;
      sym |= static_cast<u32>(b) << i;
    }
    return sym;
  }
  u32 direct(int bits) {
    u32 v = 0;
    for (int i = 0; i < bits; i++) {
      normalize();
      range >>= 1;
      code -= range;
      const u32 t = 0u - (code >> 31);
      code += range & t;
      v = (v << 1) + (t + 1);
    }
    return v;
  }
  u32 length(LenCoder& c, u32 pos_state) {
    if (!bit(c.choice)) return 2 + tree(c.low[pos_state], 3);
    if (!bit(c.choice2)) return 2 + 8 + tree(c.mid[pos_state], 3);
    return 2 + 16 + tree(c.high, 8);
  }

  size_t since_reset() const { return dict.size() - dict_start; }
  // lzma_dict.full: the bytes since the reset, at most the dictionary
  bool distance_ok(u32 dist) const { return std::min(since_reset(), dict_size) > dist; }
  u8 back(u32 dist) const { return dict[dict.size() - 1 - dist]; }

  // one LZMA chunk of `usize` bytes from compressed bytes [pos, pos + csize)
  void lzma_chunk(u32 usize, u32 csize) {
    const size_t chunk_start = pos;
    // the range decoder's five bytes, the first of them 0
    range = 0xFFFFFFFFu;
    code = 0;
    for (int i = 0; i < 5; i++) {
      const u8 b = byte();
      if (i == 0 && b != 0) fail("corrupt data (range coder)");
      code = (code << 8) | b;
    }
    const u32 pb_mask = (1u << pb) - 1, lp_mask = (1u << lp) - 1;
    u32 left = usize;
    // a chunk that reads past its compressed size: liblzma finds it out
    // after the bytes are out
    auto overrun = [&]() { return pos - chunk_start > csize; };
    try {
      while (left) {
        const u32 ps = static_cast<u32>(since_reset()) & pb_mask;
        if (!bit(is_match[state][ps])) {
          // literal
          const u32 lpos = static_cast<u32>(since_reset()) & lp_mask;
          const u8 prev = since_reset() ? back(0) : 0;
          u16* probs = &literal[kLiteralCoderSize * ((lpos << lc) + (prev >> (8 - lc)))];
          u32 sym = 1;
          if (state >= 7) {
            u32 match_byte = back(rep[0]);
            u32 offset = 0x100;
            do {
              match_byte <<= 1;
              const u32 match_bit = match_byte & offset;
              const u32 i = offset + match_bit + sym;
              const int b = bit(probs[i]);
              sym = (sym << 1) | b;
              offset &= b ? match_bit : ~match_bit;
            } while (sym < 0x100);
          } else {
            while (sym < 0x100) sym = (sym << 1) | bit(probs[sym]);
          }
          state = state < 4 ? 0 : state < 10 ? state - 3 : state - 6;
          emit(static_cast<u8>(sym));
          left--;
          continue;
        }
        u32 len;
        if (bit(is_rep[state])) {
          if (!since_reset()) fail("corrupt data (a repeated match at the start)");
          if (!bit(is_rep0[state])) {
            if (!bit(is_rep0_long[state][ps])) {
              // short rep: one byte at rep0
              state = state < 7 ? 9 : 11;
              emit(back(rep[0]));
              left--;
              continue;
            }
          } else {
            u32 dist;
            if (!bit(is_rep1[state])) {
              dist = rep[1];
            } else {
              if (!bit(is_rep2[state])) {
                dist = rep[2];
              } else {
                dist = rep[3];
                rep[3] = rep[2];
              }
              rep[2] = rep[1];
            }
            rep[1] = rep[0];
            rep[0] = dist;
          }
          state = state < 7 ? 8 : 11;
          len = length(rep_len, ps);
        } else {
          rep[3] = rep[2];
          rep[2] = rep[1];
          rep[1] = rep[0];
          len = length(match_len, ps);
          state = state < 7 ? 7 : 10;
          const u32 slot = tree(dist_slot[std::min<u32>(len - 2, kDistStates - 1)], 6);
          u32 dist;
          if (slot < kDistModelStart) {
            dist = slot;
          } else {
            const int limit = static_cast<int>(slot >> 1) - 1;
            dist = (2 | (slot & 1)) << limit;
            if (slot < kDistModelEnd) {
              dist += reverse(dist_special + dist - slot - 1, limit);
            } else {
              dist += direct(limit - kAlignBits) << kAlignBits;
              dist += reverse(dist_align, kAlignBits);
            }
          }
          rep[0] = dist;
          if (dist == 0xFFFFFFFFu) fail("corrupt data (an end marker in an LZMA2 chunk)");
        }
        if (!distance_ok(rep[0])) fail("corrupt data (a distance past the dictionary)");
        // the copy, cut at the chunk's end (which liblzma then reports)
        const u32 n = std::min(len, left);
        for (u32 k = 0; k < n; k++) emit(back(rep[0]));
        left -= n;
        if (n < len) fail("corrupt data (a match past the chunk's end)");
      }
      // the chunk's last symbol out: liblzma normalizes the range decoder
      // once more (SEQ_NORMALIZE) before its end checks
      normalize();
    } catch (const Starved&) {
      if (overrun()) fail("corrupt data (an LZMA chunk past its compressed size)");
      throw;
    }
    if (overrun()) fail("corrupt data (an LZMA chunk past its compressed size)");
    if (code != 0) fail("corrupt data (the range decoder did not end)");
    if (pos - chunk_start != csize) fail("corrupt data (an LZMA chunk short of its compressed size)");
  }

  // lzma2_decode until its end marker
  void run() {
    for (;;) {
      const u32 control = byte();
      if (control == 0) return;
      if (control >= 0xE0 || control == 1) {
        need_props = true;
        need_dict_reset = true;
      } else if (need_dict_reset) {
        fail("corrupt data (no dictionary reset at the start)");
      }
      if (control >= 0x80) {
        u32 usize = (control & 0x1F) << 16;
        bool props = false;
        if (control >= 0xC0) {
          need_props = false;
          props = true;
        } else if (need_props) {
          fail("corrupt data (an LZMA chunk without properties)");
        } else if (control >= 0xA0) {
          reset_state();
        }
        if (need_dict_reset) {
          need_dict_reset = false;
          dict_start = dict.size();
        }
        usize += u32{byte()} << 8;
        usize += byte() + 1u;
        u32 csize = u32{byte()} << 8;
        csize += byte() + 1u;
        if (props) {
          u32 b = byte();
          if (b > (4 * 5 + 4) * 9 + 8) fail("corrupt data (LZMA properties)");
          pb = static_cast<int>(b / 45);
          b -= static_cast<u32>(pb) * 45;
          lp = static_cast<int>(b / 9);
          lc = static_cast<int>(b - static_cast<u32>(lp) * 9);
          if (lc + lp > 4) fail("corrupt data (lc + lp above 4)");
          reset_state();
        }
        lzma_chunk(usize, csize);
      } else {
        if (control > 2) fail("corrupt data (LZMA2 control byte)");
        if (need_dict_reset) {
          need_dict_reset = false;
          dict_start = dict.size();
        }
        u32 csize = u32{byte()} << 8;
        csize += byte() + 1u;
        for (u32 k = 0; k < csize; k++) emit(byte());
      }
    }
  }
};

// liblzma's BCJ filters (simple/*.c), decoding: each converts what it
// can of buf[0, size) at stream position now (a block's start offset
// on), and returns how many bytes it converted; the rest waits for more
// data, or passes as it is at the block's end. Called once over a whole
// block's data they give what liblzma's buffered calls give.
struct Bcj {
  u64 id;
  u32 start;
  u32 prev_mask = 0, prev_pos = static_cast<u32>(-5);  // x86's state

  static u32 r32le(const u8* p) { return le32(p); }
  static void w32le(u8* p, u32 v) {
    for (int i = 0; i < 4; i++) p[i] = static_cast<u8>(v >> (8 * i));
  }
  static u32 r32be(const u8* p) {
    return (static_cast<u32>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
  }

  // the bytes a call may leave unconverted (simple_coder's unfiltered_max)
  static size_t unfiltered_max(u64 id) {
    return id == 4 ? 5 : id == 6 ? 16 : id == 11 ? 8 : 4;
  }

  size_t x86(u32 now, u8* b, size_t size) {
    static const u32 kBits[8] = {0, 1, 2, 2, 3, 3, 3, 3};
    auto ms = [](u32 v) { return ((v + 1) & 0xFE) == 0; };
    if (size < 5) return 0;
    if (now - prev_pos > 5) prev_pos = now - 5;
    const size_t limit = size - 5;
    size_t i = 0;
    while (i <= limit) {
      u32 c = b[i];
      if (c != 0xE8 && c != 0xE9) {
        ++i;
        continue;
      }
      const u32 offset = now + static_cast<u32>(i) - prev_pos;
      prev_pos = now + static_cast<u32>(i);
      if (offset > 5) {
        prev_mask = 0;
      } else {
        for (u32 k = 0; k < offset; ++k) {
          prev_mask &= 0x77;
          prev_mask <<= 1;
        }
      }
      c = b[i + 4];
      if (ms(c) && (prev_mask >> 1) <= 4 && (prev_mask >> 1) != 3) {
        u32 src = (c << 24) | (static_cast<u32>(b[i + 3]) << 16) | (static_cast<u32>(b[i + 2]) << 8) | b[i + 1];
        u32 dest;
        for (;;) {
          dest = src - (now + static_cast<u32>(i) + 5);
          if (prev_mask == 0) break;
          const u32 k = kBits[prev_mask >> 1];
          c = static_cast<u8>(dest >> (24 - k * 8));
          if (!ms(c)) break;
          src = dest ^ ((1u << (32 - k * 8)) - 1);
        }
        b[i + 4] = static_cast<u8>(~(((dest >> 24) & 1) - 1));
        b[i + 3] = static_cast<u8>(dest >> 16);
        b[i + 2] = static_cast<u8>(dest >> 8);
        b[i + 1] = static_cast<u8>(dest);
        i += 5;
        prev_mask = 0;
      } else {
        ++i;
        prev_mask |= 1;
        if (ms(c)) prev_mask |= 0x10;
      }
    }
    return i;
  }

  static size_t powerpc(u32 now, u8* b, size_t size) {
    size &= ~size_t{3};
    size_t i;
    for (i = 0; i < size; i += 4) {
      if ((b[i] >> 2) != 0x12 || (b[i + 3] & 3) != 1) continue;
      const u32 src = ((static_cast<u32>(b[i]) & 3) << 24) | (static_cast<u32>(b[i + 1]) << 16) |
                      (static_cast<u32>(b[i + 2]) << 8) | (static_cast<u32>(b[i + 3]) & ~3u);
      const u32 dest = src - (now + static_cast<u32>(i));
      b[i] = static_cast<u8>(0x48 | ((dest >> 24) & 3));
      b[i + 1] = static_cast<u8>(dest >> 16);
      b[i + 2] = static_cast<u8>(dest >> 8);
      b[i + 3] = static_cast<u8>((b[i + 3] & 3) | (dest & 0xFF));
    }
    return i;
  }

  static size_t ia64(u32 now, u8* b, size_t size) {
    static const u32 kBranch[32] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    4, 4, 6, 6, 0, 0, 7, 7, 4, 4, 0, 0, 4, 4, 0, 0};
    size &= ~size_t{15};
    size_t i;
    for (i = 0; i < size; i += 16) {
      const u32 mask = kBranch[b[i] & 0x1F];
      u32 bit_pos = 5;
      for (int slot = 0; slot < 3; ++slot, bit_pos += 41) {
        if (((mask >> slot) & 1) == 0) continue;
        const size_t byte_pos = bit_pos >> 3;
        const u32 bit_res = bit_pos & 7;
        u64 instr = 0;
        for (int j = 0; j < 6; ++j) instr += static_cast<u64>(b[i + j + byte_pos]) << (8 * j);
        u64 norm = instr >> bit_res;
        if (((norm >> 37) & 0xF) != 0x5 || ((norm >> 9) & 0x7) != 0) continue;
        u32 src = static_cast<u32>((norm >> 13) & 0xFFFFF);
        src |= static_cast<u32>((norm >> 36) & 1) << 20;
        src <<= 4;
        u32 dest = src - (now + static_cast<u32>(i));
        dest >>= 4;
        norm &= ~(static_cast<u64>(0x8FFFFF) << 13);
        norm |= static_cast<u64>(dest & 0xFFFFF) << 13;
        norm |= static_cast<u64>(dest & 0x100000) << (36 - 20);
        instr &= (1u << bit_res) - 1;
        instr |= norm << bit_res;
        for (int j = 0; j < 6; j++) b[i + j + byte_pos] = static_cast<u8>(instr >> (8 * j));
      }
    }
    return i;
  }

  static size_t arm(u32 now, u8* b, size_t size) {
    size &= ~size_t{3};
    size_t i;
    for (i = 0; i < size; i += 4) {
      if (b[i + 3] != 0xEB) continue;
      u32 src = (static_cast<u32>(b[i + 2]) << 16) | (static_cast<u32>(b[i + 1]) << 8) | b[i];
      src <<= 2;
      u32 dest = src - (now + static_cast<u32>(i) + 8);
      dest >>= 2;
      b[i + 2] = static_cast<u8>(dest >> 16);
      b[i + 1] = static_cast<u8>(dest >> 8);
      b[i] = static_cast<u8>(dest);
    }
    return i;
  }

  static size_t armthumb(u32 now, u8* b, size_t size) {
    if (size < 4) return 0;
    size -= 4;
    size_t i;
    for (i = 0; i <= size; i += 2) {
      if ((b[i + 1] & 0xF8) != 0xF0 || (b[i + 3] & 0xF8) != 0xF8) continue;
      u32 src = ((static_cast<u32>(b[i + 1]) & 7) << 19) | (static_cast<u32>(b[i]) << 11) |
                ((static_cast<u32>(b[i + 3]) & 7) << 8) | b[i + 2];
      src <<= 1;
      u32 dest = src - (now + static_cast<u32>(i) + 4);
      dest >>= 1;
      b[i + 1] = static_cast<u8>(0xF0 | ((dest >> 19) & 7));
      b[i] = static_cast<u8>(dest >> 11);
      b[i + 3] = static_cast<u8>(0xF8 | ((dest >> 8) & 7));
      b[i + 2] = static_cast<u8>(dest);
      i += 2;
    }
    return i;
  }

  static size_t sparc(u32 now, u8* b, size_t size) {
    size &= ~size_t{3};
    size_t i;
    for (i = 0; i < size; i += 4) {
      if (!((b[i] == 0x40 && (b[i + 1] & 0xC0) == 0) || (b[i] == 0x7F && (b[i + 1] & 0xC0) == 0xC0)))
        continue;
      u32 src = r32be(b + i);
      src <<= 2;
      u32 dest = src - (now + static_cast<u32>(i));
      dest >>= 2;
      dest = (((0u - ((dest >> 22) & 1)) << 22) & 0x3FFFFFFF) | (dest & 0x3FFFFF) | 0x40000000;
      for (int k = 0; k < 4; k++) b[i + k] = static_cast<u8>(dest >> (24 - 8 * k));
    }
    return i;
  }

  static size_t arm64(u32 now, u8* b, size_t size) {
    size &= ~size_t{3};
    size_t i;
    for (i = 0; i < size; i += 4) {
      u32 pc = now + static_cast<u32>(i);
      u32 instr = r32le(b + i);
      if ((instr >> 26) == 0x25) {
        const u32 src = instr;
        pc >>= 2;
        pc = 0u - pc;
        w32le(b + i, 0x94000000u | ((src + pc) & 0x03FFFFFF));
      } else if ((instr & 0x9F000000u) == 0x90000000u) {
        const u32 src = ((instr >> 29) & 3) | ((instr >> 3) & 0x001FFFFC);
        if ((src + 0x00020000) & 0x001C0000) continue;
        instr &= 0x9000001Fu;
        pc >>= 12;
        pc = 0u - pc;
        const u32 dest = src + pc;
        instr |= (dest & 3) << 29;
        instr |= (dest & 0x0003FFFC) << 3;
        instr |= (0u - (dest & 0x00020000)) & 0x00E00000;
        w32le(b + i, instr);
      }
    }
    return i;
  }

  static size_t riscv(u32 now, u8* b, size_t size) {
    if (size < 8) return 0;
    size -= 8;
    size_t i;
    for (i = 0; i <= size; i += 2) {
      u32 inst = b[i];
      if (inst == 0xEF) {
        // JAL with rd x1 or x5
        const u32 b1 = b[i + 1];
        if ((b1 & 0x0D) != 0) continue;
        const u32 b2 = b[i + 2], b3 = b[i + 3];
        const u32 pc = now + static_cast<u32>(i);
        u32 addr = ((b1 & 0xF0) << 13) | (b2 << 9) | (b3 << 1);
        addr -= pc;
        b[i + 1] = static_cast<u8>((b1 & 0x0F) | ((addr >> 8) & 0xF0));
        b[i + 2] = static_cast<u8>(((addr >> 16) & 0x0F) | ((addr >> 7) & 0x10) | ((addr << 4) & 0xE0));
        b[i + 3] = static_cast<u8>(((addr >> 4) & 0x7F) | ((addr >> 13) & 0x80));
        i += 4 - 2;
      } else if ((inst & 0x7F) == 0x17) {
        // AUIPC and the instruction after it
        u32 inst2;
        inst |= static_cast<u32>(b[i + 1]) << 8;
        inst |= static_cast<u32>(b[i + 2]) << 16;
        inst |= static_cast<u32>(b[i + 3]) << 24;
        if (inst & 0xE80) {
          inst2 = r32le(b + i + 4);
          if (((inst << 8) ^ (inst2 - 3)) & 0xF8003) {
            i += 6 - 2;
            continue;
          }
          u32 addr = inst & 0xFFFFF000u;
          addr += inst2 >> 20;
          inst = 0x17 | (2 << 7) | (inst2 << 12);
          inst2 = addr;
        } else {
          const u32 rs1 = inst >> 27;
          if (static_cast<u32>((inst - 0x3117) << 18) >= (rs1 & 0x1D)) {
            i += 4 - 2;
            continue;
          }
          u32 addr = r32be(b + i + 4);
          addr -= now + static_cast<u32>(i);
          inst2 = (inst >> 12) | (addr << 20);
          inst = 0x17 | (rs1 << 7) | ((addr + 0x800) & 0xFFFFF000u);
        }
        w32le(b + i, inst);
        w32le(b + i + 4, inst2);
        i += 8 - 2;
      }
    }
    return i;
  }

  // a block's whole data, where `end`: the block ended there
  void run(u8* b, size_t size) {
    switch (id) {
      case 4: x86(start, b, size); break;
      case 5: powerpc(start, b, size); break;
      case 6: ia64(start, b, size); break;
      case 7: arm(start, b, size); break;
      case 8: armthumb(start, b, size); break;
      case 9: sparc(start, b, size); break;
      case 10: arm64(start, b, size); break;
      default: riscv(start, b, size); break;
    }
  }
};

// liblzma's single-call lzma_vli_decode within [p, end)
u64 vli(const u8* d, size_t& p, size_t end) {
  u64 v = 0;
  for (int i = 0;; i++) {
    if (p >= end) fail("corrupt block header (size)");
    const u8 b = d[p++];
    v += static_cast<u64>(b & 0x7F) << (7 * i);
    if (!(b & 0x80)) {
      if (b == 0 && i > 0) fail("corrupt block header (size)");
      return v;
    }
    if (i + 1 == 9) fail("corrupt block header (size)");
  }
}

const char* bcj_name(u64 id) {
  switch (id) {
    case 4: return "x86";
    case 5: return "PowerPC";
    case 6: return "IA-64";
    case 7: return "ARM";
    case 8: return "ARM-Thumb";
    case 9: return "SPARC";
    case 10: return "ARM64";
    case 11: return "RISC-V";
    default: return nullptr;
  }
}

void decode(const u8* d, size_t n, u8* out, size_t cap, size_t& got) {
  static const u8 kMagic[6] = {0xFD, '7', 'z', 'X', 'Z', 0};
  if (n < 12) throw Starved{};
  if (std::memcmp(d, kMagic, 6)) fail("not an .xz stream");
  if (crc32(d + 6, 2) != le32(d + 8)) fail("corrupt stream header");
  if (d[6] != 0 || (d[7] & 0xF0)) fail("unsupported stream flags");
  const int check = d[7] & 15;
  size_t pos = 12;
  for (;;) {
    if (pos >= n) throw Starved{};
    // the index: the stream holds no more data
    if (d[pos] == 0) throw Starved{};
    const size_t hsize = (static_cast<size_t>(d[pos]) + 1) * 4;
    if (n - pos < hsize) throw Starved{};
    const u8* h = d + pos;
    const size_t hend = hsize - 4;
    if (crc32(h, hend) != le32(h + hend)) fail("corrupt block header (CRC32)");
    if (h[1] & 0x3C) fail("unsupported block header flags");
    size_t p = 2;
    u64 csize = ~u64{0}, usize = ~u64{0};
    if (h[1] & 0x40) {
      csize = vli(h, p, hend);
      const u64 unpadded = csize + hsize + static_cast<u64>(kCheckSize[check]);
      if (csize == 0 || csize > (~u64{0} >> 1) || unpadded > ((~u64{0} >> 1) & ~u64{3}))
        fail("corrupt block header (compressed size)");
    }
    if (h[1] & 0x80) usize = vli(h, p, hend);
    const int nfilters = (h[1] & 3) + 1;
    std::vector<u64> ids;
    std::vector<u32> props;
    for (int f = 0; f < nfilters; f++) {
      const u64 id = vli(h, p, hend);
      if (id >= (u64{1} << 62)) fail("corrupt block header (filter ID)");
      const u64 psize = vli(h, p, hend);
      if (hend - p < psize) fail("corrupt block header (filter properties)");
      u32 prop = 0;
      if (id == 0x21 || id == 3) {
        if (psize != 1) fail("unsupported filter properties");
        prop = h[p];
        if (id == 0x21 && ((prop & 0xC0) || prop > 40)) fail("unsupported LZMA2 properties");
      } else if (bcj_name(id)) {
        // the start offset, aligned as the filter's instructions are
        if (psize != 0 && psize != 4) fail("unsupported filter properties");
        if (psize == 4) prop = le32(h + p);
        static const u32 kAlign[12] = {0, 0, 0, 0, 0, 3, 15, 3, 1, 3, 3, 1};
        if (prop & kAlign[id]) fail("unsupported filter properties (start offset)");
      } else {
        fail("unsupported filter " + std::to_string(id));
      }
      p += static_cast<size_t>(psize);
      ids.push_back(id);
      props.push_back(prop);
    }
    for (; p < hend; p++)
      if (h[p] != 0) fail("unsupported block header (padding)");
    // validate_chain: Delta or BCJ filters, then LZMA2 last
    for (int f = 0; f < nfilters; f++)
      if ((ids[f] == 0x21) != (f == nfilters - 1)) fail("unsupported filter chain");
    bool bcj = false;
    size_t look = 0;  // what liblzma decodes past the strip to convert its last bytes
    for (int f = 0; f < nfilters; f++) {
      if (!bcj_name(ids[f])) continue;
      bcj = true;
      look += 2 * Bcj::unfiltered_max(ids[f]);
    }
    pos += hsize;
    // the block's data
    Lzma2 z;
    z.in = d;
    z.pos = pos;
    z.stop = csize == ~u64{0} ? n : static_cast<size_t>(std::min<u64>(n, pos + csize));
    const u32 dprop = props[nfilters - 1];
    u64 dsize = dprop == 40 ? 0xFFFFFFFFull : u64{2u | (dprop & 1)} << (dprop / 2 + 11);
    dsize = std::max<u64>(dsize, 4096);
    dsize = (dsize + 15) & ~u64{15};
    z.dict_size = static_cast<size_t>(dsize);
    z.limit = usize;
    z.dict.reserve(cap - got);
    // with a BCJ filter the chain runs over the block's LZMA2 output (as
    // far as the strip and the filters' look-ahead go) once it is out;
    // Delta filters alone run byte by byte as it comes
    std::vector<u8> raw;
    size_t raw_got = 0;
    if (bcj) {
      raw.resize(cap - got + look);
      z.out = raw.data();
      z.cap = raw.size();
      z.got = &raw_got;
    } else {
      z.out = out;
      z.cap = cap;
      z.got = &got;
      for (int f = nfilters - 2; f >= 0; f--) {
        z.deltas.push_back(static_cast<int>(props[f]) + 1);
        z.delta_hist.emplace_back(256, 0);
        z.delta_pos.push_back(0);
      }
    }
    const u8* data = out + got;
    if (bcj) {
      try {
        z.run();
      } catch (const Full&) {
      }
      for (int f = nfilters - 2; f >= 0; f--) {
        if (ids[f] == 3) {
          const size_t dist = props[f] + 1;
          for (size_t i = dist; i < raw_got; i++) raw[i] = static_cast<u8>(raw[i] + raw[i - dist]);
        } else {
          Bcj{ids[f], props[f]}.run(raw.data(), raw_got);
        }
      }
      const size_t take = std::min(raw_got, cap - got);
      std::memcpy(out + got, raw.data(), take);
      got += take;
      if (got == cap) throw Full{};
      data = raw.data();
    } else {
      z.run();
      data = out + got - z.produced;
    }
    if (usize != ~u64{0} && z.produced != usize) fail("corrupt block (uncompressed size)");
    u64 used = z.pos - pos;
    if (csize != ~u64{0} && used != csize) fail("corrupt block (compressed size)");
    pos = z.pos;
    while (used & 3) {
      if (pos >= n) throw Starved{};
      used++;
      if (d[pos++] != 0) fail("corrupt block (padding)");
    }
    const size_t cs = static_cast<size_t>(kCheckSize[check]);
    if (n - pos < cs) throw Starved{};
    const u8* c = d + pos;
    const size_t len = static_cast<size_t>(z.produced);
    bool ok = true;
    if (check == 1) {
      ok = le32(c) == crc32(data, len);
    } else if (check == 4) {
      ok = le64(c) == crc64(data, len);
    } else if (check == 10) {
      u8 dig[32];
      sha256(data, len, dig);
      ok = std::memcmp(dig, c, 32) == 0;
    }
    if (!ok) fail("corrupt block (check)");
    pos += cs;
  }
}

}  // namespace

void tiff_xz(const uint8_t* d, int64_t n, uint8_t* out, int64_t cap) {
  size_t got = 0;
  try {
    decode(d, static_cast<size_t>(n), out, static_cast<size_t>(cap), got);
  } catch (const Full&) {
    return;
  } catch (const Starved&) {
  }
  corrupt("TIFF: LZMA data: not enough data (short " + std::to_string(cap - static_cast<int64_t>(got)) +
          " bytes)");
}

}  // namespace mrt
