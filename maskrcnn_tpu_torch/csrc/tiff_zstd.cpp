// TIFF's ZSTD compression (50000): one strip or tile as libtiff 4.7's
// ZSTDDecode reads it over libzstd 1.5.7 (Pillow 12.1's libraries).
//
// libtiff resets a ZSTD_DStream for each strip and calls
// ZSTD_decompressStream with the whole strip as input and the strip's
// bytes as output until the call returns 0 (a frame ended), the input is
// consumed or the output is full; an error, or an output left short, fails
// the strip. With all the input at hand that is one call, and what it does
// is modelled here:
//
// * the frame header (magic, descriptor with its reserved bit, window
//   descriptor, dictionary ID, content size), checked as
//   ZSTD_getFrameHeader_advanced and ZSTD_decodeFrameHeader check it; a
//   skippable frame, or a frame that ends before the output is full, ends
//   the call short;
// * libzstd's single-pass shortcut: a frame whose content size is the
//   strip's and whose blocks are all in the strip is decoded by
//   ZSTD_decompress_usingDDict, every check made (content size, checksum)
//   and no window limit applied;
// * otherwise the streaming decoder: the window limit
//   (ZSTD_WINDOWLOG_LIMIT_DEFAULT, 27), blocks decoded into libzstd's
//   output buffer (window + 2 blocks, or the content size when smaller,
//   wrapped as zstd_decompress.c wraps it, its extDict segment kept) and
//   flushed to the strip, a raw block taken as far as the input goes,
//   decoding going on past a full output until a block with bytes left
//   over, the content size checked at the last block and the XXH64
//   checksum when it is reached;
// * blocks as zstd_decompress_block.c decodes them: raw, RLE and
//   compressed; literals raw, RLE, Huffman-coded with 1 or 4 streams and
//   FSE-compressed or direct weights, or treeless; the 4-stream Huffman
//   decode through huf_decompress.c's fast loop where libzstd takes it (it
//   checks no stream's end) and its plain body elsewhere; sequences with
//   predefined, RLE, FSE-compressed or repeated tables, the repeat offsets
//   and the bitstream's exact end. The bit readers are bitstream.h's, so
//   that corrupt data reads what libzstd reads.

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

[[noreturn]] void fail(const char* what) {
  corrupt(std::string("TIFF: ZSTD data: ") + what);
}

inline u32 highbit(u32 v) { return 31 - static_cast<u32>(__builtin_clz(v)); }
inline u64 le64(const u8* p) {
  u64 v = 0;
  for (int i = 7; i >= 0; i--) v = (v << 8) | p[i];
  return v;
}
inline u32 le32(const u8* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<u32>(p[3]) << 24);
}
inline u32 le24(const u8* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
inline u32 le16(const u8* p) { return p[0] | (p[1] << 8); }

// ------------------------------------------------------------------ XXH64

constexpr u64 kP1 = 11400714785074694791ULL, kP2 = 14029467366897019727ULL,
              kP3 = 1609587929392839161ULL, kP4 = 9650029242287828579ULL,
              kP5 = 2870177450012600261ULL;

inline u64 rotl(u64 x, int r) { return (x << r) | (x >> (64 - r)); }
inline u64 xround(u64 acc, u64 in) { return rotl(acc + in * kP2, 31) * kP1; }
inline u64 xmerge(u64 acc, u64 v) { return (acc ^ xround(0, v)) * kP1 + kP4; }

u64 xxh64(const u8* p, size_t len) {
  const u8* end = p + len;
  u64 h;
  if (len >= 32) {
    u64 v1 = kP1 + kP2, v2 = kP2, v3 = 0, v4 = 0 - kP1;
    do {
      v1 = xround(v1, le64(p));
      v2 = xround(v2, le64(p + 8));
      v3 = xround(v3, le64(p + 16));
      v4 = xround(v4, le64(p + 24));
      p += 32;
    } while (end - p >= 32);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = kP5;
  }
  h += len;
  for (; end - p >= 8; p += 8) h = rotl(h ^ xround(0, le64(p)), 27) * kP1 + kP4;
  if (end - p >= 4) {
    h = rotl(h ^ (static_cast<u64>(le32(p)) * kP1), 23) * kP2 + kP3;
    p += 4;
  }
  for (; p < end; p++) h = rotl(h ^ (*p * kP5), 11) * kP1;
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  return h ^ (h >> 32);
}

// ------------------------------------------------------ bitstream.h reader

enum { kUnfinished = 0, kEndOfBuffer = 1, kCompleted = 2, kOverflow = 3 };

struct BitIn {
  u64 c = 0;
  u32 consumed = 0;
  const u8* ptr = nullptr;
  const u8* start = nullptr;
  const u8* limit = nullptr;
  bool zeroed = false;  // overflow seen: ptr points at no byte of the stream

  // BIT_initDStream; false where it returns an error
  bool init(const u8* src, size_t n) {
    if (n < 1) return false;
    start = src;
    limit = src + 8;
    zeroed = false;
    const u8 last = src[n - 1];
    if (n >= 8) {
      ptr = src + n - 8;
      c = le64(ptr);
      consumed = last ? 8 - highbit(last) : 0;
      return last != 0;
    }
    ptr = start;
    c = src[0];
    for (size_t k = n - 1; k >= 1; k--) c += static_cast<u64>(src[k]) << (8 * k);
    consumed = last ? 8 - highbit(last) : 0;
    if (!last) return false;
    consumed += static_cast<u32>(8 - n) * 8;
    return true;
  }
  u64 look(u32 nb) const {
    return (c >> ((64u - consumed - nb) & 63)) & ((u64{1} << nb) - 1);
  }
  u64 look_fast(u32 nb) const { return (c << (consumed & 63)) >> ((64u - nb) & 63); }
  u64 read(u32 nb) {
    const u64 v = look(nb);
    consumed += nb;
    return v;
  }
  u64 read_fast(u32 nb) {
    const u64 v = look_fast(nb);
    consumed += nb;
    return v;
  }
  int reload_internal() {
    ptr -= consumed >> 3;
    consumed &= 7;
    c = le64(ptr);
    return kUnfinished;
  }
  int reload_fast() {
    if (zeroed || ptr < limit) return kOverflow;
    return reload_internal();
  }
  int reload() {
    if (consumed > 64) {
      zeroed = true;
      return kOverflow;
    }
    if (zeroed) return kOverflow;
    if (ptr >= limit) return reload_internal();
    if (ptr == start) return consumed < 64 ? kEndOfBuffer : kCompleted;
    u32 nbytes = consumed >> 3;
    int result = kUnfinished;
    if (ptr - nbytes < start) {
      nbytes = static_cast<u32>(ptr - start);
      result = kEndOfBuffer;
    }
    ptr -= nbytes;
    consumed -= nbytes * 8;
    c = le64(ptr);
    return result;
  }
  bool end() const { return !zeroed && ptr == start && consumed == 64; }
};

// -------------------------------------------------------------------- FSE

// FSE_readNCount: the normalized counts of symbols 0..*max_sv, *max_sv
// and *log set; the header's size, or 0 for an error
size_t read_ncount(short* norm, unsigned* max_sv, unsigned* log, const u8* src, size_t size) {
  if (size < 8) {
    u8 buf[8] = {0};
    std::memcpy(buf, src, size);
    const size_t r = read_ncount(norm, max_sv, log, buf, 8);
    return r == 0 || r > size ? 0 : r;
  }
  const u8* ip = src;
  const u8* const iend = src + size;
  const unsigned max_sv1 = *max_sv + 1;
  std::fill(norm, norm + max_sv1, 0);
  u32 bits = le32(ip);
  int nbits = static_cast<int>(bits & 15) + 5;
  if (nbits > 15) return 0;
  bits >>= 4;
  int bit_count = 4;
  *log = static_cast<unsigned>(nbits);
  int remaining = (1 << nbits) + 1;
  int threshold = 1 << nbits;
  nbits++;
  unsigned charnum = 0;
  bool previous0 = false;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (bit_count >> 3) <= iend - 4) {
      ip += bit_count >> 3;
      bit_count &= 7;
    } else {
      bit_count -= static_cast<int>(8 * (iend - 4 - ip));
      bit_count &= 31;
      ip = iend - 4;
    }
    bits = le32(ip) >> bit_count;
  };
  for (;;) {
    if (previous0) {
      int repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          bit_count -= static_cast<int>(8 * (iend - 7 - ip));
          bit_count &= 31;
          ip = iend - 4;
        }
        bits = le32(ip) >> bit_count;
        repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      }
      charnum += 3 * repeats;
      bits >>= 2 * repeats;
      bit_count += 2 * repeats;
      charnum += bits & 3;
      bit_count += 2;
      if (charnum >= max_sv1) break;
      advance();
    }
    {
      const int max = (2 * threshold - 1) - remaining;
      int count;
      if (static_cast<int>(bits & (threshold - 1)) < max) {
        count = static_cast<int>(bits & (threshold - 1));
        bit_count += nbits - 1;
      } else {
        count = static_cast<int>(bits & (2 * threshold - 1));
        if (count >= threshold) count -= max;
        bit_count += nbits;
      }
      count--;
      if (count >= 0) {
        remaining -= count;
      } else {
        remaining += count;
      }
      norm[charnum++] = static_cast<short>(count);
      previous0 = count == 0;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nbits = static_cast<int>(highbit(static_cast<u32>(remaining))) + 1;
        threshold = 1 << (nbits - 1);
      }
      if (charnum >= max_sv1) break;
      advance();
    }
  }
  if (remaining != 1) return 0;
  if (charnum > max_sv1) return 0;
  if (bit_count > 32) return 0;
  *max_sv = charnum - 1;
  ip += (bit_count + 7) >> 3;
  return static_cast<size_t>(ip - src);
}

inline u32 table_step(u32 size) { return (size >> 1) + (size >> 3) + 3; }

// the symbol spread of FSE_buildDTable and ZSTD_buildFSETable; symbol_next
// gets each symbol's first state. false where FSE_buildDTable errors.
bool spread(const short* norm, unsigned max_sv, unsigned log, std::vector<u16>& sym,
            std::vector<u16>& symbol_next, bool* fast) {
  const u32 size = 1u << log;
  u32 high = size - 1;
  sym.assign(size, 0);
  symbol_next.assign(max_sv + 1, 0);
  *fast = true;
  const short large = static_cast<short>(1 << (log - 1));
  for (unsigned s = 0; s <= max_sv; s++) {
    if (norm[s] == -1) {
      sym[high--] = static_cast<u16>(s);
      symbol_next[s] = 1;
    } else {
      if (norm[s] >= large) *fast = false;
      symbol_next[s] = static_cast<u16>(norm[s]);
    }
  }
  const u32 mask = size - 1, step = table_step(size);
  u32 pos = 0;
  for (unsigned s = 0; s <= max_sv; s++) {
    for (int i = 0; i < norm[s]; i++) {
      sym[pos] = static_cast<u16>(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  return pos == 0;
}

struct FseCell {
  u16 new_state;
  u8 symbol;
  u8 nbits;
};

// FSE_decompress_wksp with maxLog 6 into at most 255 weights (HUF_readStats'
// FSE case); the count decoded, or -1 for an error
int fse_weights(u8* dst, const u8* src, size_t size) {
  short norm[256];
  unsigned max_sv = 255, log = 0;
  const size_t hsize = read_ncount(norm, &max_sv, &log, src, size);
  if (hsize == 0 || log > 6) return -1;
  std::vector<u16> sym, next;
  bool fast;
  if (!spread(norm, max_sv, log, sym, next, &fast)) return -1;
  const u32 tsize = 1u << log;
  std::vector<FseCell> t(tsize);
  for (u32 u = 0; u < tsize; u++) {
    const u16 s = sym[u];
    const u32 ns = next[s]++;
    t[u].symbol = static_cast<u8>(s);
    t[u].nbits = static_cast<u8>(log - highbit(ns));
    t[u].new_state = static_cast<u16>((ns << t[u].nbits) - tsize);
  }
  BitIn b;
  if (!b.init(src + hsize, size - hsize)) return -1;
  u32 st1 = static_cast<u32>(b.read(log));
  b.reload();
  u32 st2 = static_cast<u32>(b.read(log));
  b.reload();
  if (b.reload() == kOverflow) return -1;
  auto get = [&](u32& st) -> u8 {
    const FseCell& e = t[st];
    const u64 low = fast ? b.read_fast(e.nbits) : b.read(e.nbits);
    st = e.new_state + static_cast<u32>(low);
    return e.symbol;
  };
  u8* op = dst;
  u8* const omax = dst + 255;
  u8* const olimit = omax - 3;
  for (; (b.reload() == kUnfinished) & (op < olimit); op += 4) {
    op[0] = get(st1);
    op[1] = get(st2);
    op[2] = get(st1);
    op[3] = get(st2);
  }
  for (;;) {
    if (op > omax - 2) return -1;
    *op++ = get(st1);
    if (b.reload() == kOverflow) {
      *op++ = get(st2);
      break;
    }
    if (op > omax - 2) return -1;
    *op++ = get(st2);
    if (b.reload() == kOverflow) {
      *op++ = get(st1);
      break;
    }
  }
  return static_cast<int>(op - dst);
}

// ---------------------------------------------------------------- Huffman

struct Huf {
  bool ready = false;
  u32 log = 0;                  // the decoding table's log (11 or 12)
  std::vector<u16> dt;          // (symbol << 8) | nbBits, as HUF_DEltX1
};

// HUF_readStats + HUF_readDTableX1_wksp: the table's description's size,
// or 0 for an error
size_t read_huf(Huf& h, const u8* src, size_t size) {
  if (!size) return 0;
  u8 w[257];
  size_t isize = src[0];
  int osize;
  if (isize >= 128) {
    osize = static_cast<int>(isize) - 127;
    isize = (osize + 1) / 2;
    if (isize + 1 > size) return 0;
    if (osize >= 256) return 0;
    for (int k = 0; k < osize; k += 2) {
      w[k] = src[1 + k / 2] >> 4;
      w[k + 1] = src[1 + k / 2] & 15;
    }
  } else {
    if (isize + 1 > size) return 0;
    osize = fse_weights(w, src + 1, isize);
    if (osize < 0) return 0;
  }
  u32 rank[16] = {0};
  u32 total = 0;
  for (int k = 0; k < osize; k++) {
    if (w[k] > 12) return 0;
    rank[w[k]]++;
    total += (1u << w[k]) >> 1;
  }
  if (total == 0) return 0;
  u32 log = highbit(total) + 1;
  if (log > 12) return 0;
  {
    const u32 rest = (1u << log) - total;
    const u32 verif = 1u << highbit(rest);
    const u32 last = highbit(rest) + 1;
    if (verif != rest) return 0;
    w[osize] = static_cast<u8>(last);
    rank[last]++;
  }
  if (rank[1] < 2 || (rank[1] & 1)) return 0;
  const int nsym = osize + 1;
  // HUF_rescaleStats to the fast decoder's 11 bits
  if (log < 11) {
    const u32 scale = 11 - log;
    for (int s = 0; s < nsym; s++) w[s] = static_cast<u8>(w[s] + (w[s] ? scale : 0));
    for (u32 s = 11; s > scale; s--) rank[s] = rank[s - scale];
    for (u32 s = scale; s > 0; s--) rank[s] = 0;
    log = 11;
  }
  h.log = log;
  h.dt.assign(size_t{1} << log, 0);
  // symbols ordered by weight, then symbol; weight w fills 2**(w-1)
  // entries of log + 1 - w bits, weight 1 first
  u32 start[16];
  u32 next = 0;
  for (u32 k = 0; k <= log; k++) {
    start[k] = next;
    next += rank[k];
  }
  std::vector<u8> order(nsym);
  for (int s = 0; s < nsym; s++) order[start[w[s]]++] = static_cast<u8>(s);
  u32 sym = rank[0], at = 0;
  for (u32 wt = 1; wt <= log; wt++) {
    const u32 len = (1u << wt) >> 1;
    const u16 nb = static_cast<u16>(log + 1 - wt);
    for (u32 k = 0; k < rank[wt]; k++) {
      const u16 e = static_cast<u16>((order[sym + k] << 8) | nb);
      for (u32 u = 0; u < len; u++) h.dt[at++] = e;
    }
    sym += rank[wt];
  }
  h.ready = true;
  return isize + 1;
}

inline u8 huf_symbol(BitIn& b, const Huf& h) {
  const u16 e = h.dt[b.look_fast(h.log)];
  b.consumed += e & 0xFF;
  return static_cast<u8>(e >> 8);
}

// HUF_decodeStreamX1: p up to end
void huf_stream(u8* p, u8* end, BitIn& b, const Huf& h) {
  if (end - p > 3) {
    while ((b.reload() == kUnfinished) & (p < end - 3)) {
      for (int k = 0; k < 4; k++) *p++ = huf_symbol(b, h);
    }
  } else {
    b.reload();
  }
  while (p < end) *p++ = huf_symbol(b, h);
}

bool huf_1x(u8* dst, size_t dsize, const u8* src, size_t size, const Huf& h) {
  BitIn b;
  if (!b.init(src, size)) return false;
  huf_stream(dst, dst + dsize, b, h);
  return b.end();
}

// HUF_decompress4X1_usingDTable_internal_body
bool huf_4x_body(u8* dst, size_t dsize, const u8* src, size_t size, const Huf& h) {
  if (size < 10 || dsize < 6) return false;
  const size_t l1 = le16(src), l2 = le16(src + 2), l3 = le16(src + 4);
  const size_t l4 = size - (l1 + l2 + l3 + 6);
  const size_t seg = (dsize + 3) / 4;
  u8* const oend = dst + dsize;
  if (l4 > size) return false;
  if (3 * seg > dsize) return false;
  u8* const ostart[4] = {dst, dst + seg, dst + 2 * seg, dst + 3 * seg};
  const u8* const istart[4] = {src + 6, src + 6 + l1, src + 6 + l1 + l2, src + 6 + l1 + l2 + l3};
  const size_t len[4] = {l1, l2, l3, l4};
  BitIn b[4];
  for (int s = 0; s < 4; s++)
    if (!b[s].init(istart[s], len[s])) return false;
  u8* op[4] = {ostart[0], ostart[1], ostart[2], ostart[3]};
  u8* const olimit = oend - 3;
  if (oend - op[3] >= 8) {
    bool go = true;
    while (go & (op[3] < olimit)) {
      for (int k = 0; k < 4; k++)
        for (int s = 0; s < 4; s++) *op[s]++ = huf_symbol(b[s], h);
      for (int s = 0; s < 4; s++) go &= b[s].reload_fast() == kUnfinished;
    }
  }
  if (op[0] > ostart[1] || op[1] > ostart[2] || op[2] > ostart[3]) return false;
  for (int s = 0; s < 4; s++) huf_stream(op[s], s < 3 ? ostart[s + 1] : oend, b[s], h);
  return b[0].end() && b[1].end() && b[2].end() && b[3].end();
}

// HUF_decompress4X1_usingDTable_internal_fast with its C loop (the
// assembly loop libzstd runs on x86-64 does the same): no stream's end is
// checked, and a stream may read on into the ones below it. 1 for done,
// 0 for the body's turn, -1 for an error.
int huf_4x_fast(u8* dst, size_t dsize, const u8* src, size_t size, const Huf& h) {
  if (dsize == 0) return 0;
  if (size < 10) return -1;
  if (h.log != 11) return 0;
  const size_t l1 = le16(src), l2 = le16(src + 2), l3 = le16(src + 4);
  const size_t l4 = size - (l1 + l2 + l3 + 6);
  const u8* iend[4];
  iend[0] = src + 6;
  iend[1] = iend[0] + l1;
  iend[2] = iend[1] + l2;
  iend[3] = iend[2] + l3;
  if (l1 < 8 || l2 < 8 || l3 < 8 || l4 < 8) return 0;
  if (l4 > size) return -1;
  const u8* ip[4] = {iend[1] - 8, iend[2] - 8, iend[3] - 8, src + size - 8};
  const size_t seg = (dsize + 3) / 4;
  u8* const oend = dst + dsize;
  u8* op[4] = {dst, dst + seg, dst + 2 * seg, dst + 3 * seg};
  if (op[3] >= oend) return 0;
  u64 bits[4];
  for (int s = 0; s < 4; s++) {
    const u8 last = ip[s][7];
    const int used = last ? 8 - static_cast<int>(highbit(last)) : 0;
    bits[s] = (le64(ip[s]) | 1) << used;
  }
  const u8* const ilowest = src;
  for (;;) {
    const size_t oiters = static_cast<size_t>(oend - op[3]) / 5;
    const size_t iiters = static_cast<size_t>(ip[0] - ilowest) / 7;
    const size_t iters = std::min(oiters, iiters);
    u8* const olimit = op[3] + iters * 5;
    if (op[3] == olimit) break;
    bool crossed = false;
    for (int s = 1; s < 4; s++) crossed |= ip[s] < ip[s - 1];
    if (crossed) break;
    do {
      for (int k = 0; k < 5; k++) {
        for (int s = 0; s < 4; s++) {
          const u16 e = h.dt[bits[s] >> 53];
          bits[s] <<= (e & 0x3F);
          op[s][k] = static_cast<u8>(e >> 8);
        }
      }
      for (int s = 0; s < 4; s++) {
        const int ctz = __builtin_ctzll(bits[s]);
        op[s] += 5;
        ip[s] -= ctz >> 3;
        bits[s] = (le64(ip[s]) | 1) << (ctz & 7);
      }
    } while (op[3] < olimit);
  }
  u8* seg_end = dst;
  for (int s = 0; s < 4; s++) {
    seg_end = seg <= static_cast<size_t>(oend - seg_end) ? seg_end + seg : oend;
    if (op[s] > seg_end) return -1;
    if (ip[s] < iend[s] - 8) return -1;
    BitIn b;
    b.c = le64(ip[s]);
    b.consumed = static_cast<u32>(__builtin_ctzll(bits[s]));
    b.start = ilowest;
    b.limit = ilowest + 8;
    b.ptr = ip[s];
    huf_stream(op[s], seg_end, b, h);
  }
  return 1;
}

bool huf_4x(u8* dst, size_t dsize, const u8* src, size_t size, const Huf& h) {
  const int r = huf_4x_fast(dst, dsize, src, size, h);
  if (r) return r > 0;
  return huf_4x_body(dst, dsize, src, size, h);
}

// -------------------------------------------------------------- sequences

struct SeqCell {
  u16 next_state;
  u8 nb_add;
  u8 nbits;
  u32 base;
};

struct SeqTable {
  u32 log = 0;
  bool fast = false;
  std::vector<SeqCell> cells;
};

const u32 kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11,
                         12, 13, 14, 15, 16, 18, 20, 22, 24, 28, 32, 40,
                         48, 64, 0x80, 0x100, 0x200, 0x400, 0x800, 0x1000,
                         0x2000, 0x4000, 0x8000, 0x10000};
const u8 kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                        1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const u32 kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                         17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                         31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                         99, 0x83, 0x103, 0x203, 0x403, 0x803, 0x1003, 0x2003,
                         0x4003, 0x8003, 0x10003};
const u8 kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                        0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                        2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const short kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                           2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const short kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                           1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                           1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const short kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                           1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
u32 kOFBase[32];
u8 kOFBits[32];

// ZSTD_buildFSETable
void build_seq(SeqTable& t, const short* norm, unsigned max_sv, unsigned log, const u32* base,
               const u8* bits) {
  std::vector<u16> sym, next;
  spread(norm, max_sv, log, sym, next, &t.fast);
  const u32 size = 1u << log;
  t.log = log;
  t.cells.assign(size, SeqCell{});
  for (u32 u = 0; u < size; u++) {
    const u16 s = sym[u];
    const u32 ns = next[s]++;
    SeqCell& c = t.cells[u];
    c.nbits = static_cast<u8>(log - highbit(ns));
    c.next_state = static_cast<u16>((ns << c.nbits) - size);
    c.nb_add = bits[s];
    c.base = base[s];
  }
}

struct Defaults {
  SeqTable ll, ml, of;
  Defaults() {
    for (int k = 0; k < 32; k++) {
      kOFBits[k] = static_cast<u8>(k);
      kOFBase[k] = k == 0 ? 0 : k == 1 ? 1 : (1u << k) - 3;
    }
    build_seq(ll, kLLNorm, 35, 6, kLLBase, kLLBits);
    build_seq(ml, kMLNorm, 52, 6, kMLBase, kMLBits);
    build_seq(of, kOFNorm, 28, 5, kOFBase, kOFBits);
  }
};

const Defaults& defaults() {
  static const Defaults d;
  return d;
}

// ------------------------------------------------------------------ frame

struct Header {
  bool skippable = false;
  size_t size = 0;          // the header's bytes
  u64 content = ~u64{0};    // ZSTD_CONTENTSIZE_UNKNOWN
  u64 window = 0;
  u32 block_max = 0;
  u32 dict_id = 0;
  bool checksum = false;
};

// ZSTD_getFrameHeader_advanced on the strip's first bytes: false for an
// error or a header past the input
bool frame_header(const u8* d, size_t n, Header& h) {
  if (n < 4) return false;
  const u32 magic = le32(d);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    h.skippable = true;
    return true;
  }
  if (magic != 0xFD2FB528u) return false;
  if (n < 5) return false;
  const u8 fhd = d[4];
  const u32 dict_code = fhd & 3, fcs_code = fhd >> 6;
  const bool single = (fhd >> 5) & 1;
  static const size_t kDictBytes[4] = {0, 1, 2, 4};
  h.size = 5 + !single + kDictBytes[dict_code] +
           (fcs_code ? size_t{1} << fcs_code : single ? 1 : 0);
  if (n < h.size) return false;
  if (fhd & 0x08) return false;  // reserved bit
  size_t pos = 5;
  u64 window = 0;
  if (!single) {
    const u8 wd = d[pos++];
    const u32 wlog = (wd >> 3) + 10;
    if (wlog > 31) return false;
    window = u64{1} << wlog;
    window += (window >> 3) * (wd & 7);
  }
  switch (dict_code) {
    case 1: h.dict_id = d[pos]; pos += 1; break;
    case 2: h.dict_id = le16(d + pos); pos += 2; break;
    case 3: h.dict_id = le32(d + pos); pos += 4; break;
    default: break;
  }
  switch (fcs_code) {
    case 0: if (single) h.content = d[pos]; break;
    case 1: h.content = le16(d + pos) + 256u; break;
    case 2: h.content = le32(d + pos); break;
    default: h.content = le64(d + pos); break;
  }
  if (single) window = h.content;
  h.window = window;
  h.block_max = static_cast<u32>(std::min<u64>(window, 128 * 1024));
  h.checksum = (fhd >> 2) & 1;
  return true;
}

struct BlockHead {
  bool last;
  int type;
  u32 size;   // the block's bytes (1 for RLE)
  u32 orig;   // RLE: the bytes it gives
};

// ZSTD_getcBlockSize; false for a short header or the reserved type
bool block_head(const u8* p, size_t avail, BlockHead& b) {
  if (avail < 3) return false;
  const u32 v = le24(p);
  b.last = v & 1;
  b.type = (v >> 1) & 3;
  b.orig = v >> 3;
  b.size = b.type == 1 ? 1 : b.orig;
  return b.type != 3;
}

// ZSTD_findFrameCompressedSize: the frame's bytes, or 0 where it errors
size_t frame_bytes(const u8* d, size_t n, const Header& h) {
  size_t pos = h.size;
  for (;;) {
    BlockHead b;
    if (!block_head(d + pos, n - pos, b)) return 0;
    if (3 + static_cast<size_t>(b.size) > n - pos) return 0;
    pos += 3 + b.size;
    if (b.last) break;
  }
  if (h.checksum) {
    if (n - pos < 4) return 0;
    pos += 4;
  }
  return pos;
}

// A ZSTD_DCtx decoding one frame's blocks into dst, with its history: the
// current segment starting at prefix, and the segment before it (ext_end
// its end, ext_len its bytes) where the output buffer has wrapped.
struct Decoder {
  u32 block_max = 0;
  u8* prefix = nullptr;
  const u8* ext_end = nullptr;
  size_t ext_len = 0;
  u32 rep[3] = {1, 4, 8};
  bool lit_entropy = false, fse_entropy = false;
  Huf huf;
  SeqTable ll_own, of_own, ml_own;
  const SeqTable* ll = nullptr;
  const SeqTable* of = nullptr;
  const SeqTable* ml = nullptr;
  std::vector<u8> lit;
  size_t lit_size = 0;

  // ZSTD_decodeLiteralsBlock: the section's bytes
  size_t literals(const u8* src, size_t size, size_t dst_cap) {
    if (size < 2) fail("corrupted block (literals)");
    const int type = src[0] & 3;
    const size_t expected = std::min<size_t>(block_max, dst_cap);
    const u32 lhl = (src[0] >> 2) & 3;
    if (type == 0 || type == 1) {
      size_t lh, n;
      switch (lhl) {
        case 1: lh = 2; n = le16(src) >> 4; break;
        case 3:
          lh = 3;
          if (size < (type == 0 ? 3u : 4u)) fail("corrupted block (literals)");
          n = le24(src) >> 4;
          break;
        default: lh = 1; n = src[0] >> 3; break;
      }
      if (type == 1 && lhl == 1 && size < 3) fail("corrupted block (literals)");
      if (n > block_max) fail("corrupted block (literals)");
      if (expected < n) fail("destination buffer too small (literals)");
      lit.resize(std::max<size_t>(n, 1));
      lit_size = n;
      if (type == 0) {
        if (lh + n > size) fail("corrupted block (literals)");
        std::memcpy(lit.data(), src + lh, n);
        return lh + n;
      }
      std::memset(lit.data(), src[lh], n);
      return lh + 1;
    }
    if (type == 3 && !lit_entropy) fail("dictionary is corrupted (treeless literals)");
    if (size < 5) fail("corrupted block (literals)");
    const u32 lhc = le32(src);
    size_t lh, n, csize;
    bool single = false;
    switch (lhl) {
      case 2: lh = 4; n = (lhc >> 4) & 0x3FFF; csize = lhc >> 18; break;
      case 3: lh = 5; n = (lhc >> 4) & 0x3FFFF; csize = (lhc >> 22) + (static_cast<size_t>(src[4]) << 10); break;
      default: single = lhl == 0; lh = 3; n = (lhc >> 4) & 0x3FF; csize = (lhc >> 14) & 0x3FF; break;
    }
    if (n > block_max) fail("corrupted block (literals)");
    if (!single && n < 6) fail("literals header wrong");
    if (csize + lh > size) fail("corrupted block (literals)");
    if (expected < n) fail("destination buffer too small (literals)");
    lit.resize(std::max<size_t>(n, 1));
    lit_size = n;
    const u8* p = src + lh;
    bool ok;
    if (type == 3) {
      ok = single ? huf_1x(lit.data(), n, p, csize, huf) : huf_4x(lit.data(), n, p, csize, huf);
    } else {
      if (!single && n == 0) fail("corrupted block (literals)");
      if (csize == 0) fail("corrupted block (literals)");
      Huf fresh;
      const size_t hs = read_huf(fresh, p, csize);
      // the table is built into the context's even when the data then fails
      if (hs == 0) fail("corrupted block (Huffman table)");
      huf = fresh;
      if (hs >= csize) fail("corrupted block (Huffman data)");
      ok = single ? huf_1x(lit.data(), n, p + hs, csize - hs, huf)
                  : huf_4x(lit.data(), n, p + hs, csize - hs, huf);
    }
    if (!ok) fail("corrupted block (Huffman data)");
    lit_entropy = true;
    return csize + lh;
  }

  // ZSTD_buildSeqTable
  size_t seq_table(int type, unsigned max, unsigned max_log, const u8* src, size_t size,
                   const u32* base, const u8* bits, const SeqTable& dflt, SeqTable& own,
                   const SeqTable*& ptr) {
    switch (type) {
      case 1: {
        if (!size) fail("corrupted block (sequence table)");
        if (src[0] > max) fail("corrupted block (sequence table)");
        own.log = 0;
        own.fast = false;
        own.cells.assign(1, SeqCell{0, bits[src[0]], 0, base[src[0]]});
        ptr = &own;
        return 1;
      }
      case 0:
        ptr = &dflt;
        return 0;
      case 3:
        if (!fse_entropy) fail("corrupted block (repeated sequence table)");
        return 0;
      default: {
        short norm[53];
        unsigned sv = max, log = 0;
        const size_t hs = read_ncount(norm, &sv, &log, src, size);
        if (hs == 0 || log > max_log) fail("corrupted block (sequence table)");
        build_seq(own, norm, sv, log, base, bits);
        ptr = &own;
        return hs;
      }
    }
  }

  // ZSTD_decompressBlock_internal: the bytes written at dst (capacity cap)
  size_t compressed(const u8* src, size_t size, u8* dst, size_t cap) {
    if (size > block_max) fail("block larger than the block size");
    const size_t lsize = literals(src, size, cap);
    const u8* ip = src + lsize;
    const u8* const iend = src + size;
    // ZSTD_decodeSeqHeaders
    if (iend - ip < 1) fail("corrupted block (sequences header)");
    u32 nseq = *ip++;
    if (nseq > 0x7F) {
      if (nseq == 0xFF) {
        if (iend - ip < 2) fail("corrupted block (sequences header)");
        nseq = le16(ip) + 0x7F00;
        ip += 2;
      } else {
        if (ip >= iend) fail("corrupted block (sequences header)");
        nseq = ((nseq - 0x80) << 8) + *ip++;
      }
    }
    const Defaults& df = defaults();
    if (nseq == 0) {
      if (ip != iend) fail("corrupted block (extraneous data after no sequences)");
    } else {
      if (iend - ip < 1) fail("corrupted block (sequences header)");
      if (*ip & 3) fail("corrupted block (reserved bits)");
      const int llt = *ip >> 6, oft = (*ip >> 4) & 3, mlt = (*ip >> 2) & 3;
      ip++;
      ip += seq_table(llt, 35, 9, ip, iend - ip, kLLBase, kLLBits, df.ll, ll_own, ll);
      ip += seq_table(oft, 31, 8, ip, iend - ip, kOFBase, kOFBits, df.of, of_own, of);
      ip += seq_table(mlt, 52, 9, ip, iend - ip, kMLBase, kMLBits, df.ml, ml_own, ml);
      if (cap == 0) fail("destination buffer too small");
    }
    // ZSTD_decompressSequences_body
    u8* op = dst;
    u8* const oend = dst + cap;
    const u8* lp = lit.data();
    const u8* const lend = lit.data() + lit_size;
    if (nseq) {
      fse_entropy = true;
      u32 prev[3] = {rep[0], rep[1], rep[2]};
      BitIn b;
      if (!b.init(ip, static_cast<size_t>(iend - ip))) fail("corrupted block (sequences)");
      u32 sll = static_cast<u32>(b.read(ll->log));
      b.reload();
      u32 sof = static_cast<u32>(b.read(of->log));
      b.reload();
      u32 sml = static_cast<u32>(b.read(ml->log));
      b.reload();
      for (; nseq; nseq--) {
        const SeqCell& L = ll->cells[sll];
        const SeqCell& M = ml->cells[sml];
        const SeqCell& O = of->cells[sof];
        size_t mlen = M.base, llen = L.base;
        const u32 total = L.nb_add + M.nb_add + O.nb_add;
        size_t offset;
        if (O.nb_add > 1) {
          offset = O.base + b.read_fast(O.nb_add);
          prev[2] = prev[1];
          prev[1] = prev[0];
          prev[0] = static_cast<u32>(offset);
        } else {
          const u32 ll0 = L.base == 0;
          if (O.nb_add == 0) {
            offset = prev[ll0];
            prev[1] = prev[!ll0];
            prev[0] = static_cast<u32>(offset);
          } else {
            offset = O.base + ll0 + b.read_fast(1);
            size_t temp = offset == 3 ? prev[0] - size_t{1} : prev[offset];
            temp -= !temp;
            if (offset != 1) prev[2] = prev[1];
            prev[1] = prev[0];
            prev[0] = static_cast<u32>(temp);
            offset = temp;
          }
        }
        if (M.nb_add) mlen += b.read_fast(M.nb_add);
        if (total >= 57 - (9 + 9 + 8)) b.reload();
        if (L.nb_add) llen += b.read_fast(L.nb_add);
        if (nseq > 1) {
          sll = L.next_state + static_cast<u32>(b.read(L.nbits));
          sml = M.next_state + static_cast<u32>(b.read(M.nbits));
          sof = O.next_state + static_cast<u32>(b.read(O.nbits));
          b.reload();
        }
        // ZSTD_execSequence(End)
        if (llen + mlen > static_cast<size_t>(oend - op)) fail("destination buffer too small (sequence)");
        if (llen > static_cast<size_t>(lend - lp)) fail("corrupted block (literals overrun)");
        std::memcpy(op, lp, llen);
        op += llen;
        lp += llen;
        const size_t in_prefix = static_cast<size_t>(op - prefix);
        if (offset > in_prefix) {
          if (offset > in_prefix + ext_len) fail("corrupted block (offset beyond the window)");
          const u8* m = ext_end - (offset - in_prefix);
          const size_t from_ext = std::min(mlen, static_cast<size_t>(ext_end - m));
          std::memmove(op, m, from_ext);
          op += from_ext;
          mlen -= from_ext;
          for (size_t k = 0; k < mlen; k++, op++) *op = prefix[k];
          continue;
        }
        const u8* m = op - offset;
        for (size_t k = 0; k < mlen; k++) op[k] = m[k];
        op += mlen;
      }
      if (!b.end()) fail("corrupted block (sequences do not end with the data)");
      rep[0] = prev[0];
      rep[1] = prev[1];
      rep[2] = prev[2];
    }
    const size_t last = static_cast<size_t>(lend - lp);
    if (last > static_cast<size_t>(oend - op)) fail("destination buffer too small (literals)");
    std::memcpy(op, lp, last);
    op += last;
    return static_cast<size_t>(op - dst);
  }

  // one block's bytes p[0, b.size) at dst (capacity cap): its output size
  size_t block(const BlockHead& b, const u8* p, u8* dst, size_t cap) {
    size_t r;
    if (b.type == 2) {
      r = compressed(p, b.size, dst, cap);
    } else if (b.type == 0) {
      if (b.size > cap) fail("destination buffer too small (raw block)");
      std::memcpy(dst, p, b.size);
      r = b.size;
    } else {
      if (b.orig > cap) fail("destination buffer too small (RLE block)");
      std::memset(dst, p[0], b.orig);
      r = b.orig;
    }
    if (r > block_max) fail("decompressed block larger than the block size");
    return r;
  }
};

// ZSTD_decompress_usingDDict on the frame d[0, n) into out[0, cap)
void single_pass(const u8* d, size_t n, const Header& h, u8* out, size_t cap) {
  Decoder z;
  z.block_max = h.block_max;
  z.prefix = out;
  size_t pos = h.size, op = 0;
  for (;;) {
    BlockHead b{};
    block_head(d + pos, n - pos, b);
    pos += 3;
    op += z.block(b, d + pos, out + op, cap - op);
    pos += b.size;
    if (b.last) break;
  }
  if (h.content != ~u64{0} && op != h.content) fail("frame content size mismatch");
  if (h.checksum && le32(d + pos) != static_cast<u32>(xxh64(out, op)))
    fail("restored data doesn't match checksum");
  if (op < cap)
    corrupt("TIFF: ZSTD data: not enough data (short " + std::to_string(cap - op) + " bytes)");
}

// ZSTD_decompressStream's streaming route over the one frame: the bytes
// flushed to out
size_t streaming(const u8* d, size_t n, const Header& h, u8* out, size_t cap) {
  u64 window = std::max<u64>(h.window, 1024);
  if (window > (u64{1} << 27) + 1) fail("frame requires too much memory for decoding");
  const u64 bsize = std::min<u64>({window, 128 * 1024, h.block_max});
  const u64 rb = window + 2 * bsize + 64;
  const u64 out_buff = std::min<u64>(h.content, rb);
  const bool wraps = out_buff < h.content;
  // what this call can touch before it stops: the output, one more block
  const u64 phys = std::min<u64>(out_buff, cap + u64{h.block_max} + 64);
  std::vector<u8> ring(static_cast<size_t>(std::max<u64>(phys, 1)));
  Decoder z;
  z.block_max = h.block_max;
  z.prefix = ring.data();
  u8* prev_end = ring.data();   // previousDstEnd
  size_t out_start = 0, flushed = 0;
  u64 decoded = 0;
  size_t pos = h.size;
  // a unit's output at ring[out_start, +r): flushed; false once the output
  // is full with bytes left over
  auto flush = [&](size_t r) {
    const size_t k = std::min(r, cap - flushed);
    std::memcpy(out + flushed, ring.data() + out_start, k);
    flushed += k;
    out_start += r;
    if (k < r) return false;
    if (wraps && out_start + h.block_max > out_buff) out_start = 0;
    return true;
  };
  // ZSTD_checkContinuity at the start of a unit
  auto continuity = [&](size_t avail) {
    u8* dst = ring.data() + out_start;
    if (dst != prev_end && avail > 0) {
      z.ext_end = prev_end;
      z.ext_len = static_cast<size_t>(prev_end - z.prefix);
      z.prefix = dst;
      prev_end = dst;
    }
  };
  for (;;) {
    const size_t avail = static_cast<size_t>(out_buff - out_start);
    if (n - pos < 3) return flushed;
    continuity(avail);
    BlockHead b;
    if (!block_head(d + pos, n - pos, b)) fail("corrupted block header");
    if (b.size > h.block_max) fail("block size exceeds the maximum");
    pos += 3;
    if (b.size == 0) {  // an empty block
      if (b.last) break;
      continue;
    }
    if (b.type == 0) {
      // a raw block, taken in pieces as far as the input goes
      u32 left = b.size;
      while (left) {
        if (pos >= n) return flushed;
        continuity(static_cast<size_t>(out_buff - out_start));
        const u32 piece = static_cast<u32>(std::min<size_t>(left, n - pos));
        BlockHead part{false, 0, piece, piece};
        const size_t r = z.block(part, d + pos, ring.data() + out_start,
                                 std::min<size_t>(static_cast<size_t>(out_buff - out_start),
                                                  ring.size() - out_start));
        pos += piece;
        left -= piece;
        decoded += r;
        prev_end = ring.data() + out_start + r;
        if (!left && b.last && h.content != ~u64{0} && decoded != h.content)
          fail("frame content size mismatch");
        if (!flush(r)) return flushed;
      }
    } else {
      if (n - pos < b.size) return flushed;
      const size_t room = std::min<size_t>(avail, ring.size() - out_start);
      const size_t r = z.block(b, d + pos, ring.data() + out_start, room);
      pos += b.size;
      decoded += r;
      prev_end = ring.data() + out_start + r;
      if (b.last && h.content != ~u64{0} && decoded != h.content)
        fail("frame content size mismatch");
      if (!flush(r)) return flushed;
    }
    if (b.last) break;
  }
  if (h.checksum) {
    if (n - pos < 4) return flushed;
    if (le32(d + pos) != static_cast<u32>(xxh64(out, flushed)))
      fail("restored data doesn't match checksum");
  }
  return flushed;
}

}  // namespace

void tiff_zstd(const uint8_t* d, int64_t n64, uint8_t* out, int64_t cap64) {
  const size_t n = static_cast<size_t>(n64), cap = static_cast<size_t>(cap64);
  Header h;
  if (!frame_header(d, n, h)) fail("unknown frame descriptor or truncated header");
  size_t got = 0;
  // a skippable frame, or one whose content is less than the strip, ends
  // the call before the strip is full
  if (!h.skippable) {
    if (h.dict_id) fail("dictionary mismatch");
    if (h.content == ~u64{0} || h.content >= cap) {
      const size_t whole = h.content == cap ? frame_bytes(d, n, h) : 0;
      if (whole) {
        single_pass(d, whole, h, out, cap);
        return;
      }
      got = streaming(d, n, h, out, cap);
    }
  }
  if (got < cap)
    corrupt("TIFF: ZSTD data: not enough data (short " + std::to_string(cap - got) + " bytes)");
}

}  // namespace mrt
